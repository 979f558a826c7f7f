"""The MSC input pyramid of the port against the JAX package's.

- ``ops.resize.resize_bilinear_factor`` against the JAX package's at
  Pascal's crop (321) and eval input (513), factors 0.5 and 0.75, on 3
  channels (atol 1e-6).
- The tiny-depth flagship (``__graft_entry__._flagship``: full widths,
  ResNet stages of one block each, concat ASPP of 4 x 64, 228 prototypes
  over 4 scales, 19 classes) with the pyramid (0.5, 0.75), plain and
  grouped, weights carried over by ``ppnet_params_to_statedict``: the
  train-mode list ``[base, 0.5, 0.75, fused]`` and the eval-mode fused
  output against the JAX model's (atol 1e-4).
- ``train.steps.compute_losses`` over that list (the JAX outputs fed to
  both) against the JAX package's (rtol 1e-5), plain and grouped.
- One joint micro-step of the MSC model against the JAX package's
  ``make_train_step``: loss within 1e-4, every accumulated gradient within
  1e-4 relative L2 (batch of ``test_torch_train_step``: void and every
  class).  Four ASPP output channels have zero weights and bias, so each
  map holds 0 there and the max meets exact ties: both packages give each
  tied input half the gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship, synthetic_init
from scaleprotoseg_tpu.ops.resize import resize_bilinear_factor as jfactor
from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from scaleprotoseg_torch.models.ppnet import PPNetOutput
from scaleprotoseg_torch.ops.resize import resize_bilinear_factor
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.state import TrainState
from test_torch_train_step import HP, _batch, _names, _offsets
from torch_parity import port_model, port_spec

SIDE = 33
SCALES = (0.5, 0.75)
TIED = (0, 73, 146, 219)        # ASPP output channels held at 0, one a rate
WEIGHTS = dict(crs_ent=1.0, l1=1e-4, kld=0.25)
GROUP_WEIGHTS = dict(crs_ent=1.0, l1=1e-3, kld=0.25, group_ent=0.05,
                     scale_max=0.1, crs_ent_group=0.1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(n)


def _msc_pair(grouped: bool, quant8=False):
    """(JAX model, JAX spec, variables, the port's model) of the tiny MSC
    flagship; ``TIED`` channels of the ASPP zeroed on the JAX side before
    the carry.  ``quant8`` builds both backbones' layer4/5 as int8 convs
    (the variables then hold no ``quant_scales``: they come from
    calibration)."""
    model, spec = _flagship(tiny=True, grouped=grouped, dtype=jnp.float32,
                            quant8=quant8)
    model = model.clone(msc_scales=SCALES, backbone=model.backbone.clone(
        n_blocks=(1, 1, 1, 1)))
    shapes = dict(jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0)))
    shapes.pop("quant_scales", None)
    variables = synthetic_init(shapes, seed=0)
    aspp = jax.tree.map(np.array, variables["params"]["backbone"]["aspp"])
    for i, branch in enumerate(sorted(aspp)):
        for c in TIED:
            if c // 64 == i:
                aspp[branch]["kernel"][..., c % 64] = 0.0
                aspp[branch]["bias"][c % 64] = 0.0
    variables["params"]["backbone"]["aspp"] = aspp
    tm = port_model(model, spec, variables, quant8=quant8)
    tm.msc_scales = SCALES
    return model, spec, variables, tm


@pytest.fixture(scope="module")
def pairs():
    return {g: _msc_pair(g) for g in (False, True)}


@pytest.fixture(scope="module")
def jax_train_outputs(pairs):
    """The JAX models' train-mode outputs on ``_batch()``."""
    x, _ = _batch()
    return {g: model.apply(variables, jnp.asarray(x), train=True)
            for g, (model, _, variables, _) in pairs.items()}


@pytest.mark.parametrize("side", [321, 513])
@pytest.mark.parametrize("factor", SCALES)
def test_resize_bilinear_factor_matches_jax(side, factor):
    x = np.random.default_rng(side).standard_normal(
        (1, side, side, 3)).astype(np.float32)
    want = np.asarray(jfactor(jnp.asarray(x), factor))
    got = resize_bilinear_factor(torch.from_numpy(x), factor).numpy()
    assert got.shape == want.shape == (1, int(side * factor),
                                       int(side * factor), 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
def test_msc_forward_matches_jax(pairs, jax_train_outputs, grouped):
    model, _, variables, tm = pairs[grouped]
    x, _ = _batch()
    want = jax_train_outputs[grouped]
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True)
        fused = tm.eval()(torch.from_numpy(x))
    assert isinstance(got, list) and len(got) == len(want) == 4
    # base, 0.5, 0.75 at their own grids, fused at the base grid
    assert [o.logits.shape[1] for o in got] == [5, 3, 4, 5]
    fields = ["logits", "distances", "activations"] + \
        (["group_activations"] if grouped else [])
    for g, w in zip(got, want):
        for f in fields:
            np.testing.assert_allclose(getattr(g, f).numpy(),
                                       np.asarray(getattr(w, f)), rtol=0,
                                       atol=1e-4, err_msg=f)
    want_eval = model.apply(variables, jnp.asarray(x), train=False)
    for f in fields:
        np.testing.assert_allclose(getattr(fused, f).numpy(),
                                   np.asarray(getattr(want_eval, f)),
                                   rtol=0, atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(fused.logits.numpy(), got[-1].logits)


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
def test_msc_losses_match_jax(pairs, jax_train_outputs, grouped):
    model, spec, variables, tm = pairs[grouped]
    _, y = _batch()
    outs = jax_train_outputs[grouped]
    w = GROUP_WEIGHTS if grouped else WEIGHTS
    _, want = jsteps.compute_losses(model, spec, variables["params"], outs,
                                    jnp.asarray(y), jsteps.LossWeights(**w),
                                    ignore_void=True)
    touts = [PPNetOutput(*(None if a is None else torch.tensor(
        np.asarray(a)) for a in o)) for o in outs]
    with torch.no_grad():
        loss, got = tsteps.compute_losses(tm, touts, torch.from_numpy(y),
                                          tsteps.LossWeights(**w))
    assert set(got) == set(want)
    assert float(got["n_patches"]) == 2 * (25 + 9 + 16 + 25)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(loss) == float(got["loss"])


def test_msc_micro_step_matches_jax(pairs):
    """One joint micro-step (``iter_size`` 2, so the accumulated gradient
    is read before any update), the ties of ``TIED`` included."""
    model, spec, variables, tm = pairs[False]
    tm.train()
    tspec = port_spec(spec)
    x, y = _batch(2)
    with torch.no_grad():
        maps = tm.backbone_features(torch.from_numpy(x), train=True)
    for c in TIED:      # every map is 0 there: the max meets exact ties
        assert all(float(m[:, c].abs().max()) == 0.0 for m in maps)

    groups = joptim.phase_groups("multiscale", 1, HP)
    trainable, _ = joptim.partition_params(variables["params"], set(groups))
    tx = joptim.make_phase_optimizer(
        groups, joptim.label_params(trainable),
        schedule=joptim.poly_schedule(0.9, 10), iter_size=2,
        guard_nonfinite=50)
    state = JState.create(variables["params"], variables["batch_stats"],
                          tx.init(trainable))
    fn = jsteps.make_train_step(model, spec, tx, set(groups),
                                jsteps.LossWeights(**WEIGHTS), donate=False)
    jstate, jm = fn(state, jnp.asarray(x), jnp.asarray(y))

    opt = toptim.PhaseOptimizer(
        tm.named_parameters(), toptim.phase_groups("multiscale", 1, HP),
        schedule=toptim.poly_schedule(0.9, 10), iter_size=2,
        guard_nonfinite=50)
    step = tsteps.make_train_step(tsteps.LossWeights(**WEIGHTS))
    got = step(TrainState(tm, opt), torch.from_numpy(x), torch.from_numpy(y))
    assert float(got["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-4)
    acc = {name: opt._acc[off:off + p.numel()].view_as(p).numpy()
           for name, p, off in _offsets(tm, opt)}
    grads = _names(jstate.opt_state.inner_state.acc_grads, tspec)
    assert set(grads) == set(acc)
    for name, g in grads.items():
        rel = np.linalg.norm(acc[name] - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= 1e-4, (name, rel)
