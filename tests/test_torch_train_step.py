"""One training micro-step of the port against the JAX package's
``make_train_step``, and the port's trainer CLI on the CPU.

The step runs the tiny-depth flagship (full widths, plain head) with the
JAX package's synthetic weights carried over by
``ppnet_params_to_statedict``, on one seeded 33 x 33 batch with every
train class and void, the Cityscapes config's loss weights and learning
rates, and ``iter_size`` 2 over the same batch twice:

- after the first micro-step both hold the accumulated gradient, which
  must agree within 1e-4 of each tensor's largest entry (float32);
- after the second, the updated parameters must agree within 1e-4
  wherever the two agree on the direction of Adam's first step: that
  update is ``-lr * u / (|u| + 1e-8)`` for ``u = g + wd * p``, so an
  entry whose two ``u`` differ by more than a tenth of ``|u|`` (a
  near-cancelling ``g + wd * p``, where a float32 rounding flips the
  step) is left out, and at least 99.9% of every tensor must be in;
- loss and metrics of both micro-steps within 1e-4.

Under the bf16 recipe (the JAX side's fused ASPP in Pallas interpret
mode through its own ``SCALEPROTOSEG_FORCE_FAST_ASPP`` hook) the loss
must agree within 1e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship, synthetic_init
from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from scaleprotoseg_torch import train_wandb_multiscale as trainer
from scaleprotoseg_torch.checkpoints.convert import ppnet_params_to_statedict
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.state import TrainState
from e2e_utils import build_synthetic_dataset
from torch_parity import port_model, port_spec, to_numpy_tree
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SIDE = 33
# scaleproto_cityscapes.gin
HP = dict(warm_lr_add_on=2.5e-4, warm_lr_protos=2.5e-4, warm_wd=5e-4,
          joint_lr_features=2.5e-5, joint_lr_add_on=2.5e-4,
          joint_lr_protos=2.5e-4, joint_wd=5e-4, last_layer_lr=1e-5)
WEIGHTS = dict(crs_ent=1.0, l1=1e-4, kld=0.25)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
    # 4 x 5 blocks of labels 0..19: void and every train class
    y = np.repeat(np.repeat(np.arange(20).reshape(4, 5), 9, 0), 7, 1)
    y = np.stack([np.roll(y[:SIDE, :SIDE], s, axis=(0, 1)) for s in (0, 3)])
    return x, y.astype(np.int32)


def _pair(dtype=jnp.float32, fast=False):
    model, spec = _flagship(tiny=True, grouped=False, dtype=dtype,
                            fast_aspp=fast)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=0)
    return model, spec, variables, port_model(model, spec, variables)


def _jax_steps(model, spec, variables, phase, x, y, n=2):
    groups = joptim.phase_groups("multiscale", phase, HP)
    trainable, _ = joptim.partition_params(variables["params"], set(groups))
    tx = joptim.make_phase_optimizer(
        groups, joptim.label_params(trainable),
        schedule=joptim.poly_schedule(0.9, 10) if phase == 1 else None,
        iter_size=2, guard_nonfinite=50)
    state = JState.create(variables["params"], variables["batch_stats"],
                          tx.init(trainable))
    fn = jsteps.make_train_step(model, spec, tx, set(groups),
                                jsteps.LossWeights(**WEIGHTS), donate=False)
    out = []
    for _ in range(n):
        state, m = fn(state, jnp.asarray(x), jnp.asarray(y))
        out.append((state, {k: float(v) for k, v in m.items()}))
    return out, groups


def _port_step_fn(tm, phase, remat=False):
    opt = toptim.PhaseOptimizer(
        tm.named_parameters(), toptim.phase_groups("multiscale", phase, HP),
        schedule=toptim.poly_schedule(0.9, 10) if phase == 1 else None,
        iter_size=2, guard_nonfinite=50)
    step = tsteps.make_train_step(tsteps.LossWeights(**WEIGHTS), remat=remat)
    return TrainState(tm, opt), step


def _names(tree, spec):
    return ppnet_params_to_statedict(to_numpy_tree(tree), None, spec,
                                     log=lambda _: None)


@pytest.mark.parametrize("phase", [0, 1, 2], ids=["warmup", "joint", "last"])
def test_train_step_matches_jax(phase):
    check_step_against_jax(phase)


def check_step_against_jax(phase, remat=False):
    """Two micro-steps of the port (``remat``: its forward computed again
    in the backward) against the JAX package's ``make_train_step``; see
    the module docstring for the bounds."""
    model, spec, variables, tm = _pair()
    tspec = port_spec(spec)
    x, y = _batch()
    (s1, m1), (s2, m2) = _jax_steps(model, spec, variables, phase, x, y)[0]
    state, step = _port_step_fn(tm, phase, remat)
    got = []
    for _ in range(2):
        got.append({k: float(v) for k, v in step(
            state, torch.from_numpy(x), torch.from_numpy(y)).items()})
        if len(got) == 1:
            acc = {name: state.optimizer._acc[off:off + p.numel()]
                   .view_as(p).clone().numpy()
                   for name, p, off in _offsets(tm, state.optimizer)}
    for want, have in ((m1, got[0]), (m2, got[1])):
        for k, v in want.items():
            assert have[k] == pytest.approx(v, rel=1e-4, abs=1e-4), k

    grads = _names(s1.opt_state.inner_state.acc_grads, tspec)
    assert set(grads) == set(acc)
    for name, g in grads.items():
        np.testing.assert_allclose(acc[name], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)

    init = _names(variables["params"], tspec)
    new = _names(s2.params, tspec)
    labels = {k: toptim.label_of_path(k) for k in new}
    groups = toptim.phase_groups("multiscale", phase, HP)
    have = tm.state_dict()
    for name, want in new.items():
        got_p = have[name].numpy()
        if labels[name] not in groups:
            np.testing.assert_array_equal(got_p, init[name], err_msg=name)
            continue
        wd = groups[labels[name]].weight_decay
        u = grads[name] + wd * init[name]
        decided = np.abs(acc[name] + wd * init[name] - u) < 0.1 * np.abs(u)
        assert decided.mean() >= 0.999, name
        np.testing.assert_allclose(got_p[decided], want[decided], rtol=0,
                                   atol=1e-4, err_msg=name)


def _offsets(tm, opt):
    names = {id(p): n for n, p in tm.named_parameters()}
    off = 0
    for p in opt.params:
        yield names[id(p)], p, off
        off += p.numel()


def test_bf16_recipe_step_loss_matches_jax(monkeypatch):
    monkeypatch.setenv("SCALEPROTOSEG_FORCE_FAST_ASPP", "interpret")
    model, spec, variables, tm = _pair(dtype=jnp.bfloat16, fast=True)
    tm.set_compute_dtype(torch.bfloat16)
    tm.features.base.aspp.fast = True
    x, y = _batch(seed=1)
    (_, want), = _jax_steps(model, spec, variables, 1, x, y, n=1)[0]
    state, step = _port_step_fn(tm, 1)
    got = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert float(got["loss"]) == pytest.approx(want["loss"], abs=1e-2)
    assert np.isfinite(state.optimizer._acc.numpy()).all()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
TINY = ["train.warmup_steps = 2", "train.joint_steps = 2",
        "train.finetune_steps = 0",
        "construct_PPNet.base_architecture = 'deeplabv2_resnet50_multiscale'",
        "deeplabv2_resnet50_features_multiscale.deeplab_n_features = 16",
        "construct_PPNet.prototype_shape = (76, 16, 1, 1)",
        "PatchClassificationDataset.window_size = (33, 33)",
        "PatchClassificationModuleMultiScale.iter_size = 1",
        "PatchClassificationDataModule.dataloader_n_jobs = 2"]


def _argv(root, results, extra):
    argv = ["scaleproto_cityscapes", "tiny_run", "--device", "cpu",
            "--data-root", str(root), "--results-root", str(results)]
    for line in TINY + extra:
        argv += ["--gin", line]
    return argv


def test_cli_trains_on_cpu_and_checkpoints_load(tmp_path):
    """2 warm-up and 2 joint micro-steps of a narrow ResNet-50 run on a
    synthetic dataset (labels are category indices: 0 void, 1 road, 2
    sidewalk); every checkpoint loads back through ``load_model`` and
    reproduces the trained model's logits."""
    root = build_synthetic_dataset(str(tmp_path / "data"), n_train=4,
                                   n_val=2, size=48)
    out = trainer.main(_argv(root, tmp_path / "results",
                             ["train.push_proto = False"]))
    assert sorted(out["phases"]) == [0, 1]
    for res in out["phases"].values():
        assert res.steps_done == 2 and len(res.losses) == 2
        assert np.isfinite(res.losses).all()
    run = tmp_path / "results" / "tiny_run"
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, SIDE, SIDE, 3)).astype(np.float32))
    logits = {}
    for stage in ("warmup_last", "nopush_last", "push_final"):
        ckpt = run / "checkpoints" / f"{stage}.pth"
        assert ckpt.exists() and (run / "checkpoints" /
                                  f"{stage}.ckpt.json").exists()
        model, spec = load_model(str(run), str(ckpt), device="cpu")
        assert spec.num_prototypes == 76 and spec.num_scales == 4
        with torch.no_grad():
            logits[stage] = model(x).logits
        assert torch.isfinite(logits[stage]).all()
    # the joint phase moved the weights; push_final is its last state
    assert not torch.equal(logits["warmup_last"], logits["nopush_last"])
    torch.testing.assert_close(logits["nopush_last"], logits["push_final"])
    assert (run / "metrics.csv").exists()


def test_cli_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.main(["scaleproto_cityscapes", "r", "--results-root",
                      str(tmp_path)])
