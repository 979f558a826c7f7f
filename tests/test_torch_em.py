"""EM / ISBI-2012 in the port against the JAX package, on the CPU in
float32 at the JAX tests' tiny EM width (``tests/e2e_utils.py``'s
``TINY_EM_CONFIG``: ``unet_base`` 8, ``unet_n_features`` 8, 24
prototypes, ``freeze_type = 'none'``).

- EM's tables, ``conversion_lut('em')`` (the identity) and the three
  config copies against the JAX package's; each config builds the JAX
  package's bank (24 / 2 / 4, 24 / 2 / 4 in 3 groups, 20 / 2 / 1).
- ``TrainableBatchNorm2d`` against flax's ``nn.BatchNorm`` at 8 values a
  channel, where the biased and unbiased variances differ by 14%: the
  train-mode output, the running-variance update ``(new - old) / 0.001``
  (so an unbiased update fails it), the eval-mode output, and the same
  statistics from bf16 inputs.
- The backbones (``UNetASPP`` concat and sum, ``UNet``) on 1 x 3 x 36 x
  52, whose up path resizes 4 -> 9: every updated ``batch_stats`` entry
  at rtol = atol = 1e-5; eval-mode and train-mode features at rtol = atol
  = 1e-4, each package also within that of the same formula in float64
  (the port's float64 copy).  That is the float32 rounding of 18 convs
  each renormalized by BN (eval: by running variances of a 6-value
  bottom; train: float32 ``E[x^2] - E[x]^2``): measured 1.8-3.6e-5 for
  either package against float64.
- The three tiny EM models' logits in eval mode; one joint micro-step and
  one last-layer micro-step against the JAX package's
  ``make_train_step(train_bn=True)``: loss, parameters after Adam,
  running statistics, BN affine unchanged.
- The knobs: ``remat`` ignored with ``train_bn`` (logged, the statistics
  moved once), ``fast_aspp`` off for UNet-ASPP and ``fast_gradconv``
  without effect (logged); BN affine in no optimizer group; the running
  statistics in the saved train state; the refusals by name (quant8 on an
  EM run, trainable BN on a DeepLab backbone); the weight carry of a
  plain-``unet`` tree with its ``outc`` and of the JAX train state.
"""

import copy
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from __graft_entry__ import synthetic_init
from scaleprotoseg_tpu import cli_common as jcli
from scaleprotoseg_tpu import configlib as jconfiglib
from scaleprotoseg_tpu import constants as jconstants
from scaleprotoseg_tpu import eval_valid_multiscale as jeval
from scaleprotoseg_tpu import settings as jsettings
from scaleprotoseg_tpu.models import factory as jfactory
from scaleprotoseg_tpu.models.ppnet import PPNet as JPPNet
from scaleprotoseg_tpu.models.unet import UNet as JUNet
from scaleprotoseg_tpu.models.unet import UNetASPP as JUNetASPP
from scaleprotoseg_tpu.spec import ProtoSpec as JSpec
from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from scaleprotoseg_torch import cli_common, configlib, constants, settings
from scaleprotoseg_torch import eval_valid_multiscale as teval
from scaleprotoseg_torch.checkpoints.convert import (
    _convbn_to_statedict, ppnet_params_to_statedict, save_checkpoint,
    to_tensors, train_state_from_jax)
from scaleprotoseg_torch.checkpoints.state_io import (restore_train_state,
                                                      save_train_state)
from scaleprotoseg_torch.cli_common import CONFIGS_DIR
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.models.layers import TrainableBatchNorm2d
from scaleprotoseg_torch.models.unet import UNet, UNetASPP
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.runner import PhaseTrainer, module_hparams
from scaleprotoseg_torch.train.state import TrainState
from test_torch_coco import _variant
from torch_parity import port_spec, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "scaleprotoseg_tpu", "configs")
CONFIGS = ("scaleproto_em", "group_scaleproto_em", "baseline_em")
SIDE = 32
# the tiny EM width of the JAX tests (tests/e2e_utils.py TINY_EM_CONFIG)
WIDTH = BASE = 8
# (prototypes, classes, scales, groups, ASPP) of each variant's config
LAYOUT = {"multiscale": (24, 2, 4, 0, "concat"),
          "group": (24, 2, 4, 3, "concat"),
          "single": (20, 2, 1, 0, "sum")}
# the configs' loss weights and learning rates
WEIGHTS = {"multiscale": dict(crs_ent=1.0, kld=0.25, l1=1e-4),
           "group": dict(crs_ent=1.0, kld=0.0, l1=1e-4, group_ent=0.05),
           "single": dict(crs_ent=1.0, kld=0.25, l1=1e-4)}
HP = dict(warm_lr_add_on=2.5e-4, warm_lr_protos=2.5e-4, warm_wd=5e-4,
          joint_lr_features=1e-4, joint_lr_add_on=1e-4,
          joint_lr_protos=1e-4, joint_wd=5e-4, last_layer_lr=1e-5,
          warm_lr_group=2.5e-4, joint_lr_group=5e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bindings(variant: str, n_features: int = WIDTH, base: int = BASE):
    """The factory's bindings of a tiny EM model of ``variant``."""
    p, c, s, g, mode = LAYOUT[variant]
    return {"unet_aspp_features": {"unet_n_features": n_features,
                                   "unet_base": base,
                                   "multiscale": mode == "concat",
                                   "scales": []},
            "PPNetMultiScale": {"num_scales": s, "num_groups": g}}


def _carry(tm, params, stats, spec):
    tm.load_state_dict(to_tensors(ppnet_params_to_statedict(
        to_numpy_tree(params), to_numpy_tree(stats), spec)), strict=True)
    return tm


def _data_stats(model, variables, seed: int, shape, **kw):
    """``batch_stats`` as a trained BN holds them: each BN's statistics of
    a seeded batch of ``shape``, so that eval-mode activations keep the
    scale of train mode's.  Read through flax's own update from zero
    statistics (``0.001 * batch``), divided back in float64."""
    x = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    zero = dict(variables, batch_stats=jax.tree.map(
        np.zeros_like, to_numpy_tree(variables["batch_stats"])))
    _, mutated = model.apply(zero, jnp.asarray(x), train_bn=True,
                             mutable=["batch_stats"], **kw)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float64) / 1e-3).astype(np.float32),
        to_numpy_tree(mutated["batch_stats"]))


@pytest.fixture(scope="module")
def pairs():
    """{variant: (JAX model, spec, variables, port model)}: the tiny EM
    models of the three configs, the port's built by its factory and its
    weights carried from the JAX package's synthetic ones (the BN running
    statistics a seeded batch's, ``_data_stats``)."""
    out = {}
    for variant, (p, c, s, g, mode) in LAYOUT.items():
        spec = JSpec.equal_allocation(p, WIDTH, num_classes=c, num_scales=s,
                                      num_groups=g)
        backbone = JUNetASPP(out_features=WIDTH, multiscale=mode == "concat",
                             base=BASE, dtype=jnp.float32)
        model = JPPNet(backbone=backbone, spec=spec,
                       backbone_channels=spec.feature_depth,
                       add_on_type="deeplab_simple", grouped=bool(g),
                       dtype=jnp.float32,
                       incorrect_strength=0.0 if g else -0.5)
        shapes = jax.eval_shape(
            lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
            jax.random.PRNGKey(0))
        variables = dict(synthetic_init(shapes, seed=1))
        variables["batch_stats"] = _data_stats(
            model, variables, 2, (2, SIDE, SIDE, 3), train=True)
        tm, tspec = construct_ppnet(
            "group" if g else variant, "unet_aspp", (p, WIDTH, 1, 1), c,
            bindings=_bindings(variant))
        assert tspec == port_spec(spec)
        _carry(tm, variables["params"], variables["batch_stats"], tspec)
        tm.incorrect_strength = model.incorrect_strength
        out[variant] = (model, spec, variables, tm.eval())
    return out


def _em_batch(seed=0, b=2):
    """Images and EM labels (1 background, 2 cell, a void row)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, SIDE, SIDE, 3)).astype(np.float32)
    yy, xx = np.mgrid[:SIDE, :SIDE]
    y = np.ones((b, SIDE, SIDE), np.int32)
    for i in range(b):
        cy, cx = rng.integers(8, SIDE - 8, 2)
        y[i][(yy - cy) ** 2 + (xx - cx) ** 2 < 36] = 2
    y[:, 0] = 0
    return x, y


# ---------------------------------------------------------------------------
# tables and configs
# ---------------------------------------------------------------------------
def test_em_tables_match_jax():
    assert constants.EM_VAL_SIZE == jconstants.EM_VAL_SIZE == 10
    assert constants.EM_RGB_2_ID == jconstants.EM_RGB_2_ID
    assert constants.EM_ID_2_LABEL == jconstants.EM_ID_2_LABEL
    assert constants.CLASS_WEIGHTS == jconstants.CLASS_WEIGHTS
    assert len(constants.EM_ID_2_LABEL) == jconstants.num_classes_for("em")
    lut = constants.conversion_lut("em")
    np.testing.assert_array_equal(lut, np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(lut, jconstants.conversion_lut("em"))
    raw = np.array([[0, 1, 2]], np.uint8)
    got = constants.convert_targets(raw, "em")
    want = jconstants.convert_targets(raw, "em",
                                      only_19_from_cityscapes=False)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, raw)
    assert teval.class_names("em", 2) == jeval.class_names("em", 2) == \
        ["background", "cell"]
    assert settings._DATA_ENV["em"] == jsettings._DATA_ENV["em"] == \
        "DATA_PATH_EM"


@pytest.mark.parametrize("name", CONFIGS)
def test_em_config_matches_jax(name):
    ours = configlib.parse_config_file(os.path.join(CONFIGS_DIR,
                                                    name + ".gin"))
    assert ours == configlib.parse_config_file(
        os.path.join(JAX_CONFIGS, name + ".gin"))
    assert ours["PatchClassificationDataset"]["data_type"] == "em"
    assert ours["PatchClassificationDataset"]["window_size"] == (512, 512)
    assert ours["train"]["warmup_steps"] == 0
    jconfiglib.clear_config()
    try:
        jconfiglib.parse_config_file(os.path.join(JAX_CONFIGS, name + ".gin"))
        jhp = jcli.train_hparams()
    finally:
        jconfiglib.clear_config()
    hp = cli_common.train_hparams(ours)
    assert hp == jhp and hp["data_type"] == "em"
    variant = _variant(ours)
    mhp = module_hparams(ours, variant)
    # baseline_em binds no freeze_type: its BN stays frozen, as in JAX
    assert mhp["freeze_type"] == ("all" if name == "baseline_em" else "none")
    if name == "group_scaleproto_em":
        assert hp["push_proto"] is False and hp["finetune_steps"] == 0
    with open(os.path.join(CONFIGS_DIR, name + ".gin")) as f:
        text = f.read()
    assert "GPU training recipe" in text and "TPU" not in text


@pytest.mark.parametrize("name,variant", [
    ("scaleproto_em", "multiscale"), ("group_scaleproto_em", "group"),
    ("baseline_em", "single")])
def test_em_config_builds_the_jax_spec(name, variant):
    bindings = configlib.parse_config_file(os.path.join(CONFIGS_DIR,
                                                        name + ".gin"))
    assert _variant(bindings) == variant
    cname = "construct_PPNet_Group" if variant == "group" else \
        "construct_PPNet"
    q = bindings[cname]
    model, spec = construct_ppnet(
        variant, q["base_architecture"], tuple(q["prototype_shape"]),
        q["num_classes"], bindings=bindings)
    jconfiglib.clear_config()
    try:
        jconfiglib.parse_config_file(os.path.join(JAX_CONFIGS, name + ".gin"))
        jmodel, jspec = jfactory.construct_PPNet_Group() \
            if variant == "group" else jfactory.construct_PPNet(variant)
    finally:
        jconfiglib.clear_config()
    p, c, s, g, mode = LAYOUT[variant]
    assert (spec.num_prototypes, spec.num_classes, spec.num_scales,
            spec.num_groups) == (p, c, s, g)
    assert spec == port_spec(jspec)
    assert model.msc_scales == tuple(jmodel.msc_scales) == ()
    base = model.features.base
    assert isinstance(base, UNetASPP) and base.aspp.mode == mode
    assert jmodel.backbone.base == 64 and base.body.inc.conv_a.conv \
        .weight.shape == (64, 3, 3, 3)
    assert base.aspp.c0.weight.shape == (64, 64, 3, 3)
    assert model.prototype_vectors.shape == (p, 64, 1, 1)


# ---------------------------------------------------------------------------
# trainable BatchNorm against flax's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dtype):
    """8 values a channel (2 x 2 x 2): the unbiased variance is 8/7 of the
    biased one, so an unbiased running update misses by 14%."""
    rng = np.random.default_rng(4)
    c = 16
    x = (0.3 + 1.7 * rng.standard_normal((2, 2, 2, c))).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    # small running statistics, so (new - old) / 0.001 keeps its digits
    mean0 = (0.01 * rng.standard_normal(c)).astype(np.float32)
    var0 = (0.01 * rng.random(c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x).astype(jdt)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.999,
                       epsilon=1e-5, dtype=jdt, param_dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, mutated = bn.apply(variables, xj, mutable=["batch_stats"])
    want_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-5,
                              dtype=jdt, param_dtype=jnp.float32).apply(
        variables, xj)

    tbn = TrainableBatchNorm2d(c, eps=1e-5, momentum=0.001)
    with torch.no_grad():
        for name, value in (("weight", scale), ("bias", bias),
                            ("running_mean", mean0), ("running_var", var0)):
            getattr(tbn, name).copy_(torch.from_numpy(value))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_eval = tbn(xt).permute(0, 2, 3, 1).float().numpy()
        got = tbn(xt, train_bn=True)
    assert got.dtype == tdt
    got = got.permute(0, 2, 3, 1).float().numpy()
    tol = 1e-5 if dtype == "float32" else 8e-3      # one bf16 ulp
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got_eval, np.asarray(want_eval, np.float32),
                               rtol=tol, atol=tol)
    new_mean = np.asarray(mutated["batch_stats"]["mean"])
    new_var = np.asarray(mutated["batch_stats"]["var"])
    assert new_var.dtype == np.float32
    step_var = (tbn.running_var.numpy().astype(np.float64) - var0) / 1e-3
    want_step = (new_var.astype(np.float64) - var0) / 1e-3
    np.testing.assert_allclose(step_var, want_step, rtol=1e-5)
    np.testing.assert_allclose(
        (tbn.running_mean.numpy().astype(np.float64) - mean0) / 1e-3,
        (new_mean.astype(np.float64) - mean0) / 1e-3, rtol=1e-5, atol=1e-6)
    assert int(tbn.num_batches_tracked) == 0
    # torch's own BatchNorm2d moves the variance by the unbiased one: the
    # check above would fail it
    ref = torch.nn.BatchNorm2d(c, eps=1e-5, momentum=0.001)
    with torch.no_grad():
        ref.running_mean.copy_(torch.from_numpy(mean0))
        ref.running_var.copy_(torch.from_numpy(var0))
    ref.train()(xt.float())
    unbiased = (ref.running_var.numpy().astype(np.float64) - var0) / 1e-3
    assert np.all(np.abs(unbiased / want_step - 1) > 0.1)


# ---------------------------------------------------------------------------
# the backbones against the JAX package's
# ---------------------------------------------------------------------------
def _flat_stats(stats, prefix=""):
    """{port buffer name: array} of a ``batch_stats`` tree."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(_flat_stats(v, f"{prefix}{k}."))
        else:
            out[prefix + {"mean": "running_mean", "var": "running_var"}[k]] \
                = v
    return out


@pytest.mark.parametrize("kind", ["concat", "sum", "unet"])
def test_backbone_matches_jax(kind):
    """1 x 3 x 36 x 52: pools 36 -> 18 -> 9 -> 4 -> 2 and 52 -> 26 -> 13
    -> 6 -> 3, so the up path resizes 4 -> 9 and 6 -> 13, not by 2."""
    if kind == "unet":
        jm, tm = JUNet(out_features=WIDTH, base=BASE), UNet(WIDTH, BASE)
    else:
        jm = JUNetASPP(out_features=WIDTH, multiscale=kind == "concat",
                       base=BASE)
        tm = UNetASPP(WIDTH, multiscale=kind == "concat", base=BASE)
    x = np.random.default_rng(5).standard_normal((1, 36, 52, 3)) \
        .astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 36, 52, 3))),
                            jax.random.PRNGKey(0))
    v = dict(synthetic_init(shapes, seed=3))
    v["batch_stats"] = _data_stats(jm, v, 6, (2, 36, 52, 3))
    params = to_numpy_tree(v["params"])
    sd = {}
    _convbn_to_statedict({k: a for k, a in params.items() if k != "aspp"},
                         v["batch_stats"], sd, "")
    for br, e in params.get("aspp", {}).items():
        sd[f"aspp.{br}.weight"] = e["kernel"].transpose(3, 2, 0, 1)
        sd[f"aspp.{br}.bias"] = e["bias"]
    tm.load_state_dict(to_tensors(sd), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    tm64 = copy.deepcopy(tm).double()
    out_ch = WIDTH * (4 if kind == "concat" else 1)
    for train_bn in (False, True):
        with torch.no_grad():
            got = tm(xt, train_bn=train_bn).permute(0, 2, 3, 1).numpy()
            exact = tm64(xt.double(), train_bn=train_bn).permute(
                0, 2, 3, 1).numpy()
        if train_bn:
            want, mutated = jm.apply(v, jnp.asarray(x), train_bn=True,
                                     mutable=["batch_stats"])
        else:
            want = jm.apply(v, jnp.asarray(x))
        assert got.shape == (1, 36, 52, out_ch)
        for value in (got, np.asarray(want)):
            np.testing.assert_allclose(value, exact, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    stats = _flat_stats(to_numpy_tree(mutated["batch_stats"]))
    own = tm.state_dict()
    assert len(stats) == 2 * 18
    for name, value in stats.items():
        np.testing.assert_allclose(own[name].numpy(), value, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        assert not np.array_equal(value, _flat_stats(
            v["batch_stats"])[name]), name


# ---------------------------------------------------------------------------
# the three EM models and their train steps against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", list(LAYOUT))
def test_em_models_carry_jax_weights(pairs, variant):
    model, spec, variables, tm = pairs[variant]
    x, _ = _em_batch(3)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.logits.shape == (2, SIDE, SIDE, 2)
    fields = ["logits", "distances", "activations"] + \
        (["group_activations"] if variant == "group" else [])
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-4, err_msg=f)


def _group_kw(variant, phase):
    """The group joint phase's step flags (incorrect_strength 0)."""
    return dict(grad_mask_last_group=phase == 1,
                project_group_simplex=True) if variant == "group" else {}


def _jax_step(model, spec, variables, variant, phase, x, y):
    groups = joptim.phase_groups(variant, phase, HP)
    trainable, _ = joptim.partition_params(variables["params"], set(groups))
    tx = joptim.make_phase_optimizer(
        groups, joptim.label_params(trainable),
        schedule=joptim.poly_schedule(0.9, 10) if phase == 1 else None,
        iter_size=1, guard_nonfinite=50)
    state = JState.create(variables["params"], variables["batch_stats"],
                          tx.init(trainable))
    fn = jsteps.make_train_step(model, spec, tx, set(groups),
                                jsteps.LossWeights(**WEIGHTS[variant]),
                                train_bn=True, donate=False,
                                **_group_kw(variant, phase))
    return fn(state, jnp.asarray(x), jnp.asarray(y))


def _port_step(tm, variant, phase, x, y, **kw):
    opt = toptim.PhaseOptimizer(
        tm.named_parameters(), toptim.phase_groups(variant, phase, HP),
        schedule=toptim.poly_schedule(0.9, 10) if phase == 1 else None,
        iter_size=1, guard_nonfinite=50)
    step = tsteps.make_train_step(tsteps.LossWeights(**WEIGHTS[variant]),
                                  train_bn=True, **_group_kw(variant, phase),
                                  **kw)
    return step(TrainState(tm, opt), torch.from_numpy(x),
                torch.from_numpy(y)), opt


@pytest.mark.parametrize("variant,phase", [("multiscale", 1),
                                           ("multiscale", 2),
                                           ("group", 1)],
                         ids=["joint", "last_layer", "group_joint"])
def test_em_micro_step_matches_jax(pairs, variant, phase):
    """One micro-step with ``train_bn`` (``iter_size`` 1, so Adam
    updates): the loss within 1e-4; each updated parameter's change within
    5e-3 relative L2 of the JAX package's (Adam's first step is about
    lr x sign(g), so one flipped sign of a 3 x 3 x 64 x 32 conv is 1.5e-2;
    gradients near Adam's eps magnify float32 rounding to 1.2e-3), or
    within 4 float32 ulps where the simplex projection takes the update
    back; every running statistic within rtol = atol = 1e-5,
    moved in the last-layer phase too, whose backbone takes no gradient;
    the BN affine parameters bit-equal before and after in both."""
    model, spec, variables, tm0 = pairs[variant]
    tspec = tm0.spec
    tm, _ = construct_ppnet("group" if variant == "group" else variant,
                            "unet_aspp", (spec.num_prototypes, WIDTH, 1, 1),
                            2, bindings=_bindings(variant))
    tm.load_state_dict(tm0.state_dict(), strict=True)
    tm.incorrect_strength = tm0.incorrect_strength
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    x, y = _em_batch()
    jstate, jm = _jax_step(model, spec, variables, variant, phase, x, y)
    got, opt = _port_step(tm, variant, phase, x, y)
    assert float(got["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-4)
    after = tm.state_dict()
    want = ppnet_params_to_statedict(to_numpy_tree(jstate.params),
                                     to_numpy_tree(jstate.batch_stats), tspec)
    trained = set(opt.names)
    assert trained and not [n for n in trained if ".bn." in n]
    if phase == 2:
        assert trained == {"last_layer.weight"}
    n_stats = 0
    for name, w in want.items():
        old = before[name].numpy()
        new = after[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            np.testing.assert_allclose(new, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            assert not np.array_equal(new, old), name
        elif name in trained:
            d_want = w.astype(np.float64) - old
            d_got = new.astype(np.float64) - old
            rel = np.linalg.norm(d_got - d_want) / max(
                np.linalg.norm(d_want), 1e-30)
            # an update the simplex projection takes back leaves only
            # the rounding of the parameters
            ulps = np.abs(d_got - d_want).max() / np.spacing(
                np.abs(old).max())
            assert rel <= 5e-3 or ulps <= 4, (name, rel, ulps)
        elif not name.endswith("num_batches_tracked"):
            # frozen in this phase: the BN affine parameters among them
            np.testing.assert_array_equal(new, old, err_msg=name)
            np.testing.assert_array_equal(w, old, err_msg=name)
    assert n_stats == 2 * 18


def test_remat_is_ignored_with_train_bn(pairs):
    """``remat`` with ``train_bn``: the step is the plain one, bit for
    bit, and the running statistics move once."""
    _, spec, _, tm0 = pairs["multiscale"]
    x, y = _em_batch(7)
    states = []
    for remat in (False, True):
        tm, _ = construct_ppnet("multiscale", "unet_aspp",
                                (spec.num_prototypes, WIDTH, 1, 1), 2,
                                bindings=_bindings("multiscale"))
        tm.load_state_dict(tm0.state_dict(), strict=True)
        _port_step(tm, "multiscale", 1, x, y, remat=remat)
        states.append(tm.state_dict())
    for name, value in states[0].items():
        torch.testing.assert_close(states[1][name], value, rtol=0, atol=0,
                                   msg=name)


def _trainer(tmp_path, bindings, hp_bindings, variant="multiscale",
             arch="unet_aspp"):
    p = LAYOUT[variant][0]
    model, spec = construct_ppnet(variant, arch, (p, WIDTH, 1, 1), 2,
                                  bindings=bindings)
    lines = []
    trainer = PhaseTrainer(model, spec, variant, str(tmp_path),
                           module_hparams(hp_bindings, variant), bindings,
                           torch.device("cpu"), log=lines.append)
    return trainer, lines


def test_knobs_on_unet_aspp(tmp_path):
    """``fast_aspp`` off for UNet-ASPP, ``fast_gradconv`` without effect,
    ``remat`` ignored with trainable BN: each logged; ``train_bn`` from
    ``freeze_type = 'none'``, frozen BN from any other value."""
    module = "PatchClassificationModuleMultiScale"
    bindings = {**_bindings("multiscale"), "train": {
        "compute_dtype": "bfloat16", "fast_aspp": True,
        "fast_gradconv": True, "remat": True}}
    trainer, lines = _trainer(tmp_path, bindings,
                              {module: {"freeze_type": "none"}})
    log = "\n".join(lines)
    assert trainer.train_bn and not trainer.model.aspp.fast
    assert "train.fast_aspp: disabled for UNet-ASPP" in log
    assert "train.fast_gradconv: no effect on UNetASPP" in log
    assert "train.remat: ignored with trainable BatchNorm" in log
    assert "fast_aspp=False fast_gradconv=False remat=False train_bn=True" \
        in log
    for freeze in ("all", "last_layer"):
        trainer, lines = _trainer(tmp_path, _bindings("multiscale"),
                                  {module: {"freeze_type": freeze}})
        assert not trainer.train_bn


def test_trainable_bn_refused_on_deeplab(tmp_path):
    bindings = {"deeplabv2_resnet50_features_multiscale":
                {"deeplab_n_features": WIDTH}}
    with pytest.raises(NotImplementedError, match="DeepLabV2.*frozen"):
        _trainer(tmp_path, bindings, {"PatchClassificationModuleMultiScale":
                                      {"freeze_type": "none"}},
                 arch="deeplabv2_resnet50_multiscale")


def test_bn_affine_in_no_optimizer_group(pairs):
    """Every UNet-ASPP parameter's label equals the JAX package's
    ``label_of_path`` of the same JAX leaf: the convs and ``outc`` are
    ``features_conv``, the ASPP ``aspp_w`` / ``aspp_b``, the BN affine
    ``features_bn``, which no phase's groups hold."""
    model, spec, variables, tm = pairs["multiscale"]
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    labels = sorted({joptim.label_of_path(tuple(p.key for p in path))
                     for path, _ in flat})
    ids = {lab: i for i, lab in enumerate(labels)}
    tagged = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(a.shape, ids[joptim.label_of_path(
            tuple(p.key for p in path))], np.float32), variables["params"])
    jax_labels = {name: labels[int(np.unique(a)[0])] for name, a in
                  ppnet_params_to_statedict(tagged, None, tm.spec).items()
                  if a.dtype == np.float32}
    ours = {n: toptim.label_of_path(n) for n, _ in tm.named_parameters()}
    assert ours == {n: jax_labels[n] for n in ours}
    assert {ours[n] for n in ours if ".bn." in n} == {"features_bn"}
    for variant in ("multiscale", "group"):
        for phase in (0, 1, 2):
            assert "features_bn" not in toptim.phase_groups(variant, phase,
                                                            HP)
    unet = UNet(WIDTH, BASE)
    assert toptim.label_of_path("features.base.outc.weight") == \
        "features_conv"
    assert "outc.bias" in unet.state_dict()


def test_running_stats_ride_in_the_train_state(pairs, tmp_path):
    """The saved train state holds every running statistic; a relaunch
    (a fresh model) restores them."""
    _, spec, _, tm0 = pairs["multiscale"]
    tm, _ = construct_ppnet("multiscale", "unet_aspp",
                            (spec.num_prototypes, WIDTH, 1, 1), 2,
                            bindings=_bindings("multiscale"))
    tm.load_state_dict(tm0.state_dict(), strict=True)
    x, y = _em_batch(8)
    _, opt = _port_step(tm, "multiscale", 1, x, y)
    state = TrainState(tm, opt, step=1)
    save_train_state(str(tmp_path / "state"), state, block=True)
    fresh, _ = construct_ppnet("multiscale", "unet_aspp",
                               (spec.num_prototypes, WIDTH, 1, 1), 2,
                               bindings=_bindings("multiscale"))
    fopt = toptim.PhaseOptimizer(fresh.named_parameters(),
                                 toptim.phase_groups("multiscale", 1, HP))
    restored = TrainState(fresh, fopt)
    assert restore_train_state(str(tmp_path / "state"), restored) is not None
    names = [n for n in tm.state_dict() if n.endswith("running_var")]
    assert len(names) == 18
    for name, value in tm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[name], value, rtol=0,
                                   atol=0, msg=name)


def test_train_state_from_jax_carries_bn_buffers(pairs):
    """The JAX package's EM train state after a ``train_bn`` step, carried
    by ``train_state_from_jax``: its ``batch_stats`` land in the running
    buffers and its Adam moments over the trainable names."""
    model, spec, variables, tm0 = pairs["multiscale"]
    x, y = _em_batch(9)
    jstate, _ = _jax_step(model, spec, variables, "multiscale", 1, x, y)
    tm, _ = construct_ppnet("multiscale", "unet_aspp",
                            (spec.num_prototypes, WIDTH, 1, 1), 2,
                            bindings=_bindings("multiscale"))
    opt = toptim.PhaseOptimizer(tm.named_parameters(),
                                toptim.phase_groups("multiscale", 1, HP),
                                iter_size=1)
    state = train_state_from_jax(
        to_numpy_tree(jstate.params), to_numpy_tree(jstate.batch_stats),
        jax.tree.map(np.asarray, jstate.opt_state), int(jstate.step),
        tm.spec, opt.names)
    TrainState(tm, opt).load_state_dict(state)
    stats = _flat_stats(to_numpy_tree(jstate.batch_stats["backbone"]),
                        "features.base.")
    assert len(stats) == 36
    own = tm.state_dict()
    for name, value in stats.items():
        np.testing.assert_array_equal(own[name].numpy(), value)


# ---------------------------------------------------------------------------
# the weight carry and the refusals
# ---------------------------------------------------------------------------
def test_convert_carries_a_plain_unet(tmp_path):
    """A plain-``unet`` PPNet: the bare ``outc`` conv node is carried
    (it was dropped without a word before), with every BN's statistics;
    the port's logits equal the JAX package's; an array the walk cannot
    place raises."""
    spec = JSpec.equal_allocation(24, WIDTH, num_classes=2, num_scales=1)
    model = JPPNet(backbone=JUNet(out_features=WIDTH, base=BASE), spec=spec,
                   backbone_channels=WIDTH, add_on_type="deeplab_simple",
                   dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = dict(synthetic_init(shapes, seed=4))
    variables["batch_stats"] = _data_stats(model, variables, 5,
                                           (2, SIDE, SIDE, 3), train=True)
    params = to_numpy_tree(variables["params"])
    sd = ppnet_params_to_statedict(params, variables["batch_stats"],
                                   port_spec(spec))
    np.testing.assert_array_equal(
        sd["features.base.outc.weight"],
        params["backbone"]["outc"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["features.base.outc.bias"],
                                  params["backbone"]["outc"]["bias"])
    bindings = {"unet_features": {"unet_n_features": WIDTH}}
    tm, tspec = construct_ppnet("single", "unet", (24, WIDTH, 1, 1), 2,
                                bindings=bindings)
    # unet_features has no base binding: the JAX UNet's is 64, so build the
    # tiny one directly
    tm.features.base = UNet(WIDTH, BASE)
    tm.load_state_dict(to_tensors(sd), strict=True)
    x, _ = _em_batch(10)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=1e-4)
    bad = {"backbone": {"body": params["backbone"]["body"],
                        "stray": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="stray"):
        ppnet_params_to_statedict(bad, None, port_spec(spec))
    bad = {"backbone": {"outc": {**params["backbone"]["outc"],
                                 "scale": np.ones(8, np.float32)}}}
    with pytest.raises(ValueError, match="scale"):
        ppnet_params_to_statedict(bad, None, port_spec(spec))


def test_quant8_refused_on_an_em_run(pairs, tmp_path):
    """An EM run's checkpoint serves with the running statistics and
    refuses quant8 by name, as the JAX package's ``load_model``."""
    _, spec, _, tm = pairs["multiscale"]
    run = tmp_path / "em_run"
    os.makedirs(run / "checkpoints")
    with open(run / "config.gin", "w") as f:
        f.write("construct_PPNet.base_architecture = 'unet_aspp'\n"
                f"unet_aspp_features.unet_n_features = {WIDTH}\n"
                f"unet_aspp_features.unet_base = {BASE}\n"
                "unet_aspp_features.multiscale = True\n"
                "PPNetMultiScale.num_scales = 4\n")
    stem = str(run / "checkpoints" / "push_final")
    save_checkpoint(stem, {k: v.numpy() for k, v in tm.state_dict().items()},
                    tm.spec, extra={"variant": "multiscale"})
    for q in (True, "static"):
        with pytest.raises(ValueError, match="DeepLabV2.*'unet_aspp'"):
            load_model(str(run), stem + ".pth", device="cpu", quant8=q)
    model, _ = load_model(str(run), stem + ".pth", device="cpu")
    x, _ = _em_batch(11)
    with torch.no_grad():
        torch.testing.assert_close(model(torch.from_numpy(x)).logits,
                                   tm.eval()(torch.from_numpy(x)).logits,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="DeepLabV2.*'unet_aspp'"):
        construct_ppnet("multiscale", "unet_aspp", (24, WIDTH, 1, 1), 2,
                        bindings=_bindings("multiscale"), quant8="static")
