"""The DeepLab-family models and heads a reference checkpoint can hold,
the port's against the JAX package's, on the CPU in float32.

Each case is a gin text that both factories build (``construct_PPNet`` /
``construct_PPNet_Group``), the ResNets at one block a stage (both
factories' block tables patched), VGG16 at its fixed widths on a 96 x 96
input; the JAX package's ``synthetic_init`` weights are carried across by
``ppnet_params_to_statedict`` with ``strict=True``:

- the four backbones ``deeplabv2_vgg16``, ``deeplabv2_vgg16_multiscale``,
  ``deeplabv3_resnet101_multiscale`` and
  ``deeplabv2_resnet101_multiscaleplus`` (the 'concat_plus' ASPP), the
  three conv add-ons ('bottleneck', 'bottleneck_pool', 'regular') and the
  three scale heads ('sum', 'mult', 'concat'): logits, distances and
  activations within rtol = atol = 1e-4, and ``label_of_path`` equal to
  the JAX package's ``label_params`` on every leaf;
- one joint training step (two micro-steps at ``iter_size`` 2) of a
  ``deeplabv2_vgg16_multiscale`` group model with the 'bottleneck' add-on
  (the full joint: backbone, add-on and prototypes train) and of a
  'concat' scale-head model, at ``test_torch_train_step``'s bounds;
- ``export-torch`` where the JAX export drops (VGG16's bare convs) or
  cannot carry (the 'concat_plus' pool Dense) a subtree: the port's
  carries it, the rest bit-equal to the JAX export's, and ``load_model``
  serves it with the JAX logits;
- what the JAX package refuses, the port refuses by name: quant8 on VGG16
  and DeepLabV3, the torchvision-style extractors and SegFormer; K2
  (``fast``) only on DeepLabV2's 'sum' / 'concat' ASPP, K1 left out of a
  scale-head model's ``fast_logits``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from __graft_entry__ import synthetic_init
from scaleprotoseg_tpu import configlib as jconfiglib
from scaleprotoseg_tpu.models import factory as jfactory
from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from scaleprotoseg_torch import configlib, kernels
from scaleprotoseg_torch.checkpoints.convert import (ppnet_params_to_statedict,
                                                     to_tensors)
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models import factory as tfactory
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.state import TrainState
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)
from torch_parity import port_spec, to_numpy_tree

TINY = (1, 1, 1, 1)
FEATURES = {"deeplabv2_vgg16": "deeplabv2_vgg16_features",
            "deeplabv2_vgg16_multiscale":
                "deeplabv2_vgg16_features_multiscale",
            "deeplabv3_resnet101_multiscale":
                "deeplabv3_resnet101_features_multiscale",
            "deeplabv2_resnet101_multiscaleplus":
                "deeplabv2_resnet101_features_multiscaleplus",
            "deeplabv2_resnet101_multiscale":
                "deeplabv2_resnet101_features_multiscale",
            "deeplabv2_resnet101": "deeplabv2_resnet101_features"}
# name -> (architecture, variant, add-on, scale head, scales, side)
CASES = {
    "deeplabv2_vgg16": ("deeplabv2_vgg16", "single", "deeplab_simple", None,
                        1, 96),
    "deeplabv2_vgg16_multiscale": ("deeplabv2_vgg16_multiscale",
                                   "multiscale", "deeplab_simple", None, 4,
                                   96),
    "deeplabv3_resnet101_multiscale": ("deeplabv3_resnet101_multiscale",
                                       "multiscale", "deeplab_simple", None,
                                       4, 65),
    "deeplabv2_resnet101_multiscaleplus": (
        "deeplabv2_resnet101_multiscaleplus", "group", "deeplab_simple",
        None, 4, 65),
    "bottleneck": ("deeplabv2_resnet101_multiscale", "single", "bottleneck",
                   None, 1, 65),
    "bottleneck_pool": ("deeplabv2_resnet101_multiscale", "single",
                        "bottleneck_pool", None, 1, 65),
    "regular": ("deeplabv2_resnet101", "single", "regular", None, 1, 65),
    "scale_head_sum": ("deeplabv2_resnet101_multiscale", "multiscale",
                       "deeplab_simple", "sum", 4, 65),
    "scale_head_mult": ("deeplabv2_resnet101_multiscale", "multiscale",
                        "deeplab_simple", "mult", 4, 65),
    "scale_head_concat": ("deeplabv2_resnet101_multiscale", "group",
                          "deeplab_simple", "concat", 4, 65),
}
# the training steps: a group VGG16 model with the bottleneck add-on and a
# 'concat' scale-head model
STEP_CASES = {
    "vgg16_group_bottleneck": ("deeplabv2_vgg16_multiscale", "group",
                               "bottleneck", None, 1, 64),
    "scale_head_concat": ("deeplabv2_resnet101_multiscale", "multiscale",
                          "deeplab_simple", "concat", 4, 33),
}
HP = dict(warm_lr_add_on=2.5e-4, warm_lr_protos=2.5e-4, warm_wd=5e-4,
          joint_lr_features=2.5e-5, joint_lr_add_on=2.5e-4,
          joint_lr_protos=2.5e-4, joint_wd=5e-4, last_layer_lr=1e-5,
          warm_lr_group=2.5e-4, joint_lr_group=2.5e-4)
WEIGHTS = {"multiscale": dict(crs_ent=1.0, l1=1e-4, kld=0.25),
           "group": dict(crs_ent=1.0, kld=0.0, l1=1e-4, group_ent=0.25)}


def gin(arch, variant, add_on, scale_head, scales) -> str:
    """A run config of the case: 24 prototypes of depth 8 over 3 classes,
    2 groups, ``deeplab_n_features`` making the backbone's channels the
    scales' feature depth (or the conv add-on's input)."""
    c = "construct_PPNet_Group" if variant == "group" else "construct_PPNet"
    concat = arch.endswith(("multiscale", "multiscaleplus"))
    n_features = 8 if add_on != "deeplab_simple" or not concat else \
        8 * scales // 4
    lines = [f"{c}.base_architecture = '{arch}'",
             f"{c}.prototype_shape = (24, 8, 1, 1)",
             f"{c}.num_classes = 3",
             f"{c}.add_on_layers_type = '{add_on}'",
             f"{FEATURES[arch]}.deeplab_n_features = {n_features}",
             f"PPNetMultiScale.num_scales = {scales}",
             "PPNetMultiScale.num_groups = 2",
             "PPNet.bottleneck_stride = 2",
             "PPNetMultiScale.bottleneck_stride = 2"]
    if scale_head:
        lines.append(f"{c}.scale_head_type = '{scale_head}'")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def tiny_tables():
    """The port's factory tables at one ResNet block a stage."""
    with pytest.MonkeyPatch.context() as mp:
        for table in (tfactory._BACKBONES, tfactory._V3):
            for name, entry in list(table.items()):
                mp.setitem(table, name, (entry[0], TINY, *entry[2:]))
        yield


def build_pair(arch, variant, add_on, scale_head, scales, side, seed=1):
    """(JAX model, JAX spec, variables, port model) of a case, built by
    both factories from the same gin text."""
    text = gin(arch, variant, add_on, scale_head, scales)
    jconfiglib.clear_config()
    try:
        jconfiglib.parse_config(text)
        jm, jspec = jfactory.construct_PPNet_Group() if variant == "group" \
            else jfactory.construct_PPNet(variant)
    finally:
        jconfiglib.clear_config()
    if hasattr(jm.backbone, "n_blocks"):
        jm = dataclasses.replace(jm, backbone=dataclasses.replace(
            jm.backbone, n_blocks=TINY))
    bindings = configlib.parse_config(text)
    q = bindings["construct_PPNet_Group" if variant == "group"
                 else "construct_PPNet"]
    tm, tspec = tfactory.construct_ppnet(
        variant, q["base_architecture"], tuple(q["prototype_shape"]),
        q["num_classes"], add_on_layers_type=q["add_on_layers_type"],
        scale_head_type=q.get("scale_head_type"), bindings=bindings,
        log=lambda _: None)
    assert tspec == port_spec(jspec)
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, side, side, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=seed)
    sd = ppnet_params_to_statedict(
        to_numpy_tree(variables["params"]),
        to_numpy_tree(variables.get("batch_stats", {})), tspec,
        log=lambda m: pytest.fail(m))
    tm.load_state_dict(to_tensors(sd), strict=True)
    return jm, jspec, variables, tm.eval()


@pytest.fixture(scope="module")
def pairs(tiny_tables):
    return {name: build_pair(*case) for name, case in CASES.items()}


def _x(side, seed=0, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_jax(pairs, name):
    jm, _, variables, tm = pairs[name]
    x = _x(CASES[name][-1])
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        fast = tm.fast_logits(torch.from_numpy(x))
    for f in ("logits", "distances", "activations"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)
    # K1's plain version on the CPU, or the plain head with a scale head
    np.testing.assert_allclose(fast.numpy(), np.asarray(want.logits),
                               rtol=1e-4, atol=1e-4)
    assert tm.kernel_head == (CASES[name][3] is None)


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_labels_match_jax(pairs, name):
    _, jspec, variables, tm = pairs[name]
    jlabels = traverse_util.flatten_dict(
        joptim.label_params(variables["params"]))
    tree = traverse_util.unflatten_dict(
        {k: np.full(np.shape(v), i, np.float32) for i, (k, v) in enumerate(
            traverse_util.flatten_dict(variables["params"]).items())})
    # each port parameter named by the JAX leaf it was carried from
    sd = ppnet_params_to_statedict(to_numpy_tree(tree), None,
                                   port_spec(jspec), log=lambda _: None)
    leaves = list(jlabels)
    got = {n: toptim.label_of_path(n) for n, _ in tm.named_parameters()}
    want = {}
    for key in got:
        if key.startswith(("group_projection.", "last_layer_group.")):
            want[key] = jlabels[(key.split(".")[0],)]
        else:
            want[key] = jlabels[leaves[int(np.asarray(sd[key]).flat[0])]]
    assert got == want
    if name == "deeplabv2_resnet101_multiscaleplus":
        assert {got[f"features.base.aspp.c{i}_pool.{w}"]
                for i in range(4) for w in ("weight", "bias")} == \
            {"aspp_w", "aspp_b"}
    if name == "deeplabv3_resnet101_multiscale":
        assert got["features.base.head_c1.conv.weight"] == "features_conv"
    if name == "scale_head_concat":
        assert got["scale_head.output_layer.linear_block.0.weight"] == \
            "scale_head"


def test_unported_backbones_refused_by_name():
    for name in ("segformer", "segformer_multiscale", "resnet50",
                 "vgg16_bn", "densenet121"):
        with pytest.raises(NotImplementedError,
                           match=f"'{name}' is not ported yet"):
            tfactory.build_backbone(name, {})


@pytest.mark.parametrize("arch", ["deeplabv2_vgg16",
                                  "deeplabv3_resnet101_multiscale"])
def test_quant8_refused_by_name(tiny_tables, arch):
    bindings = configlib.parse_config(
        f"{FEATURES[arch]}.deeplab_n_features = 8\n")
    with pytest.raises(ValueError, match=f"DeepLabV2 ResNet.*'{arch}'"):
        tfactory.build_backbone(arch, bindings, quant8="static")


def _write_run(run, name, tm, extra):
    from scaleprotoseg_torch.checkpoints.convert import save_checkpoint
    os.makedirs(os.path.join(run, "checkpoints"))
    with open(os.path.join(run, "config.gin"), "w") as f:
        f.write(gin(*CASES[name][:5]))
    stem = os.path.join(run, "checkpoints", "push_final")
    save_checkpoint(stem, {k: v.numpy() for k, v in tm.state_dict().items()},
                    tm.spec, extra=extra)
    return stem


def test_fast_reaches_k2_on_deeplabv2_only(pairs, tmp_path):
    """``load_model(fast=True)`` sets K2's route on DeepLabV2's ASPP (a
    'concat_plus' one never takes it) and leaves VGG16's off; a quant8
    'concat_plus' model builds (its layer4/5 are DeepLabV2's)."""
    for name, fast_set, kernel_path in (
            ("deeplabv2_vgg16_multiscale", False, False),
            ("deeplabv2_resnet101_multiscaleplus", True, False),
            ("scale_head_sum", True, True)):
        tm = pairs[name][3]
        stem = _write_run(str(tmp_path / name), name, tm,
                          {"variant": CASES[name][1]})
        model, _ = load_model(str(tmp_path / name), stem + ".pth",
                              fast=True, device="cpu")
        assert model.aspp.fast == fast_set, name
        assert model.aspp.kernel_path == kernel_path, name
        assert bool(model.aspp.packed_buffers()) == kernel_path, name
    q8, _ = load_model(str(tmp_path / "deeplabv2_resnet101_multiscaleplus"),
                       str(tmp_path / "deeplabv2_resnet101_multiscaleplus" /
                           "checkpoints" / "push_final.pth"),
                       device="cpu", quant8="static")
    assert q8.features.base.aspp.mode == "concat_plus"


@pytest.mark.parametrize("name", ["deeplabv2_vgg16_multiscale",
                                  "deeplabv2_resnet101_multiscaleplus"])
def test_export_torch_carries_what_jax_drops(pairs, name, tmp_path):
    from scaleprotoseg_tpu.checkpoints.io import save_checkpoint as jsave
    from scaleprotoseg_tpu.convert_checkpoint import export_torch as jexport
    from scaleprotoseg_torch.convert_checkpoint import export_torch
    jm, jspec, variables, tm = pairs[name]
    run = tmp_path / "run"
    src = str(run / "checkpoints" / "push_final.ckpt")
    os.makedirs(os.path.dirname(src))
    jsave(src, variables["params"], variables.get("batch_stats", {}),
          spec=jspec, extra={"variant": CASES[name][1]})
    with open(run / "config.gin", "w") as f:
        f.write(gin(*CASES[name][:5]))
    stem = export_torch(src, str(tmp_path / "port" / "push_final.pth"),
                        log=lambda _: None)
    ours = torch.load(stem + ".pth", weights_only=True)
    assert set(ours) == set(tm.state_dict())
    extra = {k for k in ours if "_pool." in k or "_conv" in k}
    if name == "deeplabv2_resnet101_multiscaleplus":
        # the pool Dense kernel is 2-D; JAX's 4-D transpose fails on it
        with pytest.raises(ValueError):
            jexport(src, str(tmp_path / "jax.pth"))
        assert len(extra) == 8
    else:
        jexport(src, str(tmp_path / "jax.pth"))
        theirs = torch.load(str(tmp_path / "jax.pth"), weights_only=True)
        assert len(extra) == 2 * 13 and set(theirs) == set(ours) - extra
        for k, v in theirs.items():
            assert v.dtype == ours[k].dtype and torch.equal(v, ours[k]), k
    # the run served from the JAX .ckpt alone, and from the port's export
    x = _x(CASES[name][-1], seed=4, n=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)).logits)
    for ckpt in (src, stem + ".pth"):
        model, _ = load_model(str(run), ckpt, device="cpu")
        with torch.no_grad():
            got = model(torch.from_numpy(x)).logits.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# one joint step against the JAX package's make_train_step
# ---------------------------------------------------------------------------
def _batch(side, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, side, side, 3)).astype(np.float32)
    y = np.repeat(np.repeat(np.arange(4).reshape(2, 2), side // 2 + 1, 0),
                  side // 2 + 1, 1)[:side, :side]
    y = np.stack([np.roll(y, s, axis=(0, 1)) for s in (0, 5)])
    return x, y.astype(np.int32)


def _names(tree, spec):
    return ppnet_params_to_statedict(to_numpy_tree(tree), None, spec,
                                     log=lambda _: None)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_joint_step_matches_jax(tiny_tables, name):
    """Two micro-steps at ``iter_size`` 2 of the joint phase: losses within
    rel = abs = 1e-4, the accumulated gradient within 1e-4 of each
    tensor's largest entry, the updated parameters within 1e-4 wherever
    both agree on the direction of Adam's first step (all but 0.1% of
    each tensor, or of VGG's 64-512-entry biases all but 2, whose
    near-zero gradients can take either sign), frozen ones unchanged
    (``test_torch_train_step``'s bounds)."""
    arch, variant, add_on, *_, side = STEP_CASES[name]
    jm, jspec, variables, tm = build_pair(*STEP_CASES[name], seed=2)
    tspec = port_spec(jspec)
    grouped = variant == "group"
    scale_head = jm.scale_head_type is not None
    kw = dict(joint_last=False) if grouped else {}
    jgroups = joptim.phase_groups(variant, 1, HP, has_scale_head=scale_head,
                                  **kw)
    groups = toptim.phase_groups(variant, 1, HP, has_scale_head=scale_head,
                                 **kw)
    assert set(groups) == set(jgroups)
    assert ("scale_head" in groups) == scale_head
    x, y = _batch(side)
    trainable, _ = joptim.partition_params(variables["params"], set(jgroups))
    tx = joptim.make_phase_optimizer(
        jgroups, joptim.label_params(trainable),
        schedule=joptim.poly_schedule(0.9, 10), iter_size=2,
        guard_nonfinite=50)
    state = JState.create(variables["params"],
                          variables.get("batch_stats", {}),
                          tx.init(trainable))
    extra = dict(project_group_simplex=True) if grouped else {}
    fn = jsteps.make_train_step(jm, jspec, tx, set(jgroups),
                                jsteps.LossWeights(**WEIGHTS[variant]),
                                donate=False, **extra)
    jout = []
    for _ in range(2):
        state, m = fn(state, jnp.asarray(x), jnp.asarray(y))
        jout.append((state, {k: float(v) for k, v in m.items()}))

    tm.train()
    opt = toptim.PhaseOptimizer(tm.named_parameters(), groups,
                                schedule=toptim.poly_schedule(0.9, 10),
                                iter_size=2, guard_nonfinite=50)
    tstate = TrainState(tm, opt)
    step = tsteps.make_train_step(tsteps.LossWeights(**WEIGHTS[variant]),
                                  **extra)
    got = []
    for _ in range(2):
        got.append({k: float(v) for k, v in step(
            tstate, torch.from_numpy(x), torch.from_numpy(y)).items()})
        if len(got) == 1:
            names = {id(p): n for n, p in tm.named_parameters()}
            acc, off = {}, 0
            for p in opt.params:
                acc[names[id(p)]] = opt._acc[off:off + p.numel()] \
                    .view_as(p).clone().numpy()
                off += p.numel()
    tm.eval()
    for (_, want), have in zip(jout, got):
        assert np.isfinite(have["loss"])
        for k, v in want.items():
            assert have[k] == pytest.approx(v, rel=1e-4, abs=1e-4), k

    grads = _names(jout[0][0].opt_state.inner_state.acc_grads, tspec)
    assert set(grads) == set(acc)
    for n, g in grads.items():
        np.testing.assert_allclose(acc[n], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=n)
    init = _names(variables["params"], tspec)
    new = _names(jout[1][0].params, tspec)
    have = tm.state_dict()
    moved = set()
    for n, want in new.items():
        got_p = have[n].numpy()
        label = toptim.label_of_path(n)
        if label not in groups:
            np.testing.assert_array_equal(got_p, init[n], err_msg=n)
            continue
        wd = groups[label].weight_decay
        u = grads[n] + wd * init[n]
        decided = np.abs(acc[n] + wd * init[n] - u) <= 0.1 * np.abs(u)
        assert (~decided).sum() <= max(2, 1e-3 * decided.size), n
        np.testing.assert_allclose(got_p[decided], want[decided], rtol=0,
                                   atol=1e-4, err_msg=n)
        if not np.array_equal(got_p, init[n]):
            moved.add(label)
    assert moved >= {"prototypes", "features_conv", "aspp_w"} | \
        ({"scale_head"} if scale_head else set()) | \
        ({"add_on"} if add_on != "deeplab_simple" else set())
