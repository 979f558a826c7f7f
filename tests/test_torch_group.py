"""The group phase of the port against the JAX package, on the CPU.

Inputs are seeded numpy arrays; weights are the JAX package's synthetic
ones carried over by ``ppnet_params_to_statedict``.  Tolerances:

- both simplex projections: atol 1e-6 (float32);
- the fresh group projection against the JAX package's init on the same
  uniform draw: atol 1e-6;
- the five group losses and the group L1: rtol 1e-5;
- a group micro-step (tiny-depth flagship, group head, ``iter_size`` 2
  over one batch twice) with the last-layer-group mask
  (``incorrect_strength`` 0) and the simplex projection, as
  ``test_torch_train_step.py`` holds a prototype-phase one: gradients
  within 1e-4 of each tensor's largest entry, updated parameters within
  1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship, synthetic_init
from scaleprotoseg_tpu import finetune_wandb_group as jgroup
from scaleprotoseg_tpu.checkpoints.io import save_checkpoint as jsave
from scaleprotoseg_tpu.losses import losses as JL
from scaleprotoseg_tpu.models.group_init import \
    equivariance_group_weights as jequiv
from scaleprotoseg_tpu.ops import simplex as jsimplex
from scaleprotoseg_tpu.spec import ProtoSpec
from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from scaleprotoseg_torch import cli_common
from scaleprotoseg_torch import finetune_wandb_group as tgroup
from scaleprotoseg_torch import train_wandb_multiscale as ttrain
from scaleprotoseg_torch.checkpoints.convert import (bootstrap_group_state,
                                                     ppnet_params_to_statedict,
                                                     save_checkpoint)
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.losses import losses as TL
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models.group_init import equivariance_class_weights
from scaleprotoseg_torch.models.ppnet import group_projection_init
from scaleprotoseg_torch.ops import simplex as tsimplex
from scaleprotoseg_torch.serving import serve
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.state import TrainState
from e2e_utils import build_synthetic_dataset
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import port_model, port_spec, to_numpy_tree
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SIDE = 33
# group_scaleproto_cityscapes.gin
HP = dict(warm_lr_add_on=2.5e-4, warm_lr_protos=2.5e-4, warm_wd=0.0,
          joint_lr_features=2.5e-5, joint_lr_add_on=2.5e-4,
          joint_lr_protos=2.5e-4, joint_wd=5e-4, last_layer_lr=2.5e-4,
          warm_lr_group=2.5e-4, joint_lr_group=2.5e-4)
# the config's weights (crs_ent, l1, group_ent), every other group loss on
WEIGHTS = dict(crs_ent=1.0, l1=1e-3, group_ent=0.05, kld=0.1,
               spatial_entropy=0.1, crs_ent_group=0.1, scale_max=0.1)


def _pruned_spec(g=3):
    """The flagship bank at depth 16 with prototypes pruned from three
    scales and class 4 emptied: classes own 8-12 prototypes."""
    spec = ProtoSpec.equal_allocation(228, 16, num_classes=19, num_groups=g)
    return spec.prune([3, 60, 61, 130] + [p for p, c in
                                          enumerate(spec.class_ids) if c == 4])


SPECS = {"regular": lambda: ProtoSpec.equal_allocation(
    228, 16, num_classes=19, num_groups=3), "pruned": _pruned_spec}


# ---------------------------------------------------------------------------
# simplex projections
# ---------------------------------------------------------------------------
def _rows(rng):
    v = rng.standard_normal((6, 7)).astype(np.float32)
    v[1] = 0.25                          # all tied
    v[2, :4] = v[2, 0]                   # tied at the top
    v[3] = np.abs(v[3]) / np.abs(v[3]).sum()   # on the simplex already
    v[4] *= 100.0                        # one entry survives
    return v


def test_projection_simplex_sort_matches_jax(rng):
    for v in (_rows(rng), rng.random((4, 1)).astype(np.float32)):
        want = np.asarray(jsimplex.projection_simplex_sort(jnp.asarray(v)))
        got = tsimplex.projection_simplex_sort(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
        assert (got >= 0).all()


def test_projection_simplex_sort_masked_matches_jax(rng):
    v = np.stack([_rows(rng), _rows(rng) * 3.0])             # (2, 6, 7)
    mask = np.ones_like(v)
    mask[0, :, 5:] = 0                   # padded slots
    mask[1, 0, 1:] = 0                   # one valid slot
    mask[1, 1] = 0                       # a fully masked row
    mask[1, 2, ::2] = 0                  # holes
    want = np.asarray(jsimplex.projection_simplex_sort_masked(
        jnp.asarray(v), jnp.asarray(mask)))
    got = tsimplex.projection_simplex_sort_masked(
        torch.from_numpy(v), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[mask == 0] == 0).all()


@pytest.mark.parametrize("case", sorted(SPECS))
def test_packed_projection_matches_masked_dense(rng, case):
    """The port's plain projection of each packed per-class weight equals
    the JAX package's masked projection of the dense (C, G, Pc_max)
    layout, padded slots 0."""
    spec = SPECS[case]()
    tspec = port_spec(spec)
    dense = rng.standard_normal((spec.num_classes, spec.num_groups,
                                 spec.max_protos_per_class)) \
        .astype(np.float32) * spec.class_proto_mask[:, None, :]
    want = np.asarray(jsimplex.projection_simplex_sort_masked(
        jnp.asarray(dense), jnp.asarray(
            np.broadcast_to(spec.class_proto_mask[:, None, :], dense.shape))))
    for c in tspec.nonempty_classes:
        pc = tspec.class_counts[c]
        got = tsimplex.projection_simplex_sort(
            torch.from_numpy(dense[c, :, :pc])).numpy()
        np.testing.assert_allclose(got, want[c, :, :pc], rtol=0, atol=1e-6)
        assert (want[c, :, pc:] == 0).all()


# ---------------------------------------------------------------------------
# the fresh group projection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(SPECS))
def test_group_init_matches_jax_on_the_same_draw(monkeypatch, case):
    """``group_projection_init`` of a U(-1, 1) draw against the JAX
    package's ``group_init`` (``models/ppnet.py``) fed the same draw."""
    model, _ = _flagship(tiny=True, grouped=True, dtype=jnp.float32)
    spec = SPECS[case]() if case == "pruned" else model.spec
    spec = ProtoSpec(**{**dataclasses.asdict(spec), "proto_depth": 64})
    model = dataclasses.replace(model, spec=spec)
    shape = (spec.num_classes, spec.num_groups, spec.max_protos_per_class)
    draw = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    uniform = jax.random.uniform

    def fixed(key, shape_=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if tuple(shape_) == shape:
            return jnp.asarray(draw)
        return uniform(key, shape_, dtype, minval, maxval)

    monkeypatch.setattr(jax.random, "uniform", fixed)
    want = np.asarray(model.init(jax.random.PRNGKey(0), method=lambda m:
                                 m.group_projection)["params"]
                      ["group_projection"])
    for c in range(spec.num_classes):
        pc = spec.class_counts[c]
        if pc == 0:
            continue
        got = group_projection_init(torch.from_numpy(draw[c, :, :pc]))
        np.testing.assert_allclose(got.numpy(), want[c, :, :pc], rtol=0,
                                   atol=1e-6)


def test_fresh_group_rows_are_the_init_of_the_models_draw():
    """A fresh grouped PPNet's rows are ``group_projection_init`` of its
    own generator's draw: on the simplex and sparse (entries under the
    projection's threshold are exactly 0), as the JAX package's are."""
    from scaleprotoseg_torch.models.deeplab import DeepLabV2
    from scaleprotoseg_torch.models.ppnet import PPNet
    spec = port_spec(_pruned_spec())
    backbone = DeepLabV2(n_out=16, n_blocks=(1, 1, 1, 1),
                         atrous_rates=(6, 12, 18, 24), aspp_mode="concat")
    tm = PPNet(backbone, spec, grouped=True,
               generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    torch.rand(spec.num_prototypes, spec.proto_depth, 1, 1, generator=gen)
    zeros = 0
    for k, c in enumerate(spec.nonempty_classes):
        w = tm.group_projection[k].weight.detach()
        draw = torch.rand(w.shape, generator=gen) * 2.0 - 1.0
        torch.testing.assert_close(w, group_projection_init(draw), rtol=0,
                                   atol=0)
        assert w.shape == (3, spec.class_counts[c])
        torch.testing.assert_close(w.sum(-1), torch.ones(3), rtol=0,
                                   atol=1e-6)
        zeros += int((w == 0).sum())
    assert zeros > 0


# ---------------------------------------------------------------------------
# the group losses
# ---------------------------------------------------------------------------
def _loss_inputs(rng, spec):
    b, h, w = 2, 5, 6
    act = rng.random((b, h, w, spec.num_active_prototypes)) \
        .astype(np.float32) * 5.0
    y = rng.integers(0, spec.num_classes + 1, (b, h, w)).astype(np.int32)
    y[0, :2] = 3                         # a class with many pixels
    mask = np.broadcast_to(spec.class_proto_mask[:, None, :],
                           (spec.num_classes, spec.num_groups,
                            spec.max_protos_per_class))
    gw = np.array(jsimplex.projection_simplex_sort_masked(
        jnp.asarray(rng.standard_normal(mask.shape).astype(np.float32)),
        jnp.asarray(mask)))
    group = rng.random((b, h, w, spec.num_classes, spec.num_groups)) \
        .astype(np.float32) * 3.0
    group *= spec.class_has_protos[:, None]
    glw = rng.standard_normal((spec.num_classes * spec.num_groups,
                               spec.num_classes)).astype(np.float32)
    return act, y, gw, group, glw


@pytest.mark.parametrize("case", sorted(SPECS))
def test_group_losses_match_jax(rng, case):
    spec = SPECS[case]()
    tspec = port_spec(spec)
    act, y, gw, group, glw = _loss_inputs(rng, spec)
    j, t = jnp.asarray, torch.from_numpy
    pairs = {
        "entropy_spat": (JL.entropy_spat_loss(j(act), j(y), spec),
                         TL.entropy_spat_loss(t(act), t(y), tspec)),
        "entropy_group": (JL.entropy_group_loss(j(gw), spec),
                          TL.entropy_group_loss(t(gw), tspec)),
        "cross_entropy_group": (JL.cross_entropy_group_loss(j(gw), spec),
                                TL.cross_entropy_group_loss(t(gw), tspec)),
        "scale_max": (JL.scale_max_loss(j(gw), spec),
                      TL.scale_max_loss(t(gw), tspec)),
        "kld_group": (JL.kld_group_loss(j(group), j(y), spec),
                      TL.kld_group_loss(t(group), t(y), tspec)),
        "group_l1": (JL.last_layer_l1(j(glw), spec.group_class_identity),
                     TL.last_layer_l1(t(glw), torch.from_numpy(
                         tspec.group_class_identity))),
    }
    for name, (want, got) in pairs.items():
        assert float(want) != 0.0, name
        assert float(got) == pytest.approx(float(want), rel=1e-5), name


# ---------------------------------------------------------------------------
# the optimizer groups
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("phase,joint_last,joint_no_proto",
                         [(0, True, False), (1, True, False),
                          (1, False, False), (1, False, True),
                          (2, True, False)])
def test_group_phase_groups_match_jax(phase, joint_last, joint_no_proto):
    want = joptim.phase_groups("group", phase, HP, joint_last=joint_last,
                               joint_no_proto=joint_no_proto)
    got = toptim.phase_groups("group", phase, HP, joint_last=joint_last,
                              joint_no_proto=joint_no_proto)
    assert set(got) == set(want)
    for label, grp in want.items():
        assert (got[label].lr, got[label].weight_decay,
                got[label].use_schedule) == \
            (grp.lr, grp.weight_decay, grp.use_schedule), label


# ---------------------------------------------------------------------------
# one group micro-step against make_train_step
# ---------------------------------------------------------------------------
def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
    y = np.repeat(np.repeat(np.arange(20).reshape(4, 5), 9, 0), 7, 1)
    y = np.stack([np.roll(y[:SIDE, :SIDE], s, axis=(0, 1)) for s in (0, 3)])
    return x, y.astype(np.int32)


def _names(tree, spec):
    return ppnet_params_to_statedict(to_numpy_tree(tree), None, spec,
                                     log=lambda _: None)


def _offsets(tm, opt):
    names = {id(p): n for n, p in tm.named_parameters()}
    off = 0
    for p in opt.params:
        yield names[id(p)], p, off
        off += p.numel()


@pytest.mark.parametrize("phase", [0, 1], ids=["warmup", "joint"])
def test_group_step_matches_jax(phase):
    model, spec = _flagship(tiny=True, grouped=True, dtype=jnp.float32)
    model = dataclasses.replace(model, incorrect_strength=0.0)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=0)
    tm = port_model(model, spec, variables)
    tm.incorrect_strength = 0.0
    tspec = port_spec(spec)
    x, y = _batch()

    groups = joptim.phase_groups("group", phase, HP)
    trainable, _ = joptim.partition_params(variables["params"], set(groups))
    tx = joptim.make_phase_optimizer(
        groups, joptim.label_params(trainable),
        schedule=joptim.poly_schedule(0.9, 10) if phase == 1 else None,
        iter_size=2, guard_nonfinite=50)
    state = JState.create(variables["params"], variables["batch_stats"],
                          tx.init(trainable))
    fn = jsteps.make_train_step(
        model, spec, tx, set(groups), jsteps.LossWeights(**WEIGHTS),
        grad_mask_last_group=phase == 1, project_group_simplex=True,
        donate=False)
    jout = []
    for _ in range(2):
        state, m = fn(state, jnp.asarray(x), jnp.asarray(y))
        jout.append((state, {k: float(v) for k, v in m.items()}))

    opt = toptim.PhaseOptimizer(
        tm.named_parameters(), toptim.phase_groups("group", phase, HP),
        schedule=toptim.poly_schedule(0.9, 10) if phase == 1 else None,
        iter_size=2, guard_nonfinite=50)
    tstate = TrainState(tm, opt)
    step = tsteps.make_train_step(tsteps.LossWeights(**WEIGHTS),
                                  grad_mask_last_group=phase == 1,
                                  project_group_simplex=True)
    got = []
    for _ in range(2):
        got.append({k: float(v) for k, v in step(
            tstate, torch.from_numpy(x), torch.from_numpy(y)).items()})
        if len(got) == 1:
            acc = {name: opt._acc[off:off + p.numel()].view_as(p)
                   .clone().numpy() for name, p, off in _offsets(tm, opt)}
    for (_, want), have in zip(jout, got):
        for k, v in want.items():
            assert have[k] == pytest.approx(v, rel=1e-4, abs=1e-4), k

    grads = _names(jout[0][0].opt_state.inner_state.acc_grads, tspec)
    assert set(grads) == set(acc)
    for name, g in grads.items():
        np.testing.assert_allclose(acc[name], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)
    if phase == 1:      # the mask: off-class entries get no gradient
        own = tm._glw_own.numpy() > 0
        assert (acc["last_layer_group.weight"][~own] == 0).all()
        assert np.abs(acc["last_layer_group.weight"][own]).max() > 0

    init = _names(variables["params"], tspec)
    new = _names(jout[1][0].params, tspec)
    have = tm.state_dict()
    for name, want in new.items():
        got_p = have[name].numpy()
        if toptim.label_of_path(name) not in groups:
            np.testing.assert_array_equal(got_p, init[name], err_msg=name)
            continue
        np.testing.assert_allclose(got_p, want, rtol=0, atol=1e-4,
                                   err_msg=name)
        if name.startswith("group_projection."):
            assert (got_p >= 0).all()
            np.testing.assert_allclose(got_p.sum(-1), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# the bootstrap and the CLI
# ---------------------------------------------------------------------------
def test_bootstrap_matches_jax(tmp_path):
    """A grouped model started from a prototype-phase checkpoint: the JAX
    package's ``_bootstrap_from_proto_checkpoint`` against
    ``bootstrap_group_state`` on the same weights."""
    pmodel, spec = _flagship(tiny=True, grouped=False, dtype=jnp.float32)
    gmodel, gspec = _flagship(tiny=True, grouped=True, dtype=jnp.float32)
    x = jnp.zeros((1, SIDE, SIDE, 3))
    init = lambda m, seed: synthetic_init(jax.eval_shape(  # noqa: E731
        lambda k: m.init(k, x), jax.random.PRNGKey(0)), seed=seed)
    proto, group = init(pmodel, 1), init(gmodel, 2)
    ckpt = str(tmp_path / "push_final.ckpt")
    jsave(ckpt, proto["params"], proto["batch_stats"], spec=spec)
    want, _ = jgroup._bootstrap_from_proto_checkpoint(
        gmodel, dict(group), ckpt, log=lambda _: None)
    tproto = port_model(pmodel, spec, proto).state_dict()
    tgroup_sd = port_model(gmodel, gspec, group).state_dict()
    got = bootstrap_group_state(tgroup_sd, tproto)
    want_sd = ppnet_params_to_statedict(to_numpy_tree(want["params"]),
                                        to_numpy_tree(want["batch_stats"]),
                                        port_spec(gspec))
    assert set(got) == set(want_sd) == set(tgroup_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert torch.equal(got["group_projection.0.weight"],
                       tgroup_sd["group_projection.0.weight"])
    with pytest.raises(ValueError, match="last_layer_group"):
        bootstrap_group_state(tgroup_sd, {**tproto, "last_layer_group.weight":
                                          tgroup_sd["last_layer_group.weight"]})


GROUP_TINY = [
    "train.warmup_steps = 2", "train.joint_steps = 2",
    "construct_PPNet_Group.base_architecture = "
    "'deeplabv2_resnet50_multiscale'",
    "deeplabv2_resnet50_features_multiscale.deeplab_n_features = 16",
    "PatchClassificationDataset.window_size = (33, 33)",
    "PatchClassificationModuleMultiScale.iter_size = 1",
    "PatchClassificationDataModule.dataloader_n_jobs = 2"]


def test_cli_group_phase_from_a_pruned_checkpoint(tmp_path):
    """``finetune_wandb_group`` on the CPU from a pruned prototype-phase
    ``push_final`` (narrow ResNet-50, 33 x 33 crops, 2 + 2 micro-steps):
    the group model takes the checkpoint's spec, every loss is finite,
    every group row stays on the simplex, and ``final-group`` loads
    through ``load_model`` and serves through ``serve.main``."""
    root = build_synthetic_dataset(str(tmp_path / "data"), n_train=4,
                                   n_val=2, size=48)
    proto_cfg = [line.replace("construct_PPNet_Group", "construct_PPNet")
                 for line in GROUP_TINY] + [
        "construct_PPNet.prototype_shape = (76, 16, 1, 1)"]
    _, bindings = cli_common.load_config("scaleproto_cityscapes")
    cli_common.apply_overrides(bindings, proto_cfg)
    spec = ttrain.build_model(bindings, 0)[1]
    pruned = spec.prune([0, 5, 40, 41, 75])
    model, _ = ttrain.build_model(bindings, 0, pruned)
    start = tmp_path / "proto" / "checkpoints" / "push_final"
    save_checkpoint(str(start), {k: v.numpy() for k, v in
                                 model.state_dict().items()}, pruned,
                    extra={"variant": "multiscale"})

    results = tmp_path / "results"
    argv = ["group_scaleproto_cityscapes", "group_run", "--device", "cpu",
            "--start-checkpoint", str(start), "--data-root", root,
            "--results-root", str(results)]
    for line in GROUP_TINY:
        argv += ["--gin", line]
    out = tgroup.main(argv)
    assert sorted(out["phases"]) == [0, 1]
    for res in out["phases"].values():
        assert res.steps_done == 2 and np.isfinite(res.losses).all()
    run = results / "group_run"
    for stage in ("warmup-group_last", "nopush-group_last", "final-group"):
        assert (run / "checkpoints" / f"{stage}.pth").exists(), stage
    served, spec2 = load_model(str(run), str(run / "checkpoints" /
                                              "final-group.pth"),
                               device="cpu")
    assert spec2.class_ids == pruned.class_ids and spec2.num_groups == 3
    for m in served.group_projection:
        w = m.weight.detach()
        assert (w >= 0).all()
        torch.testing.assert_close(w.sum(-1), torch.ones(3), rtol=0,
                                   atol=1e-5)
    # the backbone and the bank came from the checkpoint and stayed frozen
    start_sd = model.state_dict()
    for k, v in served.state_dict().items():
        if k.startswith("features.") or k == "prototype_vectors":
            torch.testing.assert_close(v, start_sd[k], rtol=0, atol=0)

    images = tmp_path / "images"
    images.mkdir()
    raw = np.random.default_rng(4).integers(0, 256, (3, 40, 40, 3),
                                            dtype=np.uint8)
    for i, img in enumerate(raw):
        np.save(images / f"frame_{i}.npy", img)
    record = serve.main(["group_run", "final-group", "--input", str(images),
                         "--output", str(tmp_path / "labels"), "--batch",
                         "2", "--raw-output", "--results-root", str(results),
                         "--device", "cpu"])
    assert record["images"] == 3
    labels = np.load(tmp_path / "labels" / "frame_0.npy")
    assert labels.shape == (40, 40) and labels.max() < 19


def test_equivariance_init_matches_jax(rng, tmp_path):
    spec = _pruned_spec()
    tspec = port_spec(spec)
    dense = np.asarray(jsimplex.projection_simplex_sort_masked(
        jnp.asarray(rng.standard_normal((19, 3, spec.max_protos_per_class))
                    .astype(np.float32)),
        jnp.asarray(np.broadcast_to(spec.class_proto_mask[:, None, :],
                                    (19, 3, spec.max_protos_per_class)))))
    equiv = {0: [[[0], [1, 2], [], [0]], [[], [], [2], []]],
             7: [[[1], [], [], []]]}
    want = jequiv(dense, spec, equiv, 0.25)
    for c, groups in equiv.items():
        pc = tspec.class_counts[c]
        got = equivariance_class_weights(dense[c, :, :pc],
                                         tspec.class_scale_counts[c],
                                         groups, 0.25)
        np.testing.assert_allclose(got, want[c, :, :pc], rtol=1e-6,
                                   atol=1e-7)


def test_group_cli_needs_a_start_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="start_checkpoint"):
        tgroup.main(["group_scaleproto_cityscapes", "r", "--device", "cpu",
                     "--results-root", str(tmp_path)])


def test_joint_last_is_refused_outside_the_group_variant():
    from scaleprotoseg_torch.train.runner import module_hparams
    bindings = parse_config(
        "PatchClassificationModuleMultiScale.joint_last = True")
    with pytest.raises(ValueError, match="group-phase flag"):
        module_hparams(bindings, "multiscale")
    assert module_hparams(bindings, "group")["joint_last"] is True
