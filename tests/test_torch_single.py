"""The ``single`` variant (the ProtoSeg baseline: one scale over the
summed ASPP) of the port against the JAX package's.

- One micro-step, then a second (``iter_size`` 2), of the tiny-depth
  baseline (full widths: ResNet layers 1-4 of 1/1/2/1 blocks, summed ASPP
  of 64 channels, 190 prototypes of depth 64 on one scale, 19 classes)
  against the JAX package's ``make_train_step``, phases 0/1/2, at
  ``test_torch_train_step.py::test_train_step_matches_jax``'s tolerance
  (accumulated gradients within 1e-4 of each tensor's largest entry, the
  updated parameters within 1e-4 wherever both agree on the direction of
  Adam's first step, on at least 99.9% of every tensor, losses and metrics
  within 1e-4).
- K1's packed head (``kernels.proto.pack_head``) of a one-scale bank,
  walked as the kernel walks it, against the JAX package's Pallas kernel
  in interpret mode (rtol = atol = 1e-4, the card's tolerance).
- ``train_wandb`` without ``--pruned`` on the CPU at tiny size: warm-up,
  joint, push and last layer, then ``push_final`` read by ``load_model``
  and served by ``serve.main --device cpu``;
  ``python -m scaleprotoseg_torch.train`` takes the same command line.
- The port's ``baseline_cityscapes.gin`` holds the JAX package's
  bindings, binding for binding.
"""

import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scaleprotoseg_tpu.models.deeplab import DeepLabV2 as JDeepLabV2
from scaleprotoseg_tpu.models.ppnet import PPNet as JPPNet
from scaleprotoseg_tpu.ops.pallas_proto import fused_proto_logits
from scaleprotoseg_tpu.spec import ProtoSpec as JSpec
from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from __graft_entry__ import synthetic_init
from scaleprotoseg_torch import configlib, train_wandb
from scaleprotoseg_torch.cli_common import CONFIGS_DIR
from scaleprotoseg_torch.kernels.proto import pack_head
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.serving import serve
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.runner import module_hparams
from scaleprotoseg_torch.train.state import TrainState
from e2e_utils import build_synthetic_dataset
from test_torch_train_step import HP, SIDE, WEIGHTS, _batch, _names, _offsets
from torch_parity import emulate_proto_kernel, port_model, port_spec
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

JAX_CONFIG = os.path.join(os.path.dirname(__file__), os.pardir,
                          "scaleprotoseg_tpu", "configs",
                          "baseline_cityscapes.gin")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the models here are tiny, and the test run
    shares the host's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def baseline():
    spec = JSpec.equal_allocation(190, 64, num_classes=19, num_scales=1)
    model = JPPNet(backbone=JDeepLabV2(n_out=64, n_blocks=(1, 1, 2, 1),
                                       aspp_mode="sum", dtype=jnp.float32),
                   spec=spec, backbone_channels=spec.feature_depth,
                   add_on_type="deeplab_simple", grouped=False,
                   dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    return model, spec, synthetic_init(shapes, seed=0)


def _jax_steps(model, spec, variables, phase, x, y):
    groups = joptim.phase_groups("single", phase, HP)
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
    for _ in range(2):
        state, m = fn(state, jnp.asarray(x), jnp.asarray(y))
        out.append((state, {k: float(v) for k, v in m.items()}))
    return out


@pytest.mark.parametrize("phase", [0, 1, 2], ids=["warmup", "joint", "last"])
def test_single_train_step_matches_jax(baseline, phase):
    model, spec, variables = baseline
    tm = port_model(model, spec, variables)
    assert tm.spec.num_scales == 1 and tm.features.base.aspp.mode == "sum"
    tspec = port_spec(spec)
    x, y = _batch()
    (s1, m1), (s2, m2) = _jax_steps(model, spec, variables, phase, x, y)
    groups = toptim.phase_groups("single", phase, HP)
    opt = toptim.PhaseOptimizer(
        tm.named_parameters(), groups,
        schedule=toptim.poly_schedule(0.9, 10) if phase == 1 else None,
        iter_size=2, guard_nonfinite=50)
    state = TrainState(tm, opt)
    step = tsteps.make_train_step(tsteps.LossWeights(**WEIGHTS))
    got = []
    for _ in range(2):
        got.append({k: float(v) for k, v in step(
            state, torch.from_numpy(x), torch.from_numpy(y)).items()})
        if len(got) == 1:
            acc = {name: opt._acc[off:off + p.numel()].view_as(p).clone()
                   .numpy() for name, p, off in _offsets(tm, opt)}
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
    have = tm.state_dict()
    for name, want in new.items():
        got_p = have[name].numpy()
        label = toptim.label_of_path(name)
        if label not in groups:
            np.testing.assert_array_equal(got_p, init[name], err_msg=name)
            continue
        u = grads[name] + groups[label].weight_decay * init[name]
        decided = np.abs(acc[name] + groups[label].weight_decay *
                         init[name] - u) < 0.1 * np.abs(u)
        assert decided.mean() >= 0.999, name
        np.testing.assert_allclose(got_p[decided], want[decided], rtol=0,
                                   atol=1e-4, err_msg=name)


def test_single_bank_packed_head_matches_pallas():
    rng = np.random.default_rng(3)
    spec = JSpec.equal_allocation(190, 64, num_classes=19, num_scales=1)
    tspec = port_spec(spec)
    feats = rng.random((2, 3, 5, 64)).astype(np.float32)
    feats = feats.astype(jnp.bfloat16).astype(np.float32)   # bf16 input
    protos = rng.random((190, 64)).astype(np.float32)
    w = rng.standard_normal((190, 19)).astype(np.float32)
    want = np.asarray(fused_proto_logits(
        jnp.asarray(feats), jnp.asarray(protos), jnp.asarray(w), spec,
        interpret=True, tile_n=128))
    head = pack_head(torch.from_numpy(protos), torch.from_numpy(w), tspec)
    got = emulate_proto_kernel(torch.from_numpy(feats), head, tspec)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_baseline_config_matches_jax():
    ours = configlib.parse_config_file(
        os.path.join(CONFIGS_DIR, "baseline_cityscapes.gin"))
    assert ours == configlib.parse_config_file(JAX_CONFIG)
    hp = module_hparams(ours, "single")
    assert hp["iter_size"] == 5 and hp["weights"].kld == 0.25


TINY = ["train.warmup_steps = 2", "train.joint_steps = 2",
        "train.finetune_steps = 2",
        "construct_PPNet.base_architecture = 'deeplabv2_resnet50'",
        "deeplabv2_resnet50_features.deeplab_n_features = 16",
        "construct_PPNet.prototype_shape = (38, 16, 1, 1)",
        "PatchClassificationDataset.window_size = (33, 33)",
        "PatchClassificationModule.iter_size = 1",
        "PatchClassificationDataModule.dataloader_n_jobs = 2"]


def _argv(root, results):
    argv = ["baseline_cityscapes", "base_run", "--device", "cpu",
            "--data-root", str(root), "--results-root", str(results)]
    for line in TINY:
        argv += ["--gin", line]
    return argv


@pytest.fixture
def workdir(tmp_path):
    """``tmp_path``, removed after the test (checkpoints of ~100 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_train_wandb_trains_pushes_and_serves_the_baseline(workdir):
    root = build_synthetic_dataset(str(workdir / "data"), n_train=4,
                                   n_val=2, size=48)
    results = workdir / "results"
    out = train_wandb.main(_argv(root, results))
    assert sorted(out["phases"]) == [0, 1, 2]
    for res in out["phases"].values():
        assert res.steps_done == 2 and np.isfinite(res.losses).all()
    assert out["push"] is not None
    run = results / "base_run"
    model, spec = load_model(str(run), out["final"] + ".pth", device="cpu")
    assert spec.num_scales == 1 and not model.grouped
    assert spec.num_prototypes == out["push"].spec.num_prototypes
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, SIDE, SIDE, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.isfinite(model(x).logits).all()

    images = workdir / "images"
    images.mkdir()
    raw = np.random.default_rng(4).integers(0, 256, (3, 40, 40, 3),
                                            dtype=np.uint8)
    for i, img in enumerate(raw):
        np.save(images / f"frame_{i}.npy", img)
    record = serve.main(["base_run", "push_final", "--input", str(images),
                         "--output", str(workdir / "labels"), "--batch",
                         "2", "--raw-output", "--results-root",
                         str(results), "--device", "cpu"])
    assert record["images"] == 3
    labels = np.load(workdir / "labels" / "frame_0.npy")
    assert labels.shape == (40, 40) and labels.max() < 19


def test_python_m_train_takes_train_wandb_arguments(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(train_wandb, "train",
                        lambda *a, **kw: seen.append((a, kw)))
    argv = _argv(tmp_path / "data", tmp_path / "results") + ["--pruned"]
    train_wandb.main(argv)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    runpy.run_module("scaleprotoseg_torch.train", run_name="__main__")
    assert len(seen) == 2 and seen[0] == seen[1]
    args, kw = seen[0]
    assert args == ("baseline_cityscapes", "base_run") and kw["pruned"]
    assert kw["device"] == "cpu" and kw["gin_overrides"] == TINY
