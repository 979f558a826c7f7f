"""The EM / ISBI-2012 path through the port's CLIs on the CPU, at the JAX
tests' tiny EM width (``unet_base`` 8, ``unet_n_features`` 8) on a
synthetic EM root in the JAX layout (``tests/e2e_utils.py``: 32 x 32
frames, labels 1 background / 2 cell and a void row).

- ``train_wandb_multiscale scaleproto_em`` (warm-up 0, joint, push, last
  layer; ``freeze_type = 'none'``): every BN's running statistics move
  and stay finite, the BN affine parameters stay at their init; then
  ``finetune_wandb_group group_scaleproto_em`` from its ``push_final``
  (joint phase only: ``push_proto = False``, ``finetune_steps = 0``),
  whose backbone takes no gradient while its statistics move on; then
  ``eval_valid_multiscale ... em`` and ``serve --device cpu`` on
  ``final-group``; ``train_wandb baseline_em`` (frozen BN: no
  ``freeze_type`` binding), whose statistics stay.
- ``run_evaluation`` against the JAX package's on one tiny grouped EM
  model (weights carried by ``ppnet_params_to_statedict``): mIoU and pixel
  accuracy within 1e-6; the serve CLI's labels against the JAX package's
  serve CLI on the same frames.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import synthetic_init
from e2e_utils import build_synthetic_dataset
from scaleprotoseg_tpu import eval_valid_multiscale as jeval
from scaleprotoseg_tpu.models.ppnet import PPNet as JPPNet
from scaleprotoseg_tpu.models.unet import UNetASPP as JUNetASPP
from scaleprotoseg_tpu.spec import ProtoSpec as JSpec
from scaleprotoseg_torch import (eval_valid_multiscale, finetune_wandb_group,
                                 train_wandb, train_wandb_multiscale)
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     spec_from_meta)
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.serving import serve
from test_torch_em import BASE, WIDTH, _carry, _data_stats, _bindings
from torch_parity import labels_equal_outside_ties, to_numpy_tree
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SIDE = 32
TINY = [f"unet_aspp_features.unet_n_features = {WIDTH}",
        f"unet_aspp_features.unet_base = {BASE}",
        f"PatchClassificationDataset.window_size = ({SIDE}, {SIDE})",
        "PatchClassificationDataModule.dataloader_n_jobs = 2",
        "Trainer.val_check_interval = 2"]
PROTO = TINY + ["construct_PPNet.prototype_shape = (24, 8, 1, 1)",
                "train.joint_steps = 2", "train.finetune_steps = 1"]
GROUP = TINY + ["construct_PPNet_Group.prototype_shape = (24, 8, 1, 1)",
                "train.joint_steps = 2"]
SINGLE = TINY + ["construct_PPNet.prototype_shape = (20, 8, 1, 1)",
                 "train.joint_steps = 2", "train.finetune_steps = 1",
                 "train.push_proto = False"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def em(tmp_path_factory):
    """The synthetic EM root and the results directory."""
    tmp = tmp_path_factory.mktemp("em_cli")
    root = build_synthetic_dataset(str(tmp / "data"), n_train=6, n_val=3,
                                   size=SIDE, seed=0)
    yield root, str(tmp / "results")
    shutil.rmtree(tmp, ignore_errors=True)


def _argv(config, run, root, results, gin, extra=()):
    argv = [config, run, "--device", "cpu", "--data-root", root,
            "--results-root", results, *extra]
    for line in gin:
        argv += ["--gin", line]
    return argv


def _bn(sd, suffix):
    return {k: v for k, v in sd.items() if k.endswith(suffix)}


def test_em_prototype_group_eval_serve(em):
    root, results = em
    init, _ = construct_ppnet("multiscale", "unet_aspp", (24, WIDTH, 1, 1),
                              2, bindings=_bindings("multiscale"))
    init = init.state_dict()
    out = train_wandb_multiscale.main(
        _argv("scaleproto_em", "proto", root, results, PROTO))
    assert sorted(out["phases"]) == [1, 2]          # warm-up 0 is skipped
    for res in out["phases"].values():
        assert all(np.isfinite(res.losses))
    assert out["push"] is not None
    with open(os.path.join(results, "proto", "train.log")) as f:
        log = f.read()
    assert "train_bn=True" in log
    proto, _ = load_checkpoint(out["final"])
    stats = _bn(proto, ("running_mean", "running_var"))
    assert len(stats) == 36
    for name, value in stats.items():
        assert torch.isfinite(value).all(), name
        assert not torch.equal(value, init[name]), name
    for name in _bn(proto, (".bn.weight", ".bn.bias")):
        torch.testing.assert_close(proto[name], init[name], rtol=0, atol=0)

    gout = finetune_wandb_group.main(_argv(
        "group_scaleproto_em", "group", root, results, GROUP,
        ["--start-checkpoint", out["final"]]))
    assert sorted(gout["phases"]) == [1]            # joint only
    assert all(np.isfinite(gout["phases"][1].losses))
    group, _ = load_checkpoint(gout["final"])
    for name, value in proto.items():
        if name.startswith("features.") and "running_" not in name and \
                "num_batches" not in name:
            # joint_last: the backbone takes no gradient
            torch.testing.assert_close(group[name], value, rtol=0, atol=0)
        elif "running_" in name:
            assert not torch.equal(group[name], value), name

    got = eval_valid_multiscale.main(
        ["group", "final-group", "2", "em", "--device", "cpu", "--data-root",
         root, "--results-root", results])
    assert 0.0 <= got["mean_iou"] <= 1.0 and 0.0 <= got["pixel_accuracy"]
    with open(os.path.join(results, "group", "evaluation", "final-group",
                           "iou_scores.json")) as f:
        assert list(json.load(f)) == ["background", "cell"]

    val = os.path.join(root, "img_with_margin_0", "val")
    rec = serve.main(["group", "final-group", "--input", val, "--device",
                      "cpu", "--raw-output", "--output",
                      os.path.join(results, "served"), "--results-root",
                      results])
    assert rec["images"] == 3
    labels = np.load(os.path.join(results, "served", "val_img_000.npy"))
    assert labels.shape == (SIDE, SIDE) and set(np.unique(labels)) <= {0, 1}


def test_em_baseline_keeps_bn_frozen(em):
    """``baseline_em`` binds no ``freeze_type``: its BN stays frozen, as
    the JAX package's trainer keeps it."""
    root, results = em
    out = train_wandb.main(_argv("baseline_em", "single", root, results,
                                 SINGLE))
    assert sorted(out["phases"]) == [1, 2]
    for res in out["phases"].values():
        assert all(np.isfinite(res.losses))
    sd, meta = load_checkpoint(out["final"])
    assert spec_from_meta(meta["spec"]).num_scales == 1
    assert sd["prototype_vectors"].shape == (20, WIDTH, 1, 1)
    for name, value in _bn(sd, "running_mean").items():
        assert torch.equal(value, torch.zeros_like(value)), name
    for name, value in _bn(sd, "running_var").items():
        assert torch.equal(value, torch.ones_like(value)), name


# ---------------------------------------------------------------------------
# eval and serving against the JAX package's, on one tiny grouped model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_group(em):
    """(JAX model, spec, variables, the port's model, its spec): a tiny
    ``group_scaleproto_em`` (24 / 2 / 4 / 3), the BN statistics a seeded
    batch's, and each class's prototypes placed on the features of its
    own pixels in the val frames (noise 0.01 a coordinate), each class's
    groups connected to that class alone with weight 1 + c / 100, so
    that the predictions follow the cells rather than one class."""
    root, _ = em
    spec = JSpec.equal_allocation(24, WIDTH, num_classes=2, num_scales=4,
                                  num_groups=3)
    model = JPPNet(backbone=JUNetASPP(out_features=WIDTH, multiscale=True,
                                      base=BASE, dtype=jnp.float32),
                   spec=spec, backbone_channels=spec.feature_depth,
                   add_on_type="deeplab_simple", grouped=True,
                   dtype=jnp.float32, incorrect_strength=0.0)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = dict(synthetic_init(shapes, seed=7))
    variables["batch_stats"] = _data_stats(model, variables, 8,
                                           (2, SIDE, SIDE, 3), train=True)
    tm, tspec = construct_ppnet("group", "unet_aspp", (24, WIDTH, 1, 1), 2,
                                bindings=_bindings("group"))
    _carry(tm, variables["params"], variables["batch_stats"], tspec)
    tm.eval()
    feats, labels = [], []
    for i in range(3):
        img, ann = (np.load(os.path.join(root, sub, "val",
                                         f"val_img_{i:03d}.npy"))
                    for sub in ("img_with_margin_0", "annotations"))
        x = eval_valid_multiscale.prepare_image(img, "em")
        with torch.no_grad():
            feats.append(tm.conv_features(torch.from_numpy(x)[None])[0])
        labels.append(ann)
    feats = torch.cat([f.reshape(-1, f.shape[-1]) for f in feats]).numpy()
    labels = np.concatenate([a.reshape(-1) for a in labels])
    rng = np.random.default_rng(9)
    params = to_numpy_tree(variables["params"])
    protos = np.array(params["prototype_vectors"])
    idx = spec.class_proto_index
    for c in range(2):
        own = np.flatnonzero(labels == c + 1)
        for s, (lo, hi) in enumerate(spec.scale_bounds):
            cols = slice(s * WIDTH, (s + 1) * WIDTH)
            for p in range(lo, hi):
                if p in idx[c]:
                    pix = own[rng.integers(len(own))]
                    protos[p] = feats[pix, cols] + 0.01 * \
                        rng.standard_normal(WIDTH)
    glw = np.zeros((2 * 3, 2), np.float32)
    for c in range(2):
        glw[c * 3:(c + 1) * 3, c] = 1.0 + c / 100
    params["prototype_vectors"] = protos.astype(np.float32)
    params["last_layer_group"] = glw
    variables["params"] = params
    _carry(tm, params, variables["batch_stats"], tspec)
    return model, spec, variables, tm.eval(), tspec


@pytest.fixture
def loaders(tiny_group, monkeypatch):
    import scaleprotoseg_tpu.model_loading as jml
    import scaleprotoseg_torch.model_loading as tml
    model, spec, variables, tm, tspec = tiny_group
    for mod, load in ((jml, lambda *a, **k: (model, spec, variables)),
                      (tml, lambda *a, **k: (tm, tspec))):
        monkeypatch.setattr(mod, "load_model", load)
        monkeypatch.setattr(mod, "resolve_checkpoint", lambda *a: "ckpt")
    monkeypatch.setattr(jeval, "load_model",
                        lambda *a, **k: (model, spec, variables))
    monkeypatch.setattr(eval_valid_multiscale, "load_model",
                        lambda *a, **k: (tm, tspec))
    for mod, name in ((jeval, "_save_sample_artifacts"),
                      (jeval, "_save_plots"),
                      (eval_valid_multiscale, "_save_sample_artifacts"),
                      (eval_valid_multiscale, "_save_plots")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)
    return tiny_group


def test_em_eval_matches_jax(em, loaders, tmp_path):
    root, _ = em
    got = eval_valid_multiscale.run_evaluation(
        "run", "final-group", batch_size=2, data_type="em", data_root=root,
        results_root=str(tmp_path / "port"), device="cpu")
    want = jeval.run_evaluation(
        "run", "final-group", batch_size=2, data_type="em", data_root=root,
        results_root=str(tmp_path / "jax"), fp32=True)
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-6
    assert abs(got["pixel_accuracy"] - want["pixel_accuracy"]) <= 1e-6
    # the placed prototypes make the predictions follow the cells: both
    # classes predicted, neither everywhere
    assert min(got["per_class_iou"]) > 0.3, got


def test_em_serve_matches_jax(em, loaders, tmp_path):
    from scaleprotoseg_tpu.serving.serve import main as jmain
    root, _ = em
    model, spec, variables, _, _ = loaders
    val = os.path.join(root, "img_with_margin_0", "val")
    for name, main, extra in (("jax", jmain, []),
                              ("port", serve.main, ["--device", "cpu"])):
        main(["run", "final-group", "--input", val, "--output",
              str(tmp_path / name), "--batch", "2", "--raw-output", *extra])
    for i in range(3):
        f = f"val_img_{i:03d}.npy"
        img = np.load(os.path.join(val, f))
        x = eval_valid_multiscale.prepare_image(img, "em")[None]
        up = np.asarray(model.apply(variables, jnp.asarray(x)).logits)[0]
        got = np.load(tmp_path / "port" / f)
        assert got.shape == (SIDE, SIDE)
        labels_equal_outside_ties(got, np.load(tmp_path / "jax" / f), up)
