"""The ADE20K path through the port's CLIs on the CPU, at tiny size: a
synthetic ADE20K root (``train`` images of 36-52 pixels a side, ``val``
images of 24 x 32, upscaled by the eval protocol, and 520 x 640,
downscaled; final labels 0-150 in class blocks framed by void) and the
ADE configs with narrow widths (16 channels a rate) over ResNet stages of
one block each (the factory's block table patched for this module); the
bank of 1800 prototypes and the 150 classes kept.

- ``train_wandb_multiscale`` on ``scaleproto_ade``: warm-up, joint, push
  at batch 1 over mixed sizes (its artifacts' class directories named
  after ADE's classes) and last layer.
- ``finetune_wandb_group`` on ``group_scaleproto_ade`` (which binds no
  ``train.data_type``) from that ``push_final`` to ``final-group``.
- ``eval_valid_multiscale ... ade`` on ``final-group`` and ``serve
  --canvas 64 64`` on images of two sizes.
- ``train_wandb`` on ``baseline_ade`` (the single-scale model).
- ``run_evaluation`` with ADE's protocol against the JAX package's on the
  same weights (a tiny grouped model at ADE's head widths, carried by
  ``ppnet_params_to_statedict``) through the CLI: mIoU and pixel accuracy
  within 1e-6, at the default multiple and with ``--shape-multiple 0``, as
  ``test_torch_pascal_eval.py::test_pascal_eval_matches_jax`` holds
  Pascal.
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
from scaleprotoseg_tpu import eval_valid_multiscale as jeval
from scaleprotoseg_tpu.models.deeplab import DeepLabV2 as JDeepLabV2
from scaleprotoseg_tpu.models.ppnet import PPNet as JPPNet
from scaleprotoseg_tpu.spec import ProtoSpec as JSpec
from scaleprotoseg_torch import (eval_valid_multiscale, finetune_wandb_group,
                                 train_wandb, train_wandb_multiscale)
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models import factory
from scaleprotoseg_torch.ops.resize import resize_label_nearest_np
from scaleprotoseg_torch.serving import serve
from test_torch_ade import write_ade_root
from torch_parity import port_model, port_spec
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SIZES = {"train": [(40, 52), (52, 40), (36, 48), (44, 44)],
         "val": [(24, 32), (520, 640)]}
# each val image's eval input: the default multiple of 64, and exact
EVAL_SHAPES = {None: [(512, 704), (512, 640)], 0: [(512, 683), (512, 630)]}
COMMON = ["PatchClassificationDataset.window_size = (33, 33)",
          "PatchClassificationDataModule.dataloader_n_jobs = 2",
          "Trainer.val_check_interval = 2", "train.warmup_batch_size = 2",
          "train.joint_batch_size = 2"]
MSC = ["deeplabv2_resnet50_features_multiscale.deeplab_n_features = 16",
       "deeplabv2_resnet50_features_multiscale.scales = []",
       "PatchClassificationModuleMultiScale.iter_size = 1"]
PROTO = COMMON + MSC + [
    "train.warmup_steps = 1", "train.joint_steps = 1",
    "train.finetune_steps = 1",
    "construct_PPNet.base_architecture = 'deeplabv2_resnet50_multiscale'",
    "construct_PPNet.prototype_shape = (1800, 16, 1, 1)"]
GROUP = COMMON + MSC + [
    "train.warmup_steps = 1", "train.joint_steps = 1",
    "construct_PPNet_Group.base_architecture = "
    "'deeplabv2_resnet50_multiscale'",
    "construct_PPNet_Group.prototype_shape = (1800, 16, 1, 1)"]
SINGLE = COMMON + [
    "train.warmup_steps = 1", "train.joint_steps = 1",
    "train.finetune_steps = 1", "train.push_proto = False",
    "PatchClassificationModule.iter_size = 1",
    "construct_PPNet.base_architecture = 'deeplabv2_resnet50'",
    "deeplabv2_resnet50_features.deeplab_n_features = 16",
    "deeplabv2_resnet50_features.scales = []",
    "construct_PPNet.prototype_shape = (1800, 16, 1, 1)"]


@pytest.fixture(autouse=True, scope="module")
def _tiny_backbones():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        for name, (cfg, _, mode) in list(factory._BACKBONES.items()):
            if "resnet50" in name:
                mp.setitem(factory._BACKBONES, name, (cfg, (1, 1, 1, 1),
                                                      mode))
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ade(tmp_path_factory):
    """The synthetic root and the results directory, removed after the
    module: the runs' train states take a few hundred MB."""
    tmp = tmp_path_factory.mktemp("ade_cli")
    root = write_ade_root(str(tmp / "data"), SIZES, seed=2)
    yield root, str(tmp / "results")
    shutil.rmtree(tmp, ignore_errors=True)


def _argv(config, run, root, results, gin, extra=()):
    argv = [config, run, "--device", "cpu", "--data-root", root,
            "--results-root", results, *extra]
    for line in gin:
        argv += ["--gin", line]
    return argv


def test_ade_prototype_group_eval_serve(ade, tmp_path):
    root, results = ade
    out = train_wandb_multiscale.main(
        _argv("scaleproto_ade", "proto", root, results, PROTO))
    for phase in (0, 1, 2):
        assert all(np.isfinite(out["phases"][phase].losses))
    assert out["push"] is not None
    run = os.path.join(results, "proto")
    model, spec = load_model(run, out["final"] + ".pth", device="cpu")
    assert model.msc_scales == () and spec.num_classes == 150
    assert spec.num_scales == 4
    # the push artifacts sit in class directories named after the classes
    names = {n for _, dirs, _ in os.walk(os.path.join(run, "prototypes"))
             for n in dirs}
    ade_names = set(eval_valid_multiscale.class_names("ade", 150))
    assert names & ade_names and not any(n.startswith("class_")
                                         for n in names)

    gout = finetune_wandb_group.main(_argv(
        "group_scaleproto_ade", "group", root, results, GROUP,
        ["--start-checkpoint", out["final"]]))
    assert gout["final"].endswith("final-group")
    assert sorted(gout["phases"]) == [0, 1]
    for res in gout["phases"].values():
        assert all(np.isfinite(res.losses))
    grun = os.path.join(results, "group")
    gmodel, gspec = load_model(grun, gout["final"] + ".pth", device="cpu")
    assert gmodel.grouped and gmodel.msc_scales == ()
    _, glw = gmodel.group_weights()
    assert tuple(glw.shape) == (150 * 3, 150)
    assert gspec.num_classes == 150

    # the upscaled val image (test_ade_eval_matches_jax runs both, at both
    # multiples)
    got = eval_valid_multiscale.main(
        ["group", "final-group", "1", "ade", "--device", "cpu",
         "--data-root", root, "--results-root", results, "--limit", "1"])
    assert 0.0 <= got["pixel_accuracy"] <= 1.0
    with open(os.path.join(grun, "evaluation", "final-group",
                           "iou_scores.json")) as f:
        assert list(json.load(f)) == \
            eval_valid_multiscale.class_names("ade", 150)

    # --canvas: images of two sizes no larger than it through one program
    images = tmp_path / "images"
    images.mkdir()
    for i, (h, w) in enumerate([(40, 52), (64, 48)]):
        np.save(images / f"img_{i}.npy", np.random.default_rng(i).integers(
            0, 256, (h, w, 3), dtype=np.uint8))
    record = serve.main(["group", "final-group", "--input", str(images),
                         "--output", str(tmp_path / "labels"),
                         "--raw-output", "--results-root", results,
                         "--device", "cpu", "--canvas", "64", "64"])
    assert record["images"] == 2 and record["preprocess"] == "host"
    for i, shape in enumerate([(40, 52), (64, 48)]):
        labels = np.load(tmp_path / "labels" / f"img_{i}.npy")
        assert labels.shape == shape and labels.dtype == np.uint8
        assert labels.max() < 150


def test_ade_single_scale_cli(ade):
    root, results = ade
    out = train_wandb.main(_argv("baseline_ade", "single", root, results,
                                 SINGLE))
    assert sorted(out["phases"]) == [0, 1, 2]
    model, spec = load_model(os.path.join(results, "single"),
                             out["final"] + ".pth", device="cpu")
    assert (spec.num_prototypes, spec.num_classes, spec.num_scales) == \
        (1800, 150, 1)
    assert model.msc_scales == ()
    assert model.features.base.aspp.mode == "sum"


@pytest.fixture(scope="module")
def tiny_group(ade):
    """(JAX model, spec, variables, the port's model, its spec): the
    grouped head of ``group_scaleproto_ade`` (1800 / 150 / 4 / 3) over a
    one-block-a-stage backbone, no pyramid.  With synthetic weights every
    pixel takes one class; here the predictions follow the val images'
    class blocks instead, so that mIoU and pixel accuracy measure
    something (the blocks' void frames, a quarter of a block's side, hold
    the predicted class boundaries, where the two packages' float32
    logits could break a near tie apart: one scored pixel at a margin of
    1e-6 moves mIoU by ~5e-6, as a 600 x 600 val image showed, so the
    1e-6 bound holds only where no tie falls on a scored pixel, as on
    these images):
    each class of a val image's blocks gets its prototypes near the
    features of its block's pixels (noise of 0.1 a coordinate), every
    other prototype sits far from all features, and the group last layer
    connects each class's groups to that class alone, with weight 1 + c /
    100 for class c: where no prototype is near, the classes' logits
    differ by that step, not by rounding, and no common offset of the
    classes' logits (the -0.5 of the model's own init, summed over 449
    columns) takes their float32 precision."""
    spec = JSpec.equal_allocation(1800, 64, num_classes=150, num_scales=4,
                                  num_groups=3)
    model = JPPNet(backbone=JDeepLabV2(n_out=64, n_blocks=(1, 1, 1, 1),
                                       aspp_mode="concat", dtype=jnp.float32),
                   spec=spec, backbone_channels=spec.feature_depth,
                   add_on_type="deeplab_simple", grouped=True,
                   dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 65, 65, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=4)
    tm = port_model(model, spec, variables)
    root, _ = ade
    rng = np.random.default_rng(5)
    protos = np.full((spec.num_prototypes, 64), 10.0, np.float32)
    owner = {}                   # class -> the (features, pixels) it owns
    for i in range(len(SIZES["val"])):
        img, ann = (np.load(os.path.join(root, sub, "val", f"val_{i:03d}.npy"))
                    for sub in ("img_with_margin_0", "annotations"))
        x = eval_valid_multiscale.prepare_image(img, "ade")
        with torch.no_grad():
            feats = tm.conv_features(torch.from_numpy(x)[None])[0].numpy()
        grid = resize_label_nearest_np(ann, feats.shape[1::-1])
        for c in np.unique(grid[grid > 0]) - 1:
            owner.setdefault(int(c), []).append(
                (feats.reshape(-1, 256), np.flatnonzero(grid == c + 1)))
    for c, places in owner.items():
        for k, j in enumerate(spec.class_proto_index[c]):
            if j < 0:
                continue
            s = spec.scale_of(j) if hasattr(spec, "scale_of") else next(
                s for s, (lo, hi) in enumerate(spec.scale_bounds)
                if lo <= j < hi)
            feats, pixels = places[k % len(places)]
            protos[j] = feats[rng.choice(pixels), s * 64:(s + 1) * 64]
    protos += 0.1 * rng.standard_normal(protos.shape).astype(np.float32)
    cls = np.arange(150)
    own = np.arange(450)[:, None] // 3 == cls[None]
    params = dict(variables["params"], prototype_vectors=jnp.asarray(protos),
                  last_layer_group=jnp.asarray(np.where(
                      own, 1.0 + cls / 100, 0.0).astype(np.float32)))
    variables = dict(variables, params=params)
    return model, spec, variables, port_model(model, spec, variables), \
        port_spec(spec)


@pytest.mark.parametrize("multiple", [None, 0], ids=["default", "exact"])
def test_ade_eval_matches_jax(ade, tiny_group, tmp_path, monkeypatch,
                              multiple):
    root, _ = ade
    model, spec, variables, tm, tspec = tiny_group
    monkeypatch.setattr(jeval, "load_model",
                        lambda *a, **k: (model, spec, variables))
    monkeypatch.setattr(eval_valid_multiscale, "load_model",
                        lambda *a, **k: (tm, tspec))
    # the sample renders and plots are artifacts, not the result
    for mod, name in ((jeval, "_save_sample_artifacts"),
                      (jeval, "_save_plots"),
                      (eval_valid_multiscale, "_save_sample_artifacts"),
                      (eval_valid_multiscale, "_save_plots")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)
    batches = []
    real_update = eval_valid_multiscale.SegEvaluator.update

    def update(self, images, targets):
        batches.append((tuple(images.shape), tuple(targets.shape)))
        return real_update(self, images, targets)

    monkeypatch.setattr(eval_valid_multiscale.SegEvaluator, "update", update)
    flags = [] if multiple is None else ["--shape-multiple", str(multiple)]
    got = eval_valid_multiscale.main(
        ["run", "final-group", "2", "ade", "--device", "cpu", "--data-root",
         root, "--results-root", str(tmp_path / "port"), *flags])
    want = jeval.run_evaluation(
        "run", "final-group", batch_size=2, data_type="ade",
        data_root=root, results_root=str(tmp_path / "jax"),
        shape_multiple=multiple, fp32=True)
    # ADE's sizes differ, so every image is a batch of its own
    assert batches == [((1, *shape, 3), (1, *size)) for shape, size in
                       zip(EVAL_SHAPES[multiple], SIZES["val"])]
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-6
    assert abs(got["pixel_accuracy"] - want["pixel_accuracy"]) <= 1e-6
    assert got["pixel_accuracy"] > 0.15 and got["mean_iou"] > 0.05, got
    out = os.path.join(str(tmp_path / "port"), "run", "evaluation",
                       "final-group")
    with open(os.path.join(out, "iou_scores.json")) as f:
        assert list(json.load(f)) == jeval.class_names("ade", 150)
