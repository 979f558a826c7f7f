"""The COCO-Stuff path through the port's CLIs on the CPU, at tiny size: a
synthetic COCO-Stuff root (``train``, ``val``; images of 36-52 pixels a
side, final labels 0-182 in class blocks) and the COCO configs with
narrow widths (16 channels a rate) over ResNet stages of one block each
(the factory's block table patched for this module); the banks (2184 and
2054 prototypes), the 182 classes and the pyramid (0.5, 0.75) kept.

- ``train_wandb_multiscale`` on ``baseline_coco`` (the multiscale model):
  warm-up, joint, push (its artifacts' class directories named after
  COCO's classes, spaces included) and last layer; ``run_pruning`` on it.
- ``finetune_wandb_group`` on ``group_scaleproto_coco`` from that
  ``push_final`` (phases 0 and 1, no push) to ``final-group``: a group
  head of 182 x 3 group columns.
- ``eval_valid_multiscale ... coco`` and ``serve`` on ``final-group``.
- ``train_wandb`` on ``scaleproto_coco`` (the single-scale model).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from scaleprotoseg_torch import (eval_valid_multiscale, finetune_wandb_group,
                                 run_pruning, train_wandb,
                                 train_wandb_multiscale)
from scaleprotoseg_torch.checkpoints.convert import load_checkpoint
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models import factory
from scaleprotoseg_torch.serving import serve
from test_torch_coco import write_coco_root
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SIZES = {"train": [(40, 52), (52, 40), (36, 48), (44, 44)],
         "val": [(40, 52), (52, 40)]}
COMMON = ["PatchClassificationDataset.window_size = (33, 33)",
          "PatchClassificationDataModule.dataloader_n_jobs = 2",
          "Trainer.val_check_interval = 2", "train.warmup_batch_size = 2",
          "train.joint_batch_size = 2"]
MSC = ["deeplabv2_resnet50_features_multiscale.deeplab_n_features = 16",
       "deeplabv2_resnet50_features_multiscale.scales = [0.5, 0.75]"]
PROTO = COMMON + MSC + [
    "train.warmup_steps = 1", "train.joint_steps = 1",
    "train.finetune_steps = 1",
    "construct_PPNet.base_architecture = 'deeplabv2_resnet50_multiscale'",
    "construct_PPNet.prototype_shape = (2184, 16, 1, 1)"]
GROUP = COMMON + MSC + [
    "train.warmup_steps = 1", "train.joint_steps = 1",
    "construct_PPNet_Group.base_architecture = "
    "'deeplabv2_resnet50_multiscale'",
    "construct_PPNet_Group.prototype_shape = (2054, 16, 1, 1)"]
SINGLE = COMMON + [
    "train.warmup_steps = 1", "train.joint_steps = 1",
    "train.finetune_steps = 1", "train.push_proto = False",
    "construct_PPNet.base_architecture = 'deeplabv2_resnet50'",
    "deeplabv2_resnet50_features.deeplab_n_features = 16",
    "deeplabv2_resnet50_features.scales = [0.5, 0.75]",
    "construct_PPNet.prototype_shape = (2184, 16, 1, 1)"]


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
def coco(tmp_path_factory):
    """The synthetic root and the results directory, removed after the
    module: the runs' train states take a few hundred MB."""
    tmp = tmp_path_factory.mktemp("coco_cli")
    root = write_coco_root(str(tmp / "data"), SIZES, seed=2)
    yield root, str(tmp / "results")
    shutil.rmtree(tmp, ignore_errors=True)


def _argv(config, run, root, results, gin, extra=()):
    argv = [config, run, "--device", "cpu", "--data-root", root,
            "--results-root", results, *extra]
    for line in gin:
        argv += ["--gin", line]
    return argv


def test_coco_prototype_group_eval_serve(coco, tmp_path):
    root, results = coco
    out = train_wandb_multiscale.main(
        _argv("baseline_coco", "proto", root, results, PROTO))
    for phase in (0, 1, 2):
        assert all(np.isfinite(out["phases"][phase].losses))
    push = out["push"]
    assert push is not None
    run = os.path.join(results, "proto")
    model, spec = load_model(run, out["final"] + ".pth", device="cpu")
    assert model.msc_scales == (0.5, 0.75) and spec.num_classes == 182
    assert spec.num_scales == 4
    # the push artifacts sit in class directories named after the classes
    names = {n for _, dirs, _ in os.walk(os.path.join(run, "prototypes"))
             for n in dirs}
    assert any(" " in n for n in names), sorted(names)[:10]

    # purity pruning at 182 classes: find_nearest and the pruning scan
    pruned = run_pruning.main(["baseline_coco", "proto", "--k", "3",
                               "--prune-threshold", "1",
                               "--push-batch-size", "1", "--device", "cpu",
                               "--data-root", root, "--results-root",
                               results])
    sd, meta = load_checkpoint(pruned["pruned"])
    assert sd["prototype_vectors"].shape[0] == len(pruned["kept"])
    pmodel, pspec = load_model(run, pruned["alias"] + ".pth", device="cpu")
    assert pspec.num_classes == 182 and pspec.num_scales == 4
    assert pmodel.last_layer.weight.shape == (182, len(pruned["kept"]))

    gout = finetune_wandb_group.main(_argv(
        "group_scaleproto_coco", "group", root, results, GROUP,
        ["--start-checkpoint", out["final"]]))
    assert gout["final"].endswith("final-group")
    assert sorted(gout["phases"]) == [0, 1]
    for res in gout["phases"].values():
        assert all(np.isfinite(res.losses))
    grun = os.path.join(results, "group")
    gmodel, gspec = load_model(grun, gout["final"] + ".pth", device="cpu")
    assert gmodel.grouped and gmodel.msc_scales == (0.5, 0.75)
    _, glw = gmodel.group_weights()
    assert tuple(glw.shape) == (182 * 3, 182)
    assert gspec.num_classes == 182

    got = eval_valid_multiscale.main(
        ["group", "final-group", "1", "coco", "--device", "cpu",
         "--data-root", root, "--results-root", results])
    assert 0.0 <= got["pixel_accuracy"] <= 1.0
    with open(os.path.join(grun, "evaluation", "final-group",
                           "iou_scores.json")) as f:
        assert list(json.load(f)) == \
            eval_valid_multiscale.class_names("coco", 182)

    images = tmp_path / "images"
    images.mkdir()
    np.save(images / "img_0.npy", np.load(os.path.join(
        root, "img_with_margin_0", "val", "val_000.npy")))
    record = serve.main(["group", "final-group", "--input", str(images),
                         "--output", str(tmp_path / "labels"),
                         "--raw-output", "--results-root", results,
                         "--device", "cpu"])
    assert record["images"] == 1
    labels = np.load(tmp_path / "labels" / "img_0.npy")
    assert labels.shape == (40, 52) and labels.dtype == np.uint8
    assert labels.max() < 182


def test_coco_single_scale_cli(coco):
    root, results = coco
    out = train_wandb.main(_argv("scaleproto_coco", "single", root, results,
                                 SINGLE))
    assert sorted(out["phases"]) == [0, 1, 2]
    model, spec = load_model(os.path.join(results, "single"),
                             out["final"] + ".pth", device="cpu")
    assert (spec.num_prototypes, spec.num_classes, spec.num_scales) == \
        (2184, 182, 1)
    assert model.msc_scales == (0.5, 0.75)
    assert model.features.base.aspp.mode == "sum"
