"""The Pascal VOC-2012 path through the port's CLIs on the CPU, at tiny
size: a synthetic Pascal root (``train``, ``train_aug``, ``val``,
``test``; images of 36-52 pixels a side, smaller than the 33 x 33 crop
after the 0.5 scale draw) and the Pascal configs with narrow widths (16
channels a rate) over ResNet stages of one block each (the factory's
block table patched for this module), the pyramid (0.5, 0.75) kept.

- ``train_wandb_multiscale`` on ``scaleproto_pascal``: warm-up, joint,
  push and last layer; ``push_final`` loads with the pyramid; the metrics
  rows and the TensorBoard event directory (or, without
  ``torch.utils.tensorboard``, its log line).
- ``finetune_wandb_group`` on ``group_scaleproto_pascal`` from that
  ``push_final``, to ``final-group``.
- ``eval_valid_multiscale ... pascal``, ``eval_test --pascal`` and
  ``serve`` on ``final-group``.
- ``run_pruning`` on the prototype run: ``find_nearest`` and the pruning
  scan take the fused map, as push does.
- ``train_wandb`` without ``--pruned`` on ``baseline_pascal`` (the summed
  ASPP with the pyramid).
- ``serve --quant8-static`` and ``--quant8`` of the MSC ``final-group``
  (the record names the form), ``eval_valid_multiscale ... pascal
  --quant8-static``, and ``serve --export`` then ``--artifact``:
  the artifact's labels equal the run-dir serve's.
"""

import json
import os

import numpy as np
import pytest
import torch

from scaleprotoseg_torch import (eval_test, eval_valid_multiscale,
                                 finetune_wandb_group, run_pruning,
                                 train_wandb, train_wandb_multiscale)
from scaleprotoseg_torch.checkpoints.convert import load_checkpoint
from scaleprotoseg_torch.imageio import read_png
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models import factory
from scaleprotoseg_torch.serving import serve
from test_torch_pascal import write_pascal_root
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SIZES = {"train": [(40, 52), (52, 40), (36, 48)],
         "train_aug": [(40, 52), (52, 40), (36, 48), (44, 44)],
         "val": [(40, 52), (52, 40)], "test": [(40, 52), (52, 40)]}
COMMON = ["PatchClassificationDataset.window_size = (33, 33)",
          "PatchClassificationDataModule.dataloader_n_jobs = 2",
          "Trainer.val_check_interval = 2"]
MSC = ["deeplabv2_resnet50_features_multiscale.deeplab_n_features = 16",
       "deeplabv2_resnet50_features_multiscale.scales = [0.5, 0.75]"]
PROTO = COMMON + MSC + [
    "train.warmup_steps = 2", "train.joint_steps = 2",
    "train.finetune_steps = 1",
    "construct_PPNet.base_architecture = 'deeplabv2_resnet50_multiscale'",
    "construct_PPNet.prototype_shape = (84, 16, 1, 1)",
    "PatchClassificationModuleMultiScale.iter_size = 1"]
GROUP = COMMON + MSC + [
    "train.warmup_steps = 1", "train.joint_steps = 1",
    "construct_PPNet_Group.base_architecture = "
    "'deeplabv2_resnet50_multiscale'",
    "construct_PPNet_Group.prototype_shape = (84, 16, 1, 1)",
    "PatchClassificationModuleMultiScale.iter_size = 1"]
BASELINE = COMMON + [
    "train.warmup_steps = 1", "train.joint_steps = 1",
    "train.finetune_steps = 1",
    "construct_PPNet.base_architecture = 'deeplabv2_resnet50'",
    "deeplabv2_resnet50_features.deeplab_n_features = 16",
    "deeplabv2_resnet50_features.scales = [0.5, 0.75]",
    "construct_PPNet.prototype_shape = (42, 16, 1, 1)",
    "PatchClassificationModule.iter_size = 1"]


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
def pascal(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pascal_cli")
    root = write_pascal_root(str(tmp / "data"), SIZES, seed=2)
    return root, str(tmp / "results")


def _argv(config, run, root, results, gin, extra=()):
    argv = [config, run, "--device", "cpu", "--data-root", root,
            "--results-root", results, *extra]
    for line in gin:
        argv += ["--gin", line]
    return argv


@pytest.fixture(scope="module")
def proto_run(pascal):
    root, results = pascal
    return train_wandb_multiscale.main(
        _argv("scaleproto_pascal", "proto", root, results, PROTO))


def test_pascal_prototype_cli(pascal, proto_run):
    _, results = pascal
    run = os.path.join(results, "proto")
    for phase in (0, 1, 2):
        res = proto_run["phases"][phase]
        assert res.steps_done == {0: 2, 1: 2, 2: 1}[phase]
        assert all(np.isfinite(res.losses))
    assert proto_run["push"] is not None
    model, spec = load_model(run, proto_run["final"] + ".pth", device="cpu")
    assert model.msc_scales == (0.5, 0.75)
    assert spec.num_classes == 21 and spec.num_scales == 4
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows and all("train_loss" in r for r in rows)
    with open(os.path.join(run, "train.log")) as f:
        text = f.read()
    try:
        import torch.utils.tensorboard  # noqa: F401
        assert os.listdir(os.path.join(run, "logs", "tb"))
    except ImportError:
        assert "TensorBoard logging disabled" in text


def test_pascal_group_eval_export_serve(pascal, proto_run, tmp_path):
    root, results = pascal
    out = finetune_wandb_group.main(_argv(
        "group_scaleproto_pascal", "group", root, results, GROUP,
        ["--start-checkpoint", proto_run["final"]]))
    assert out["final"].endswith("final-group")
    for res in out["phases"].values():
        assert all(np.isfinite(res.losses))
    grun = os.path.join(results, "group")
    model, _ = load_model(grun, out["final"] + ".pth", device="cpu")
    assert model.grouped and model.msc_scales == (0.5, 0.75)

    got = eval_valid_multiscale.main(
        ["group", "final-group", "2", "pascal", "--device", "cpu",
         "--data-root", root, "--results-root", results])
    assert 0.0 <= got["pixel_accuracy"] <= 1.0
    with open(os.path.join(grun, "evaluation", "final-group",
                           "iou_scores.json")) as f:
        assert list(json.load(f)) == \
            eval_valid_multiscale.class_names("pascal", 21)

    tdir = eval_test.main(["group", "final-group", "2", "--pascal",
                           "--device", "cpu", "--data-root", root,
                           "--results-root", results])
    for i, (h, w) in enumerate(SIZES["test"]):
        png = read_png(os.path.join(tdir, f"test_{i:03d}.png"))
        assert png.shape == (h, w) and png.max() <= 20

    images = tmp_path / "images"
    images.mkdir()
    for i in range(2):
        np.save(images / f"img_{i}.npy", np.load(os.path.join(
            root, "img_with_margin_0", "val", "val_000.npy")))
    record = serve.main(["group", "final-group", "--input", str(images),
                         "--output", str(tmp_path / "labels"), "--batch",
                         "2", "--raw-output", "--results-root", results,
                         "--device", "cpu"])
    assert record["images"] == 2
    labels = np.load(tmp_path / "labels" / "img_0.npy")
    assert labels.shape == (40, 52) and labels.max() < 21

    # int8 serving and the artifact of an MSC model
    base = ["group", "final-group", "--input", str(images), "--batch", "2",
            "--raw-output", "--results-root", results, "--device", "cpu"]
    for flag, form in (("--quant8-static", "static"), ("--quant8", True)):
        out_dir = tmp_path / f"labels{flag}"
        rec = serve.main([*base, flag, "--calib-images", "1", "--output",
                          str(out_dir)])
        assert rec["quant8"] == form and rec["images"] == 2
        q = np.load(out_dir / "img_0.npy")
        assert q.shape == (40, 52) and q.max() < 21
    got = eval_valid_multiscale.main(
        ["group", "final-group", "2", "pascal", "--quant8-static",
         "--calib-images", "1", "--device", "cpu", "--data-root", root,
         "--results-root", results])
    assert 0.0 <= got["pixel_accuracy"] <= 1.0
    assert os.path.exists(os.path.join(grun, "evaluation",
                                       "final-group-quant8static",
                                       "iou_scores.json"))
    # the artifact takes one input size: the val images' own
    rec = serve.main([*base, "--export", str(tmp_path / "artifact")])
    assert rec["input"] == [2, 40, 52, 3]
    rec = serve.main(["--artifact", str(tmp_path / "artifact"), "--input",
                      str(images), "--output", str(tmp_path / "art_labels"),
                      "--raw-output", "--device", "cpu"])
    assert rec["images"] == 2
    for i in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / "art_labels" / f"img_{i}.npy"),
            np.load(tmp_path / "labels" / f"img_{i}.npy"))


def test_pascal_run_pruning_cli(pascal, proto_run):
    root, results = pascal
    # Pascal's train images differ in size: one a batch, as in the JAX
    # package, whose push loader stacks a batch too
    pruned = run_pruning.main(["scaleproto_pascal", "proto", "--k", "3",
                               "--prune-threshold", "1",
                               "--push-batch-size", "1", "--device", "cpu",
                               "--data-root", root, "--results-root",
                               results])
    sd, meta = load_checkpoint(pruned["pruned"])
    assert meta["extra"]["kept"] == [int(i) for i in pruned["kept"]]
    assert sd["prototype_vectors"].shape[0] == len(pruned["kept"])
    model, _ = load_model(os.path.join(results, "proto"),
                          pruned["alias"] + ".pth", device="cpu")
    assert model.msc_scales == (0.5, 0.75)


def test_pascal_baseline_cli(pascal):
    root, results = pascal
    out = train_wandb.main(_argv("baseline_pascal", "base", root, results,
                                 BASELINE))
    assert sorted(out["phases"]) == [0, 1, 2]
    model, spec = load_model(os.path.join(results, "base"),
                             out["final"] + ".pth", device="cpu")
    assert spec.num_scales == 1 and spec.num_classes == 21
    assert model.msc_scales == (0.5, 0.75)
    assert model.features.base.aspp.mode == "sum"
