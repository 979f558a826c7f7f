"""Validation-set evaluation of the port against the JAX package's, on the
CPU: ``iou_from_confusion``, ``SegEvaluator``'s confusion matrix and
purity curve on the same logits and distances, the two resizes it uses,
and ``eval_valid_multiscale.run_evaluation`` end to end on one run
directory (float32 on both sides, bf16 and static quant8)."""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scaleprotoseg_torch.eval.miou import SegEvaluator, iou_from_confusion
from scaleprotoseg_torch.ops.resize import bilinear_sample, resize_bilinear

C, P = 5, 12


def test_iou_from_confusion_matches_jax(rng):
    from scaleprotoseg_tpu.eval.miou import iou_from_confusion as jiou
    cm = rng.integers(0, 1000, size=(C, C)).astype(np.float64)
    cm[3] = 0
    cm[:, 3] = 0                       # an unseen class is left out
    for a, b in zip(iou_from_confusion(cm), jiou(cm)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("src,out", [((17, 33), (129, 257)),
                                     ((33, 65), (257, 513))])
def test_resizes_match_jax(rng, src, out):
    """Both within 1e-6 of the JAX package's at output-stride-8 shapes."""
    from scaleprotoseg_tpu.ops import resize as jr
    x = rng.standard_normal((2, *src, 6)).astype(np.float32)
    np.testing.assert_allclose(
        resize_bilinear(torch.from_numpy(x), *out).numpy(),
        np.asarray(jr.resize_bilinear(jnp.asarray(x), *out)),
        atol=1e-6, rtol=0)
    rows = rng.integers(0, out[0], size=(2, 40))
    cols = rng.integers(0, out[1], size=(2, 40))
    np.testing.assert_allclose(
        bilinear_sample(torch.from_numpy(x), torch.from_numpy(rows),
                        torch.from_numpy(cols), *out).numpy(),
        np.asarray(jr.bilinear_sample(jnp.asarray(x), jnp.asarray(rows),
                                      jnp.asarray(cols), *out)),
        atol=1e-6, rtol=0)


class _Fixed(torch.nn.Module):
    """A model whose output is set from outside, per batch."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))
        self.out = None

    def forward(self, images):
        return self.out


class _FixedJax:
    """The JAX side: ``apply`` returns the arrays passed as variables."""

    def apply(self, variables, images, train=False):
        return types.SimpleNamespace(logits=variables["logits"],
                                     distances=variables["distances"])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_seg_evaluator_matches_jax(rng, fast):
    """Two batches of random logits and distances at an output-stride-8
    grid: the confusion matrix equal to JAX's (void excluded), the top-K
    purity curve within 1e-4.  ``fast``: the port's K3 form (its plain
    version here) against JAX's gather-form resize; random logits leave
    no label within reach of their summation-order difference."""
    from scaleprotoseg_tpu.eval.miou import SegEvaluator as JEval
    proto_class = rng.integers(0, C, size=P)
    tm = _Fixed()
    te = SegEvaluator(tm, C, proto_class=proto_class, fast_output=fast)
    je = JEval(_FixedJax(), C, proto_class=proto_class)
    n_valid = 0
    for _ in range(2):
        logits = rng.standard_normal((2, 9, 17, C)).astype(np.float32)
        dist = rng.random((2, 9, 17, P)).astype(np.float32) * 10
        targets = rng.integers(0, C + 1, size=(2, 65, 129)).astype(np.int32)
        n_valid += int((targets > 0).sum())
        images = np.zeros((2, 65, 129, 3), np.float32)
        tm.out = types.SimpleNamespace(logits=torch.from_numpy(logits),
                                       distances=torch.from_numpy(dist))
        te.update(torch.from_numpy(images), torch.from_numpy(targets))
        je.update({"logits": jnp.asarray(logits),
                   "distances": jnp.asarray(dist)}, images, targets)
    np.testing.assert_array_equal(te.cm, je.cm)
    assert te.cm.sum() == n_valid
    got, want = te.result(), je.result()
    assert got["purity_images"] == want["purity_images"] == 4
    np.testing.assert_allclose(got["top_k_purity_percent"],
                               want["top_k_purity_percent"], atol=1e-4)
    assert got["mean_iou"] == want["mean_iou"]


def test_class_names_match_jax():
    from scaleprotoseg_tpu.eval_valid_multiscale import class_names as jnames
    from scaleprotoseg_torch.eval_valid_multiscale import class_names
    for data_type, n in (("cityscapes", 19), ("em", 2), ("coco", 182),
                         ("pascal", 21), ("ade", 150)):
        assert class_names(data_type, n) == jnames(data_type, n)


def test_eval_refuses_cv2_protocols(tmp_path):
    """Both cv2 protocols are ported (Pascal's 513 x 513:
    tests/test_torch_pascal_eval.py; ADE's short side of 512:
    tests/test_torch_ade_cli.py), so none is refused any more; a data type
    the port does not know is refused by name before anything loads."""
    from scaleprotoseg_torch.eval_valid_multiscale import (PROTOCOLS,
                                                           run_evaluation)
    assert {"pascal", "ade"} <= set(PROTOCOLS)
    with pytest.raises(ValueError, match="'ade20k'"):
        run_evaluation("run", "push_final", data_type="ade20k",
                       results_root=str(tmp_path), device="cpu")
    assert not (tmp_path / "run").exists()


H, W = 33, 65
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scaleprotoseg_tpu", "configs",
    "group_scaleproto_cityscapes.gin")


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """A run directory written by the JAX package (full-depth flagship,
    synthetic weights, ``.ckpt`` and the exported ``.pth``) and a
    Cityscapes-layout val root of 3 images whose raw category-index
    labels hold void and every train class."""
    from __graft_entry__ import _flagship, synthetic_init
    from scaleprotoseg_tpu.checkpoints.io import save_checkpoint
    from scaleprotoseg_tpu.constants import CITYSCAPES_19_EVAL_CATEGORIES
    from scaleprotoseg_tpu.convert_checkpoint import export_torch

    root = tmp_path_factory.mktemp("eval")
    run = root / "results" / "city_run"
    model, spec = _flagship(tiny=False, grouped=True, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, H, W, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=2)
    ckpt = str(run / "checkpoints" / "push_final.ckpt")
    save_checkpoint(ckpt, variables["params"], variables["batch_stats"],
                    spec=spec, extra={"variant": "group"})
    export_torch(ckpt, str(run / "checkpoints" / "push_final.pth"))
    shutil.copyfile(CONFIG, run / "config.gin")

    data = root / "city"
    rng = np.random.default_rng(5)
    cats = [0] + [next(k for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items()
                       if v == c) for c in range(1, 20)]
    for sub in ("img_with_margin_0/val", "annotations/val"):
        (data / sub).mkdir(parents=True)
    for i in range(3):
        grid = rng.permutation(cats).reshape(4, 5).astype(np.uint8)
        label = np.repeat(np.repeat(grid, 9, 0), 14, 1)[:H, :W]
        np.save(data / "annotations/val" / f"val_{i}.npy",
                np.ascontiguousarray(label))
        np.save(data / "img_with_margin_0/val" / f"val_{i}.npy",
                rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    return str(root / "results"), str(data)


@pytest.mark.parametrize("quant8", [False, "static"], ids=["fp", "static"])
def test_eval_cli_matches_jax(eval_run, quant8):
    """The port's evaluation (``--device cpu``: float32, exact output)
    against the JAX package's with ``--fp32`` on the same run and val
    root: per-class IoU and pixel accuracy within 1e-3 (labels may flip
    at near-ties of the two float32 forwards); static quant8 calibrates
    on the first 2 images and writes its own directory."""
    from scaleprotoseg_tpu.eval_valid_multiscale import \
        run_evaluation as jrun
    from scaleprotoseg_torch.eval_valid_multiscale import main
    results, data = eval_run
    args = ["city_run", "push_final", "2", "cityscapes", "--device", "cpu",
            "--data-root", data, "--results-root", results,
            "--calib-images", "2"]
    if quant8:
        args.append("--quant8-static")
    got = main(args)
    out = os.path.join(results, "city_run", "evaluation",
                       "push_final-quant8static" if quant8 else "push_final")
    with open(os.path.join(out, "mean_iou.txt")) as f:
        assert float(f.read()) == got["mean_iou"]
    with open(os.path.join(out, "iou_scores.json")) as f:
        assert len(json.load(f)) == 19
    with open(os.path.join(out, "proto_purity.json")) as f:
        assert len(json.load(f)["top_k_purity_percent"]) == 228
    assert os.path.exists(os.path.join(out, "eval.log"))
    assert got["purity_images"] == 3

    want = jrun("city_run", "push_final", batch_size=2, data_root=data,
                results_root=results, fp32=True, quant8=quant8,
                calib_images=2)
    np.testing.assert_allclose(got["per_class_iou"], want["per_class_iou"],
                               atol=1e-3)
    assert abs(got["pixel_accuracy"] - want["pixel_accuracy"]) <= 1e-3
