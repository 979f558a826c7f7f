"""Test-split inference and the benchmark server's PNG export.

    python -m scaleprotoseg_torch.eval_test MODEL_NAME PHASE [batch_size] \\
        [--pascal] [--margin M] [--limit N] [--data-root DIR] \\
        [--results-root DIR] [--fp32] [--device cuda|cpu]

The port of the JAX package's ``eval_test.py``: the run's checkpoint of
PHASE over ``img_with_margin_{M}/test/*.npy``, each image's train ids
mapped back to the source dataset's label ids (``train_id_to_source_lut``:
Cityscapes train id -> category name -> official id; Pascal the inverse of
its +1 shift) and saved as an 8-bit gray PNG,
``<run>/evaluation/test/<PHASE>/<name>.png``, without PIL
(``scaleprotoseg_torch.imageio``).  Images of one shape are batched,
``batch_size`` at a time; a chunk of mixed shapes runs one image at a time.

On the card (the default) the forward runs in bf16 with K2 and K1 and the
labels come from K3, the fused upsample + argmax; ``--fp32`` runs the
float32 forward (TF32 off, no K2 or K1), still through K3.  ``--device
cpu`` runs the float32 plain path with the JAX package's bilinear upsample
(``ops.resize.resize_bilinear``) and a first-maximum argmax.  Pascal
(``--pascal``, its data root ``DATA_PATH_PASCAL``) resizes each normalized
image to 513 x 513 as cv2's ``INTER_LINEAR`` does
(``eval_valid_multiscale.resize_pascal``) and upsamples the labels to the
image's own size.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from scaleprotoseg_torch import settings
from scaleprotoseg_torch.constants import (CITYSCAPES_19_EVAL_CATEGORIES,
                                           CITYSCAPES_CATEGORIES,
                                           CITYSCAPES_ID_2_LABEL,
                                           IMAGENET_MEAN, IMAGENET_STD,
                                           PASCAL_ID_MAPPING)
from scaleprotoseg_torch.imageio import save_gray
from scaleprotoseg_torch.kernels.upsample import fused_upsample_argmax
from scaleprotoseg_torch.model_loading import (load_model, resolve_checkpoint,
                                               resolve_device)
from scaleprotoseg_torch.eval_valid_multiscale import resize_pascal
from scaleprotoseg_torch.ops.resize import resize_bilinear
from scaleprotoseg_torch.train.metrics import create_logger


def train_id_to_source_lut(pascal: bool = False) -> np.ndarray:
    """(256,) int64 LUT over (1 + train id) -> source label id: the
    Cityscapes label id (index 0, void, maps to the last void id) or the
    Pascal id (index 0 to 255, void)."""
    lut = np.zeros(256, np.int64)
    if pascal:
        for k, v in PASCAL_ID_MAPPING.items():
            lut[v] = k
        return lut
    ours2source = {v: k for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items()}
    ours2source[0] = 0
    rev = {v: k for k, v in CITYSCAPES_ID_2_LABEL.items()}
    for k, v in ours2source.items():
        lut[k] = rev[CITYSCAPES_CATEGORIES[v]]
    return lut


def make_predict(model, fast: bool, exact_output: bool):
    """``predict(x (B, H, W, 3) normalized float32, h, w) -> (B, h, w)``
    train ids on the host."""
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def predict(x: np.ndarray, h: int, w: int) -> np.ndarray:
        xt = torch.from_numpy(x).to(dev)
        if fast:
            # float32 in, as the JAX package feeds its bf16 model: the
            # first conv rounds it, and the MSC pyramid resizes it first
            logits = model.fast_logits(xt)
        else:
            logits = model(xt).logits
        if exact_output:
            labels = resize_bilinear(logits, h, w).argmax(dim=-1)
        else:
            labels = fused_upsample_argmax(logits, h, w)
        return labels.cpu().numpy()

    return predict


def run_evaluation(model_name: str, training_phase: str,
                   batch_size: int = 2, pascal: bool = False,
                   margin: int = 0, limit: Optional[int] = None,
                   data_root: Optional[str] = None,
                   results_root: Optional[str] = None, fp32: bool = False,
                   device=None) -> str:
    """Export the test split's predictions; returns the output directory."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_path = os.path.join(results_root or settings.results_dir(),
                              model_name)
    checkpoint = resolve_checkpoint(model_path, training_phase)
    out_dir = os.path.join(model_path, "evaluation", "test", training_phase)
    os.makedirs(out_dir, exist_ok=True)
    log = create_logger(os.path.join(out_dir, "eval.log"))
    log(f"Loading model from {checkpoint}")
    fast = dev.type == "cuda" and not fp32
    model, _ = load_model(
        model_path, checkpoint,
        dtype=torch.bfloat16 if fast else torch.float32, fast=fast,
        device=dev)
    predict = make_predict(model, fast, exact_output=dev.type != "cuda")

    data_type = "pascal" if pascal else "cityscapes"
    img_dir = os.path.join(data_root or settings.data_path(data_type),
                           f"img_with_margin_{margin}", "test")
    files = sorted(p[:-4] for p in os.listdir(img_dir) if p.endswith(".npy"))
    if limit:
        files = files[:limit]
    lut = train_id_to_source_lut(pascal)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    for start in range(0, len(files), batch_size):
        chunk = files[start:start + batch_size]
        imgs, shapes = [], []
        for name in chunk:
            img = np.load(os.path.join(img_dir, name + ".npy")) \
                .astype(np.uint8)
            if margin:
                img = img[margin:-margin, margin:-margin]
            shapes.append(img.shape[:2])
            x = (img.astype(np.float32) / 255.0 - mean) / std
            imgs.append(resize_pascal(x) if pascal else x)
        if len(set(shapes)) > 1:
            batches = [([im], [sh], [nm]) for im, sh, nm in
                       zip(imgs, shapes, chunk)]
        else:
            batches = [(imgs, shapes, chunk)]
        for bimgs, bshapes, bnames in batches:
            h, w = bshapes[0]
            pred = predict(np.stack(bimgs), h, w)
            for i, name in enumerate(bnames):
                save_gray(os.path.join(out_dir, f"{name}.png"),
                          lut[pred[i].astype(np.int64) + 1].astype(np.uint8))
    log(f"Saved {len(files)} test predictions to {out_dir}")
    return out_dir


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name")
    p.add_argument("training_phase")
    p.add_argument("batch_size", nargs="?", type=int, default=2)
    p.add_argument("--pascal", action="store_true",
                   help="Pascal VOC-2012's export: 513 x 513 input, Pascal "
                   "label ids")
    p.add_argument("--margin", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--results-root", default=None,
                   help="override the settings' results directory")
    p.add_argument("--fp32", action="store_true",
                   help="the float32 forward without K2 and K1")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda, an error without one; "
                   "'cpu' runs the float32 plain path)")
    a = p.parse_args(argv)
    return run_evaluation(a.model_name, a.training_phase, a.batch_size,
                          pascal=a.pascal, margin=a.margin, limit=a.limit,
                          data_root=a.data_root, results_root=a.results_root,
                          fp32=a.fp32, device=a.device)


if __name__ == "__main__":
    main()
