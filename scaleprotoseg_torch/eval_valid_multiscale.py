"""Validation-set evaluation (multi-scale and grouped models).

    python -m scaleprotoseg_torch.eval_valid_multiscale MODEL_NAME PHASE \\
        [batch_size] [data_type] [--quant8-static | --quant8] \\
        [--calib-images N] [--fast-output | --exact-output] [--fp32] \\
        [--shape-multiple N] [--limit N] [--data-root DIR] \\
        [--results-root DIR] [--device cpu]

The port's counterpart of ``scaleprotoseg_tpu/eval_valid_multiscale.py``:
loads the run's checkpoint, runs full-image inference over the raw val
``.npy`` files (Cityscapes, COCO-Stuff, EM; Pascal VOC-2012 resized to
513 x 513 after normalization, as cv2's ``INTER_LINEAR`` resizes it:
``ops.resize.resize_linear_cv2``; ADE20K resized the same way to a short
side of 512, ``ade_eval_shape``), upsamples the logits to label
resolution, and accumulates mIoU and pixel accuracy ignoring void,
with the top-K prototype purity curve over the whole split.  Writes
``evaluation/<phase>[-quant8static|-quant8]/{iou_scores.json,
mean_iou.txt, eval.log, proto_purity.json}``; the sample renders
``samples/<name>.png`` of the first 5 files (input | ground truth |
prediction at the model's output grid, the label panels coloured by
``imageio.tab20_bytes``, written without matplotlib); and, where
matplotlib is importable, the plots: per-class IoU, the purity curve and
``proto_distance_hist.png``, the histogram of same-class prototype
squared distances (computed on the model's device).  A failure of these
artifacts is logged; the result stays.

On the card (the default) the forward runs in bf16 with K2 and the
output through K3 (``--exact-output``: the gather-form resize instead;
``--fp32``: the float32 forward without K2); ``--device cpu`` runs the
float32 plain path.  Quantized evaluations get their own directory, so
the mIoU difference to the unquantized one is the accuracy cost of int8:
``--quant8-static`` calibrates on the first ``--calib-images`` val images
(float32, one per batch); ``--quant8`` (dynamic) forces the non-K3
output path.  Images are batched only while both the image's and the
annotation's shapes repeat, so a Pascal or ADE split runs mostly at
batch 1.  ADE's short-side-512 sizes are rounded to ``--shape-multiple``
(64 by default, as in the JAX package; 0 keeps the exact size of the
reference's protocol).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from scaleprotoseg_torch import settings
from scaleprotoseg_torch.constants import (ADE20k_ID_2_LABEL,
                                           CITYSCAPES_19_EVAL_CATEGORIES,
                                           CITYSCAPES_19_LUT,
                                           CITYSCAPES_CATEGORIES,
                                           COCO_ID_2_LABEL, EM_ID_2_LABEL,
                                           IMAGENET_MEAN, IMAGENET_STD,
                                           PASCAL_CATEGORIES,
                                           PASCAL_ID_MAPPING, PASCAL_LUT)
from scaleprotoseg_torch.eval.miou import SegEvaluator
from scaleprotoseg_torch.imageio import tab20_bytes, write_png
from scaleprotoseg_torch.model_loading import (calibrate_quant_scales,
                                               load_model, resolve_checkpoint,
                                               resolve_device)
from scaleprotoseg_torch.ops.resize import (resize_label_nearest_np,
                                            resize_linear_cv2)
from scaleprotoseg_torch.train.metrics import create_logger

FULL_IMAGE = ("cityscapes", "coco", "em")
PROTOCOLS = FULL_IMAGE + ("pascal", "ade")
PASCAL_SIZE = 513      # Pascal's eval input, both sides
ADE_SHORT_SIDE = 512   # ADE's eval input, the short side
ADE_SHAPE_MULTIPLE = 64


def class_names(data_type: str, num_classes: int) -> List[str]:
    if data_type == "cityscapes":
        inv = {v - 1: k for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items()
               if v > 0}
        return [CITYSCAPES_CATEGORIES[inv[i]] for i in range(num_classes)]
    if data_type == "pascal":
        inv = {v - 1: k for k, v in PASCAL_ID_MAPPING.items() if v > 0}
        return [PASCAL_CATEGORIES[inv[i] + 1] if inv[i] + 1 <
                len(PASCAL_CATEGORIES) else str(i)
                for i in range(num_classes)]
    if data_type == "ade":
        return [ADE20k_ID_2_LABEL[i] for i in range(num_classes)]
    if data_type == "em":
        return [EM_ID_2_LABEL[i] for i in range(num_classes)]
    if data_type == "coco":
        return [COCO_ID_2_LABEL[i] for i in range(num_classes)]
    return [str(i) for i in range(num_classes)]


def _check_protocol(data_type: str) -> None:
    if data_type not in PROTOCOLS:
        raise ValueError(f"unknown data type {data_type!r}")


def eval_targets(ann: np.ndarray, data_type: str) -> np.ndarray:
    """Stored annotation -> labels (0 = void): Cityscapes and Pascal
    convert their stored ids online, COCO-Stuff and EM ids are already
    final."""
    if ann.ndim == 3:
        ann = ann[..., 0]
    if data_type == "cityscapes":
        ann = CITYSCAPES_19_LUT[ann]
    elif data_type == "pascal":
        ann = PASCAL_LUT[ann]
    return ann.astype(np.int32)


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> ``(x / 255 - mean) / std``, the constants taken in
    float64 and the result cast to float32, as the JAX package's eval."""
    x = img.astype(np.float32) / 255.0
    x = (x - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    return x.astype(np.float32)


def ade_eval_shape(h: int, w: int, shape_multiple: Optional[int] = None
                   ) -> Tuple[int, int]:
    """ADE's eval input size (th, tw) of an h x w image: the short side
    scaled to 512 with the aspect kept (Python ``round`` on both sides),
    then, where ``shape_multiple`` is given, each side rounded to a
    multiple of it, at least one multiple.  The JAX package's arithmetic."""
    s = ADE_SHORT_SIDE / min(h, w)
    tw, th = int(round(w * s)), int(round(h * s))
    if shape_multiple:
        tw = max(shape_multiple, round(tw / shape_multiple) * shape_multiple)
        th = max(shape_multiple, round(th / shape_multiple) * shape_multiple)
    return th, tw


def resize_normalized(x: np.ndarray, height: int, width: int) -> np.ndarray:
    """A normalized (H, W, 3) float32 image -> (height, width, 3), as
    ``cv2.resize(..., INTER_LINEAR)`` resizes float32."""
    chw = torch.from_numpy(x).permute(2, 0, 1)
    return resize_linear_cv2(chw, height, width).permute(
        1, 2, 0).contiguous().numpy()


def resize_pascal(x: np.ndarray) -> np.ndarray:
    """Pascal's eval and test input: ``resize_normalized`` to 513 x 513."""
    return resize_normalized(x, PASCAL_SIZE, PASCAL_SIZE)


def prepare_image(img: np.ndarray, data_type: str,
                  shape_multiple: Optional[int] = None) -> np.ndarray:
    """The model's input of a uint8 RGB val image: ``normalize``d, for
    Pascal ``resize_pascal``d and for ADE resized to ``ade_eval_shape(h,
    w, shape_multiple)`` (the JAX package resizes the normalized image in
    float64 and casts the result: the two differ by float32 rounding)."""
    x = normalize(img)
    if data_type == "pascal":
        return resize_pascal(x)
    if data_type == "ade":
        return resize_normalized(x, *ade_eval_shape(*x.shape[:2],
                                                    shape_multiple))
    return x


def run_evaluation(model_name: str, training_phase: str,
                   batch_size: int = 2, data_type: str = "cityscapes",
                   margin: int = 0, limit: Optional[int] = None,
                   data_root: Optional[str] = None,
                   results_root: Optional[str] = None,
                   fast_output: Optional[bool] = None,
                   quant8=False, calib_images: int = 8,
                   fp32: bool = False, shape_multiple: Optional[int] = None,
                   device=None) -> dict:
    """Evaluate one checkpoint over the val split; returns the result
    dict (``mean_iou``, ``pixel_accuracy``, ``per_class_iou``, the purity
    curve) and writes the evaluation directory.  ``shape_multiple`` (ADE
    only): None takes ``ADE_SHAPE_MULTIPLE``, 0 the exact short-side-512
    size."""
    _check_protocol(data_type)
    if shape_multiple is None and data_type == "ade":
        shape_multiple = ADE_SHAPE_MULTIPLE
    shape_multiple = shape_multiple or None
    dev = resolve_device(device)
    model_path = os.path.join(results_root or settings.results_dir(),
                              model_name)
    checkpoint = resolve_checkpoint(model_path, training_phase)
    eval_name = training_phase + (
        "-quant8static" if quant8 == "static" else
        "-quant8" if quant8 else "")
    out_dir = os.path.join(model_path, "evaluation", eval_name)
    os.makedirs(out_dir, exist_ok=True)
    log = create_logger(os.path.join(out_dir, "eval.log"))
    log(f"Loading model from {checkpoint}")

    fast = dev.type == "cuda" and not fp32
    dtype = torch.bfloat16 if fast else torch.float32
    model, spec = load_model(model_path, checkpoint, dtype=dtype, fast=fast,
                             device=dev, quant8=quant8)
    if fast_output is None:
        fast_output = dev.type == "cuda"
    if quant8 is True and fast_output:
        log("dynamic quant8: the output takes the resize + argmax path, "
            "not K3 (as the JAX package's dynamic quant8)")
        fast_output = False

    dataset_path = data_root or settings.data_path(data_type)
    img_dir = os.path.join(dataset_path, f"img_with_margin_{margin}", "val")
    ann_dir = os.path.join(dataset_path, "annotations", "val")
    files = sorted(p[:-4] for p in os.listdir(img_dir) if p.endswith(".npy"))
    if limit:
        files = files[:limit]
    log(f"Evaluating {len(files)} val images ({data_type}) on {dev}")

    def load_one(name):
        img = np.load(os.path.join(img_dir, name + ".npy"))
        if margin:
            img = img[margin:-margin, margin:-margin]
        ann = np.load(os.path.join(ann_dir, name + ".npy"))
        return (prepare_image(img, data_type, shape_multiple),
                eval_targets(ann, data_type))

    if quant8 == "static":
        calib = (torch.from_numpy(load_one(n)[0][None]).to(dev)
                 for n in files[:max(1, calib_images)])
        calibrate_quant_scales(model, calib, log=log)

    evaluator = SegEvaluator(
        model, spec.num_classes, fast_output=fast_output,
        proto_class=np.argmax(
            spec.class_identity[:spec.num_active_prototypes], axis=1))
    pending_imgs, pending_anns, pending_shape = [], [], None

    def flush():
        nonlocal pending_imgs, pending_anns
        if pending_imgs:
            evaluator.update(torch.from_numpy(np.stack(pending_imgs)),
                             torch.from_numpy(np.stack(pending_anns)))
            pending_imgs, pending_anns = [], []

    # a bounded prefetch of the disk loads overlaps the device work
    with ThreadPoolExecutor(max_workers=2) as pool:
        it = iter(files)
        window = deque(pool.submit(load_one, n) for _, n in zip(range(4), it))
        while window:
            x, ann = window.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                window.append(pool.submit(load_one, nxt))
            if pending_shape not in (None, (x.shape, ann.shape)) or \
                    len(pending_imgs) >= batch_size:
                flush()
            pending_shape = (x.shape, ann.shape)
            pending_imgs.append(x)
            pending_anns.append(ann)
    flush()
    try:
        _save_sample_artifacts(model, files, img_dir, ann_dir, data_type,
                               margin, out_dir, dtype, shape_multiple)
    except Exception as e:  # the renders are best-effort artifacts
        log(f"eval sample artifacts skipped: {e!r}")

    result = evaluator.result()
    # the scores first: a plot failure must never lose the result
    names = class_names(data_type, spec.num_classes)
    iou_scores = {names[i]: result["per_class_iou"][i]
                  for i in range(spec.num_classes)}
    with open(os.path.join(out_dir, "iou_scores.json"), "w") as f:
        json.dump(iou_scores, f, indent=2)
    with open(os.path.join(out_dir, "mean_iou.txt"), "w") as f:
        f.write(f"{result['mean_iou']}\n")
    if "top_k_purity_percent" in result:
        with open(os.path.join(out_dir, "proto_purity.json"), "w") as f:
            json.dump({"top_k_purity_percent": result["top_k_purity_percent"],
                       "n_images": int(result["purity_images"])}, f, indent=2)
        log(f"top-1 prototype purity over {result['purity_images']} "
            f"images: {result['top_k_purity_percent'][0]:.2f}%")
    try:
        dists = same_class_distances(model.prototypes().detach(), spec)
        _save_plots(out_dir, iou_scores, result.get("top_k_purity_percent"),
                    dists.cpu().numpy())
    except Exception as e:  # the plots are best-effort artifacts
        log(f"eval plot artifacts skipped: {e!r}")
    log(f"mean IoU: {result['mean_iou']:.4f}  "
        f"pixel acc: {result['pixel_accuracy']:.4f}")
    return result


def same_class_distances(prototypes: torch.Tensor, spec) -> torch.Tensor:
    """Squared L2 distances between the prototypes of each class, every
    pair once (classes in order, pairs in ``np.triu_indices`` order), on
    the prototypes' device: the numbers behind the JAX package's
    ``proto_distance_hist.png``."""
    p = prototypes.float()
    identity = torch.as_tensor(spec.class_identity, device=p.device)
    out = [p.new_zeros(0)]
    for c in range(spec.num_classes):
        idx = torch.nonzero(identity[:, c]).flatten()
        if len(idx) < 2:
            continue
        pc = p[idx]
        d = ((pc[:, None] - pc[None]) ** 2).sum(-1)
        i, j = torch.triu_indices(len(idx), len(idx), 1, device=p.device)
        out.append(d[i, j])
    return torch.cat(out)


def render_sample(image: np.ndarray, target: np.ndarray,
                  pred: np.ndarray, gap: int = 8) -> np.ndarray:
    """uint8 RGB: the input image, the target labels and the predicted
    labels side by side, top-aligned on white, ``gap`` pixels apart; each
    label panel coloured by ``tab20_bytes`` (matplotlib's tab20 over that
    panel's own minimum and maximum)."""
    panels = [np.asarray(image)[..., :3].astype(np.uint8),
              tab20_bytes(torch.as_tensor(target)),
              tab20_bytes(torch.as_tensor(pred))]
    height = max(q.shape[0] for q in panels)
    width = sum(q.shape[1] for q in panels) + gap * (len(panels) - 1)
    out = np.full((height, width, 3), 255, np.uint8)
    x0 = 0
    for q in panels:
        out[:q.shape[0], x0:x0 + q.shape[1]] = q
        x0 += q.shape[1] + gap
    return out


def _save_sample_artifacts(model, files, img_dir: str, ann_dir: str,
                           data_type: str, margin: int, out_dir: str,
                           dtype: torch.dtype,
                           shape_multiple: Optional[int] = None,
                           n_samples: int = 5) -> None:
    """``samples/<name>.png`` of the first ``n_samples`` files: input |
    ground truth (nearest-resized to the output grid, 0 = void) |
    prediction + 1, the JAX package's three panels."""
    sample_dir = os.path.join(out_dir, "samples")
    os.makedirs(sample_dir, exist_ok=True)
    dev = next(model.parameters()).device
    for name in files[:n_samples]:
        img = np.load(os.path.join(img_dir, name + ".npy"))
        if margin:
            img = img[margin:-margin, margin:-margin]
        ann = eval_targets(np.load(os.path.join(ann_dir, name + ".npy")),
                           data_type).astype(np.int64)
        x = torch.from_numpy(prepare_image(img, data_type, shape_multiple))[
            None].to(dev, dtype)
        with torch.inference_mode():
            pred = model(x).logits[0].argmax(-1).cpu().numpy()
        target = resize_label_nearest_np(ann, (pred.shape[1], pred.shape[0]))
        write_png(os.path.join(sample_dir, f"{name}.png"),
                  render_sample(img, target, pred + 1))


def _save_plots(out_dir: str, iou_scores: dict, curve,
                dists: np.ndarray) -> None:
    """The per-class IoU bar chart, the top-K purity plot and the
    same-class prototype distance histogram, where matplotlib is
    importable."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(max(6, len(iou_scores) * 0.4), 4))
    ax.bar(list(iou_scores), list(iou_scores.values()))
    ax.set_ylabel("IoU")
    plt.xticks(rotation=90)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "iou_per_class.png"), dpi=120)
    plt.close(fig)
    if curve is not None:
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.plot(curve)
        ax.set_xlabel("Nearest K prototypes to a pixel")
        ax.set_ylabel("% of K prototypes from pixel class")
        ax.set_ylim(0, 100)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir,
                                 "class_prototypes_in_nearest_k.png"),
                    dpi=110)
        plt.close(fig)
    if len(dists):
        fig, ax = plt.subplots()
        ax.hist(dists.tolist(), bins=50)
        ax.set_xlabel("same-class prototype squared L2 distance")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "proto_distance_hist.png"),
                    dpi=120)
        plt.close(fig)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name")
    p.add_argument("training_phase")
    p.add_argument("batch_size", nargs="?", type=int, default=2)
    p.add_argument("data_type", nargs="?", default="cityscapes")
    p.add_argument("--margin", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--results-root", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the float32 "
                   "plain path)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--fast-output", dest="fast_output", action="store_true",
                   default=None,
                   help="labels through K3, the fused upsample + argmax "
                   "(the default on the card)")
    g.add_argument("--exact-output", dest="fast_output",
                   action="store_false",
                   help="labels through the gather-form bilinear resize, "
                   "the reference's protocol")
    q = p.add_mutually_exclusive_group()
    q.add_argument("--quant8-static", dest="quant8", action="store_const",
                   const="static", default=False,
                   help="static int8 layer4/5, calibrated on the first "
                   "--calib-images val images; results in "
                   "evaluation/<phase>-quant8static")
    q.add_argument("--quant8", dest="quant8", action="store_true",
                   help="dynamic int8 layer4/5 (no K3 output path)")
    p.add_argument("--calib-images", type=int, default=8,
                   help="calibration images for --quant8-static")
    p.add_argument("--fp32", action="store_true",
                   help="the float32 forward without K2")
    p.add_argument("--shape-multiple", type=int, default=None,
                   help="round ADE's short-side-512 eval sizes to this "
                   f"multiple (default {ADE_SHAPE_MULTIPLE} for ade; 0 "
                   "keeps the exact sizes of the reference's protocol)")
    a = p.parse_args(argv)
    return run_evaluation(a.model_name, a.training_phase, a.batch_size,
                          a.data_type, margin=a.margin, limit=a.limit,
                          data_root=a.data_root,
                          results_root=a.results_root,
                          fast_output=a.fast_output, quant8=a.quant8,
                          calib_images=a.calib_images, fp32=a.fp32,
                          shape_multiple=a.shape_multiple, device=a.device)


if __name__ == "__main__":
    main()
