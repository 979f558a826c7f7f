"""Shared helpers of the interpretability analysis CLIs.

The port of the JAX package's ``analysis/common.py``.  The model is loaded
by ``model_loading.load_model`` in float32 without the kernel path, as the
JAX package's analysis loads it, and runs on the device the CLI names
(``cuda`` unless ``--device`` says otherwise).  Every forward of the
analysis (``make_distance_fn``, ``make_forward_fn``) runs under
``float32_precision``: TF32 off for cuDNN's convolutions and for
matmuls, the caller's setting back after it, as push's
``float32_forward`` does; cuDNN would otherwise take TF32 for a float32
conv.  Images are normalized on
that device with the JAX package's float64 arithmetic, so the forward sees
the same input bits.  The per-map work (activations, quantile masks) takes
tensors on any device; ``quantile_map`` is the numpy form the plain part
pass and the tests use.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scaleprotoseg_torch import settings
from scaleprotoseg_torch.constants import (
    CITYSCAPES_19_EVAL_CATEGORIES, CITYSCAPES_CATEGORIES, IMAGENET_MEAN,
    IMAGENET_STD, MAX_PARTS_CITY, MAX_PARTS_PASCAL, PASCAL_CATEGORIES,
    PASCAL_FILTER_CLASS, PASCAL_ID_MAPPING, convert_targets)
from scaleprotoseg_torch.model_loading import (load_model, resolve_checkpoint,
                                               resolve_device)


def quantile_map(act_map: np.ndarray, quantile: float) -> np.ndarray:
    """Per-map quantile threshold -> binary mask, (H, W) or (1, H, W) in,
    (H, W, 1) int32 out: 1 where the map is strictly above its
    ``np.quantile`` (linear) over every pixel."""
    act = np.asarray(act_map)
    if act.ndim == 3:
        act = act[0]
    thr = np.quantile(act, quantile)
    return (act > thr).astype(np.int32)[..., None]


def quantile_rows(x: torch.Tensor, quantile: float,
                  n: Optional[int] = None) -> torch.Tensor:
    """(k, m) float32 -> (k,) float32: ``np.quantile(row, quantile)`` of
    each row, bit for bit, where a row is ``x``'s m values and ``n - m``
    zeros (``n`` defaults to m): a class's masked map given by the class's
    pixels alone.  numpy takes the virtual index ``(n - 1) * q`` and its
    fraction in float32 (``q`` in the array's dtype) and interpolates the
    two order statistics around it in float32, from the upper one where
    the fraction is at least 0.5."""
    m = x.shape[-1]
    n = m if n is None else n
    q = np.float32(quantile)
    v = np.float32(np.float32(n - 1) * q)
    lo = n - 1 if v >= n - 1 else int(np.floor(v))
    hi = min(lo + 1, n - 1)
    gamma = np.float32(v - np.float32(lo)) if v < n - 1 else np.float32(0)
    s = torch.sort(x, dim=-1).values
    below = (s < 0).sum(-1, keepdim=True)               # before the zeros
    zeros = (s == 0).sum(-1, keepdim=True) + (n - m)

    def stat(j: int) -> torch.Tensor:
        """The j-th smallest of each row's n values."""
        k = torch.where(j < below, j, j - (n - m)).clamp(0, max(m - 1, 0))
        got = s.gather(-1, k)[:, 0] if m else torch.zeros(
            x.shape[0], dtype=x.dtype, device=x.device)
        in_zeros = ((j >= below) & (j < below + zeros))[:, 0]
        return torch.where(in_zeros, torch.zeros_like(got), got)

    a = stat(lo)
    b = a if hi == lo else stat(hi)
    diff = b - a
    if gamma >= 0.5:
        return b - diff * float(np.float32(1) - gamma)
    return a + diff * float(gamma)


def quantile_masks(maps: torch.Tensor, quantile: float) -> torch.Tensor:
    """(k, ...) maps -> (k, ...) bool: each map strictly above its own
    quantile (``quantile_map`` of each map, on the maps' device)."""
    flat = maps.reshape(maps.shape[0], -1)
    thr = quantile_rows(flat, quantile)
    return (flat > thr[:, None]).reshape(maps.shape)


def pair_ious(masks: torch.Tensor) -> np.ndarray:
    """(k, ...) bool masks -> (k, k) float64 IoUs (0 where the union is
    empty), from the intersections as one product of the flattened masks:
    float32 sums of 0 / 1 are exact below 2^24 pixels a map."""
    flat = masks.reshape(masks.shape[0], -1).float()
    if flat.shape[1] >= 2 ** 24:
        raise ValueError("pair_ious: a map of 2^24 pixels or more")
    inter = (flat @ flat.t()).cpu().numpy().astype(np.int64)
    size = np.diag(inter)
    union = size[:, None] + size[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def dataset_meta(data_type: str):
    """(cls2name, max_parts, filter_class) of a dataset: the train id's
    name, the largest part id counted and the class ids left out."""
    if data_type == "cityscapes":
        pred2name = {v - 1: k for k, v in
                     CITYSCAPES_19_EVAL_CATEGORIES.items() if v > 0}
        cls2name = {i: CITYSCAPES_CATEGORIES[k]
                    for i, k in pred2name.items()}
        return cls2name, MAX_PARTS_CITY, []
    if data_type == "pascal":
        pred2name = {v - 1: k for k, v in PASCAL_ID_MAPPING.items()
                     if v > 0}
        cls2name = {i: PASCAL_CATEGORIES[k + 1]
                    for i, k in pred2name.items()
                    if k < len(PASCAL_CATEGORIES) - 1}
        return cls2name, MAX_PARTS_PASCAL, PASCAL_FILTER_CLASS
    # any other dataset with annotations_PIDS: class names are the ids
    cls2name = {i: str(i) for i in range(256)}
    return cls2name, MAX_PARTS_CITY, []


def load_eval_model(model_name: str, training_phase: str,
                    results_root: Optional[str] = None,
                    device: Optional[str] = None):
    """(model in float32 on the device, spec, run directory, device)."""
    dev = resolve_device(device)
    model_path = os.path.join(results_root or settings.results_dir(),
                              model_name)
    ckpt = resolve_checkpoint(model_path, training_phase)
    model, spec = load_model(model_path, ckpt, dtype=torch.float32,
                             fast=False, device=dev)
    return model, spec, model_path, dev


def normalize_image(img, device=None) -> torch.Tensor:
    """uint8 (H, W, 3) -> float32 (H, W, 3) on ``device``: ``x / 255`` in
    float32, then ``(x - mean) / std`` in float64, as the JAX package
    computes it on the host."""
    x = torch.as_tensor(np.asarray(img), device=device).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float64, device=x.device)
    return ((x.double() - mean) / std).float()


def load_image(img_dir: str, img_id: str, device) -> Tuple[np.ndarray,
                                                          torch.Tensor]:
    """(the uint8 image, its normalized tensor on ``device``)."""
    img = np.load(os.path.join(img_dir, img_id + ".npy"))
    return img, normalize_image(img, device)


@contextlib.contextmanager
def float32_precision():
    """TF32 off for matmuls and cuDNN convolutions inside the block; the
    caller's two settings back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def make_distance_fn(model):
    """(H, W, 3) normalized image -> (H', W', P) distances of the fused
    map (``PPNet.push_forward``), P = ``num_active_prototypes``; in
    float32 without TF32."""

    @torch.no_grad()
    def distances(x: torch.Tensor) -> torch.Tensor:
        with float32_precision():
            return model.push_forward(x[None])[1][0]

    return distances


def make_forward_fn(model):
    """(H, W, 3) normalized image -> the model's eval output of batch 1;
    in float32 without TF32."""

    @torch.no_grad()
    def forward(x: torch.Tensor):
        with float32_precision():
            return model(x[None], train=False)

    return forward


def activation_from_distance(d: torch.Tensor, epsilon: float = 1e-4
                             ) -> torch.Tensor:
    return torch.log((d + 1.0) / (d + epsilon))


def activation_from_distance_np(d: np.ndarray, epsilon: float = 1e-4
                                ) -> np.ndarray:
    return np.log((d + 1.0) / (d + epsilon))


def class_protos(spec, c: int) -> np.ndarray:
    """Prototype ids of class ``c``."""
    return np.nonzero(spec.class_identity[:, c])[0]


def proto_filter(group_state: Dict, spec) -> List[int]:
    """Prototype ids the grouping uses: a nonzero column sum in the
    class's group projection.  ``group_state`` is a grouped checkpoint's
    state dict (``group_projection.{k}.weight``, (G, Pc), for the k-th
    class with prototypes)."""
    out = []
    for k, c in enumerate(spec.nonempty_classes):
        w = np.asarray(group_state[f"group_projection.{k}.weight"])
        col_sums = w.sum(axis=0)
        for j, p in enumerate(class_protos(spec, c)):
            if col_sums[j] != 0:
                out.append(int(p))
    return out


def val_image_ids(data_type: str, data_root: Optional[str] = None
                  ) -> Tuple[str, str, List[str]]:
    """(img_dir, ann_dir, ids) of the val split."""
    root = data_root or settings.data_path(data_type)
    img_dir = os.path.join(root, "img_with_margin_0", "val")
    ann_dir = os.path.join(root, "annotations", "val")
    with open(os.path.join(root, "all_images.json")) as f:
        ids = json.load(f)["val"]
    return img_dir, ann_dir, ids


def sample_ids(ids: List[str], n_images: int) -> List[str]:
    """The images the sampling scripts take: numpy's
    ``default_rng(0).choice(ids, min(n, len(ids)), replace=False)``."""
    rng = np.random.default_rng(0)
    return [str(i) for i in rng.choice(ids, min(n_images, len(ids)),
                                       replace=False)]


def load_label(ann_dir: str, img_id: str, data_type: str) -> np.ndarray:
    """The converted (H, W) class annotation (0 = void) as int64."""
    ann = np.load(os.path.join(ann_dir, img_id + ".npy"))
    if ann.ndim == 3:
        ann = ann[..., 0]
    return convert_targets(ann, data_type).astype(np.int64)


def output_dir(model_path: str, script: str, training_phase: str) -> str:
    out = os.path.join(model_path, "analysis", script, training_phase)
    os.makedirs(out, exist_ok=True)
    return out


def add_cli_args(p, data_type: bool = True) -> None:
    """The positional arguments every analysis CLI shares, and
    ``--device``."""
    p.add_argument("model_name")
    p.add_argument("training_phase")
    if data_type:
        p.add_argument("data_type")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda, an error without one)")
