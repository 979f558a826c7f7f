"""The k nearest training patches of every prototype.

The port of the JAX package's ``find_nearest.py``: one float32 forward per
batch of the fixed-order train split gives every pixel's distance to
every prototype; pixels whose (nearest-resized) label is void are pushed
``VOID_PENALTY`` away; each image's least distance and its pixel per
prototype are padded to bank width (dangling bank rows +inf), and the
batch's ``min(k, B)`` best images per prototype are taken on the device
with a stable sort (the lower image first on a tie, as ``lax.top_k``
orders it).  The host merges a running top-k over the split with the
same numpy calls as the JAX package, so the k nearest come from k
different images.  A second pass fetches only the winners' annotations,
and each patch's label is ``_patch_label``: the prototype's class if any
pixel of the grid cell's region holds it, else the region's most common
value (-1 is void).

``full_save`` writes, per prototype and rank i, ``nearest-{i}_act.npy``
(the log activation), ``nearest-{i}_original.png`` (the de-normalised
image) and ``nearest-{i}_patch.png`` (the grid cell's region), pixel for
pixel as the JAX package writes them, and ``nearest-{i}_bbox.png``.  The
JAX package draws that last one as a matplotlib figure, which needs a
display stack the GPU machine lacks: here it is the port's own rendering,
the image with the cell's rectangle drawn in yellow, 2 pixels wide, at
the same ``h0:h1, w0:w1``, not a pixel copy of the figure.

The scan runs the model's float32 forward with TF32 off and without the
K2 kernels (``push.float32_forward``), as prototype push does.  A device
mesh (``mesh``) waits for the port's scale-out and is refused.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from scaleprotoseg_torch.imageio import imsave_rgb
from scaleprotoseg_torch.ops.prototype import (distance_to_similarity,
                                               pad_minima_to_bank)
from scaleprotoseg_torch.ops.resize import resize_label_nearest
from scaleprotoseg_torch.push.push import float32_forward
from scaleprotoseg_torch.spec import ProtoSpec

VOID_PENALTY = 10e6
_MEAN = np.array([0.485, 0.456, 0.406])
_STD = np.array([0.229, 0.224, 0.225])
_YELLOW = (1.0, 1.0, 0.0)


def _batch_top_k(model, spec: ProtoSpec, k: int, images: torch.Tensor,
                 targets: torch.Tensor):
    """Per prototype over one batch: the ``min(k, B)`` least void-masked
    distances, their rows in the batch and their flat pixel indices, (P,
    min(k, B)) each, on the device; and the distance grid's shape."""
    _, distances = model.push_forward(images)
    h, w = distances.shape[1], distances.shape[2]
    t = resize_label_nearest(targets, h, w).long() - 1
    masked = distances + VOID_PENALTY * (t < 0)[..., None]
    vals, idxs = masked.reshape(masked.shape[0], -1,
                                masked.shape[-1]).min(dim=1)     # (B, Pa)
    vals, idxs = pad_minima_to_bank(vals, idxs, spec)
    kk = min(k, vals.shape[0])
    top, rows = torch.sort(vals.t(), dim=1, stable=True)
    rows = rows[:, :kk]
    return top[:, :kk], rows, idxs.t().gather(1, rows), (h, w)


def _patch_label(ann_minus1: np.ndarray, gi: int, gj: int, grid_h: int,
                 grid_w: int, target_class: int) -> int:
    ih, iw = ann_minus1.shape
    ph, pw = ih / grid_h, iw / grid_w
    h0, h1 = int(gi * ph), int((gi + 1) * ph)
    w0, w1 = int(gj * pw), int((gj + 1) * pw)
    region = ann_minus1[h0:h1, w0:w1]
    if region.size == 0:
        return -1
    if np.any(region == target_class):
        return int(target_class)
    values, counts = np.unique(region, return_counts=True)
    return int(values[np.argmax(counts)])


def nearest_patches(push_loader, model, spec: ProtoSpec, k: int = 6,
                    log=print):
    """The scan and the host merge: (top_d (P, k) float64, top_img (P, k)
    int64, top_flat (P, k) int64, grid shape); unfilled ranks hold inf /
    -1 / 0."""
    P = spec.num_prototypes
    dev = model.prototype_vectors.device
    top_d = np.full((P, k), np.inf)
    top_img = np.full((P, k), -1, np.int64)
    top_flat = np.zeros((P, k), np.int64)
    grid_shape = None

    def fold(off, vals, rows, flats):
        nonlocal top_d, top_img, top_flat
        cand_d = np.concatenate([top_d, vals], axis=1)
        cand_img = np.concatenate([top_img, off + rows.astype(np.int64)],
                                  axis=1)
        cand_flat = np.concatenate([top_flat, flats.astype(np.int64)], axis=1)
        order = np.argsort(cand_d, axis=1)[:, :k]
        top_d = np.take_along_axis(cand_d, order, 1)
        top_img = np.take_along_axis(cand_img, order, 1)
        top_flat = np.take_along_axis(cand_flat, order, 1)

    # the device results wait in a short queue, fetched in bulk, so the
    # scan dispatches ahead of the host merge
    pending = []

    def drain():
        for off, outs in pending:
            fold(off, *(o.cpu().numpy() for o in outs))
        pending.clear()

    offset = 0
    with float32_forward(model), torch.no_grad():
        for images, targets in push_loader:
            *outs, grid_shape = _batch_top_k(
                model, spec, k, torch.from_numpy(np.asarray(images)).to(dev),
                torch.from_numpy(np.asarray(targets)).to(dev))
            pending.append((offset, outs))
            if len(pending) >= 16:
                drain()
            offset += len(images)
        drain()
    log(f"find_nearest: scanned {offset} images, grid {grid_shape}")
    return top_d, top_img, top_flat, grid_shape


def find_k_nearest_patches_to_prototypes(
        push_loader, model, spec: ProtoSpec, k: int = 6,
        full_save: bool = False,
        root_dir_for_saving_images: Optional[str] = None,
        mesh=None, log=print) -> np.ndarray:
    """(P, k) class ids of the k nearest patches of each prototype of
    ``model`` over ``push_loader`` (re-iterable, fixed-order batches of
    normalized float32 images and labels, 0 = void), -1 where a rank is
    unfilled or the patch is void."""
    if mesh is not None:
        raise NotImplementedError(
            "find_k_nearest_patches_to_prototypes: a device mesh (the JAX "
            "package's data-parallel scan) waits for the port's scale-out; "
            "pass mesh=None")
    P = spec.num_prototypes
    proto_class = np.argmax(spec.class_identity, axis=1)
    top_d, top_img, top_flat, grid_shape = nearest_patches(
        push_loader, model, spec, k, log=log)

    # second pass: only the (<= P * k unique) winner annotations
    needed = set(int(i) for i in np.unique(top_img) if i >= 0)
    ann_cache = {}
    offset = 0
    for _, targets in push_loader:
        for b in range(len(targets)):
            if offset + b in needed:
                ann_cache[offset + b] = np.asarray(targets[b])
        offset += len(targets)
        if len(ann_cache) == len(needed):
            break

    gh, gw = grid_shape
    labels = np.full((P, k), -1, np.int64)
    for p in range(P):
        for i in range(k):
            if top_img[p, i] < 0 or not np.isfinite(top_d[p, i]):
                continue
            ann = ann_cache[int(top_img[p, i])].astype(np.int64) - 1
            gi, gj = divmod(int(top_flat[p, i]), gw)
            labels[p, i] = _patch_label(ann, gi, gj, gh, gw, proto_class[p])

    if full_save and root_dir_for_saving_images:
        _save_artifacts(push_loader, model, top_d, top_img, top_flat,
                        grid_shape, root_dir_for_saving_images)
    return labels


def draw_box(image: np.ndarray, h0: int, h1: int, w0: int, w1: int,
             color=_YELLOW, width: int = 2) -> np.ndarray:
    """A copy of the (H, W, 3) image with the outline of rows h0:h1 and
    columns w0:w1 drawn ``width`` pixels wide, centred on the box's edges
    and clipped to the image."""
    out = image.copy()
    H, W = image.shape[:2]
    lo, hi = width // 2, width - width // 2
    rows = slice(max(h0 - lo, 0), min(h1 + hi, H))
    cols = slice(max(w0 - lo, 0), min(w1 + hi, W))
    for r in (h0, h1):
        out[max(r - lo, 0):min(r + hi, H), cols] = color
    for c in (w0, w1):
        out[rows, max(c - lo, 0):min(c + hi, W)] = color
    return out


def _save_artifacts(push_loader, model, top_d, top_img, top_flat,
                    grid_shape, root_dir) -> None:
    """Per-prototype nearest-patch artifacts (module docstring)."""
    dev = model.prototype_vectors.device
    gh, gw = grid_shape
    P, k = top_d.shape
    by_winner = {}
    for p in range(P):
        for i in range(k):
            w = int(top_img[p, i])
            if w >= 0 and np.isfinite(top_d[p, i]):
                by_winner.setdefault(w, []).append((p, i))

    offset = 0
    with float32_forward(model), torch.no_grad():
        for images, _ in push_loader:
            batch_winners = [w for w in range(offset, offset + len(images))
                             if w in by_winner]
            if batch_winners:
                _, d = model.push_forward(
                    torch.from_numpy(np.asarray(images)).to(dev))
                for w in batch_winners:
                    img = np.asarray(images[w - offset])
                    dist_map = d[w - offset]                     # (gh, gw, P)
                    ih, iw = img.shape[:2]
                    ph, pw = ih / gh, iw / gw
                    disp = np.clip(img * _STD + _MEAN, 0, 1)
                    for p, i in by_winner[w]:
                        out_dir = os.path.join(root_dir, str(p))
                        os.makedirs(out_dir, exist_ok=True)
                        act = distance_to_similarity(dist_map[:, :, p])
                        np.save(os.path.join(out_dir,
                                             f"nearest-{i + 1}_act.npy"),
                                act.cpu().numpy())
                        imsave_rgb(os.path.join(
                            out_dir, f"nearest-{i + 1}_original.png"),
                            torch.from_numpy(disp))
                        gi, gj = divmod(int(top_flat[p, i]), gw)
                        h0, h1 = int(gi * ph), max(int((gi + 1) * ph),
                                                   int(gi * ph) + 1)
                        w0, w1 = int(gj * pw), max(int((gj + 1) * pw),
                                                   int(gj * pw) + 1)
                        imsave_rgb(os.path.join(
                            out_dir, f"nearest-{i + 1}_patch.png"),
                            torch.from_numpy(disp[h0:h1, w0:w1]))
                        imsave_rgb(os.path.join(
                            out_dir, f"nearest-{i + 1}_bbox.png"),
                            torch.from_numpy(draw_box(disp, h0, h1, w0, w1)))
            offset += len(images)
