"""Training dataset with the reference's augmentation, in numpy alone.

Reads the preprocessed layout (``all_images.json``, ``.npy`` images under
``img_with_margin_<m>/<split>`` and category-index labels under
``annotations/<split>``), converts the labels to 0 = void / class + 1, and
augments as the reference does, drawing the randomness in the same order
from Python's ``random``: a uniform scale in ``scales``, a crop start in
rows then columns, a horizontal flip.  The image is resized bilinearly
with half-pixel centres (cv2's ``INTER_LINEAR`` up to its fixed-point
rounding) and the label with PIL's NEAREST indices; the resized image is
padded bottom/right with the mean (label 0), cropped to the window,
flipped and normalized.  With ``det_seed`` the draws come from a stream
of their own per (det_seed, epoch, index), as in the JAX package, so an
item does not depend on the loader's threads and a resumed run sees the
crops an uninterrupted one would.

Only the window's pixels of the resized image are computed: each output
pixel reads its own source taps, as the JAX package's native
augmentation does, so a 513 x 513 crop of a 1536 x 3072 resize costs a
513 x 513 gather.  Batches are NHWC float32 images and int32 labels.
"""

from __future__ import annotations

import json
import os
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from scaleprotoseg_torch import settings
from scaleprotoseg_torch.constants import convert_targets
from scaleprotoseg_torch.ops.resize import _nearest_index


def _bilinear_taps(out_size: int, in_size: int, dst: np.ndarray):
    """(lo, hi, weight of hi) for output coordinates ``dst`` of a resize
    from ``in_size`` to ``out_size``: ``src = (dst + 0.5) * in/out - 0.5``
    clamped to the input."""
    src = np.clip((dst + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    lo = src.astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def resized_window(image: np.ndarray, label: np.ndarray,
                   resized: Tuple[int, int], start: Tuple[int, int],
                   window: Tuple[int, int], pad_value: Sequence[float]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The ``window`` at ``start`` of ``image`` (uint8 HWC) resized to
    ``resized`` and padded bottom/right with ``pad_value`` (on the [0, 1]
    scale): float32 in [0, 1]; and of ``label`` resized with PIL's
    NEAREST and padded with 0."""
    (rs_h, rs_w), (y0, x0), (win_h, win_w) = resized, start, window
    in_h, in_w = label.shape
    rows = np.arange(y0, min(y0 + win_h, rs_h))
    cols = np.arange(x0, min(x0 + win_w, rs_w))
    out = np.empty((win_h, win_w, 3), np.float32)
    out[...] = np.asarray(pad_value, np.float32)
    out_label = np.zeros((win_h, win_w), np.int32)
    if rows.size and cols.size:
        ylo, yhi, wy = _bilinear_taps(rs_h, image.shape[0], rows)
        xlo, xhi, wx = _bilinear_taps(rs_w, image.shape[1], cols)
        wy = wy[:, None, None]
        wx = wx[None, :, None]
        top = image[ylo]
        bot = image[yhi]
        v = (1 - wy) * ((1 - wx) * top[:, xlo] + wx * top[:, xhi]) + \
            wy * ((1 - wx) * bot[:, xlo] + wx * bot[:, xhi])
        out[:rows.size, :cols.size] = v / np.float32(255.0)
        iy = _nearest_index(rs_h, in_h)[rows]
        ix = _nearest_index(rs_w, in_w)[cols]
        out_label[:rows.size, :cols.size] = label[np.ix_(iy, ix)]
    return out, out_label


class PatchClassificationDataset:
    """Map-style dataset of (image (H, W, 3) float32, label (H, W) int32),
    augmented alike for training and validation, as the reference does;
    with ``push_prototypes`` the whole image, normalized, unaugmented.

    ``jitter`` (color jitter, training only) is off in every shipped
    config and not ported: it is refused.

    ``det_seed``: when set, each item's draws come from
    ``random.Random(f"{det_seed}/{epoch}/{index}")`` (``set_epoch``
    sets the epoch; the loader calls it once an epoch), otherwise from
    the process-global ``random``, as the reference's loader workers
    draw."""

    def __init__(self, split_key: str, data_type: str,
                 mean: Sequence[float], std: Sequence[float],
                 image_margin_size: int = 0,
                 window_size: Optional[Tuple[int, int]] = None,
                 scales: Tuple[float, ...] = (1.0,), jitter: bool = False,
                 root: Optional[str] = None, push_prototypes: bool = False,
                 det_seed: Optional[int] = None):
        self.push_prototypes = push_prototypes
        self.det_seed = det_seed
        self.epoch = 0
        if jitter:
            raise NotImplementedError("color jitter is not ported yet "
                                      "(PatchClassificationDataset.jitter)")
        self.split_key = split_key
        self.data_type = data_type
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.image_margin_size = image_margin_size
        self.window_size = tuple(window_size) if window_size else None
        self.scales = tuple(scales)
        self.root = root or settings.data_path(data_type)
        self.annotations_dir = os.path.join(self.root, "annotations",
                                            split_key)
        self.img_dir = os.path.join(
            self.root, f"img_with_margin_{image_margin_size}", split_key)
        with open(os.path.join(self.root, "all_images.json")) as fp:
            self.img_ids = json.load(fp)[split_key]

    def __len__(self) -> int:
        return len(self.img_ids)

    def set_epoch(self, epoch: int) -> None:
        """The epoch of ``det_seed``'s streams (no effect without it)."""
        self.epoch = int(epoch)

    def _load_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        img_id = self.img_ids[index]
        image = np.load(os.path.join(self.img_dir, img_id + ".npy"))
        label = np.load(os.path.join(self.annotations_dir, img_id + ".npy"))
        if label.ndim == 3:
            label = label[:, :, 0]
        return image.astype(np.uint8), label

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        image, label = self._load_raw(index)
        window = self.window_size or label.shape[:2]
        if self.image_margin_size:
            m = self.image_margin_size
            image = image[m:-m, m:-m]
        if self.push_prototypes:
            # prototype push: the whole image, normalized, no augmentation
            image = (image.astype(np.float32) / 255.0 - self.mean) / self.std
            return image.astype(np.float32), \
                convert_targets(label, self.data_type).astype(np.int32)
        resized, start, flip = self.draw(index, label.shape, window)
        return self.augment(image, convert_targets(label, self.data_type),
                            window, resized, start, flip)

    def draw(self, index: int, shape: Tuple[int, int],
             window: Tuple[int, int]
             ) -> Tuple[Tuple[int, int], Tuple[int, int], bool]:
        """(resized size, crop start, flip) of item ``index`` of an image
        of ``shape``: the reference's draws in its order (a uniform scale
        in ``scales``, the crop start in rows then columns, the flip), from
        the global stream or, with ``det_seed``, the item's own."""
        r = random if self.det_seed is None else \
            random.Random(f"{self.det_seed}/{self.epoch}/{index}")
        in_h, in_w = shape
        scale = 1.0 if len(self.scales) < 2 else \
            r.uniform(self.scales[0], self.scales[1])
        rs_h, rs_w = int(in_h * scale), int(in_w * scale)
        pad_h = max(window[0] - rs_h, 0)
        pad_w = max(window[1] - rs_w, 0)
        start_h = r.randint(0, rs_h + pad_h - window[0])
        start_w = r.randint(0, rs_w + pad_w - window[1])
        flip = r.random() < 0.5
        return (rs_h, rs_w), (start_h, start_w), flip

    def augment(self, image: np.ndarray, label: np.ndarray,
                window: Tuple[int, int], resized: Tuple[int, int],
                start: Tuple[int, int], flip: bool
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Resize, pad, crop, flip and normalize one drawn sample."""
        img, lab = resized_window(image, label, resized, start, window,
                                  self.mean)
        if flip:
            img = img[:, ::-1]
            lab = lab[:, ::-1]
        img = (img - self.mean) / self.std
        return np.ascontiguousarray(img, np.float32), \
            np.ascontiguousarray(lab, np.int32)
