"""Resize ops with the reference's exact sampling.

- Bilinear, ``F.interpolate(mode='bilinear', align_corners=False)``'s
  grid, in the separable dense-matrix form: ``_bilinear_matrix`` builds
  each (out, in) matrix on a float64 grid and casts it to float32, as the
  JAX package does, so both interpolate with bit-equal weights.
- Label resize as PIL's ``Image.resize(..., NEAREST)``: ``_nearest_index``
  gives PIL's source index for every output pixel without PIL.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=4096)
def _nearest_index_cached(out_size: int, in_size: int) -> np.ndarray:
    idx = np.full(out_size, in_size / out_size, np.float64)
    idx[0] *= 0.5
    # sequential float64 sums, as PIL steps its source coordinate
    np.add.accumulate(idx, out=idx)
    return np.minimum(idx.astype(np.int64), in_size - 1)


def _nearest_index(out_size: int, in_size: int) -> np.ndarray:
    """PIL-NEAREST source index of each output pixel, (out_size,) int64.

    PIL resizes with NEAREST through its affine transform: the source
    coordinate of output pixel i starts at ``0.5 * in/out`` and steps by
    ``in/out`` once per pixel in float64, and the index is its truncation.
    The float64 running sum, not ``floor((i + 0.5) * in/out)``, is what
    decides the pixels whose centre falls on a source boundary, so the
    sum is repeated here in the same order.  Callers must not write to
    the cached array."""
    return _nearest_index_cached(out_size, in_size)


def resize_label_nearest_np(label: np.ndarray,
                            size: Tuple[int, int]) -> np.ndarray:
    """PIL-compatible nearest resize of an (H, W) label map; ``size`` is
    (width, height), PIL's argument order."""
    w, h = size
    return label[np.ix_(_nearest_index(h, label.shape[0]),
                        _nearest_index(w, label.shape[1]))]


@lru_cache(maxsize=256)
def _device_index(out_size: int, in_size: int,
                  device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_nearest_index(out_size, in_size), device=device)


def resize_label_nearest(label: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """PIL-compatible nearest resize of (..., H, W) label maps; the index
    tables go to the device once per size pair."""
    iy = _device_index(height, label.shape[-2], label.device)
    ix = _device_index(width, label.shape[-1], label.device)
    return label.index_select(-2, iy).index_select(-1, ix)


@lru_cache(maxsize=512)
def _bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Dense (out, in) float32 matrix for ``src = (dst + 0.5) * in/out -
    0.5``, clipped to the input; each row holds the two-tap lerp weights.
    Callers must not write to the cached array."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * (in_size / out_size) - 0.5,
                  0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    t = src - lo
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += (1 - t).astype(np.float32)
    m[np.arange(out_size), hi] += t.astype(np.float32)
    return m


def resize_bilinear_matrix(x: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., height, width, C) float32: the H
    interpolation then the W interpolation, each one dense matmul."""
    kw = dict(dtype=torch.float32, device=x.device)
    my = torch.as_tensor(_bilinear_matrix(height, x.shape[-3]), **kw)
    mx = torch.as_tensor(_bilinear_matrix(width, x.shape[-2]), **kw)
    y = torch.einsum("oh,...hwc->...owc", my, x.float())
    return torch.einsum("pw,...owc->...opc", mx, y)
