"""Bilinear resize with the reference's ``F.interpolate(mode='bilinear',
align_corners=False)`` sampling grid, in the separable dense-matrix form.

``_bilinear_matrix`` builds each (out, in) interpolation matrix on a
float64 grid and casts it to float32, exactly as the JAX package does, so
the two packages interpolate with bit-equal weights.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


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
