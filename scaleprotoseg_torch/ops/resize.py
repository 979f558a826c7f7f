"""Resize ops with the reference's exact sampling.

- Bilinear, ``F.interpolate(mode='bilinear', align_corners=False)``'s
  grid, in the separable dense-matrix form: ``_bilinear_matrix`` builds
  each (out, in) matrix on a float64 grid and casts it to float32, as the
  JAX package does, so both interpolate with bit-equal weights.
- Bilinear by a scale factor (``resize_bilinear_factor``), the MSC input
  pyramid's resize: ``F.interpolate(scale_factor=p)``'s grid, which
  differs from a size-based resize at odd sizes.
- Bilinear as the JAX package's ``resize_bilinear`` computes it
  (``jax.image.resize``, linear, no antialias: the eval upsample behind
  ``--exact-output``): ``_linear_weights`` builds each axis's weights in
  float32 the way ``jax.image`` does, a triangle kernel normalized per
  output sample; and ``bilinear_sample``: the grid's values at chosen
  output pixels without the full upsampled volume (the purity curve).
- Label resize as PIL's ``Image.resize(..., NEAREST)``: ``_nearest_index``
  gives PIL's source index for every output pixel without PIL.
- Bilinear as ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)`` computes
  it for float32 input (``resize_linear_cv2``), without cv2: the push
  artifacts' activation upsample and the Pascal and ADE eval resizes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from scaleprotoseg_torch.ops import as_dtype


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


def _on_device(build, *args, device: torch.device) -> torch.Tensor:
    """``build(*args)`` (a cached numpy table) as a tensor on ``device``,
    copied there once per table and device, not on every call.  While
    ``torch.export`` traces it is made anew and not kept: a tensor made
    then is a fake tensor (the trace lifts it as a constant of the
    program)."""
    if torch.compiler.is_exporting():
        t = torch.from_numpy(build(*args))
        return t if t.device == device else t.to(device)
    return _device_table(build, args, device)


@lru_cache(maxsize=256)
@torch.inference_mode(False)
def _device_table(build, args, device: torch.device) -> torch.Tensor:
    # never an inference tensor: training saves it for backward
    return torch.as_tensor(build(*args), device=device)


def resize_label_nearest(label: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """PIL-compatible nearest resize of (..., H, W) label maps."""
    iy = _on_device(_nearest_index, height, label.shape[-2],
                    device=label.device)
    ix = _on_device(_nearest_index, width, label.shape[-1],
                    device=label.device)
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
    my = _on_device(_bilinear_matrix, height, x.shape[-3], device=x.device)
    mx = _on_device(_bilinear_matrix, width, x.shape[-2], device=x.device)
    y = torch.einsum("oh,...hwc->...owc", my, as_dtype(x, torch.float32))
    return torch.einsum("pw,...owc->...opc", mx, y)


@lru_cache(maxsize=64)
def _factor_matrix(out_size: int, in_size: int, factor: float) -> np.ndarray:
    """Dense (out, in) float32 matrix of a resize by ``factor``: output
    pixel o reads ``(o + 0.5) / factor - 0.5`` (exactly ``1/factor``, not
    ``in/out``), clipped to the input.  Callers must not write to the
    cached array."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) / factor - 0.5, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    t = src - lo
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += (1 - t)
    m[np.arange(out_size), hi] += t
    return m


def resize_bilinear_factor(x: torch.Tensor, factor: float) -> torch.Tensor:
    """(..., H, W, C) -> (..., int(H * factor), int(W * factor), C) in
    ``x``'s dtype: ``F.interpolate(x, scale_factor=factor,
    align_corners=False, recompute_scale_factor=False)``'s sampling (321
    -> 160 and 240, 513 -> 256 and 384), as the JAX package's
    ``resize_bilinear_factor``: the two separable matrices applied in
    float32."""
    h, w = x.shape[-3], x.shape[-2]
    dev = x.device
    my = _on_device(_factor_matrix, int(h * factor), h, factor, device=dev)
    mx = _on_device(_factor_matrix, int(w * factor), w, factor, device=dev)
    y = torch.einsum("oh,...hwc->...owc", my, as_dtype(x, torch.float32))
    return as_dtype(torch.einsum("pw,...owc->...opc", mx, y), x.dtype)


@lru_cache(maxsize=512)
def _linear_weights(out_size: int, in_size: int) -> np.ndarray:
    """(in, out) float32 weights of ``jax.image.resize``'s linear kernel
    without antialias as XLA computes them: sample ``s = (o + 0.5) *
    in/out - 0.5`` rounded once (XLA fuses the multiply-add; the float64
    product of two float32 values is exact), weight ``max(0, 1 - |s -
    i|)``, each column normalized by its sum, in float32."""
    inv = np.float32(1.0 / (out_size / in_size))
    q = np.arange(out_size, dtype=np.float32) + np.float32(0.5)
    s = (q.astype(np.float64) * np.float64(inv) - 0.5).astype(np.float32)
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(
        s[None, :] - np.arange(in_size, dtype=np.float32)[:, None]))
    total = w.sum(0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (s >= -0.5) & (s <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bilinear(x: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """(..., H, W, C) -> (..., height, width, C) float32: the JAX package's
    ``resize_bilinear`` (torch's ``align_corners=False`` grid, no
    antialias), with ``jax.image``'s float32 weights."""
    wy = _on_device(_linear_weights, height, x.shape[-3], device=x.device)
    wx = _on_device(_linear_weights, width, x.shape[-2], device=x.device)
    y = torch.einsum("...hwc,ho->...owc", as_dtype(x, torch.float32), wy)
    return torch.einsum("...owc,wp->...opc", y, wx)


def bilinear_sample(arr: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Values of the align_corners=False bilinear upsample of ``arr`` (B,
    H, W, C) to (out_h, out_w) at the output pixels ``rows``/``cols`` (B,
    n): (B, n, C) float32, computed from the four source neighbours."""
    b, h, w = arr.shape[:3]
    sy = ((rows.float() + 0.5) * (h / out_h) - 0.5).clamp(0, h - 1)
    sx = ((cols.float() + 0.5) * (w / out_w) - 0.5).clamp(0, w - 1)
    y0 = sy.floor().long()
    x0 = sx.floor().long()
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    bi = torch.arange(b, device=arr.device)[:, None]
    a = arr.float()
    return (a[bi, y0, x0] * (1 - wy) * (1 - wx) +
            a[bi, y0, x1] * (1 - wy) * wx +
            a[bi, y1, x0] * wy * (1 - wx) +
            a[bi, y1, x1] * wy * wx)


@lru_cache(maxsize=512)
def _cv2_linear_taps(out_size: int, in_size: int):
    """cv2's INTER_LINEAR taps along one axis: (first source index, second
    source index, float32 weight of the second).  The source coordinate
    ``(o + 0.5) * in/out - 0.5`` and its fraction are float64, the weight
    is the fraction rounded to float32; a coordinate below 0 clamps to
    index 0 with weight 0, one at or past the last index to the last with
    weight 0.  Callers must not write to the cached arrays."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * \
        (in_size / out_size) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    frac[lo < 0] = 0
    lo[lo < 0] = 0
    past = lo >= in_size - 1
    frac[past] = 0
    lo[past] = in_size - 1
    return lo, np.minimum(lo + 1, in_size - 1), frac


def _fma_lerp(p: torch.Tensor, q: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """``fma(q - p, t, p)`` in float32, as cv2 interpolates: the float32
    difference times the weight plus ``p`` in float64 (the product of two
    float32 values is exact there), then rounded to float32 (it differs
    from a single rounding only where the float64 sum lands on a float32
    tie, about one element in 2^29)."""
    return ((q - p).double() * t.double() + p.double()).float()


def resize_linear_cv2(x: torch.Tensor, height: int, width: int
                      ) -> torch.Tensor:
    """(..., h, w) float32 -> (..., height, width) float32 as
    ``cv2.resize(x, (width, height), interpolation=cv2.INTER_LINEAR)``
    computes it for float32 input: half-pixel centres, edges clamped, the
    rows interpolated first and then the columns, each step an FMA lerp
    (``_fma_lerp``).  Runs on ``x``'s device.  It downscales as it
    upscales: bit-equal to cv2 5.0 at ADE's downscales, at an exact halving
    of both axes (1024 x 1536 -> 512 x 768, where cv2 switches to its
    INTER_AREA path: the same numbers) and at upscales of 5x and less.  At
    large upscales (10.7x and more in the cases tried) of 3-channel images,
    cv2's values in the clamped border columns (source coordinate outside
    the image) differ from this form's by at most one float32 ulp of the
    image's largest magnitude (``tests/test_torch_ade.py``)."""
    if x.dtype != torch.float32:
        raise TypeError(f"resize_linear_cv2 takes float32, got {x.dtype}")
    taps = [[torch.as_tensor(a, device=x.device) for a in
             _cv2_linear_taps(n, x.shape[d])]
            for n, d in ((height, -2), (width, -1))]
    (y0, y1, wy), (x0, x1, wx) = taps
    rows = _fma_lerp(x[..., x0], x[..., x1], wx)
    return _fma_lerp(rows[..., y0, :], rows[..., y1, :], wy[:, None])
