"""Color jitter of a training crop, as the JAX package's
``PatchClassificationDataset._color_jitter``: torchvision-style
ColorJitter(0.2, 0.2, 0.2, 0.2) on a float32 RGB image in [0, 1].

Brightness, contrast about the image's grey mean, saturation about each
pixel's grey, then a hue shift through HSV.  The four factors are drawn
in that order from the item's stream, right after its flip.

The HSV pair is OpenCV's float32 ``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB``
(H in degrees) in numpy, without OpenCV: the formulas of its vector path,
with its fused multiply-adds computed as an exact float64 product and
sum rounded once to float32.  OpenCV runs its scalar formula on the last
``width % lanes`` pixels of each row, where its hue can differ by one
float32 rounding (3.1e-5 degrees); elsewhere both directions are
bit-equal to OpenCV (``tests/test_torch_jitter.py``).
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np

_EPS = np.float32(np.finfo(np.float32).eps)      # OpenCV's FLT_EPSILON
_HSCALE = np.float32(6.0 / 360.0)
# (b, g, r) picks among (v, p, q, t) per hue sextant
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                    [2, 1, 0]])


def jitter_draws(r=random) -> Tuple[float, float, float, float]:
    """(brightness, contrast, saturation, hue) factors from stream ``r``."""
    return (r.uniform(0.8, 1.2), r.uniform(0.8, 1.2), r.uniform(0.8, 1.2),
            r.uniform(-0.2, 0.2))


def _fma(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the float64 product is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """float32 RGB (..., 3) -> HSV with H in [0, 360), S and V in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _EPS)
    r_max, g_max = r == v, g == v
    num = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
    offset = np.where(r_max, np.where(g < b, np.float32(360), np.float32(0)),
                      np.where(g_max, np.float32(120), np.float32(240)))
    h = _fma(num, np.float32(60) / (diff + _EPS), offset)
    return np.stack([h, s, v], -1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """The inverse of ``rgb_to_hsv``: float32 HSV (..., 3) -> RGB."""
    h = hsv[..., 0] * _HSCALE
    s, v = hsv[..., 1], hsv[..., 2]
    sector = np.floor(h)
    h = h - sector
    one = np.float32(1)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one),
                    v * _fma(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTOR[sector.astype(np.int64) % 6], -1)
    return np.ascontiguousarray(bgr[..., ::-1])


def color_jitter(image: np.ndarray,
                 draws: Tuple[float, float, float, float]) -> np.ndarray:
    """Jitter float32 RGB ``image`` (H, W, 3) in [0, 1] by ``draws``
    (``jitter_draws``); the JAX package's arithmetic, step for step."""
    b, c, s, h = draws
    image = np.clip(np.ascontiguousarray(image, np.float32) * b, 0, 1)
    gray = image.mean(axis=-1, keepdims=True)
    image = np.clip((image - gray.mean()) * c + gray.mean(), 0, 1)
    image = np.clip((image - gray) * s + gray, 0, 1)
    hsv = rgb_to_hsv(image.astype(np.float32))
    hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
    return hsv_to_rgb(hsv)
