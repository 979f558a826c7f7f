"""K3: bilinear upsample + argmax as one CUDA kernel (``csrc/upsample.cu``).

Replaces ``scaleprotoseg_tpu/ops/pallas_upsample.py::fused_upsample_argmax``:
low-resolution class logits (B, h, w, C) interpolated with
align_corners=False to (height, width), W first then H as the TPU kernel
does, and argmaxed over classes with the first maximum winning.

Bound on the H100: a few microseconds either way (~9 MB moved, ~0.35
GFLOP); the point is never to write the full-resolution fp32 logits
(~318 MB at the flagship).  One thread per output pixel reads its two row
and two column taps from tables built here from the nonzeros of
``_bilinear_matrix``, so the weights are bit-equal to the matrix form,
and writes the label as uint8 (int32 above 255 classes).

``fused_upsample_argmax`` launches the kernel for a CUDA tensor and runs
``upsample_argmax_plain`` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from scaleprotoseg_torch.kernels._build import check, library
from scaleprotoseg_torch.ops.resize import _bilinear_matrix


def label_dtype(num_classes: int) -> torch.dtype:
    return torch.uint8 if num_classes <= 255 else torch.int32


def interp_taps(out_size: int, in_size: int) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """(out, 2) int32 source indices and (out, 2) float32 weights: the
    two nonzeros of each ``_bilinear_matrix`` row, read from the matrix
    itself; where both taps clamp to one pixel the second weight is 0."""
    m = _bilinear_matrix(out_size, in_size)
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * (in_size / out_size) - 0.5, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    rows = np.arange(out_size)
    w_lo = m[rows, lo]
    w_hi = np.where(hi != lo, m[rows, hi], np.float32(0))
    idx = np.stack([lo, hi], axis=1).astype(np.int32)
    return idx, np.stack([w_lo, w_hi], axis=1).astype(np.float32)


@lru_cache(maxsize=64)
def _device_taps(out_size: int, in_size: int, device: torch.device):
    idx, wts = interp_taps(out_size, in_size)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(wts, device=device))


def upsample_argmax_plain(logits: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per class
    ``my @ (x @ mx)`` with the dense interpolation matrices, then argmax
    (first maximum wins)."""
    _, h, w, c = logits.shape
    kw = dict(dtype=torch.float32, device=logits.device)
    mx = torch.as_tensor(_bilinear_matrix(width, w), **kw)    # (width, w)
    my = torch.as_tensor(_bilinear_matrix(height, h), **kw)   # (height, h)
    t2 = torch.einsum("bhwc,pw->bhpc", logits.float(), mx)
    t3 = torch.einsum("oh,bhpc->bopc", my, t2)
    return t3.argmax(dim=-1).to(label_dtype(c))


@lru_cache(maxsize=None)
def _launcher():
    fn = library("upsample").upsample_argmax_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_upsample_argmax(logits: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """(B, h, w, C) logits -> (B, height, width) labels, uint8 for up to
    255 classes, else int32."""
    if logits.device.type == "cpu":
        return upsample_argmax_plain(logits, height, width)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_upsample_argmax: unsupported device "
                         f"{logits.device}")
    if logits.dtype != torch.float32 or not logits.is_contiguous() \
            or logits.dim() != 4:
        raise ValueError("fused_upsample_argmax: logits must be contiguous "
                         "fp32 (B, h, w, C)")
    b, h, w, c = logits.shape
    yi, yw = _device_taps(height, h, logits.device)
    xi, xw = _device_taps(width, w, logits.device)
    dtype = label_dtype(c)
    out = torch.empty((b, height, width), dtype=dtype, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    status = _launcher()(logits.data_ptr(), yi.data_ptr(), yw.data_ptr(),
                         xi.data_ptr(), xw.data_ptr(), out.data_ptr(),
                         int(dtype == torch.int32), b, h, w, c, height,
                         width, stream)
    check(library("upsample"), status, "upsample_argmax_forward")
    fused_upsample_argmax.launches += 1
    return out


fused_upsample_argmax.launches = 0
