"""K3: bilinear upsample + argmax as one CUDA kernel (``csrc/upsample.cu``).

Replaces ``scaleprotoseg_tpu/ops/pallas_upsample.py::fused_upsample_argmax``:
low-resolution class logits (B, h, w, C) interpolated with
align_corners=False to (height, width), W first then H as the TPU kernel
does, and argmaxed over classes with the first maximum winning.

Bound on the H100: operations (~0.35 GFLOP of fp32 at the flagship against
~9 MB moved); the point is never to write the full-resolution fp32 logits
(~318 MB).  A block owns a band of output rows by a span of output columns
(``plan``), stages the source rows and columns their taps reach in shared
memory, forms each source row's W interpolation once per output column and
class, and keeps a running first maximum per output pixel.
The taps come from tables built here from the nonzeros of
``_bilinear_matrix``, so the weights are bit-equal to the matrix form; the
labels leave as uint8 (int32 above 255 classes), 16 bytes at a time.

``fused_upsample_argmax`` runs the registered op
``scaleprotoseg::fused_upsample_argmax``: the kernel for a CUDA tensor,
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

_BAND = 16                 # output rows per block (``BH`` in the source)
_SPANS = (256, 128, 64, 32)  # output columns per block, widest first
_SMEM_BUDGET = 96 * 1024   # staged bytes a block may take (two per SM)


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


def _reach(idx: np.ndarray, size: int) -> int:
    """The most source indices one block of ``size`` consecutive outputs
    reaches: taps are non-decreasing, so a block reads from the first
    output's low tap to the last output's high tap."""
    starts = np.arange(0, len(idx), size)
    ends = np.minimum(starts + size, len(idx)) - 1
    return int((idx[ends, 1] - idx[starts, 0]).max()) + 1


@lru_cache(maxsize=256)
def plan(h: int, w: int, height: int, width: int,
         num_classes: int) -> Tuple[int, int, int]:
    """(output columns per block, the most source rows a band reaches, the
    most source columns a span reaches): the widest span whose staged
    window fits the shared-memory budget."""
    rows = _reach(interp_taps(height, h)[0], _BAND)
    x_idx = interp_taps(width, w)[0]
    for span in _SPANS:
        cols = _reach(x_idx, span)
        staged = rows * ((cols * num_classes + 6) // 4 * 4) * 4
        if staged <= _SMEM_BUDGET:
            return span, rows, cols
    raise ValueError(f"fused_upsample_argmax: {num_classes} classes from "
                     f"{h} x {w} to {height} x {width} need more shared "
                     "memory than a block has")


@lru_cache(maxsize=None)
def _launcher():
    fn = library("upsample").upsample_argmax_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_upsample_argmax(logits: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """(B, h, w, C) logits -> (B, height, width) labels, uint8 for up to
    255 classes, else int32.  Runs the registered op
    ``scaleprotoseg::fused_upsample_argmax``."""
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_upsample_argmax: unsupported device "
                         f"{logits.device}")
    return _upsample_op(logits, height, width)


fused_upsample_argmax.launches = 0


@torch.library.custom_op("scaleprotoseg::fused_upsample_argmax",
                         mutates_args=(), device_types="cpu")
def _upsample_op(logits: torch.Tensor, height: int,
                 width: int) -> torch.Tensor:
    """K3 as one graph node; on the CPU its plain version."""
    return upsample_argmax_plain(logits, height, width)


@_upsample_op.register_kernel("cuda")
def _upsample_cuda(logits, height, width):
    if logits.dtype != torch.float32 or not logits.is_contiguous() \
            or logits.dim() != 4:
        raise ValueError("fused_upsample_argmax: logits must be contiguous "
                         "fp32 (B, h, w, C)")
    if logits.data_ptr() % 16:
        raise ValueError("fused_upsample_argmax: logits must be 16-byte "
                         "aligned")
    b, h, w, c = logits.shape
    span, max_rows, max_cols = plan(h, w, height, width, c)
    yi, yw = _device_taps(height, h, logits.device)
    xi, xw = _device_taps(width, w, logits.device)
    dtype = label_dtype(c)
    out = torch.empty((b, height, width), dtype=dtype, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    status = _launcher()(logits.data_ptr(), yi.data_ptr(), yw.data_ptr(),
                         xi.data_ptr(), xw.data_ptr(), out.data_ptr(),
                         int(dtype == torch.int32), b, h, w, c, height,
                         width, span, max_rows, max_cols, stream)
    check(library("upsample"), status, "upsample_argmax_forward")
    fused_upsample_argmax.launches += 1
    return out


@_upsample_op.register_fake
def _upsample_fake(logits, height, width):
    return logits.new_empty((logits.shape[0], height, width),
                            dtype=label_dtype(logits.shape[-1]))
