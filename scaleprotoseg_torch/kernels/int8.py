"""K4 and the int8 convolutions of the quant8 path (``csrc/int8_mm.cu``).

``int8_mm`` replaces ``benchmarks/bench_int8_mosaic.py::pallas_mm``: the
tiled product ``a @ b`` with ``b`` passed transposed, ``bt = b^T`` (N, K),
the K-contiguous layout that ``wgmma`` reads for 8-bit types (the int8
arm: TMA-fed, persistent 128 x 256 tiles; the bf16 arm is an
``mma.sync`` tile); a weight is transposed once, when it is quantized.
int8 x int8 -> int32, or with ``sx``/``sw`` the dequantized ``float(acc) *
(sx * sw[n])`` in bf16 or fp32; bf16 x bf16 -> fp32 is the other arm.
``int8_conv3x3`` is the dilated 3x3 conv as an implicit GEMM, the
counterpart of XLA's s8 conv in ``scaleprotoseg_tpu/ops/quant.py``: K2's
design with s8 operands (TMA boxes of a 32 x 8 output patch's column
strips, the three dy taps of a dx read from one strip, ``wgmma``
m64n128k32 on a persistent grid).
``quantize_int8`` (static: ``x * (1 / max(s, 1e-12))``; dynamic:
``x / s``) and ``int8_absmax`` (the dynamic scale ``max(max|x|, 1e-12) /
127``, kept on the device) feed them.

Bound on the H100: the layer4/5 convs are operations-bound (int8 tensor
cores, 1,979 TOP/s); K4 at its benchmark shape and the quantize passes
are bytes-bound.  See the source for the design.

Each wrapper runs a registered op (``scaleprotoseg::<name>``) whose CPU
implementation is the plain PyTorch version and whose CUDA one launches
the kernel, or raises; a traced graph holds each as one node.  The plain
int8 products run in float64, exact for int8 operands below 2^53, then
cast to int32.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from scaleprotoseg_torch.kernels._build import check, library

_TILE_N = 128       # N a multiple of the conv's output-channel tile
_TILE_KB = 64       # K (C for the conv) a multiple of half a 128-byte chunk
_MODES = {None: 0, torch.bfloat16: 1, torch.float32: 2}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``float(acc) * (sx * sw)``, the scale product formed first, then
    cast to ``out_dtype``."""
    return (acc.float() * (sx.float() * sw.float())).to(out_dtype)


def int8_mm_plain(a: torch.Tensor, bt: torch.Tensor,
                  sx: Optional[torch.Tensor] = None,
                  sw: Optional[torch.Tensor] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``int8_mm``'s function: int8 ``a @ bt^T`` exactly (float64 sums cast
    to int32), dequantized when ``sx`` is given; bf16 operands give the
    fp32 product (exact products; on the card the caller turns TF32 off)."""
    if a.dtype != torch.int8:
        return a.float() @ bt.float().t()
    acc = (a.double() @ bt.double().t()).to(torch.int32)
    return acc if sx is None else dequantize(acc, sx, sw, out_dtype)


def int8_conv3x3_plain(x: torch.Tensor, wt: torch.Tensor, dilation: int,
                       sx: Optional[torch.Tensor] = None,
                       sw: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """``int8_conv3x3``'s function: x (B, H, W, C) int8 and wt (9, N, C)
    int8 (tap 3 * ky + kx) -> the zero-padded dilated conv (B, H, W, N),
    int32 from a float64 conv, dequantized when ``sx`` is given."""
    n, c = wt.shape[1], wt.shape[2]
    w = wt.double().reshape(3, 3, n, c).permute(2, 3, 0, 1)
    acc = F.conv2d(x.double().permute(0, 3, 1, 2), w, padding=dilation,
                   dilation=dilation).permute(0, 2, 3, 1)
    acc = acc.to(torch.int32).contiguous()
    return acc if sx is None else dequantize(acc, sx, sw, out_dtype)


def quantize_int8_plain(x: torch.Tensor, scale: torch.Tensor,
                        divide: bool = False) -> torch.Tensor:
    """``round(x / s)`` (``divide``, the dynamic form) or ``round(x * (1 /
    max(s, 1e-12)))`` (the static form) in float32, half to even, clipped
    to +-127, as int8."""
    xf = x.float()
    s = scale.float()
    v = xf / s if divide else xf * (1.0 / torch.clamp_min(s, 1e-12))
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale ``max(max|x|, 1e-12) / 127``, float32 ()."""
    return torch.clamp_min(x.float().abs().amax(), 1e-12) / 127.0


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _launchers():
    lib = library("int8_mm")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    sigs = {
        "int8_mm": [ptr] * 5 + [i32] * 4 + [ptr],
        "bf16_mm": [ptr] * 3 + [i32] * 3 + [ptr],
        "int8_conv3x3": [ptr] * 5 + [i32] * 7 + [ptr],
        "quantize_int8": [ptr] * 3 + [i64, i32, i32, ptr],
        "int8_absmax": [ptr] * 3 + [i64, i32, ptr],
        "absmax_blocks": [i64],
    }
    fns = {}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _devices(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {t.device}")


def _cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")


def _aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels read their operands 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def _scales(name: str, sx, sw, n: int, out_dtype, dev):
    """Validated (mode, sx, sw) of a dequantizing call."""
    if sx is None:
        if sw is not None or out_dtype is not None:
            raise ValueError(f"{name}: sw and out_dtype need sx")
        return 0, None, None
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bf16 or float32")
    sx = sx.reshape(1)
    if sx.dtype != torch.float32 or sw is None or sw.dtype != torch.float32 \
            or tuple(sw.shape) != (n,) or not sw.is_contiguous() \
            or sx.device != dev or sw.device != dev:
        raise ValueError(f"{name}: sx () and sw ({n},) must be float32 on "
                         f"{dev}")
    return _MODES[out_dtype], sx, sw


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def int8_mm(a: torch.Tensor, bt: torch.Tensor,
            sx: Optional[torch.Tensor] = None,
            sw: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ bt^T`` for a (M, K) and bt (N, K): int8 -> int32, or with
    ``sx`` () and ``sw`` (N,) float32 the dequantized ``out_dtype``
    (bf16 or float32); bf16 -> float32.  The kernel takes contiguous
    operands with N % 128 == 0 and K % 64 (int8) or 32 (bf16) == 0; rows
    past M are masked.  Runs the registered op ``scaleprotoseg::int8_mm``."""
    _devices("int8_mm", a, bt)
    return _mm_op(a, bt, sx, sw, out_dtype)


int8_mm.launches = 0


@torch.library.custom_op("scaleprotoseg::int8_mm", mutates_args=(),
                         device_types="cpu")
def _mm_op(a: torch.Tensor, bt: torch.Tensor, sx: Optional[torch.Tensor],
           sw: Optional[torch.Tensor],
           out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    return int8_mm_plain(a, bt, sx, sw, out_dtype)


@_mm_op.register_kernel("cuda")
def _mm_cuda(a, bt, sx, sw, out_dtype):
    _cuda("int8_mm", a, bt)
    m, k = a.shape
    n = bt.shape[0]
    if a.dtype != bt.dtype or a.dtype not in (torch.int8, torch.bfloat16) \
            or not a.is_contiguous() or not bt.is_contiguous():
        raise ValueError("int8_mm: a and bt must be contiguous, both int8 "
                         "or both bf16")
    kb = k * a.element_size()
    if bt.shape[1] != k or n % _TILE_N or kb % _TILE_KB or m < 1:
        raise ValueError(f"int8_mm: needs a (M, K), bt (N, K) with N % "
                         f"{_TILE_N} == 0 and K of {_TILE_KB}-byte chunks, "
                         f"got {tuple(a.shape)} {tuple(bt.shape)}")
    _aligned("int8_mm", a, bt)
    fns = _launchers()
    if a.dtype == torch.bfloat16:
        if sx is not None:
            raise ValueError("int8_mm: the bf16 arm does not dequantize")
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        status = fns["bf16_mm"](a.data_ptr(), bt.data_ptr(), out.data_ptr(),
                                m, k, n, _stream(a))
    else:
        mode, sx, sw = _scales("int8_mm", sx, sw, n, out_dtype, a.device)
        out = torch.empty((m, n), dtype=out_dtype or torch.int32,
                          device=a.device)
        status = fns["int8_mm"](a.data_ptr(), bt.data_ptr(), out.data_ptr(),
                                _ptr(sx), _ptr(sw), m, k, n, mode, _stream(a))
    check(library("int8_mm"), status, "int8_mm")
    int8_mm.launches += 1
    return out


@_mm_op.register_fake
def _mm_fake(a, bt, sx, sw, out_dtype):
    dtype = torch.float32 if a.dtype != torch.int8 else \
        out_dtype if sx is not None else torch.int32
    return a.new_empty((a.shape[0], bt.shape[0]), dtype=dtype)


def int8_conv3x3(x: torch.Tensor, wt: torch.Tensor, dilation: int,
                 sx: Optional[torch.Tensor] = None,
                 sw: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dilated 3x3 conv, zero padding = ``dilation``: x (B, H, W, C) int8
    NHWC and wt (9, N, C) int8 -> (B, H, W, N) int32, or dequantized as
    ``int8_mm``.  The kernel needs C % 64 == 0 and N % 128 == 0.  Runs the
    registered op ``scaleprotoseg::int8_conv3x3``."""
    _devices("int8_conv3x3", x, wt)
    return _conv_op(x, wt, dilation, sx, sw, out_dtype)


int8_conv3x3.launches = 0


@torch.library.custom_op("scaleprotoseg::int8_conv3x3", mutates_args=(),
                         device_types="cpu")
def _conv_op(x: torch.Tensor, wt: torch.Tensor, dilation: int,
             sx: Optional[torch.Tensor], sw: Optional[torch.Tensor],
             out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    return int8_conv3x3_plain(x, wt, dilation, sx, sw, out_dtype)


@_conv_op.register_kernel("cuda")
def _conv_cuda(x, wt, dilation, sx, sw, out_dtype):
    _cuda("int8_conv3x3", x, wt)
    b, h, w, c = x.shape
    n = wt.shape[1]
    if x.dtype != torch.int8 or wt.dtype != torch.int8 or \
            not x.is_contiguous() or not wt.is_contiguous():
        raise ValueError("int8_conv3x3: x and wt must be contiguous int8")
    if tuple(wt.shape) != (9, n, c) or c % _TILE_KB or n % _TILE_N or \
            dilation < 1:
        raise ValueError(f"int8_conv3x3: needs wt (9, N, C) with C % "
                         f"{_TILE_KB} == 0 and N % {_TILE_N} == 0, got "
                         f"x {tuple(x.shape)} wt {tuple(wt.shape)}")
    _aligned("int8_conv3x3", x, wt)
    mode, sx, sw = _scales("int8_conv3x3", sx, sw, n, out_dtype, x.device)
    out = torch.empty((b, h, w, n), dtype=out_dtype or torch.int32,
                      device=x.device)
    status = _launchers()["int8_conv3x3"](
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), _ptr(sx), _ptr(sw), b, h,
        w, c, n, dilation, mode, _stream(x))
    check(library("int8_mm"), status, "int8_conv3x3")
    int8_conv3x3.launches += 1
    return out


@_conv_op.register_fake
def _conv_fake(x, wt, dilation, sx, sw, out_dtype):
    dtype = out_dtype if sx is not None else torch.int32
    return x.new_empty((*x.shape[:3], wt.shape[1]), dtype=dtype)


def _elementwise_input(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be bf16 or float32")
    x = x.contiguous()
    if x.numel() % 8 or x.numel() < 8:
        raise ValueError(f"{name}: needs a multiple of 8 elements")
    _aligned(name, x)
    return x


def quantize_int8(x: torch.Tensor, scale: torch.Tensor,
                  divide: bool = False) -> torch.Tensor:
    """x (any shape, bf16 or float32) -> int8 of the same shape with the
    device scalar ``scale``; see ``quantize_int8_plain``.  Runs the
    registered op ``scaleprotoseg::quantize_int8``."""
    _devices("quantize_int8", x)
    return _quantize_op(x, scale, divide)


quantize_int8.launches = 0


@torch.library.custom_op("scaleprotoseg::quantize_int8", mutates_args=(),
                         device_types="cpu")
def _quantize_op(x: torch.Tensor, scale: torch.Tensor,
                 divide: bool) -> torch.Tensor:
    return quantize_int8_plain(x, scale, divide)


@_quantize_op.register_kernel("cuda")
def _quantize_cuda(x, scale, divide):
    _cuda("quantize_int8", x, scale)
    x = _elementwise_input("quantize_int8", x)
    scale = scale.reshape(1)
    if scale.dtype != torch.float32:
        raise ValueError("quantize_int8: scale must be float32")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    status = _launchers()["quantize_int8"](
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), x.numel(),
        int(x.dtype == torch.bfloat16), int(divide), _stream(x))
    check(library("int8_mm"), status, "quantize_int8")
    quantize_int8.launches += 1
    return q


@_quantize_op.register_fake
def _quantize_fake(x, scale, divide):
    return x.new_empty(x.shape, dtype=torch.int8)


def int8_absmax(x: torch.Tensor) -> torch.Tensor:
    """The dynamic per-tensor scale ``max(max|x|, 1e-12) / 127`` as a
    float32 () tensor on x's device: per-block maxima, then one block;
    no host sync.  Runs the registered op ``scaleprotoseg::int8_absmax``."""
    _devices("int8_absmax", x)
    return _absmax_op(x)


int8_absmax.launches = 0


@torch.library.custom_op("scaleprotoseg::int8_absmax", mutates_args=(),
                         device_types="cpu")
def _absmax_op(x: torch.Tensor) -> torch.Tensor:
    return absmax_plain(x)


@_absmax_op.register_kernel("cuda")
def _absmax_cuda(x):
    x = _elementwise_input("int8_absmax", x)
    fns = _launchers()
    partials = torch.empty(fns["absmax_blocks"](x.numel()),
                           dtype=torch.float32, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    status = fns["int8_absmax"](x.data_ptr(), partials.data_ptr(),
                                scale.data_ptr(), x.numel(),
                                int(x.dtype == torch.bfloat16), _stream(x))
    check(library("int8_mm"), status, "int8_absmax")
    int8_absmax.launches += 1
    return scale


@_absmax_op.register_fake
def _absmax_fake(x):
    return x.new_empty((), dtype=torch.float32)
