"""w8a8 int8 convolution for inference serving (the quant8 path).

The port's counterpart of ``scaleprotoseg_tpu/ops/quant.py``, NHWC inputs
and HWIO kernels as there:

- ``quantize_symmetric``: int8 values and a float32 scale
  ``max(amax, 1e-12) / 127``, per tensor or per kept axis, by division;
- ``dynamic_int8_conv``: both operands quantized per call (activation per
  tensor by division, weight per output channel over (H, W, I));
- ``static_int8_conv``: the activation scale fixed by calibration, the
  quantize a multiply by ``1 / max(s, 1e-12)``.  The two forms round
  differently at .5 boundaries and are kept apart on purpose.

Rounding is half to even, values clip to +-127, and the int32 accumulator
is dequantized as ``float(acc) * (sx * sw)`` (the scale product first),
then cast to ``out_dtype``.  These three are the plain versions: their
int8 products run in float64 (exact) and are cast to int32, so the
int32 -> float32 cast rounds where XLA's does.

``int8_conv`` is the card dispatch the model uses: ``quantize_int8``
(after ``int8_absmax`` in the dynamic form), then ``int8_mm`` for a 1x1
conv or ``int8_conv3x3`` for a dilated 3x3 conv, with the dequantize
fused into the product's epilogue; the weight comes quantized and
transposed once from ``pack_int8_weight``.  On CPU tensors those wrappers
run their plain versions, so the dispatch equals ``static_int8_conv`` /
``dynamic_int8_conv`` bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from scaleprotoseg_torch.kernels.int8 import (absmax_plain, dequantize,
                                              int8_absmax, int8_conv3x3,
                                              int8_mm, quantize_int8,
                                              quantize_int8_plain)

Padding = Union[str, Sequence[Tuple[int, int]]]


def quantize_symmetric(x: torch.Tensor, axis=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) with ``x ~= values * scale``.
    ``axis=None``: one per-tensor scale; an int or tuple keeps those axes
    and reduces the rest (per channel)."""
    if axis is None:
        scale = shaped = absmax_plain(x)
    else:
        keep = (axis,) if isinstance(axis, int) else tuple(axis)
        keep = tuple(a % x.dim() for a in keep)
        reduce_axes = tuple(i for i in range(x.dim()) if i not in keep)
        amax = x.float().abs().amax(dim=reduce_axes, keepdim=True)
        shaped = torch.clamp_min(amax, 1e-12) / 127.0
        scale = shaped.reshape([x.shape[a] for a in keep])
    return quantize_int8_plain(x, shaped, divide=True), scale


def _pads(padding: Padding, in_hw, kernel_hw, strides, dilation):
    """Explicit ((lo, hi), (lo, hi)) padding; 'SAME' as XLA computes it."""
    if padding != "SAME":
        return [tuple(p) for p in padding]
    pads = []
    for n, k, s, d in zip(in_hw, kernel_hw, strides, dilation):
        eff = (k - 1) * d + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, strides,
                     padding: Padding, dilation) -> torch.Tensor:
    """int32 NHWC conv of int8 NHWC ``xq`` and HWIO ``wq``, from a float64
    conv (exact below 2^53)."""
    dilation = tuple(dilation or (1, 1))
    pads = _pads(padding, xq.shape[1:3], wq.shape[:2], strides, dilation)
    xd = F.pad(xq.double().permute(0, 3, 1, 2),
               (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    acc = F.conv2d(xd, wq.double().permute(3, 2, 0, 1), None,
                   tuple(strides), 0, dilation)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def dynamic_int8_conv(x: torch.Tensor, kernel: torch.Tensor, *,
                      strides: Sequence[int] = (1, 1),
                      padding: Padding = "SAME",
                      dilation: Optional[Sequence[int]] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """NHWC/HWIO conv with both operands quantized per call; float32
    output unless ``out_dtype``."""
    xq, sx = quantize_symmetric(x)
    wq, sw = quantize_symmetric(kernel, axis=3)
    acc = _int8_conv_plain(xq, wq, strides, padding, dilation)
    return dequantize(acc, sx, sw, out_dtype or torch.float32)


def static_int8_conv(x: torch.Tensor, kernel: torch.Tensor,
                     x_scale: torch.Tensor, *,
                     strides: Sequence[int] = (1, 1),
                     padding: Padding = "SAME",
                     dilation: Optional[Sequence[int]] = None,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """``dynamic_int8_conv`` with the activation scale ``x_scale`` (a
    float32 scalar from calibration); values outside the calibrated range
    saturate at +-127."""
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    xq = quantize_int8_plain(x, xs)
    wq, sw = quantize_symmetric(kernel, axis=3)
    acc = _int8_conv_plain(xq, wq, strides, padding, dilation)
    return dequantize(acc, xs, sw, out_dtype or torch.float32)


def pack_int8_weight(kernel: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO kernel -> (wt (kh*kw, O, I) int8, K-contiguous, tap ky*kw+kx;
    sw (O,) float32), the per-output-channel quantization of
    ``quantize_symmetric(kernel, axis=3)``.  A model packs once per set of
    weights."""
    kh, kw, ci, co = kernel.shape
    wq, sw = quantize_symmetric(kernel, axis=3)
    wt = wq.permute(0, 1, 3, 2).reshape(kh * kw, co, ci).contiguous()
    return wt, sw.contiguous()


def int8_conv(x: torch.Tensor, packed: Tuple[torch.Tensor, torch.Tensor],
              x_scale: Optional[torch.Tensor] = None, dilation: int = 1,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stride-1 'SAME' int8 conv of x (B, H, W, C) through the kernels:
    ``x_scale`` set is the static form, None the dynamic one.  ``packed``
    is ``pack_int8_weight`` of a 1x1 or 3x3 kernel.  Returns (B, H, W, O)
    in ``out_dtype``."""
    wt, sw = packed
    b, h, w, c = x.shape
    if x_scale is None:
        sx = int8_absmax(x)
        xq = quantize_int8(x, sx, divide=True)
    else:
        sx = x_scale
        xq = quantize_int8(x, sx)
    if wt.shape[0] == 1:
        out = int8_mm(xq.reshape(b * h * w, c), wt[0], sx, sw, out_dtype)
        return out.reshape(b, h, w, -1)
    if wt.shape[0] == 9:
        return int8_conv3x3(xq, wt, dilation, sx, sw, out_dtype)
    raise ValueError(f"int8_conv: 1x1 or 3x3 kernels only, got "
                     f"{wt.shape[0]} taps")
