"""Dilated 3x3 convolution with the hybrid backward of the JAX package's
``ops/gradconv.py``: the weight gradient as shifted products over the
pixel axis, the input gradient as one convolution.

    y[q]  = sum_k x[q + (k-1)d] W[k]
    dW[k] = sum_q x[q + (k-1)d]^T dy[q]      (nine shifted products)
    dx[q] = sum_k dy[q - (k-1)d] W[k]^T      (= conv(dy, rot180(W)^T))

The forward is the ``F.conv2d`` call ``ConvBN`` makes, so it gives the
same bits.  The backward re-expresses the same sums (same operands,
float32 accumulation) in another order; it approximates nothing.  The
products are the JAX package's XLA products, not a Pallas kernel, so here
they are ``torch.matmul`` and ``F.conv2d``.

Layout: the backbone runs NCHW tensors in ``channels_last`` memory, where
the NHWC permutes below are free views.  The weight gradient copies x ten
times: once zero-padded, then its nine shifted taps gathered into one
(pixels, 9 * Cin) matrix, so that the nine products run as one
(9 * Cin, pixels) x (pixels, Cout) GEMM (a dy that is not NHWC-contiguous
costs one copy of dy more).  dx is one ``F.conv2d`` of dy with the
flipped, IO-swapped kernel at the same dilation and padding.

bf16: ``ConvBN`` hands the weight in already cast to the compute dtype,
as the JAX package casts its kernel; dW comes back in that dtype (the
GEMM's float32 sums rounded once) and flows through the cast to the
float32 parameter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    return F.conv2d(x, w, None, (1, 1), (d, d), (d, d))


def grad_weight(x: torch.Tensor, dy: torch.Tensor, d: int) -> torch.Tensor:
    """dW (Cout, Cin, 3, 3) of the 'same' stride-1 3x3 conv at dilation
    ``d``, from x (B, Cin, H, W) and dy (B, Cout, H, W)."""
    b, cin, h, w = x.shape
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, d, d, d, d))  # (B, H+2d, W+2d, C)
    taps = torch.cat([xp[:, ky * d:ky * d + h, kx * d:kx * d + w]
                      for ky in range(3) for kx in range(3)], dim=-1)
    dy2 = dy.permute(0, 2, 3, 1).reshape(b * h * w, -1)
    dw = taps.reshape(b * h * w, 9 * cin).t() @ dy2         # (9*Cin, Cout)
    return dw.reshape(3, 3, cin, -1).permute(3, 2, 0, 1)


def grad_input(dy: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """dx (B, Cin, H, W): one conv of dy with the spatially flipped,
    IO-swapped kernel at the same dilation and padding."""
    return _conv(dy, w.flip(2, 3).transpose(0, 1), d)


class _Conv3x3Dilated(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, dilation: int):
        ctx.dilation = dilation
        ctx.save_for_backward(x, w)
        return _conv(x, w, dilation)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        d = ctx.dilation
        dx = grad_input(dy, w, d).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = grad_weight(x, dy.to(x.dtype), d).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def conv3x3_dilated(x: torch.Tensor, w: torch.Tensor,
                    dilation: int) -> torch.Tensor:
    """'Same'-padded stride-1 dilated 3x3 conv, x (B, Cin, H, W) and w
    (Cout, Cin, 3, 3) in one dtype, with the hybrid backward.  Where no
    gradient is recorded the conv runs alone."""
    if w.shape[-2:] != (3, 3):
        raise ValueError(f"conv3x3_dilated takes a 3x3 kernel, got "
                         f"{tuple(w.shape)}")
    if not torch.is_grad_enabled():
        return _conv(x, w, dilation)
    return _Conv3x3Dilated.apply(x, w, dilation)
