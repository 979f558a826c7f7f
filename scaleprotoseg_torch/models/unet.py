"""U-Net and U-Net + ASPP feature extractors of EM / ISBI-2012.

A standard U-Net of four 2 x 2 max-pools down and four linear resizes
up, each stage a ``DoubleConv`` (two 3 x 3 ``ConvBN`` with ReLU), whose
full-resolution decoder output feeds either the ASPP (``UNetASPP``: the
DeepLab head, rates 6/12/18/24, 'concat' or 'sum') or a 1 x 1 conv
(``UNet``'s ``outc``).  The output grid is the input's, so the prototype
head of an EM model runs at 512 x 512.

Parameters carry the JAX package's names (``body.inc.conv_a.conv.weight``,
``body.up4.conv_b.bn.running_var``, ``aspp.c0.weight``, ``outc.bias``), so
``checkpoints.convert.ppnet_params_to_statedict`` carries a JAX U-Net
across with ``strict=True``.  As in the JAX package:

- the pools floor (flax's VALID pool, torch's default);
- the up path resizes to the skip's size with ``jax.image.resize``'s
  half-pixel linear weights (``ops.resize.resize_bilinear``), so odd
  sizes resize by other factors than 2 (4 -> 9 at an input of 36 rows),
  and concatenates ``[skip, h]`` in that order;
- the BN is trainable and trains only where the caller passes
  ``train_bn`` (the trainers with ``freeze_type = 'none'``), not when the
  module is in training mode alone.

Tensors are NCHW, as the rest of the port's backbones.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from scaleprotoseg_torch.models.deeplab import ASPP
from scaleprotoseg_torch.models.layers import ConvBN, HeadConv
from scaleprotoseg_torch.ops import as_dtype
from scaleprotoseg_torch.ops.resize import resize_bilinear


class DoubleConv(nn.Module):
    """Two 3 x 3 ``ConvBN`` + ReLU: ``conv_a``, ``conv_b``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_a = ConvBN(cin, cout, 3, trainable_bn=True)
        self.conv_b = ConvBN(cout, cout, 3, trainable_bn=True)

    def forward(self, x: torch.Tensor, train_bn: bool = False
                ) -> torch.Tensor:
        return self.conv_b(self.conv_a(x, train_bn), train_bn)


def resize_to(h: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, height, width) in ``h``'s dtype: the JAX
    package's ``jax.image.resize(method='linear')`` (float32 weights)."""
    out = resize_bilinear(h.permute(0, 2, 3, 1), height, width)
    return as_dtype(out.permute(0, 3, 1, 2), h.dtype)


class UNetEncoderDecoder(nn.Module):
    """The U-Net body (``inc``, ``down1..4``, ``up1..4``) of width
    ``base``: (B, 3, H, W) -> (B, base, H, W)."""

    def __init__(self, base: int = 64, cin: int = 3):
        super().__init__()
        c = base
        self.inc = DoubleConv(cin, c)
        self.down1 = DoubleConv(c, 2 * c)
        self.down2 = DoubleConv(2 * c, 4 * c)
        self.down3 = DoubleConv(4 * c, 8 * c)
        self.down4 = DoubleConv(8 * c, 8 * c)
        # input channels: the skip's, then the resized map's
        self.up1 = DoubleConv(8 * c + 8 * c, 4 * c)
        self.up2 = DoubleConv(4 * c + 4 * c, 2 * c)
        self.up3 = DoubleConv(2 * c + 2 * c, c)
        self.up4 = DoubleConv(c + c, c)

    def forward(self, x: torch.Tensor, train_bn: bool = False
                ) -> torch.Tensor:
        d0 = self.inc(x, train_bn)
        d1 = self.down1(F.max_pool2d(d0, 2, 2), train_bn)
        d2 = self.down2(F.max_pool2d(d1, 2, 2), train_bn)
        d3 = self.down3(F.max_pool2d(d2, 2, 2), train_bn)
        d4 = self.down4(F.max_pool2d(d3, 2, 2), train_bn)
        h = d4
        for skip, up in ((d3, self.up1), (d2, self.up2), (d1, self.up3),
                         (d0, self.up4)):
            h = resize_to(h, skip.shape[2], skip.shape[3])
            h = up(torch.cat([skip, h], dim=1), train_bn)
        return h


class UNetASPP(nn.Module):
    """U-Net body + ASPP head: ``n_out`` channels a rate, concatenated
    (``multiscale``) or summed.  The ASPP's input has ``base`` channels,
    below K2's ``KERNEL_MIN_C``, so it always takes the shifted-matmul
    form (the trainer keeps ``fast_aspp`` off for this backbone, as the
    JAX package's does)."""

    trainable_bn = True
    takes_fast_aspp = True        # the knob exists (the trainer keeps it off)

    def __init__(self, n_out: int, rates: Sequence[int] = (6, 12, 18, 24),
                 multiscale: bool = True, base: int = 64):
        super().__init__()
        self.body = UNetEncoderDecoder(base)
        self.aspp = ASPP(base, n_out, rates,
                         "concat" if multiscale else "sum")

    def forward(self, x: torch.Tensor, train_bn: bool = False
                ) -> torch.Tensor:
        return self.aspp(self.body(x, train_bn))


class UNet(nn.Module):
    """U-Net body + a 1 x 1 conv head ``outc`` (with bias) to ``n_out``
    channels."""

    trainable_bn = True

    def __init__(self, n_out: int, base: int = 64):
        super().__init__()
        self.body = UNetEncoderDecoder(base)
        self.outc = HeadConv(base, n_out, 1)

    def forward(self, x: torch.Tensor, train_bn: bool = False
                ) -> torch.Tensor:
        return self.outc(self.body(x, train_bn))
