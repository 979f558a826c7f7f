"""DeepLabV2 dilated ResNet with a sum/concat ASPP head (output stride 8).

The reference naming (``layer1.conv1``, ``layerN.blockM.{reduce,conv3x3,
increase,shortcut}.{conv,bn}``, ``aspp.c0..c3``) is kept so reference-named
state dicts load with ``strict=True``.  Stride sits on the 1x1 reduce conv
(COCO/caffe convention); layer3 strides 2, layer4/5 dilate by 2/4.

Modules take and return NCHW tensors; on the card they run in
channels_last memory, where the NCHW <-> NHWC permutes the ASPP and the
prototype head need are free views.

ASPP (``aspp_mode='concat'``: rate r's F channels at ``[r*F, (r+1)*F)``;
``'sum'``: branches summed):

- ``fast`` and bf16: ``kernels.aspp.aspp_trainable``, the JAX package's
  ``fused_aspp_trainable``: the K2 kernel forward at C >= 512 (the
  shifted-matmul form with the same bf16 contract below), the tap-packed
  backward kernels in training; its bf16 output cast to float32.  K2's
  packed weight stack is built once per set of weights, so once per
  optimizer step in training, while the per-rate weights stay the
  Function's inputs and take the gradients;
- otherwise the shifted-matmul form (weights rounded to the input dtype,
  float32 sums), as the JAX package's XLA path.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import partial
from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn

from scaleprotoseg_torch.kernels.aspp import (KERNEL_MIN_C, aspp_trainable,
                                              pack_weights, shifted_sum)
from scaleprotoseg_torch.models.layers import (ConvBN, QuantConvBN,
                                               WeightCache, max_pool_ceil)

Quant8 = Union[bool, str]       # False | True (dynamic) | "static"


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (dilated) -> 1x1 increase, projection shortcut on
    the first block of a layer."""

    def __init__(self, cin: int, mid: int, out: int, stride: int,
                 dilation: int, shortcut: bool, quant8: Quant8 = False):
        super().__init__()
        conv_bn = partial(QuantConvBN, static=quant8 == "static") \
            if quant8 else ConvBN
        self.reduce = conv_bn(cin, mid, 1, stride=stride)
        self.conv3x3 = conv_bn(mid, mid, 3, dilation=dilation)
        self.increase = conv_bn(mid, out, 1, relu=False)
        self.shortcut = conv_bn(cin, out, 1, stride=stride, relu=False) \
            if shortcut else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.increase(self.conv3x3(self.reduce(x)))
        s = self.shortcut(x) if self.shortcut is not None else x
        return torch.relu_(h + s)


def res_layer(n_blocks: int, cin: int, mid: int, out: int, stride: int,
              dilation: int, quant8: Quant8 = False) -> nn.Sequential:
    return nn.Sequential(OrderedDict(
        (f"block{i + 1}", Bottleneck(cin if i == 0 else out, mid, out,
                                     stride if i == 0 else 1, dilation,
                                     shortcut=(i == 0), quant8=quant8))
        for i in range(n_blocks)))


class Stem(nn.Module):
    """7x7/2 conv + BN + ReLU + 3x3/2 ceil-mode max pool."""

    def __init__(self, out: int = 64):
        super().__init__()
        self.conv1 = ConvBN(3, out, 7, stride=2, padding=3)
        self.pool = max_pool_ceil()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pool(self.conv1(x))


class ASPPBranch(nn.Module):
    """Parameters of one 3x3 atrous branch: ``weight`` (F, C, 3, 3) and
    ``bias`` (F,), as an ``nn.Conv2d`` would name them."""

    def __init__(self, cin: int, cout: int, rate: int):
        super().__init__()
        self.rate = rate
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.normal_(self.weight, std=0.01)

    def hwio(self) -> torch.Tensor:
        """(3, 3, C, F) view, the JAX package's kernel layout."""
        return self.weight.permute(2, 3, 1, 0)


class ASPP(nn.Module):
    """Parallel 3x3 atrous branches ``c0..c{R-1}`` in 'sum' or 'concat'
    mode; see the module docstring for the three forms."""

    def __init__(self, cin: int, n_out: int, rates: Sequence[int],
                 mode: str, fast: bool = False):
        super().__init__()
        if mode not in ("sum", "concat"):
            raise ValueError(f"Unknown ASPP mode: {mode}")
        self.rates = tuple(rates)
        self.mode = mode
        self.fast = fast
        for i, r in enumerate(self.rates):
            self.add_module(f"c{i}", ASPPBranch(cin, n_out, r))
        self._packed = WeightCache()      # K2's weight stack, built once

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1).contiguous()        # NHWC
        branches = self._branches()
        weights = [b.hwio() for b in branches]
        biases = [b.bias for b in branches]
        if self.fast and x.dtype == torch.bfloat16:
            packed = None
            if "k2_wstack" in self._buffers:       # held for export
                packed = (self.k2_wstack, self.k2_bias)
            elif xh.shape[-1] >= KERNEL_MIN_C:
                packed = self._packed.get(list(self.parameters()),
                                          self._pack)
            y = aspp_trainable(xh, weights, biases, self.rates,
                               packed).float()
        else:
            y = shifted_sum(xh, weights, biases, self.rates)
        if self.mode == "sum":
            y = y.reshape(*y.shape[:-1], len(self.rates), -1).sum(-2)
        return y.permute(0, 3, 1, 2)

    def _branches(self) -> list:
        return [getattr(self, f"c{i}") for i in range(len(self.rates))]

    def _pack(self):
        branches = self._branches()
        return pack_weights([b.hwio() for b in branches],
                            [b.bias for b in branches])

    def packed_buffers(self) -> dict:
        """K2's weight stack and bias, for ``packed_as_buffers`` (none
        unless ``fast`` and the input depth reaches ``KERNEL_MIN_C``)."""
        if not self.fast or self.c0.weight.shape[1] < KERNEL_MIN_C:
            return {}
        wstack, bias = self._pack()
        return {"k2_wstack": wstack, "k2_bias": bias}


class DeepLabV2(nn.Module):
    """Dilated ResNet + ASPP feature extractor (output stride 8).

    ``n_blocks=(3, 4, 23, 3)`` is ResNet-101, ``(3, 4, 6, 3)`` ResNet-50.
    Output channels: ``n_out`` for 'sum', ``len(rates) * n_out`` for
    'concat'.  ``fast_gradconv``: see ``set_fast_gradconv``."""

    def __init__(self, n_out: int, n_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 atrous_rates: Tuple[int, ...] = (6, 12, 18, 24),
                 aspp_mode: str = "concat", fast_aspp: bool = False,
                 quant8: Quant8 = False, fast_gradconv: bool = False):
        super().__init__()
        if quant8 not in (False, True, "static"):
            raise ValueError(f"quant8 must be False, True or 'static', got "
                             f"{quant8!r}")
        self.quant8 = quant8
        ch = [64 * 2 ** p for p in range(6)]
        self.layer1 = Stem(ch[0])
        self.layer2 = res_layer(n_blocks[0], ch[0], ch[0], ch[2], 1, 1)
        self.layer3 = res_layer(n_blocks[1], ch[2], ch[1], ch[3], 2, 1)
        self.layer4 = res_layer(n_blocks[2], ch[3], ch[2], ch[4], 1, 2,
                                quant8)
        self.layer5 = res_layer(n_blocks[3], ch[4], ch[3], ch[5], 1, 4,
                                quant8)
        self.aspp = ASPP(ch[5], n_out, atrous_rates, aspp_mode,
                         fast=fast_aspp)
        self.set_fast_gradconv(fast_gradconv)

    def set_fast_gradconv(self, on: bool) -> None:
        """Route the dilated 3x3 convs of layer4 and layer5 (d = 2, 4)
        through the hybrid backward of ``ops/gradconv.py`` (``on``) or
        cuDNN's.  The d = 1 convs of layer2/3 keep cuDNN's; parameters
        and state dict are unchanged."""
        if on and self.quant8:
            raise ValueError("fast_gradconv is a training knob; quant8 "
                             "serving convs take no gradient")
        for layer in (self.layer4, self.layer5):
            for block in layer:
                block.conv3x3.fast_grad = on
        self.fast_gradconv = on

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4,
                      self.layer5):
            x = layer(x)
        return self.aspp(x)
