"""The DeepLab-family backbones beside DeepLabV2-ResNet: dilated VGG16 and
DeepLabV3's multi-grid ResNet-101, as the JAX package's
``models/classic_backbones.py`` reconstructs them from the reference's
factory surface (``deeplab_features.py``; the defining files live in its
missing ``deeplab_pytorch`` submodule).  No shipped config binds them; a
reference checkpoint can hold them.

Parameters carry the JAX package's names, so
``checkpoints.convert.ppnet_params_to_statedict`` carries a JAX model
across with ``strict=True``: VGG's bare convs ``block{b}_conv{c}.{weight,
bias}`` and ``aspp.c{i}``; V3's ``layer1``-``layer4`` as DeepLabV2's,
``layer5_block{n}`` bottlenecks and the head's ``head_c{i}`` ConvBNs.
Tensors are NCHW; BN is frozen.  The torchvision-style extractors of the
JAX file (ResNet-18...152, VGG-11...19, DenseNet) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scaleprotoseg_torch.models.deeplab import (ASPP, Bottleneck, Stem,
                                                res_layer)
from scaleprotoseg_torch.models.layers import (ConvBN, HeadConv,
                                               lecun_normal_, max_pool_ceil)

VGG16_BLOCKS = (2, 2, 3, 3, 3)            # convs per block
VGG_WIDTHS = (64, 128, 256, 512, 512)


class DeepLabVGG16(nn.Module):
    """Dilated VGG16 at output stride 8 (pools of stride 2, 2, 2, 1, 1, the
    last block's convs dilated 2) and a 'sum' or 'concat' ASPP over its
    512 channels.  The ASPP always takes its plain form, as in the JAX
    package (``fast_aspp`` is DeepLabV2's)."""

    trainable_bn = False          # no BN at all

    def __init__(self, n_out: int,
                 atrous_rates: Tuple[int, ...] = (6, 12, 18, 24),
                 aspp_mode: str = "sum"):
        super().__init__()
        dilations = (1, 1, 1, 1, 2)
        self.pool_strides = (2, 2, 2, 1, 1)
        self.convs = []
        cin = 3
        for bi, n in enumerate(VGG16_BLOCKS):
            names = []
            for ci in range(n):
                d = dilations[bi]
                conv = HeadConv(cin, VGG_WIDTHS[bi], 3, padding=d,
                                dilation=d)
                lecun_normal_(conv.weight)
                nn.init.zeros_(conv.bias)
                name = f"block{bi + 1}_conv{ci + 1}"
                self.add_module(name, conv)
                names.append(name)
                cin = VGG_WIDTHS[bi]
            self.convs.append(names)
        self.pools = nn.ModuleList(max_pool_ceil(3, s, 1)
                                   for s in self.pool_strides)
        self.aspp = ASPP(cin, n_out, atrous_rates, aspp_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for names, pool in zip(self.convs, self.pools):
            for name in names:
                x = F.relu(getattr(self, name)(x))
            x = pool(x)
        return self.aspp(x)


class DeepLabV3Scale(nn.Module):
    """DeepLabV3's dilated ResNet (output stride 8 or 16) with a multi-grid
    last stage (``layer5_block{n}``, dilation ``d * multi_grids[n % 3]``)
    and four head branches, a 1x1 ``head_c0`` and a 3x3 atrous
    ``head_c{i}`` per rate, each ConvBN + ReLU, concatenated: 4 scales of
    ``n_out`` channels."""

    trainable_bn = False          # every BN frozen

    def __init__(self, n_out: int, n_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 atrous_rates: Tuple[int, ...] = (6, 12, 18),
                 multi_grids: Tuple[int, ...] = (1, 2, 4),
                 output_stride: int = 8):
        super().__init__()
        if output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        else:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        ch = [64 * 2 ** p for p in range(6)]
        self.layer1 = Stem(ch[0])
        cins = (ch[0], ch[2], ch[3])
        for i in range(3):
            self.add_module(f"layer{i + 2}", res_layer(
                n_blocks[i], cins[i], ch[i], ch[i + 2], strides[i],
                dilations[i]))
        self.n_last = n_blocks[3]
        for bi in range(self.n_last):
            d = dilations[3] * multi_grids[bi % len(multi_grids)]
            self.add_module(f"layer5_block{bi + 1}", Bottleneck(
                ch[4] if bi == 0 else ch[5], ch[3], ch[5],
                strides[3] if bi == 0 else 1, d, shortcut=(bi == 0)))
        self.head_c0 = ConvBN(ch[5], n_out, 1)
        for i, r in enumerate(atrous_rates):
            self.add_module(f"head_c{i + 1}", ConvBN(ch[5], n_out, 3,
                                                     dilation=r))
        self.n_heads = 1 + len(atrous_rates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        for bi in range(self.n_last):
            x = getattr(self, f"layer5_block{bi + 1}")(x)
        return torch.cat([getattr(self, f"head_c{i}")(x)
                          for i in range(self.n_heads)], 1)
