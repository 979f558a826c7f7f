"""Model construction from a run's config bindings.

Covers the DeepLabV2 ResNet backbones of the Cityscapes and Pascal configs
(``deeplabv2_resnet{101,50}`` with a summed ASPP and their ``_multiscale``
concat-ASPP twins), with the MSC input pyramid of their ``scales``
binding (1.0 entries dropped, as the JAX package does), and EM's U-Nets
(``unet_aspp``: ``unet_aspp_features.{unet_n_features, multiscale,
scales, unet_base}``, a concat ASPP of ``n_features`` x 4 channels or a
summed one of ``n_features``; ``unet``: ``unet_features.{unet_n_features,
scales}`` at base 64).  The other DeepLab-family models a reference
checkpoint can hold, bound by no shipped config: ``deeplabv2_vgg16``
(summed ASPP) and ``deeplabv2_vgg16_multiscale`` (concat),
``deeplabv3_resnet101_multiscale`` (DeepLabV3's four head branches) and
``deeplabv2_resnet101_multiscaleplus`` (the 'concat_plus' ASPP), each
reading ``deeplab_n_features`` and ``scales`` of its ``*_features``
binding as the JAX package's factories do.

``quant8`` (int8 serving of layer4/5) applies to the DeepLabV2 ResNet
backbones, pyramid included: the pyramid calls the one backbone once per
map, so a static site calibrates over all of them and serves every map
with its one scale.  The torchvision-style extractors and SegFormer are
not part of the port yet and are refused by name.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from scaleprotoseg_torch.configlib import Bindings, query
from scaleprotoseg_torch.models.classic_backbones import (DeepLabV3Scale,
                                                          DeepLabVGG16)
from scaleprotoseg_torch.models.deeplab import DeepLabV2
from scaleprotoseg_torch.models.ppnet import PPNet
from scaleprotoseg_torch.models.unet import UNet, UNetASPP
from scaleprotoseg_torch.spec import ProtoSpec

RATES = (6, 12, 18, 24)
_BACKBONES = {
    # name -> (config name, ResNet blocks, ASPP mode)
    "deeplabv2_resnet101": ("deeplabv2_resnet101_features", (3, 4, 23, 3),
                            "sum"),
    "deeplabv2_resnet50": ("deeplabv2_resnet50_features", (3, 4, 6, 3),
                           "sum"),
    "deeplabv2_resnet101_multiscale": (
        "deeplabv2_resnet101_features_multiscale", (3, 4, 23, 3), "concat"),
    "deeplabv2_resnet50_multiscale": (
        "deeplabv2_resnet50_features_multiscale", (3, 4, 6, 3), "concat"),
    "deeplabv2_resnet101_multiscaleplus": (
        "deeplabv2_resnet101_features_multiscaleplus", (3, 4, 23, 3),
        "concat_plus"),
}
# dilated VGG16: name -> (config name, ASPP mode)
_VGG = {"deeplabv2_vgg16": ("deeplabv2_vgg16_features", "sum"),
        "deeplabv2_vgg16_multiscale": ("deeplabv2_vgg16_features_multiscale",
                                       "concat")}
# DeepLabV3: name -> (config name, ResNet blocks)
_V3 = {"deeplabv3_resnet101_multiscale": (
    "deeplabv3_resnet101_features_multiscale", (3, 4, 23, 3))}
# EM's U-Nets: name -> config name
_UNETS = {"unet_aspp": "unet_aspp_features", "unet": "unet_features"}
# the JAX package's other names, refused by name
NOT_PORTED = ("segformer", "segformer_multiscale", "resnet18", "resnet34",
              "resnet50", "resnet101", "resnet152", "vgg11", "vgg11_bn",
              "vgg13", "vgg13_bn", "vgg16", "vgg16_bn", "vgg19", "vgg19_bn",
              "densenet121", "densenet161", "densenet169", "densenet201")


def _required(bindings: Bindings, name: str, param: str) -> int:
    value = query(bindings, name, param)
    if value is None:
        raise ValueError(f"{name}.{param} is REQUIRED")
    return int(value)


def _pyramid(bindings: Bindings, name: str) -> Tuple[float, ...]:
    """The MSC pyramid of a ``scales`` binding: its entries but 1.0
    (empty: none)."""
    return tuple(float(s) for s in
                 (query(bindings, name, "scales", ()) or ()) if s != 1.0)


def build_backbone(base_architecture: str, bindings: Bindings,
                   quant8=False) -> Tuple[nn.Module, int, Tuple[float, ...]]:
    """(backbone, output channels, MSC pyramid scales) for a named
    architecture; ``quant8`` as ``DeepLabV2``'s (a U-Net refuses it)."""
    if base_architecture in _UNETS:
        name = _UNETS[base_architecture]
        if quant8:
            raise ValueError(f"quant8 serving needs a DeepLabV2 backbone; "
                             f"got {base_architecture!r}")
        n_features = _required(bindings, name, "unet_n_features")
        if base_architecture == "unet":
            return UNet(n_features), n_features, _pyramid(bindings, name)
        multiscale = bool(query(bindings, name, "multiscale", False))
        backbone = UNetASPP(n_features, RATES, multiscale,
                            int(query(bindings, name, "unet_base", 64)))
        out_ch = n_features * (len(RATES) if multiscale else 1)
        return backbone, out_ch, _pyramid(bindings, name)
    if base_architecture in (*_VGG, *_V3):
        if quant8:
            raise ValueError(f"quant8 serving needs a DeepLabV2 ResNet "
                             f"backbone; got {base_architecture!r}")
        if base_architecture in _VGG:
            name, mode = _VGG[base_architecture]
            n_features = _required(bindings, name, "deeplab_n_features")
            return (DeepLabVGG16(n_features, RATES, mode),
                    n_features * (len(RATES) if mode == "concat" else 1),
                    _pyramid(bindings, name))
        name, n_blocks = _V3[base_architecture]
        n_features = _required(bindings, name, "deeplab_n_features")
        return (DeepLabV3Scale(n_features, n_blocks), 4 * n_features,
                _pyramid(bindings, name))
    if base_architecture not in _BACKBONES:
        ported = sorted([*_BACKBONES, *_VGG, *_V3, *_UNETS])
        why = "is not ported yet" if base_architecture in NOT_PORTED \
            else "is unknown"
        raise NotImplementedError(
            f"backbone {base_architecture!r} {why}; the port has {ported}")
    name, n_blocks, mode = _BACKBONES[base_architecture]
    n_features = _required(bindings, name, "deeplab_n_features")
    scales = _pyramid(bindings, name)
    backbone = DeepLabV2(n_out=int(n_features), n_blocks=n_blocks,
                         atrous_rates=RATES, aspp_mode=mode, quant8=quant8)
    out_ch = int(n_features) * (len(RATES) if mode.startswith("concat")
                                else 1)
    return backbone, out_ch, scales


def construct_ppnet(variant: str, base_architecture: str,
                    prototype_shape=(2000, 512, 1, 1), num_classes: int = 200,
                    prototype_activation_function: str = "log",
                    add_on_layers_type: str = "deeplab_simple",
                    scale_head_type: Optional[str] = None,
                    bindings: Optional[Bindings] = None,
                    spec: Optional[ProtoSpec] = None,
                    incorrect_strength: float = -0.5,
                    dtype: torch.dtype = torch.float32,
                    generator: Optional[torch.Generator] = None,
                    quant8=False, log=print) -> Tuple[PPNet, ProtoSpec]:
    """Build (model, spec).  ``variant``: 'single' | 'multiscale' | 'group'.

    ``spec`` overrides the equal-allocation bank (a pushed or pruned
    checkpoint's own layout); ``quant8`` (False, True or 'static') runs
    the backbone's layer4/5 as int8 convs (``DeepLabV2``).  A model whose
    head K1 cannot compute (a scale head, an activation but 'log') says
    so through ``log``: its ``fast_logits`` runs the plain head."""
    bindings = bindings or {}
    if variant not in ("single", "multiscale", "group"):
        raise ValueError(variant)
    cls_name = "PPNet" if variant == "single" else "PPNetMultiScale"
    num_scales = 1 if variant == "single" else \
        int(query(bindings, cls_name, "num_scales", 4))
    num_groups = int(query(bindings, cls_name, "num_groups", 3)) \
        if variant == "group" else 0
    bottleneck_stride = query(bindings, cls_name, "bottleneck_stride", None)
    if not query(bindings, cls_name, "patch_classification", True):
        raise NotImplementedError("only per-pixel classification exists")
    backbone, out_ch, msc_scales = build_backbone(base_architecture,
                                                  bindings, quant8)
    if spec is None:
        spec = ProtoSpec.equal_allocation(
            prototype_shape[0], prototype_shape[1], num_classes,
            num_scales=num_scales, num_groups=num_groups)
    if spec.feature_depth != out_ch and add_on_layers_type == "deeplab_simple":
        raise ValueError(
            f"backbone channels {out_ch} != num_scales*proto_depth "
            f"{spec.feature_depth}; check deeplab_n_features / num_scales")
    model = PPNet(backbone, spec, add_on_type=add_on_layers_type,
                  activation_fn=prototype_activation_function,
                  grouped=(variant == "group"),
                  incorrect_strength=incorrect_strength,
                  msc_scales=msc_scales, dtype=dtype, generator=generator,
                  backbone_channels=out_ch, scale_head_type=scale_head_type,
                  bottleneck_stride=bottleneck_stride)
    if not model.kernel_head:
        log(f"prototype head: the plain head in fast_logits, not K1 (scale "
            f"head {scale_head_type!r}, activation "
            f"{prototype_activation_function!r}: K1 computes the log "
            "activation of scale-free distances)")
    return model, spec
