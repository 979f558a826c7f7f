"""Model construction from a run's config bindings.

Covers the DeepLabV2 ResNet backbones of the Cityscapes and Pascal configs
(``deeplabv2_resnet{101,50}`` with a summed ASPP and their ``_multiscale``
concat-ASPP twins), with the MSC input pyramid of their ``scales``
binding (1.0 entries dropped, as the JAX package does), and EM's U-Nets
(``unet_aspp``: ``unet_aspp_features.{unet_n_features, multiscale,
scales, unet_base}``, a concat ASPP of ``n_features`` x 4 channels or a
summed one of ``n_features``; ``unet``: ``unet_features.{unet_n_features,
scales}`` at base 64).  ``quant8`` (int8 serving of layer4/5) applies to
the DeepLab backbones, pyramid included: the pyramid calls the one
backbone once per map, so a static site calibrates over all of them and
serves every map with its one scale.  The other backbones and the scale
head are not part of the port yet and are refused by name.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from scaleprotoseg_torch.configlib import Bindings, query
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
}
# EM's U-Nets: name -> config name
_UNETS = {"unet_aspp": "unet_aspp_features", "unet": "unet_features"}


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
    if base_architecture not in _BACKBONES:
        raise NotImplementedError(
            f"backbone {base_architecture!r} is not ported yet; the port "
            f"has {sorted([*_BACKBONES, *_UNETS])}")
    name, n_blocks, mode = _BACKBONES[base_architecture]
    n_features = _required(bindings, name, "deeplab_n_features")
    scales = _pyramid(bindings, name)
    backbone = DeepLabV2(n_out=int(n_features), n_blocks=n_blocks,
                         atrous_rates=RATES, aspp_mode=mode, quant8=quant8)
    out_ch = int(n_features) * (len(RATES) if mode == "concat" else 1)
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
                    quant8=False) -> Tuple[PPNet, ProtoSpec]:
    """Build (model, spec).  ``variant``: 'single' | 'multiscale' | 'group'.

    ``spec`` overrides the equal-allocation bank (a pushed or pruned
    checkpoint's own layout); ``quant8`` (False, True or 'static') runs
    the backbone's layer4/5 as int8 convs (``DeepLabV2``)."""
    bindings = bindings or {}
    if variant not in ("single", "multiscale", "group"):
        raise ValueError(variant)
    if scale_head_type is not None:
        raise NotImplementedError("the scale head is not ported yet")
    cls_name = "PPNet" if variant == "single" else "PPNetMultiScale"
    num_scales = 1 if variant == "single" else \
        int(query(bindings, cls_name, "num_scales", 4))
    num_groups = int(query(bindings, cls_name, "num_groups", 3)) \
        if variant == "group" else 0
    if not query(bindings, cls_name, "patch_classification", True):
        raise NotImplementedError("only per-pixel classification exists")
    backbone, out_ch, msc_scales = build_backbone(base_architecture,
                                                  bindings, quant8)
    if spec is None:
        spec = ProtoSpec.equal_allocation(
            prototype_shape[0], prototype_shape[1], num_classes,
            num_scales=num_scales, num_groups=num_groups)
    if spec.feature_depth != out_ch:
        raise ValueError(
            f"backbone channels {out_ch} != num_scales*proto_depth "
            f"{spec.feature_depth}; check deeplab_n_features / num_scales")
    model = PPNet(backbone, spec, add_on_type=add_on_layers_type,
                  activation_fn=prototype_activation_function,
                  grouped=(variant == "group"),
                  incorrect_strength=incorrect_strength,
                  msc_scales=msc_scales, dtype=dtype, generator=generator)
    return model, spec
