"""Rebuild a PPNet from a run directory and a checkpoint.

A run directory holds ``config.gin`` (the experiment config) and
``checkpoints/<stage>.ckpt.json`` (the spec sidecar) beside
``checkpoints/<stage>.pth`` (the reference-named state dict, as the port
and ``convert_checkpoint export-torch`` write it) or, for a run the JAX
package trained, its msgpack ``checkpoints/<stage>.ckpt``, read by
``checkpoints.jax_ckpt`` and carried in memory (the ``.pth`` wins where
both exist).

``quant8='static'`` models calibrate their activation scales with
``calibrate_quant_scales`` before they serve.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple, Union

import torch

from scaleprotoseg_torch import configlib
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     spec_from_meta)
from scaleprotoseg_torch.device import resolve_device  # noqa: F401
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.models.layers import QuantConvBN, cast_convs
from scaleprotoseg_torch.models.ppnet import PPNet
from scaleprotoseg_torch.spec import ProtoSpec


def resolve_checkpoint(model_path: str, training_phase: str) -> str:
    """Reference checkpoint naming: ``<run>/checkpoints/<stage>.ckpt``."""
    if training_phase == "pruned":
        return os.path.join(model_path, "pruned", "checkpoints",
                            "push_last.ckpt")
    if training_phase in ("final-group", "push_final"):
        return os.path.join(model_path, "checkpoints",
                            f"{training_phase}.ckpt")
    return os.path.join(model_path, "checkpoints",
                        f"{training_phase}_last.ckpt")


def quant_sites(model: torch.nn.Module):
    """The ``(name, QuantConvBN)`` sites of a quant8 model, in order."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, QuantConvBN)]


def calibrate_quant_scales(model: PPNet, batches: Iterable[torch.Tensor],
                           log=None) -> PPNet:
    """Post-training max calibration of a ``quant8='static'`` model: run
    the float forward over ``batches`` (normalized (B, H, W, 3) tensors
    on the model's device, in its input space) with every static site
    folding ``max|x| / 127`` into its scale.  A model with the MSC input
    pyramid makes the pyramid itself: each site then folds the base map
    and every pyramid map into its one scale, in that order, as the JAX
    package's ``calibrate_quant_scales`` does, and serves all of them
    with it.  Returns ``model``, ready to serve.  Raises on a model
    without static sites or an empty ``batches``."""
    sites = [m for _, m in quant_sites(model) if m.static]
    if not sites:
        raise ValueError("calibrate_quant_scales: the model has no "
                         "quant8='static' conv sites")
    n = 0
    for m in sites:
        m.calibrating = True
    try:
        with torch.no_grad():
            for x in batches:
                model(x)
                n += 1
    finally:
        for m in sites:
            m.calibrating = False
    if n == 0:
        raise ValueError("calibrate_quant_scales: no calibration batches")
    if log:
        scales = torch.stack([m.x_scale for m in sites]).cpu()
        log(f"quant8 calibration: {n} batches, {len(sites)} conv sites, "
            f"scale range [{float(scales.min()):.2e}, "
            f"{float(scales.max()):.2e}]")
    return model


def set_quant_scales(model: PPNet, scales: Dict[str, float]) -> PPNet:
    """Load per-site activation scales ``{module name: scale}`` (see
    ``checkpoints.convert.quant_scales_from_jax``) into a static quant8
    model; every static site must be covered."""
    sites = {n: m for n, m in quant_sites(model) if m.static}
    missing = sorted(set(sites) - set(scales))
    extra = sorted(set(scales) - set(sites))
    if missing or extra:
        raise ValueError(f"quant scales do not match the model's static "
                         f"sites: missing {missing}, unknown {extra}")
    for name, m in sites.items():
        m.set_scale(scales[name])
    return model


def load_model(model_path: str, checkpoint_path: str,
               dtype: torch.dtype = torch.float32, fast: bool = False,
               device: Optional[Union[str, torch.device]] = None,
               quant8: Union[bool, str] = False
               ) -> Tuple[PPNet, ProtoSpec]:
    """(model in eval mode on ``device``, spec).

    ``dtype`` is the compute dtype of the convolutions and the add-on
    (the prototype head stays float32); ``fast`` routes the ASPP through
    the K2 kernel when the dtype is bf16 (``models/deeplab.py``).  On the
    card the model runs in channels_last memory.

    ``quant8=True`` runs the layer4/5 convs as dynamic w8a8 int8 and drops
    ``fast``, as the JAX package does; ``quant8='static'`` uses calibrated
    per-site scales (``calibrate_quant_scales``) and keeps ``fast``.
    Serving only; the state dict is the same either way.  A backbone
    without DeepLabV2's ResNet layers (the U-Nets, VGG16, DeepLabV3)
    refuses ``quant8`` by name; the U-Nets' trainable BN serves with the
    running statistics.  ``fast`` reaches K2 on DeepLabV2's 'sum' and
    'concat' ASPP only (``takes_fast_aspp``), as the JAX package's
    ``fast_aspp``."""
    if quant8 not in (False, True, "static"):
        raise ValueError(f"quant8 must be False, True or 'static', got "
                         f"{quant8!r}")
    if quant8 is True:
        fast = False
    dev = resolve_device(device)
    stem = os.path.splitext(checkpoint_path)[0]
    sd, meta = load_checkpoint(stem)
    spec = spec_from_meta(meta["spec"])
    variant = (meta.get("extra") or {}).get("variant")
    if variant is None:
        variant = "group" if "last_layer_group.weight" in sd else (
            "multiscale" if spec.num_scales > 1 else "single")

    config_file = os.path.join(model_path, "config.gin")
    bindings = configlib.parse_config_file(config_file) \
        if os.path.exists(config_file) else {}
    cname = "construct_PPNet_Group" if variant == "group" else \
        "construct_PPNet"

    def q(param, default=None):
        for name in (cname, "construct_PPNet", "construct_PPNet_Group"):
            value = configlib.query(bindings, name, param)
            if value is not None:
                return value
        return default

    model, _ = construct_ppnet(
        variant=variant, base_architecture=q("base_architecture"),
        prototype_shape=(spec.num_prototypes, spec.proto_depth, 1, 1),
        num_classes=spec.num_classes,
        prototype_activation_function=q("prototype_activation_function",
                                        "log"),
        add_on_layers_type=q("add_on_layers_type", "deeplab_simple"),
        scale_head_type=q("scale_head_type"), bindings=bindings, spec=spec,
        dtype=dtype, quant8=quant8)
    model.load_state_dict(sd, strict=True)
    if getattr(model.features.base, "takes_fast_aspp", False):
        model.aspp.fast = fast
    cast_convs(model, dtype)
    model.to(dev)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model.eval(), spec
