"""Rebuild a PPNet from a run directory and a checkpoint.

A run directory holds ``config.gin`` (the experiment config) and
``checkpoints/<stage>.ckpt.json`` (the spec sidecar) beside
``checkpoints/<stage>.pth`` (the reference-named state dict, as the JAX
package's ``convert_checkpoint export-torch`` writes it).  The msgpack
``.ckpt`` itself is not read.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from scaleprotoseg_torch import configlib
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     spec_from_meta)
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.models.layers import cast_convs
from scaleprotoseg_torch.models.ppnet import PPNet
from scaleprotoseg_torch.spec import ProtoSpec


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA
    is asked for (or defaulted to) and absent."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


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


def load_model(model_path: str, checkpoint_path: str,
               dtype: torch.dtype = torch.float32, fast: bool = False,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[PPNet, ProtoSpec]:
    """(model in eval mode on ``device``, spec).

    ``dtype`` is the compute dtype of the convolutions and the add-on
    (the prototype head stays float32); ``fast`` routes the ASPP through
    the K2 kernel when the dtype is bf16 (``models/deeplab.py``).  On the
    card the model runs in channels_last memory."""
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
        dtype=dtype)
    model.load_state_dict(sd, strict=True)
    model.features.base.aspp.fast = fast
    cast_convs(model, dtype)
    model.to(dev)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model.eval(), spec
