"""A pretrained backbone read from a file already on disk.

The port's counterpart of the JAX package's ``torchvision_key_to_deeplab``,
``torchvision_resnet_to_backbone`` and ``load_torch_backbone_into``
(``checkpoints/torch_convert.py``) and of the trainer's
``_maybe_load_pretrained_backbone``: a torchvision ResNet state dict
(``layerN.M.convK``, ``downsample``, ``conv1``/``bn1``) is renamed to the
DeepLabV2 backbone's reference names (``layer{N+1}.block{M+1}.{reduce|
conv3x3|increase}``, ``shortcut``, ``layer1.conv1``) under the port's
``features.base.`` prefix; ``fc`` and ``num_batches_tracked`` are dropped.
The layouts already agree (OIHW kernels, BN weight / bias / running
statistics), so no tensor is transposed.

Two environment variables, read by the trainers after the model is built
and before ``train.start_checkpoint``:

  PRETRAINED_BACKBONE       a torchvision-layout ``.pth`` / ``.pt`` state
                            dict (read with ``weights_only=True``)
  PRETRAINED_BACKBONE_CKPT  a checkpoint stem, the port's (``.pth`` +
                            ``.ckpt.json``) or the JAX package's msgpack
                            ``.ckpt`` (``checkpoints.jax_ckpt``, carried
                            by ``convert.ppnet_params_to_statedict``): its
                            ``features.base.*`` tensors

A tensor whose shape differs from the model's is skipped with a log
line, as the JAX package's merge skips it; a renamed key the model lacks
is skipped with a log line too.  ``torchvision`` is not imported.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Mapping, Optional, Union

import torch

PREFIX = "features.base."


def torchvision_key_to_deeplab(key: str) -> Optional[str]:
    """The DeepLabV2 reference name of a torchvision ResNet key (without
    the ``features.base.`` prefix), or None for keys without one (``fc``)."""
    parts = key.split(".")
    if parts[0].startswith("layer"):
        layer = int(parts[0][len("layer"):]) + 1
        block = f"block{int(parts[1]) + 1}"
        unit = parts[2]
        if unit == "downsample":
            sub = {0: "conv", 1: "bn"}[int(parts[3])]
            return f"layer{layer}.{block}.shortcut.{sub}.{parts[-1]}"
        kind, num = unit[:-1], int(unit[-1])
        name = {1: "reduce", 2: "conv3x3", 3: "increase"}[num]
        return f"layer{layer}.{block}.{name}.{kind}.{parts[-1]}"
    if parts[0] in ("conv1", "bn1"):
        return f"layer1.conv1.{parts[0][:-1]}.{parts[-1]}"
    return None


def torchvision_resnet_to_backbone(state_dict: Mapping[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """``{features.base.<reference name>: tensor}`` from a torchvision
    ResNet state dict; ``fc`` and ``num_batches_tracked`` are dropped.
    Raises when no key converts."""
    out = {}
    for key, value in state_dict.items():
        dl_key = torchvision_key_to_deeplab(key)
        if dl_key is None or key.endswith("num_batches_tracked"):
            continue
        out[PREFIX + dl_key] = value
    assert out, "no convertible keys found"
    return out


def _merge_into(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor],
                log) -> int:
    """Copy ``tensors`` into the model's state where the key exists and the
    shape agrees; every other tensor is skipped with a log line.  Returns
    the number copied."""
    state = model.state_dict()
    n = 0
    with torch.no_grad():
        for key, value in tensors.items():
            if key not in state:
                log(f"pretrained backbone: {key} is not in the model; "
                    "skipping")
                continue
            if tuple(state[key].shape) != tuple(value.shape):
                log(f"shape mismatch at {key}: {tuple(state[key].shape)} vs "
                    f"{tuple(value.shape)}; skipping")
                continue
            state[key].copy_(value)
            n += 1
    return n


def read_state_dict(source: Union[str, torch.nn.Module]
                     ) -> Mapping[str, torch.Tensor]:
    if isinstance(source, torch.nn.Module):
        return source.state_dict()
    try:
        sd = torch.load(source, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"PRETRAINED_BACKBONE {source}: the file needs unpickling (a "
            "pickled module or other objects), which the port does not do; "
            "save the module's state_dict() instead") from e
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_torch_backbone_into(model: torch.nn.Module,
                             source: Union[str, torch.nn.Module],
                             log=print) -> torch.nn.Module:
    """Load a torchvision ResNet (a ``.pth`` path or a module) into the
    model's backbone in place; returns ``model``."""
    converted = torchvision_resnet_to_backbone(read_state_dict(source))
    n = _merge_into(model, converted, log)
    log(f"Loaded pretrained backbone weights from {source} ({n} of "
        f"{len(converted)} tensors)")
    return model


def load_backbone_checkpoint_into(model: torch.nn.Module, path: str,
                                  log=print) -> torch.nn.Module:
    """Copy the ``features.base.*`` tensors of the checkpoint at ``path``
    (a stem, or the stem's ``.pth`` / ``.ckpt``): the port's ``.pth`` with
    its ``.ckpt.json``, else the JAX package's msgpack ``.ckpt``, into the
    model in place; returns ``model``."""
    from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                         load_jax_checkpoint)
    stem = os.path.splitext(path)[0] if path.endswith((".pth", ".ckpt")) \
        else path
    if os.path.exists(stem + ".pth") and os.path.exists(stem + ".ckpt.json"):
        sd, _ = load_checkpoint(stem)
    elif os.path.exists(stem + ".ckpt"):
        sd, _ = load_jax_checkpoint(stem + ".ckpt", log)
    else:
        raise FileNotFoundError(
            f"PRETRAINED_BACKBONE_CKPT {path}: no {stem}.pth with its "
            f".ckpt.json sidecar and no JAX {stem}.ckpt")
    n = _merge_into(model, {k: v for k, v in sd.items()
                            if k.startswith(PREFIX)}, log)
    log(f"Loaded pretrained backbone from {path} ({n} tensors)")
    return model


def maybe_load_pretrained_backbone(model: torch.nn.Module,
                                   log=print) -> torch.nn.Module:
    """The trainers' load: ``PRETRAINED_BACKBONE_CKPT`` first, else
    ``PRETRAINED_BACKBONE``, else nothing (the JAX package's order)."""
    ckpt_path = os.environ.get("PRETRAINED_BACKBONE_CKPT", "")
    torch_path = os.environ.get("PRETRAINED_BACKBONE", "")
    if ckpt_path:
        return load_backbone_checkpoint_into(model, ckpt_path, log)
    if torch_path:
        return load_torch_backbone_into(model, torch_path, log)
    return model
