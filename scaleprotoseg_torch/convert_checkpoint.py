"""Convert checkpoints into the port's form, ``<stem>.pth`` (a
reference-named state dict) beside ``<stem>.ckpt.json`` (the spec
sidecar): the JAX package's ``convert_checkpoint``, with its three kinds
and flags.

    # a reference whole-module pickle (e.g. a released push_final.pth),
    # optionally installing configs/NAME.gin as the run's config.gin
    python -m scaleprotoseg_torch.convert_checkpoint reference \\
        push_final.pth results/run/checkpoints/push_final.pth \\
        [--variant auto|single|multiscale|group] [--config NAME]

    # a torchvision ResNet state dict -> a backbone-only checkpoint that
    # PRETRAINED_BACKBONE_CKPT reads
    python -m scaleprotoseg_torch.convert_checkpoint torchvision \\
        resnet101.pth backbone.pth

    # a checkpoint the JAX package wrote (msgpack <stage>.ckpt and its
    # .ckpt.json) -> the port's <stage>.pth + .ckpt.json
    python -m scaleprotoseg_torch.convert_checkpoint export-torch \\
        jax_run/checkpoints/push_final.ckpt run/checkpoints/push_final.pth

DST names the stem; a ``.pth`` or ``.ckpt`` ending is taken off.

- ``reference`` reads the pickle without running code from it
  (``checkpoints.reference``), rebuilds the bank's spec from the module's
  attributes (a pushed or pruned bank keeps its scale ranges) and keeps
  the tensors the port's model holds under their own names.
- ``torchvision`` renames the ResNet keys to the DeepLab backbone's
  (``checkpoints.pretrained``), each BN with a ``num_batches_tracked`` of
  0, as the JAX package's backbone checkpoint carried across gives them.
- ``export-torch`` reads the ``.ckpt`` without ``msgpack`` or ``flax``
  (``checkpoints.jax_ckpt``) and carries it with
  ``checkpoints.convert.ppnet_params_to_statedict``: the same tensors,
  key for key and bit for bit, as the JAX package's ``export-torch`` writes,
  and also what that export drops or cannot carry (VGG16's bare convs,
  the 'concat_plus' ASPP's ``c{i}_pool`` Linears).
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

import torch

from scaleprotoseg_torch.checkpoints import jax_ckpt, pretrained, reference
from scaleprotoseg_torch.checkpoints.convert import (ppnet_params_to_statedict,
                                                     save_checkpoint,
                                                     spec_from_meta)

CONFIGS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs")


def _stem(dst: str) -> str:
    return os.path.splitext(dst)[0] if dst.endswith((".pth", ".ckpt")) \
        else dst


def install_run_config(dst: str, config: str) -> str:
    """Copy the port's ``configs/<config>.gin`` into the run directory of
    ``dst`` (the parent of its ``checkpoints/``) as ``config.gin``, so
    that eval, serving and the analysis rebuild the model; returns its
    path."""
    ckpt_dir = os.path.dirname(os.path.abspath(dst))
    run_dir = os.path.dirname(ckpt_dir) \
        if os.path.basename(ckpt_dir) == "checkpoints" else ckpt_dir
    src = os.path.join(CONFIGS_DIR, f"{config}.gin")
    if not os.path.exists(src):
        raise FileNotFoundError(f"no such experiment config: {src}")
    os.makedirs(run_dir, exist_ok=True)
    out = os.path.join(run_dir, "config.gin")
    shutil.copyfile(src, out)
    print(f"Installed {config}.gin as {out}")
    return out


def convert_reference(src: str, dst: str, variant: str = "auto",
                      config: Optional[str] = None, log=print) -> str:
    """A reference whole-module pickle -> ``<stem>.pth`` + sidecar;
    returns the stem."""
    sd, meta = reference.load_reference_pickle(src)
    spec = reference.spec_from_reference_meta(sd, meta)
    sd = reference.model_state_dict(sd, log)
    if variant == "auto":
        variant = "group" if "last_layer_group.weight" in sd else (
            "multiscale" if spec.num_scales > 1 else "single")
    stem = _stem(dst)
    save_checkpoint(stem, sd, spec, extra={
        "variant": variant, "source": src,
        "converted_from": "reference_pickle"})
    if config:
        install_run_config(stem, config)
    log(f"Converted {src} -> {stem}.pth ({spec.num_prototypes} prototypes, "
        f"{spec.num_classes} classes, {spec.num_scales} scales, "
        f"variant={variant})")
    return stem


def convert_torchvision(src: str, dst: str, log=print) -> str:
    """A torchvision ResNet state dict -> a backbone-only ``<stem>.pth`` +
    sidecar (no spec); returns the stem."""
    sd = pretrained.torchvision_resnet_to_backbone(
        pretrained.read_state_dict(src))
    for key in [k for k in sd if k.endswith(".bn.weight")]:
        sd[key[:-len("weight")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.int64)
    stem = _stem(dst)
    save_checkpoint(stem, sd, None, extra={"source": src,
                                           "converted_from": "torchvision"})
    log(f"Converted {src} -> {stem}.pth (backbone only; use "
        "PRETRAINED_BACKBONE_CKPT to load)")
    return stem


def export_torch(src: str, dst: str, log=print) -> str:
    """The JAX package's ``<stage>.ckpt`` -> ``<stem>.pth`` + its sidecar;
    returns the stem."""
    params, batch_stats, meta = jax_ckpt.load_checkpoint(src)
    if "spec" not in meta:
        raise ValueError(f"{src} has no ProtoSpec metadata: only full "
                         "model checkpoints export")
    spec = spec_from_meta(meta["spec"])
    sd = ppnet_params_to_statedict(params, batch_stats, spec, log=log)
    stem = _stem(dst)
    save_checkpoint(stem, sd, spec, extra=meta.get("extra"))
    log(f"Exported {src} -> {stem}.pth ({len(sd)} tensors, reference "
        "state-dict naming)")
    return stem


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=
                                argparse.RawDescriptionHelpFormatter)
    p.add_argument("kind", choices=["reference", "torchvision",
                                    "export-torch"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--variant", default="auto",
                   choices=["auto", "single", "multiscale", "group"])
    p.add_argument("--config", default=None,
                   help="experiment config name (e.g. "
                   "group_scaleproto_cityscapes) to install as the run's "
                   "config.gin so eval/analysis can rebuild the model")
    a = p.parse_args(argv)
    if a.kind == "reference":
        return convert_reference(a.src, a.dst, a.variant, config=a.config)
    if a.kind == "export-torch":
        return export_torch(a.src, a.dst)
    return convert_torchvision(a.src, a.dst)


if __name__ == "__main__":
    main()
