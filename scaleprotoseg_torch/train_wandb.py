"""The ProtoSeg single-scale baseline trainer, and the last-layer
re-finetune of a pruned model.

    python -m scaleprotoseg_torch.train_wandb CONFIG RUN [--pruned] \\
        [--data-root DIR] [--gpu-recipe] [--gin BINDING ...] \\
        [--device cuda|cpu] [--results-root DIR]

The port of the JAX package's ``train_wandb.py``.  Without ``--pruned``
it trains the ``single`` variant (``PPNet``: one scale over the summed
ASPP, the ``PatchClassificationModule`` bindings, e.g.
``baseline_cityscapes``) through the prototype-phase pipeline of
``train_wandb_multiscale``: warm-up, joint, push, last layer, then
``checkpoints/push_final``.  Relaunching the same command resumes it
(see ``train_wandb_multiscale``).

``--pruned`` (``train_pruned``) loads ``<run>/pruned/pruned`` (what
``run_pruning`` wrote), builds the variant its spec and weights hold, and
runs phase 2 (the last layer; the group last layer in a grouped model)
for ``max(train.finetune_steps, 1)`` micro-steps with the last-layer
early stopping, in ``<run>/pruned`` (its ``push_{last,best}`` checkpoints
and metrics there), then saves ``<run>/pruned/checkpoints/push_last``, the
checkpoint of the ``pruned`` phase.  CONFIG gives the training bindings
(batch size, steps, learning rate, the dataset).

Both forms also log their metrics to TensorBoard (``<run>/logs/tb``;
``<run>/pruned/logs/tb``) where ``torch.utils.tensorboard`` imports; the
baseline reads a pretrained backbone as ``train_wandb_multiscale`` does.
The device is ``cuda`` unless ``--device`` names another; without a card
that is an error.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from scaleprotoseg_torch import cli_common, settings
from scaleprotoseg_torch import train_wandb_multiscale
from scaleprotoseg_torch.checkpoints.convert import save_checkpoint
from scaleprotoseg_torch.configlib import flat_bindings
from scaleprotoseg_torch.model_loading import load_model, resolve_device
from scaleprotoseg_torch.train.metrics import (MetricsLogger, create_logger,
                                               make_external_sinks)
from scaleprotoseg_torch.train.runner import PhaseTrainer, module_hparams


def train(config: str, experiment_name: str, pruned: bool = False,
          **kwargs) -> Dict:
    if pruned:
        return train_pruned(config, experiment_name, **kwargs)
    return train_wandb_multiscale.train(config, experiment_name,
                                        variant="single", **kwargs)


def train_pruned(config: str, experiment_name: str,
                 data_root: Optional[str] = None,
                 num_workers: Optional[int] = None,
                 gin_overrides: Optional[List[str]] = None,
                 gpu_recipe: bool = False, device: Optional[str] = None,
                 results_root: Optional[str] = None, log=None) -> Dict:
    """Phase 2 of the pruned model; returns ``{"final": <pruned/checkpoints/
    push_last stem>, "phases": {2: PhaseResult}}``."""
    dev = resolve_device(device)
    _, bindings = cli_common.load_config(config)
    lines = cli_common.apply_overrides(bindings, gin_overrides, gpu_recipe)
    hp = cli_common.train_hparams(bindings)
    results_dir = os.path.join(results_root or settings.results_dir(),
                               experiment_name)
    pruned_dir = os.path.join(results_dir, "pruned")
    log = log or create_logger(os.path.join(results_dir, "train.log"))
    if lines:
        log(f"CLI gin overrides: {'; '.join(lines)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cli_common.seed_everything(hp["random_seed"])

    model, spec = load_model(results_dir,
                             os.path.join(pruned_dir, "pruned.pth"),
                             device=dev)
    variant = "group" if model.grouped else (
        "multiscale" if spec.num_scales > 1 else "single")
    logger = MetricsLogger(pruned_dir,
                           sinks=make_external_sinks(pruned_dir, log=log))
    logger.log_hyperparams(flat_bindings(bindings))
    trainer = PhaseTrainer(model, spec, variant, pruned_dir,
                           module_hparams(bindings, variant), bindings, dev,
                           logger=logger, log=log)
    tl, vl = cli_common.make_loaders(bindings, hp["joint_batch_size"],
                                     num_workers=num_workers,
                                     seed=hp["random_seed"],
                                     data_root=data_root, log=log)
    res = trainer.run_phase(
        2, max(hp["finetune_steps"], 1), tl, vl,
        early_stopping_patience=hp["early_stopping_patience_last_layer"])
    final = os.path.join(pruned_dir, "checkpoints", "push_last")
    save_checkpoint(final, {k: v.detach().cpu().numpy()
                            for k, v in model.state_dict().items()}, spec)
    logger.finish()
    log(f"Pruned finetune complete: {final}.pth")
    return {"final": final, "phases": {2: res}}


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("experiment_name")
    p.add_argument("--pruned", action="store_true")
    p.add_argument("--data-root", default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--results-root", default=None,
                   help="override the settings' results directory")
    cli_common.add_override_args(p)
    a = p.parse_args(argv)
    return train(a.config, a.experiment_name, pruned=a.pruned,
                 data_root=a.data_root, num_workers=a.num_workers,
                 gin_overrides=a.gin, gpu_recipe=a.gpu_recipe,
                 device=a.device, results_root=a.results_root)


if __name__ == "__main__":
    main()
