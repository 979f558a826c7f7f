"""The purity-pruning CLI.

    python -m scaleprotoseg_torch.run_pruning CONFIG RUN [--k 6] \\
        [--prune-threshold 3] [--push-batch-size 2] [--data-root DIR] \\
        [--full-save] [--results-root DIR] [--device cuda|cpu]

The port of the JAX package's ``run_pruning.py``: loads the run's first
checkpoint of ``push_last``, ``final-group``, ``push-group_last`` and
``nopush-group_last``, finds each prototype's k nearest train patches,
prunes the impure ones (``prune.prune_prototypes``) and saves
``pruned/pruned`` (``.pth`` and the ``.ckpt.json`` sidecar, with
``extra = {variant, kept}``) and its alias ``pruned/checkpoints/push_last``,
the checkpoint of the ``pruned`` phase.  ``train_wandb --pruned`` then
re-finetunes its last layer.  CONFIG names the dataset bindings of the
push loader (the train split at full resolution).

The device is ``cuda`` unless ``--device`` names another; without a card
that is an error.  The scan runs the float32 forward.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from scaleprotoseg_torch import cli_common, settings
from scaleprotoseg_torch.checkpoints.convert import save_checkpoint
from scaleprotoseg_torch.model_loading import load_model, resolve_device
from scaleprotoseg_torch.prune import prune_prototypes
from scaleprotoseg_torch.train.metrics import create_logger

CANDIDATES = ("push_last", "final-group", "push-group_last",
              "nopush-group_last")


def run_pruning(config: str, experiment_name: str, k: int = 6,
                prune_threshold: int = 3, push_batch_size: int = 2,
                data_root: Optional[str] = None,
                results_root: Optional[str] = None, full_save: bool = False,
                device: Optional[str] = None) -> Dict:
    """Prune the run's prototypes; returns ``{"pruned": <pruned/pruned
    stem>, "alias": <its push_last alias>, "spec": the pruned spec,
    "kept": kept indices, "source": the checkpoint pruned}``."""
    dev = resolve_device(device)
    _, bindings = cli_common.load_config(config)
    model_dir = os.path.join(results_root or settings.results_dir(),
                             experiment_name)
    log = create_logger(os.path.join(model_dir, "pruning.log"))
    # prototype-phase runs save push_last; grouped runs the group names
    ckpt = next((s for s in (os.path.join(model_dir, "checkpoints", c)
                             for c in CANDIDATES)
                 if os.path.exists(s + ".pth")),
                os.path.join(model_dir, "checkpoints", CANDIDATES[0]))
    model, spec = load_model(model_dir, ckpt + ".pth", device=dev)
    log(f"Pruning {ckpt} ({spec.num_prototypes} prototypes) on {dev}")
    push_loader = cli_common.make_push_loader(
        bindings, batch_size=push_batch_size, data_root=data_root)
    state, new_spec, keep = prune_prototypes(
        push_loader, model, spec, k=k, prune_threshold=prune_threshold,
        original_model_dir=model_dir, full_save=full_save, log=log)

    sd = {key: v.detach().cpu().numpy() for key, v in state.items()}
    variant = "group" if model.grouped else (
        "multiscale" if spec.num_scales > 1 else "single")
    out = os.path.join(model_dir, "pruned", "pruned")
    save_checkpoint(out, sd, new_spec,
                    extra={"variant": variant,
                           "kept": [int(i) for i in keep]})
    # the "pruned" phase resolves to pruned/checkpoints/push_last
    alias = os.path.join(model_dir, "pruned", "checkpoints", "push_last")
    save_checkpoint(alias, sd, new_spec)
    log(f"Pruned model saved to {out}.pth ({spec.num_prototypes} -> "
        f"{new_spec.num_prototypes} prototypes)")
    return {"pruned": out, "alias": alias, "spec": new_spec, "kept": keep,
            "source": ckpt}


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("experiment_name")
    p.add_argument("--k", type=int, default=6)
    p.add_argument("--prune-threshold", type=int, default=3)
    p.add_argument("--push-batch-size", type=int, default=2)
    p.add_argument("--data-root", default=None)
    p.add_argument("--full-save", action="store_true")
    p.add_argument("--results-root", default=None,
                   help="override the settings' results directory")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda, an error without one; "
                   "'cpu' runs the plain versions of the kernels)")
    a = p.parse_args(argv)
    return run_pruning(a.config, a.experiment_name, k=a.k,
                       prune_threshold=a.prune_threshold,
                       push_batch_size=a.push_batch_size,
                       data_root=a.data_root, results_root=a.results_root,
                       full_save=a.full_save, device=a.device)


if __name__ == "__main__":
    main()
