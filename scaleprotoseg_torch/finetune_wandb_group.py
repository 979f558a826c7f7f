"""ScaleProtoSeg group-phase trainer.

    python -m scaleprotoseg_torch.finetune_wandb_group CONFIG RUN \\
        --start-checkpoint RUNS/PROTO_RUN/checkpoints/push_final \\
        [--data-root DIR] [--gpu-recipe] [--gin BINDING ...] \\
        [--device cuda|cpu] [--results-root DIR]

CONFIG is a name in ``scaleprotoseg_torch/configs`` (e.g.
``group_scaleproto_cityscapes``) or a path; the start checkpoint (or
``train.start_checkpoint``) is a prototype-phase checkpoint, pushed and
possibly pruned.  Pipeline: the grouped model on the checkpoint's own spec
(its sidecar's, with the config's ``num_groups``), its backbone and
prototypes copied from the checkpoint and its group heads freshly
initialized (group projections on the simplex; optionally the
equivariance JSON of ``construct_PPNet_Group.group_equiv_path``) ->
phase 0 (group warm-up: the group projections) -> phase 1 (joint under
poly decay: with ``joint_last`` the group projections and the group last
layer) -> phase 2 (the group last layer, when ``train.finetune_steps >
0``) -> ``checkpoints/final-group`` (``<stem>.pth`` plus its sidecar,
``variant: group``), which ``serving.serve RUN final-group`` serves.
Stages are ``{warmup,nopush,push}-group_{last,best}``.

The device is ``cuda`` unless ``--device`` names another; without a card
that is an error.  The metrics also go to TensorBoard (``<run>/logs/tb``)
where ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from scaleprotoseg_torch import cli_common, settings
from scaleprotoseg_torch.checkpoints.convert import (bootstrap_group_state,
                                                     load_checkpoint,
                                                     save_checkpoint,
                                                     spec_from_meta)
from scaleprotoseg_torch.configlib import flat_bindings, query
from scaleprotoseg_torch.model_loading import resolve_device
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.models.group_init import apply_equivariance_init
from scaleprotoseg_torch.train.metrics import (MetricsLogger, create_logger,
                                               make_external_sinks)
from scaleprotoseg_torch.train.runner import (PhaseResult, PhaseTrainer,
                                              module_hparams)

VARIANT = "group"


def train(config: str, experiment_name: str,
          start_checkpoint: Optional[str] = None,
          data_root: Optional[str] = None, num_workers: Optional[int] = None,
          gin_overrides: Optional[List[str]] = None, gpu_recipe: bool = False,
          device: Optional[str] = None, results_root: Optional[str] = None,
          log=None) -> Dict:
    """Run the group phases; returns ``{"final": <final-group stem>,
    "phases": {phase: PhaseResult}}``."""
    dev = resolve_device(device)
    config_file, bindings = cli_common.load_config(config)
    lines = cli_common.apply_overrides(bindings, gin_overrides, gpu_recipe)
    hp = cli_common.train_hparams(bindings)
    ckpt = str(start_checkpoint or hp["start_checkpoint"] or "")
    if ckpt in ("", "TBD"):
        raise ValueError("group finetuning requires train.start_checkpoint "
                         "(a prototype-phase checkpoint) or "
                         "--start-checkpoint")
    run = cli_common.setup_run_dir(results_root or settings.results_dir(),
                                   experiment_name, config_file, lines)
    log = log or create_logger(os.path.join(run, "train.log"))
    if lines:
        log(f"CLI gin overrides: {'; '.join(lines)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = hp["random_seed"]
    cli_common.seed_everything(seed)

    # the checkpoint's spec: push may have pruned the bank
    proto_state, meta = load_checkpoint(os.path.splitext(ckpt)[0])
    q = lambda p, d=None: query(bindings, "construct_PPNet_Group", p, d)  # noqa
    num_groups = int(query(bindings, "PPNetMultiScale", "num_groups", 3))
    spec = spec_from_meta(meta["spec"]).with_groups(num_groups)
    model, spec = construct_ppnet(
        VARIANT, base_architecture=q("base_architecture"),
        num_classes=q("num_classes", 200),
        prototype_activation_function=q("prototype_activation_function",
                                        "log"),
        add_on_layers_type=q("add_on_layers_type", "deeplab_simple"),
        scale_head_type=q("scale_head_type"), bindings=bindings, spec=spec,
        generator=torch.Generator().manual_seed(seed))
    model.load_state_dict(bootstrap_group_state(model.state_dict(),
                                                proto_state), strict=True)
    log(f"Bootstrapped the backbone and {spec.num_prototypes} prototypes "
        f"from {ckpt}")
    equiv_path = q("group_equiv_path")
    if equiv_path:
        apply_equivariance_init(model, spec, equiv_path,
                                weight=q("equiv_scale_weight", 0.25), log=log)

    logger = MetricsLogger(run, sinks=make_external_sinks(run, log=log))
    logger.log_hyperparams(flat_bindings(bindings))
    trainer = PhaseTrainer(model, spec, VARIANT, run,
                           module_hparams(bindings, VARIANT), bindings, dev,
                           logger=logger, log=log)
    phases: Dict[int, PhaseResult] = {}
    cli_common.run_phases(trainer, bindings, hp, (0, 1, 2), phases,
                          num_workers=num_workers, data_root=data_root)
    final = os.path.join(run, "checkpoints", "final-group")
    save_checkpoint(final, {k: v.detach().cpu().numpy()
                            for k, v in model.state_dict().items()}, spec,
                    extra={"variant": VARIANT})
    logger.finish()
    log(f"Group training complete; final checkpoint: {final}.pth")
    return {"final": final, "phases": phases}


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("experiment_name")
    p.add_argument("--start-checkpoint", default=None,
                   help="prototype-phase checkpoint (<stem>[.pth])")
    p.add_argument("--data-root", default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--results-root", default=None,
                   help="override the settings' results directory")
    cli_common.add_override_args(p)
    a = p.parse_args(argv)
    return train(a.config, a.experiment_name,
                 start_checkpoint=a.start_checkpoint, data_root=a.data_root,
                 num_workers=a.num_workers, gin_overrides=a.gin,
                 gpu_recipe=a.gpu_recipe, device=a.device,
                 results_root=a.results_root)


if __name__ == "__main__":
    main()
