"""ScaleProtoSeg prototype-phase trainer.

    python -m scaleprotoseg_torch.train_wandb_multiscale CONFIG RUN \\
        [--data-root DIR] [--gpu-recipe] [--gin BINDING ...] \\
        [--device cuda|cpu] [--results-root DIR]

CONFIG is a name in ``scaleprotoseg_torch/configs`` (e.g.
``scaleproto_cityscapes``) or a path; RUN names the run directory under
the results root.  Pipeline: seed -> model -> phase 0 (warm-up: ASPP and
prototypes) -> phase 1 (joint: every conv outside BN, ASPP at 10x, and
prototypes, under poly decay) -> prototype push (``train.push_proto``,
default True: each prototype onto its nearest same-class training pixel,
exact duplicates pruned, ``push_last`` written) -> phase 2 (last layer,
when ``train.finetune_steps > 0``) -> ``checkpoints/push_final``.  Each
phase writes ``{warmup,nopush,push}_{last,best}`` at its validations;
every checkpoint is ``<stem>.pth`` plus its spec sidecar and loads
through ``model_loading.load_model``.  ``finetune_wandb_group`` starts the
group phase from ``push_final``.

Push writes its per-prototype image artifacts and bound-box tables to
``<run>/prototypes/`` (``push_artifacts``, on by default, as in the JAX
package; each class's directory is named after the class).

``train(..., variant='single')`` runs the same pipeline on the
single-scale ProtoSeg baseline (``train_wandb`` without ``--pruned``).

Relaunching the same command resumes: each phase restores its
``checkpoints/<stage>_state`` (saved at every validation, and on SIGTERM,
after which the process exits 143), a finished phase takes no step, and
push runs again on the restored weights.  Bind
``PatchClassificationDataset.det_seed`` for a resumed run that equals an
uninterrupted one bit for bit.

The device is ``cuda`` unless ``--device`` names another; without a card
that is an error.  ``--gin 'train.profile_steps = N'`` writes one profiler
trace of N micro-steps to ``<run>/profile`` (``train/runner.py``; read it
with ``python -m scaleprotoseg_torch.profiling <run>/profile``).

A pretrained backbone is read from a file on disk after the model is
built and before ``train.start_checkpoint``: ``PRETRAINED_BACKBONE``, a
torchvision-layout ResNet ``.pth``, or ``PRETRAINED_BACKBONE_CKPT``, the
port's own checkpoint stem (``checkpoints/pretrained.py``).
``construct_PPNet.pretrained`` loads nothing, as in the JAX package.
The metrics also go to TensorBoard (``<run>/logs/tb``) where
``torch.utils.tensorboard`` imports (``train/metrics.py``).  Not ported
yet, and refused: W&B and more than one device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from scaleprotoseg_torch import cli_common, settings
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     save_checkpoint)
from scaleprotoseg_torch.checkpoints.pretrained import \
    maybe_load_pretrained_backbone
from scaleprotoseg_torch.configlib import Bindings, flat_bindings, query
from scaleprotoseg_torch.model_loading import resolve_device
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.push.push import push_prototypes
from scaleprotoseg_torch.spec import ProtoSpec
from scaleprotoseg_torch.train.metrics import (MetricsLogger, create_logger,
                                               make_external_sinks)
from scaleprotoseg_torch.train.runner import (PhaseResult, PhaseTrainer,
                                              module_hparams)

VARIANTS = ("multiscale", "single")


def build_model(bindings: Bindings, seed: int,
                spec: Optional[ProtoSpec] = None,
                variant: str = "multiscale"):
    """(model, spec) of ``variant`` from the ``construct_PPNet`` bindings
    (``spec``: a pruned bank in place of the equal allocation); the
    prototypes come from a generator seeded with ``seed``, the convs from
    torch's seeded global stream."""
    q = lambda p, d=None: query(bindings, "construct_PPNet", p, d)  # noqa
    return construct_ppnet(
        variant=variant, base_architecture=q("base_architecture"),
        prototype_shape=tuple(q("prototype_shape", (2000, 512, 1, 1))),
        num_classes=q("num_classes", 200),
        prototype_activation_function=q("prototype_activation_function",
                                        "log"),
        add_on_layers_type=q("add_on_layers_type", "deeplab_simple"),
        scale_head_type=q("scale_head_type"), bindings=bindings, spec=spec,
        generator=torch.Generator().manual_seed(seed))


def train(config: str, experiment_name: str, data_root: Optional[str] = None,
          num_workers: Optional[int] = None,
          gin_overrides: Optional[List[str]] = None, gpu_recipe: bool = False,
          device: Optional[str] = None, results_root: Optional[str] = None,
          push_artifacts: bool = True, variant: str = "multiscale",
          log=None) -> Dict:
    """Run the phases of ``variant`` ('multiscale' or 'single'); returns
    ``{"final": <push_final stem>, "phases": {phase: PhaseResult},
    "push": PushResult or None}``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: the prototype-phase trainer "
                         f"runs {VARIANTS}")
    dev = resolve_device(device)
    config_file, bindings = cli_common.load_config(config)
    lines = cli_common.apply_overrides(bindings, gin_overrides, gpu_recipe)
    hp = cli_common.train_hparams(bindings)
    run = cli_common.setup_run_dir(results_root or settings.results_dir(),
                                   experiment_name, config_file, lines)
    log = log or create_logger(os.path.join(run, "train.log"))
    if lines:
        log(f"CLI gin overrides: {'; '.join(lines)}")
    # float32 stays float32: no TF32 in the convs or the products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = hp["random_seed"]
    cli_common.seed_everything(seed)

    model, spec = build_model(bindings, seed, variant=variant)
    if query(bindings, "construct_PPNet", "pretrained", False):
        log("construct_PPNet.pretrained = True loads nothing (as in the JAX "
            "package): backbone weights come only from PRETRAINED_BACKBONE "
            "or PRETRAINED_BACKBONE_CKPT")
    maybe_load_pretrained_backbone(model, log)
    start = str(hp["start_checkpoint"] or "")
    if start not in ("", "TBD"):
        sd, _ = load_checkpoint(os.path.splitext(start)[0])
        model.load_state_dict(sd, strict=True)
        log(f"Resumed from {start}")
    mhp = module_hparams(bindings, variant)
    logger = MetricsLogger(run, sinks=make_external_sinks(run, log=log))
    logger.log_hyperparams(flat_bindings(bindings))
    trainer = PhaseTrainer(model, spec, variant, run, mhp, bindings, dev,
                           logger=logger, log=log)
    phases: Dict[int, PhaseResult] = {}
    cli_common.run_phases(trainer, bindings, hp, (0, 1), phases,
                          num_workers=num_workers, data_root=data_root)
    push = None
    if hp["push_proto"]:
        from scaleprotoseg_torch.eval_valid_multiscale import class_names
        cls2name = dict(enumerate(class_names(hp["data_type"] or "cityscapes",
                                              spec.num_classes)))
        push = push_prototypes(
            model, spec, cli_common.make_push_loader(
                bindings, num_workers=num_workers, data_root=data_root),
            prototypes_dir=os.path.join(run, "prototypes"),
            save_artifacts=push_artifacts, cls2name=cls2name, log=log)
        if push.spec.num_prototypes != spec.num_prototypes:
            # dedup pruned the bank: a model, optimizer and K2 weight
            # cache of the new size
            spec = push.spec
            model, _ = build_model(bindings, seed, spec, variant)
            model.load_state_dict(push.state_dict, strict=True)
            trainer = PhaseTrainer(model, spec, variant, run, mhp, bindings,
                                   dev, logger=trainer.logger, log=log)
            log(f"push: the model now holds {spec.num_prototypes} "
                "prototypes")
        save_checkpoint(os.path.join(run, "checkpoints", "push_last"),
                        _numpy_state(model), spec, extra={"variant": variant})
    cli_common.run_phases(trainer, bindings, hp, (2,), phases,
                          num_workers=num_workers, data_root=data_root)

    final = os.path.join(run, "checkpoints", "push_final")
    save_checkpoint(final, _numpy_state(model), spec,
                    extra={"variant": variant})
    logger.finish()
    log(f"Training complete; final checkpoint: {final}.pth")
    return {"final": final, "phases": phases, "push": push}


def _numpy_state(model) -> Dict:
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("experiment_name")
    p.add_argument("--data-root", default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--results-root", default=None,
                   help="override the settings' results directory")
    cli_common.add_override_args(p)
    a = p.parse_args(argv)
    return train(a.config, a.experiment_name, data_root=a.data_root,
                 num_workers=a.num_workers, gin_overrides=a.gin,
                 gpu_recipe=a.gpu_recipe, device=a.device,
                 results_root=a.results_root)


if __name__ == "__main__":
    main()
