"""ScaleProtoSeg prototype-phase trainer.

    python -m scaleprotoseg_torch.train_wandb_multiscale CONFIG RUN \\
        [--data-root DIR] [--gpu-recipe] [--gin BINDING ...] \\
        [--device cuda|cpu] [--results-root DIR]

CONFIG is a name in ``scaleprotoseg_torch/configs`` (e.g.
``scaleproto_cityscapes``) or a path; RUN names the run directory under
the results root.  Pipeline: seed -> model -> phase 0 (warm-up: ASPP and
prototypes) -> phase 1 (joint: every conv outside BN, ASPP at 10x, and
prototypes, under poly decay) -> phase 2 (last layer, when
``train.finetune_steps > 0``) -> ``checkpoints/push_final``.  Each phase
writes ``{warmup,nopush,push}_{last,best}`` at its validations; every
checkpoint is ``<stem>.pth`` plus its spec sidecar and loads through
``model_loading.load_model``.

The device is ``cuda`` unless ``--device`` names another; without a card
that is an error.  Not ported yet, and refused: prototype push
(``train.push_proto``, default True: pass ``--gin "train.push_proto =
False"``), the group phase, a pretrained backbone from the environment,
Orbax resume and preemption, the profiler trace, W&B and TensorBoard
sinks, and more than one device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from scaleprotoseg_torch import cli_common, settings
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     save_checkpoint)
from scaleprotoseg_torch.configlib import Bindings, query
from scaleprotoseg_torch.model_loading import resolve_device
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.train.metrics import MetricsLogger, create_logger
from scaleprotoseg_torch.train.runner import (PhaseResult, PhaseTrainer,
                                              module_hparams)

VARIANT = "multiscale"


def build_model(bindings: Bindings, seed: int):
    """(model, spec) from the ``construct_PPNet`` bindings; the prototypes
    come from a generator seeded with ``seed``, the convs from torch's
    seeded global stream."""
    q = lambda p, d=None: query(bindings, "construct_PPNet", p, d)  # noqa
    if q("pretrained", False):
        raise NotImplementedError("construct_PPNet.pretrained is not ported")
    return construct_ppnet(
        variant=VARIANT, base_architecture=q("base_architecture"),
        prototype_shape=tuple(q("prototype_shape", (2000, 512, 1, 1))),
        num_classes=q("num_classes", 200),
        prototype_activation_function=q("prototype_activation_function",
                                        "log"),
        add_on_layers_type=q("add_on_layers_type", "deeplab_simple"),
        scale_head_type=q("scale_head_type"), bindings=bindings,
        generator=torch.Generator().manual_seed(seed))


def train(config: str, experiment_name: str, data_root: Optional[str] = None,
          num_workers: Optional[int] = None,
          gin_overrides: Optional[List[str]] = None, gpu_recipe: bool = False,
          device: Optional[str] = None, results_root: Optional[str] = None,
          log=None) -> Dict:
    """Run the phases; returns ``{"final": <push_final stem>, "phases":
    {phase: PhaseResult}}``."""
    dev = resolve_device(device)
    config_file, bindings = cli_common.load_config(config)
    lines = cli_common.apply_overrides(bindings, gin_overrides, gpu_recipe)
    hp = cli_common.train_hparams(bindings)
    if hp["push_proto"]:
        raise NotImplementedError(
            "prototype push (train.push_proto) is not ported yet; run with "
            "--gin \"train.push_proto = False\"")
    for env in ("PRETRAINED_BACKBONE", "PRETRAINED_BACKBONE_CKPT"):
        if os.environ.get(env):
            raise NotImplementedError(f"{env}: loading a pretrained backbone "
                                      "is not ported yet")
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

    model, spec = build_model(bindings, seed)
    start = str(hp["start_checkpoint"] or "")
    if start not in ("", "TBD"):
        sd, _ = load_checkpoint(os.path.splitext(start)[0])
        model.load_state_dict(sd, strict=True)
        log(f"Resumed from {start}")
    trainer = PhaseTrainer(model, spec, VARIANT, run,
                           module_hparams(bindings, VARIANT), bindings, dev,
                           logger=MetricsLogger(run), log=log)
    val_check = query(bindings, "Trainer", "val_check_interval", None)

    phases: Dict[int, PhaseResult] = {}
    global_step = 0
    plan = ((0, hp["warmup_steps"], hp["warmup_batch_size"], None),
            (1, hp["joint_steps"], hp["joint_batch_size"], None),
            (2, hp["finetune_steps"], hp["joint_batch_size"],
             hp["early_stopping_patience_last_layer"]))
    for phase, steps, batch, patience in plan:
        if steps <= 0:
            continue
        tl, vl = cli_common.make_loaders(bindings, batch,
                                         num_workers=num_workers,
                                         seed=seed + phase,
                                         data_root=data_root)
        res = trainer.run_phase(phase, steps, tl, vl,
                                early_stopping_patience=patience,
                                val_every_steps=val_check,
                                global_step0=global_step)
        phases[phase] = res
        global_step += res.steps_done

    final = os.path.join(run, "checkpoints", "push_final")
    save_checkpoint(final, {k: v.detach().cpu().numpy()
                            for k, v in model.state_dict().items()}, spec,
                    extra={"variant": VARIANT})
    log(f"Training complete; final checkpoint: {final}.pth")
    return {"final": final, "phases": phases}


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
