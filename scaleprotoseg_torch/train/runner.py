"""Phase orchestration of the prototype-phase trainer.

Drives one phase (0 warm-up, 1 joint, 2 last layer) over the prefetching
loader: a micro-step per batch, validation every ``val_every`` micro-steps
and at the end, ``{stage}_last`` and, on a better validation accuracy,
``{stage}_best`` checkpoints (``<stem>.pth`` plus the spec sidecar), early
stopping, and the reference's metric names, ``avg_dist_proto`` included.
Metrics stay on the card and are fetched in bulk; step times come from
CUDA events (``train.metrics.StepTimer``).

Knobs read from the ``train`` bindings:

  train.compute_dtype = 'bfloat16'   convs and add-on in bf16, parameters
                                     float32 (``PPNet.set_compute_dtype``)
  train.fast_aspp = True             the ASPP through K2's forward kernel
                                     and its tap-packed backward kernels
                                     (needs compute_dtype bfloat16)

``train.remat``, ``train.fast_gradconv`` and ``train.profile_steps`` are
not ported and are refused, as are Orbax resume and preemption.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.checkpoints.convert import save_checkpoint
from scaleprotoseg_torch.configlib import Bindings, query
from scaleprotoseg_torch.ops.prototype import pairwise_l2
from scaleprotoseg_torch.train.metrics import (BulkFetcher, MetricAccumulator,
                                               MetricsLogger, StepTimer)
from scaleprotoseg_torch.train.optim import (PhaseOptimizer, phase_groups,
                                             poly_schedule)
from scaleprotoseg_torch.train.state import TrainState
from scaleprotoseg_torch.train.steps import (LossWeights, make_eval_step,
                                             make_train_step)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def module_hparams(bindings: Bindings, variant: str) -> Dict:
    """The ``PatchClassificationModule[MultiScale]`` bindings."""
    name = "PatchClassificationModule" if variant == "single" else \
        "PatchClassificationModuleMultiScale"
    q = lambda p, d: query(bindings, name, p, d)  # noqa: E731
    if q("freeze_type", "all") != "all":
        raise NotImplementedError("trainable BatchNorm (freeze_type "
                                  f"{q('freeze_type', None)!r}) is not "
                                  "ported; BN stays frozen")
    return dict(
        weights=LossWeights(crs_ent=q("loss_weight_crs_ent", 1.0),
                            l1=q("loss_weight_l1", 1e-4),
                            kld=q("loss_weight_kld", 0.0),
                            entropy=q("loss_weight_entropy", 0.0),
                            norm=q("loss_weight_norm", 0.0)),
        hp=dict(
            warm_lr_add_on=q("warm_optimizer_lr_add_on_layers", 2.5e-4),
            warm_lr_protos=q("warm_optimizer_lr_prototype_vectors", 2.5e-4),
            warm_wd=q("warm_optimizer_weight_decay", 0.0),
            joint_lr_features=q("joint_optimizer_lr_features", 2.5e-5),
            joint_lr_add_on=q("joint_optimizer_lr_add_on_layers", 2.5e-4),
            joint_lr_protos=q("joint_optimizer_lr_prototype_vectors",
                              2.5e-4),
            joint_wd=q("joint_optimizer_weight_decay", 0.0),
            last_layer_lr=q("last_layer_optimizer_lr", 2.5e-4)),
        poly_lr_power=q("poly_lr_power", 0.9),
        iter_size=q("iter_size", 1),
        ignore_void_class=q("ignore_void_class", True),
    )


@dataclasses.dataclass
class PhaseResult:
    best_acc: float
    steps_done: int
    validations: int
    losses: List[float]             # every micro-step's loss, in order
    perf: Dict[str, Optional[float]]
    launches: Dict[str, int]        # kernel launches during the phase


class PhaseTrainer:
    """Runs the phases of one model on ``device``; see the module
    docstring for the knobs."""

    def __init__(self, model, spec, variant: str, model_dir: str,
                 hparams: Dict, bindings: Bindings, device: torch.device,
                 logger: Optional[MetricsLogger] = None, log=print):
        for knob in ("remat", "fast_gradconv", "profile_steps"):
            if query(bindings, "train", knob, None):
                raise NotImplementedError(f"train.{knob} is not ported yet")
        dt_name = query(bindings, "train", "compute_dtype", None)
        fast = bool(query(bindings, "train", "fast_aspp", False))
        if dt_name:
            model.set_compute_dtype(_DTYPES[dt_name])
        if fast:
            if model.dtype == torch.bfloat16:
                model.features.base.aspp.fast = True
            else:
                log("WARNING: train.fast_aspp=True requires "
                    "train.compute_dtype='bfloat16'; the K2 kernels stay "
                    "off")
        log(f"GPU recipe knobs: compute_dtype={dt_name or 'float32'} "
            f"fast_aspp={model.features.base.aspp.fast}")
        self.model = model.to(device)
        self.spec = spec
        self.variant = variant
        self.device = device
        self.model_dir = model_dir
        self.checkpoints_dir = os.path.join(model_dir, "checkpoints")
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        self.hp = hparams
        self.logger = logger or MetricsLogger(model_dir)
        self.log = log
        self.best_acc = 0.0

    def stage_key(self, phase: int) -> str:
        return {0: "warmup", 1: "nopush", 2: "push"}[min(phase, 2)]

    def _avg_dist_proto(self) -> float:
        """Per-scale mean pairwise squared distance of the prototypes."""
        p = self.model.prototypes().detach()
        total = torch.zeros((), device=p.device)
        for lo, hi in self.spec.scale_bounds:
            total = total + pairwise_l2(p[lo:hi], p[lo:hi]).mean()
        return float(total) / self.spec.num_scales

    def _to_device(self, image: np.ndarray, target: np.ndarray):
        x = torch.from_numpy(np.asarray(image))
        t = torch.from_numpy(np.asarray(target))
        if self.device.type == "cuda":
            return (x.pin_memory().to(self.device, non_blocking=True),
                    t.pin_memory().to(self.device, non_blocking=True))
        return x.to(self.device), t.to(self.device)

    def run_phase(self, phase: int, max_steps: int, train_loader,
                  val_loader, early_stopping_patience: Optional[int] = None,
                  val_every_steps: Optional[int] = None,
                  limit_val_batches: Optional[int] = None,
                  global_step0: int = 0) -> PhaseResult:
        hp = self.hp
        iter_size = int(hp["iter_size"])
        groups = phase_groups(self.variant, phase, hp["hp"])
        schedule = poly_schedule(hp["poly_lr_power"],
                                 max(max_steps // iter_size, 1)) \
            if phase == 1 else None
        state = TrainState(self.model, PhaseOptimizer(
            self.model.named_parameters(), groups, schedule=schedule,
            iter_size=iter_size, guard_nonfinite=50))
        step_fn = make_train_step(hp["weights"], hp["ignore_void_class"])
        eval_fn = make_eval_step(hp["weights"], hp["ignore_void_class"])
        stage = self.stage_key(phase)
        val_every = val_every_steps or max(len(train_loader), 1)
        self.log(f"PHASE {phase} ({stage}) START: {max_steps} steps, "
                 f"trainable={sorted(groups)}")

        acc_train = MetricAccumulator()
        fetcher = BulkFetcher(acc_train.update, limit=32)
        losses: List[float] = []
        timer = StepTimer(self.device)
        batch_size = getattr(train_loader, "batch_size", 1)
        launches0 = kernels.launch_counts()
        validations = stale = 0
        stop = False
        while state.step < max_steps and not stop:
            for image, target in train_loader:
                if state.step >= max_steps:
                    break
                timer.begin()
                x, t = self._to_device(image, target)
                fetcher.add(step_fn(state, x, t))
                timer.end()
                steps = state.step
                if steps % val_every and steps < max_steps:
                    continue
                losses += [m["loss"] for m in fetcher.drain()]
                timer.close()
                val = self._validate(eval_fn, val_loader, limit_val_batches)
                validations += 1
                train = acc_train.summary()
                acc_train.reset()
                self.logger.log({
                    **{f"train_{k}": v for k, v in train.items()},
                    **{f"val_{k}": v for k, v in val.items()},
                    "training_stage": float(phase),
                    "avg_dist_proto": self._avg_dist_proto()},
                    step=global_step0 + steps)
                val_acc = val.get("accuracy", 0.0)
                self.log(f"step {steps}/{max_steps} "
                         f"train_loss={train.get('loss', 0):.4f} "
                         f"val_acc={val_acc:.4f}")
                self._save(f"{stage}_last")
                if val_acc > self.best_acc:
                    self.best_acc = val_acc
                    self._save(f"{stage}_best")
                    stale = 0
                else:
                    stale += 1
                if early_stopping_patience is not None and \
                        stale >= early_stopping_patience:
                    self.log("Early stopping triggered")
                    stop = True
                    break
        losses += [m["loss"] for m in fetcher.drain()]
        perf = timer.summary(batch_size)
        launches = {k: v - launches0[k]
                    for k, v in kernels.launch_counts().items()}
        self.log(f"PHASE {phase} ({stage}) END: {state.step} steps; "
                 f"{perf}; kernel launches {launches}")
        return PhaseResult(best_acc=self.best_acc, steps_done=state.step,
                           validations=validations, losses=losses,
                           perf=perf, launches=launches)

    def _validate(self, eval_fn, val_loader,
                  limit_val_batches: Optional[int] = None
                  ) -> Dict[str, float]:
        acc = MetricAccumulator()
        fetcher = BulkFetcher(acc.update, limit=64)
        for i, (image, target) in enumerate(val_loader):
            if limit_val_batches is not None and i >= limit_val_batches:
                break
            fetcher.add(eval_fn(self.model, *self._to_device(image, target)))
        fetcher.drain()
        return acc.summary()

    def _save(self, name: str) -> None:
        sd = {k: v.detach().cpu().numpy()
              for k, v in self.model.state_dict().items()}
        save_checkpoint(os.path.join(self.checkpoints_dir, name), sd,
                        self.spec, extra={"best_acc": self.best_acc,
                                          "variant": self.variant})
