"""Phase orchestration of the prototype-phase and group-phase trainers.

Drives one phase (0 warm-up, 1 joint, 2 last layer; the group variant's
stages carry ``-group``) over the prefetching
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
  train.fast_gradconv = True         layer4/5's dilated 3x3 convs through
                                     the hybrid backward of
                                     ``ops/gradconv.py`` (same forward)
  train.remat = True                 the forward computed again in the
                                     backward (``make_train_step``)
  train.profile_steps = N            one ``torch.profiler`` trace of N
                                     micro-steps per trainer, from the
                                     phase's fourth micro-step, to
                                     ``<run>/profile``
                                     (``profiling.StepProfiler``; read it
                                     with ``python -m
                                     scaleprotoseg_torch.profiling``)

Each phase's ``perf`` (and its END log line) carries img/s, the median
step ms, the device's idle share and, on the card, the peak memory
allocated in the phase (``peak_memory_mb``).

Mid-phase resume, as in the JAX package: the full train state (every
model tensor, the phase optimizer's Adam moments, ``iter_size``
accumulation and device counters, the step) is saved without blocking at
every validation to ``checkpoints/<stage>_state``
(``checkpoints/state_io.py``).  A phase whose state exists restores it
before its first step (``resume=True``), carries ``best_acc`` over from
``<stage>_best``'s sidecar and fast-forwards both loaders, so that with a
``det_seed`` dataset it continues exactly where the saved run was; a
finished phase restores at its last step and takes none.  The counter of
validations without improvement is not saved, as in the JAX package: a
phase that stopped early trains on when relaunched.  SIGTERM
(``train/preemption.py``) commits the state after the current micro-step
and exits 143.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.checkpoints.convert import save_checkpoint
from scaleprotoseg_torch.checkpoints.state_io import (last_save_stats,
                                                      restore_train_state,
                                                      save_train_state,
                                                      wait_for_checkpoints)
from scaleprotoseg_torch.configlib import Bindings, query
from scaleprotoseg_torch.ops.prototype import pairwise_l2
from scaleprotoseg_torch.profiling import StepProfiler
from scaleprotoseg_torch.train.metrics import (BulkFetcher, MetricAccumulator,
                                               MetricsLogger, StepTimer)
from scaleprotoseg_torch.train.optim import (PhaseOptimizer, phase_groups,
                                             poly_schedule)
from scaleprotoseg_torch.train.preemption import Preempted, get_guard
from scaleprotoseg_torch.train.state import TrainState
from scaleprotoseg_torch.train.steps import (LossWeights, make_eval_step,
                                             make_train_step)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def module_hparams(bindings: Bindings, variant: str) -> Dict:
    """The ``PatchClassificationModule[MultiScale]`` bindings; the group
    variant reads the same names."""
    name = "PatchClassificationModule" if variant == "single" else \
        "PatchClassificationModuleMultiScale"
    q = lambda p, d: query(bindings, name, p, d)  # noqa: E731
    if q("freeze_type", "all") != "all":
        raise NotImplementedError("trainable BatchNorm (freeze_type "
                                  f"{q('freeze_type', None)!r}) is not "
                                  "ported; BN stays frozen")
    if variant != "group" and q("joint_last", None) is not None:
        # joint_last / joint_no_proto shape the group joint phase only; on
        # another variant they would do nothing
        raise ValueError("joint_last is a group-phase flag; it has no "
                         f"effect on the {variant!r} variant's phases")
    return dict(
        weights=LossWeights(
            crs_ent=q("loss_weight_crs_ent", 1.0),
            l1=q("loss_weight_l1", 1e-4),
            kld=q("loss_weight_kld", 0.0),
            entropy=q("loss_weight_entropy", 0.0),
            spatial_entropy=q("loss_weight_spatial_entropy", 0.0),
            norm=q("loss_weight_norm", 0.0),
            crs_ent_group=q("loss_weight_crs_ent_group", 0.0),
            scale_max=q("loss_weight_scale_max", 0.0),
            group_ent=q("loss_weight_group_ent", 0.0)),
        hp=dict(
            warm_lr_add_on=q("warm_optimizer_lr_add_on_layers", 2.5e-4),
            warm_lr_protos=q("warm_optimizer_lr_prototype_vectors", 2.5e-4),
            warm_wd=q("warm_optimizer_weight_decay", 0.0),
            joint_lr_features=q("joint_optimizer_lr_features", 2.5e-5),
            joint_lr_add_on=q("joint_optimizer_lr_add_on_layers", 2.5e-4),
            joint_lr_protos=q("joint_optimizer_lr_prototype_vectors",
                              2.5e-4),
            joint_wd=q("joint_optimizer_weight_decay", 0.0),
            last_layer_lr=q("last_layer_optimizer_lr", 2.5e-4),
            warm_lr_group=q("warm_optimizer_lr_group_projection", 2.5e-4),
            joint_lr_group=q("joint_optimizer_lr_group_projection",
                             2.5e-4)),
        poly_lr_power=q("poly_lr_power", 0.9),
        iter_size=q("iter_size", 1),
        ignore_void_class=q("ignore_void_class", True),
        joint_no_proto=q("joint_no_proto", False),
        joint_last=q("joint_last", True),
    )


@dataclasses.dataclass
class PhaseResult:
    best_acc: float
    steps_done: int
    validations: int
    losses: List[float]             # every micro-step's loss, in order
    perf: Dict[str, Optional[float]]
    launches: Dict[str, int]        # kernel launches during the phase
    resumed_at: int = 0             # the restored step (0: a fresh phase)


class PhaseTrainer:
    """Runs the phases of one model on ``device``; see the module
    docstring for the knobs."""

    def __init__(self, model, spec, variant: str, model_dir: str,
                 hparams: Dict, bindings: Bindings, device: torch.device,
                 logger: Optional[MetricsLogger] = None, log=print):
        dt_name = query(bindings, "train", "compute_dtype", None)
        fast = bool(query(bindings, "train", "fast_aspp", False))
        self.remat = bool(query(bindings, "train", "remat", False))
        if query(bindings, "train", "fast_gradconv", False):
            model.features.base.set_fast_gradconv(True)
        if dt_name:
            model.set_compute_dtype(_DTYPES[dt_name])
        if fast:
            if model.dtype == torch.bfloat16:
                model.features.base.aspp.fast = True
            else:
                log("WARNING: train.fast_aspp=True requires "
                    "train.compute_dtype='bfloat16'; the K2 kernels stay "
                    "off")
        base = model.features.base
        log(f"GPU recipe knobs: compute_dtype={dt_name or 'float32'} "
            f"fast_aspp={base.aspp.fast} "
            f"fast_gradconv={base.fast_gradconv} remat={self.remat}")
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
        self.profiler = StepProfiler(
            query(bindings, "train", "profile_steps", 0),
            os.path.join(model_dir, "profile"), device, log)

    def stage_key(self, phase: int) -> str:
        base = {0: "warmup", 1: "nopush", 2: "push"}[min(phase, 2)]
        return base + ("-group" if self.variant == "group" else "")

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
                  global_step0: int = 0, resume: bool = True) -> PhaseResult:
        hp = self.hp
        iter_size = int(hp["iter_size"])
        groups = phase_groups(self.variant, phase, hp["hp"],
                              joint_last=hp["joint_last"],
                              joint_no_proto=hp["joint_no_proto"])
        schedule = poly_schedule(hp["poly_lr_power"],
                                 max(max_steps // iter_size, 1)) \
            if phase == 1 else None
        state = TrainState(self.model, PhaseOptimizer(
            self.model.named_parameters(), groups, schedule=schedule,
            iter_size=iter_size, guard_nonfinite=50))
        grouped = self.variant == "group"
        step_fn = make_train_step(
            hp["weights"], hp["ignore_void_class"],
            grad_mask_last_group=(grouped and phase == 1 and
                                  self.model.incorrect_strength == 0),
            project_group_simplex=grouped, remat=self.remat)
        eval_fn = make_eval_step(hp["weights"], hp["ignore_void_class"])
        stage = self.stage_key(phase)
        val_every = val_every_steps or max(len(train_loader), 1)
        state_dir = os.path.join(self.checkpoints_dir, f"{stage}_state")
        acc_train = MetricAccumulator()
        steps0 = 0
        t0 = time.perf_counter()
        if resume and restore_train_state(state_dir, state) is not None:
            steps0 = state.step
            restore_s = time.perf_counter() - t0
            acc_train.load(state.extra.get("train_metrics",
                                           acc_train.state()))
            self._resume_streams(stage, steps0, val_every, train_loader,
                                 val_loader)
            self.log(f"Resumed phase {phase} at step {steps0} from "
                     f"{state_dir} (best_acc={self.best_acc:.4f}); train "
                     "state restored: " + json.dumps(
                         {"phase": phase, "step": steps0,
                          "seconds": restore_s}))
        self.log(f"PHASE {phase} ({stage}) START: {max_steps} steps, "
                 f"trainable={sorted(groups)}")
        preempt = get_guard(log=self.log)

        fetcher = BulkFetcher(acc_train.update, limit=32)
        losses: List[float] = []
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        timer = StepTimer(self.device)
        prof = self.profiler
        batch_size = getattr(train_loader, "batch_size", 1)
        launches0 = kernels.launch_counts()
        validations = stale = 0
        stop = False
        while state.step < max_steps and not stop:
            for image, target in train_loader:
                if state.step >= max_steps:
                    break
                prof.begin(state.step, steps0)
                timer.begin()
                with prof.span():
                    x, t = self._to_device(image, target)
                    fetcher.add(step_fn(state, x, t))
                timer.end()
                if prof.due(state.step):
                    timer.close()   # the trace's export is not timed
                    prof.stop()
                steps = state.step
                if steps % val_every and steps < max_steps:
                    self._check_preempted(preempt, global_step0, state,
                                          state_dir, fetcher, losses,
                                          acc_train)
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
                state.extra = {}
                # the commit overlaps the next steps
                save_train_state(state_dir, state)
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
                # after the validation of this step, so that a relaunch
                # does not skip it
                self._check_preempted(preempt, global_step0, state,
                                      state_dir, fetcher, losses, acc_train)
        if prof.active:     # the phase ended mid-trace
            timer.close()
            prof.stop()
        losses += [m["loss"] for m in fetcher.drain()]
        try:
            wait_for_checkpoints()
            if validations:
                self.log("train state saved: " + json.dumps(
                    {"phase": phase, **last_save_stats()}))
        except RuntimeError as e:
            # the run goes on; a later resume restarts from an older step
            self.log(f"async state checkpoint commit FAILED ({e}); resume "
                     "would restart from an older step")
        perf = timer.summary(batch_size)
        perf["peak_memory_mb"] = torch.cuda.max_memory_allocated(
            self.device) / 2**20 if cuda else None
        launches = {k: v - launches0[k]
                    for k, v in kernels.launch_counts().items()}
        self.log(f"PHASE {phase} ({stage}) END: {state.step} steps; "
                 f"{perf}; kernel launches {launches}")
        return PhaseResult(best_acc=self.best_acc, steps_done=state.step,
                           validations=validations, losses=losses,
                           perf=perf, launches=launches, resumed_at=steps0)

    def _check_preempted(self, preempt, global_step0: int,
                         state: TrainState, state_dir: str, fetcher,
                         losses: List[float], acc_train) -> None:
        """On a SIGTERM: fetch the metrics held, commit the state with
        the partial train metrics, raise ``Preempted``."""
        if not preempt.should_stop(global_step0 + state.step):
            return
        self.profiler.discard()
        losses += [m["loss"] for m in fetcher.drain()]
        state.extra = {"train_metrics": acc_train.state()}
        save_train_state(state_dir, state, block=True)
        self.log("train state saved: " + json.dumps(last_save_stats()))
        self.log(f"PREEMPTED at step {state.step}: train state committed to "
                 f"{state_dir}; relaunch the same command to resume")
        raise Preempted(state.step)

    def _resume_streams(self, stage: str, steps0: int, val_every: int,
                        train_loader, val_loader) -> None:
        """After a restore: ``best_acc`` from ``<stage>_best``'s sidecar
        (so that an early validation does not overwrite a better best),
        and both loaders where the saved run left them (the val loader one
        epoch a validation)."""
        best_path = os.path.join(self.checkpoints_dir,
                                 f"{stage}_best.ckpt.json")
        if os.path.exists(best_path):
            try:
                with open(best_path) as f:
                    prev = json.load(f).get("extra", {}).get("best_acc", 0.0)
                self.best_acc = max(self.best_acc, float(prev))
            except (OSError, ValueError) as e:
                self.log(f"WARNING: best-checkpoint metadata unreadable "
                         f"({e}); tracking restarts at 0, so an early "
                         f"post-resume validation may overwrite {stage}_best")
        try:
            train_loader.fast_forward(steps0)
            val_loader.fast_forward((steps0 // val_every) * len(val_loader))
        except (AttributeError, ZeroDivisionError) as e:
            self.log(f"WARNING: loader fast-forward failed ({e}); the data "
                     "stream restarts from epoch 0 (resume is not "
                     "bit-exact)")

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
