"""Phase optimizers: the JAX package's optax chain in PyTorch.

Per phase, the trainable parameters fall into labelled groups
(``label_of_path`` of the reference parameter name), each an Adam with
torch's *coupled* weight decay (``torch.optim.Adam(weight_decay=...)``,
the same as optax's ``add_decayed_weights`` before ``scale_by_adam``) and
a learning rate scaled by the poly schedule in the joint phase.  On top,
as in the JAX package:

- ``iter_size`` accumulation averages the micro-step gradients with
  ``optax.MultiSteps``' running mean and updates once every ``iter_size``
  finite micro-steps;
- the non-finite guard (``optax.apply_if_finite``): a micro-step whose
  gradients hold a NaN or an inf is dropped whole (not accumulated, moments
  untouched), up to ``guard_nonfinite`` times in a row; past that the
  update goes through.

Both decisions depend on the data, and the host must not wait for the
card on every micro-step, so they are taken on the device: the
micro-step counter, the non-finite streak and the schedule count are
device scalars, and Adam is torch's fused implementation, which skips its
update (moments and step count included) when its ``found_inf`` tensor is
set.  Gradients land in one flat buffer (each ``p.grad`` is a view of it),
so a micro-step's bookkeeping is a handful of kernels, not one per
parameter.  Frozen parameters get ``requires_grad_(False)``, so the
backward never runs for them.

Labels:
  features_conv  backbone convs outside the ASPP
  aspp_w/aspp_b  ASPP branch weights/biases (10x lr in the joint phase)
  features_bn    frozen BatchNorm affine (no phase trains it)
  add_on         add-on layers
  prototypes     prototype bank
  last_layer     the plain head's last layer
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch


def label_of_path(name: str) -> str:
    """Optimizer label of a reference parameter name, e.g.
    ``features.base.aspp.c0.weight`` -> ``aspp_w``."""
    parts = name.split(".")
    if parts[0] == "prototype_vectors":
        return "prototypes"
    if parts[0] in ("last_layer", "last_layer_group", "group_projection"):
        return parts[0]
    if parts[0] == "add_on_layers":
        return "add_on"
    if "aspp" in parts:
        return "aspp_b" if parts[-1] == "bias" else "aspp_w"
    if "bn" in parts:
        return "features_bn"
    return "features_conv"


@dataclasses.dataclass(frozen=True)
class OptimGroup:
    lr: float
    weight_decay: float = 0.0
    use_schedule: bool = False


def poly_schedule(power: float, iter_max: int
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """PolynomialLR factor ``(1 - t / iter_max) ** power`` clamped at 0,
    for the count ``t`` of optimizer updates done (1 at update 0)."""

    def fn(count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - count.clamp(max=iter_max) / iter_max
        return frac.clamp_min(0.0) ** power

    return fn


def phase_groups(variant: str, phase: int,
                 hp: Dict[str, float]) -> Dict[str, OptimGroup]:
    """Trainable label -> OptimGroup for a (variant, phase) of the
    prototype model: 0 warm-up (add-on, ASPP, prototypes), 1 joint under
    poly decay (every conv, ASPP at 10x, add-on, prototypes), 2 the last
    layer.  ``hp`` carries the config's learning rates and decays."""
    if variant not in ("single", "multiscale"):
        raise NotImplementedError(
            f"the {variant!r} variant's phases (finetune_wandb_group) are "
            "not ported yet")
    g: Dict[str, OptimGroup] = {}
    if phase == 0:
        for label in ("add_on", "aspp_w", "aspp_b"):
            g[label] = OptimGroup(hp["warm_lr_add_on"], hp["warm_wd"])
        g["prototypes"] = OptimGroup(hp["warm_lr_protos"])
    elif phase == 1:
        g["add_on"] = OptimGroup(hp["joint_lr_add_on"], hp["joint_wd"],
                                 use_schedule=True)
        g["features_conv"] = OptimGroup(hp["joint_lr_features"],
                                        hp["joint_wd"], use_schedule=True)
        for label in ("aspp_w", "aspp_b"):
            g[label] = OptimGroup(10 * hp["joint_lr_features"],
                                  hp["joint_wd"], use_schedule=True)
        g["prototypes"] = OptimGroup(hp["joint_lr_protos"],
                                     use_schedule=True)
    else:
        g["last_layer"] = OptimGroup(hp["last_layer_lr"])
    return g


class PhaseOptimizer:
    """One phase's optimizer over ``named_params`` (name, parameter)
    pairs; parameters whose label is not in ``groups`` are frozen.

    Call ``step()`` once per micro-step, after its backward."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 groups: Dict[str, OptimGroup],
                 schedule: Optional[Callable] = None, iter_size: int = 1,
                 guard_nonfinite: int = 0):
        by_label: Dict[str, list] = {label: [] for label in groups}
        for name, p in named_params:
            label = label_of_path(name)
            p.requires_grad_(label in groups)
            p.grad = None
            if label in groups:
                if p.dtype != torch.float32:
                    raise ValueError(f"{name}: trainable parameters must be "
                                     f"float32, got {p.dtype}")
                if not p.is_contiguous():
                    # the fused update pairs each parameter with a
                    # contiguous gradient view element by element
                    p.data = p.data.contiguous()
                by_label[label].append(p)
        params = [p for ps in by_label.values() for p in ps]
        if not params:
            raise ValueError(f"no parameters carry the labels {sorted(groups)}")
        dev = params[0].device
        self.params = params
        self.iter_size = int(iter_size)
        self.guard = int(guard_nonfinite)
        self.schedule = schedule
        self._grad = torch.zeros(sum(p.numel() for p in params),
                                 dtype=torch.float32, device=dev)
        self._acc = torch.zeros_like(self._grad)
        off = 0
        for p in params:
            p.grad = self._grad[off:off + p.numel()].view_as(p)
            off += p.numel()
        scalar = lambda v, dt=torch.float32: torch.tensor(  # noqa: E731
            v, dtype=dt, device=dev)
        self._mini = scalar(0, torch.int64)       # MultiSteps.mini_step
        self._streak = scalar(0, torch.int64)     # non-finite in a row
        self._updates = scalar(0.0)               # schedule count
        self._found_inf = scalar(0.0)
        self._groups = [(grp, ps) for grp, ps in
                        ((groups[label], by_label[label]) for label in groups)
                        if ps]
        self.adam = torch.optim.Adam(
            [{"params": ps, "lr": scalar(grp.lr),
              "weight_decay": grp.weight_decay} for grp, ps in self._groups],
            betas=(0.9, 0.999), eps=1e-8, fused=True)

    def step(self) -> None:
        """Fold this micro-step's gradients in and update on the
        ``iter_size``-th finite one; nothing here waits for the device."""
        g = self._grad
        k = self.iter_size
        if self.guard > 0:
            finite = torch.isfinite(g).all()
            self._streak = torch.where(finite, torch.zeros_like(self._streak),
                                       self._streak + 1)
            do = finite | (self._streak > self.guard)
        else:
            do = torch.ones((), dtype=torch.bool, device=g.device)
        # running mean of the accepted micro-step gradients
        self._acc.add_((torch.where(do, g, self._acc) - self._acc)
                       / (self._mini + 1).float())
        emit = do & (self._mini == k - 1)
        g.copy_(self._acc)                       # the grads Adam reads
        self._found_inf.copy_((~emit).float())   # skip unless emitting
        for (grp, _), pg in zip(self._groups, self.adam.param_groups):
            lr = torch.full_like(self._updates, grp.lr)
            if grp.use_schedule and self.schedule is not None:
                lr = lr * self.schedule(self._updates)
            pg["lr"] = lr
        self.adam.found_inf = self._found_inf
        self.adam.grad_scale = None
        self.adam.step()
        # the fused update writes the parameters without bumping their
        # version counters, and whether it wrote is known on the device
        # only: declare them changed, so caches keyed on the versions
        # (the K2 weight stack, ``models.layers.WeightCache``) rebuild
        torch.autograd.graph.increment_version(self.params)
        self._acc.masked_fill_(emit, 0.0)
        self._mini = torch.where(do, (self._mini + 1) % k, self._mini)
        self._updates = self._updates + emit.float()
        g.zero_()

