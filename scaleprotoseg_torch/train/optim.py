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
  features_conv  backbone convs outside the ASPP (the U-Nets' ``outc``,
                 VGG16's convs and DeepLabV3's ``head_c*`` too: the JAX
                 package's rule looks for ``aspp`` in the path, and V3's
                 head has none)
  aspp_w/aspp_b  ASPP branch weights/biases, 'concat_plus''s ``c{i}_pool``
                 Linears too (10x lr in the joint phase)
  features_bn    BatchNorm affine (no phase trains it; the U-Nets'
                 trainable BN moves only its running statistics, buffers)
  add_on         add-on layers
  scale_head     the scale head's Linear ('concat'): trained with the
                 add-on in the prototype model's warm-up and joint phases
  prototypes     prototype bank
  last_layer     the plain head's last layer
  group_projection, last_layer_group   the group head
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
    if parts[0] == "scale_head":
        return "scale_head"
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


def phase_groups(variant: str, phase: int, hp: Dict[str, float],
                 joint_last: bool = True, joint_no_proto: bool = False,
                 has_scale_head: bool = False) -> Dict[str, OptimGroup]:
    """Trainable label -> OptimGroup for a (variant, phase); ``hp`` carries
    the config's learning rates and decays.

    Prototype model: 0 warm-up (add-on, ASPP, prototypes; the scale head
    at the add-on's rate), 1 joint under poly decay (every conv, ASPP at
    10x, add-on and scale head, prototypes), 2 the last layer.  Group
    model: 0 the group projections, 1 joint under poly decay
    (``joint_last``: the group projections and the group last layer only;
    otherwise also every conv, the ASPP at 10x, the add-on and, unless
    ``joint_no_proto``, the prototypes), 2 the group last layer."""
    g: Dict[str, OptimGroup] = {}
    if variant in ("single", "multiscale"):
        if phase == 0:
            for label in ("add_on", "aspp_w", "aspp_b") + \
                    (("scale_head",) if has_scale_head else ()):
                g[label] = OptimGroup(hp["warm_lr_add_on"], hp["warm_wd"])
            g["prototypes"] = OptimGroup(hp["warm_lr_protos"])
        elif phase == 1:
            _joint_backbone(g, hp)
            if has_scale_head:
                g["scale_head"] = OptimGroup(hp["joint_lr_add_on"],
                                             hp["joint_wd"],
                                             use_schedule=True)
            g["prototypes"] = OptimGroup(hp["joint_lr_protos"],
                                         use_schedule=True)
        else:
            g["last_layer"] = OptimGroup(hp["last_layer_lr"])
    elif variant == "group":
        if phase == 0:
            g["group_projection"] = OptimGroup(hp["warm_lr_group"])
        elif phase == 1:
            if not joint_last:
                _joint_backbone(g, hp)
                if not joint_no_proto:
                    g["prototypes"] = OptimGroup(hp["joint_lr_protos"],
                                                 use_schedule=True)
            g["group_projection"] = OptimGroup(hp["joint_lr_group"],
                                               use_schedule=True)
            g["last_layer_group"] = OptimGroup(hp["last_layer_lr"],
                                               use_schedule=True)
        else:
            g["last_layer_group"] = OptimGroup(hp["last_layer_lr"])
    else:
        raise ValueError(variant)
    return g


def _joint_backbone(g: Dict[str, OptimGroup], hp: Dict[str, float]) -> None:
    """The joint phase's backbone groups: add-on, convs, ASPP at 10x."""
    g["add_on"] = OptimGroup(hp["joint_lr_add_on"], hp["joint_wd"],
                             use_schedule=True)
    g["features_conv"] = OptimGroup(hp["joint_lr_features"], hp["joint_wd"],
                                    use_schedule=True)
    for label in ("aspp_w", "aspp_b"):
        g[label] = OptimGroup(10 * hp["joint_lr_features"], hp["joint_wd"],
                              use_schedule=True)


class PhaseOptimizer:
    """One phase's optimizer over ``named_params`` (name, parameter)
    pairs; parameters whose label is not in ``groups`` are frozen.

    Call ``step()`` once per micro-step, after its backward."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 groups: Dict[str, OptimGroup],
                 schedule: Optional[Callable] = None, iter_size: int = 1,
                 guard_nonfinite: int = 0):
        by_label: Dict[str, list] = {label: [] for label in groups}
        names: Dict[int, str] = {}
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
                names[id(p)] = name
        params = [p for ps in by_label.values() for p in ps]
        if not params:
            raise ValueError(f"no parameters carry the labels {sorted(groups)}")
        dev = params[0].device
        self.params = params
        self.names = [names[id(p)] for p in params]
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

    def state_dict(self) -> Dict:
        """Everything a micro-step reads besides the parameters, as
        tensors on the optimizer's device (not copies): per trainable
        parameter, in ``names`` order, Adam's ``exp_avg``,
        ``exp_avg_sq`` and ``step``; the ``iter_size`` running mean
        ``acc``; the device scalars ``mini``, ``streak`` and ``updates``.
        The gradient buffer is zero between micro-steps and is left
        out.  Adam makes its state on the first ``step()``: there is no
        state before it."""
        per = [self.adam.state[p] for p in self.params]
        if not all(per):
            raise ValueError("the optimizer has no state before its first "
                             "step")
        return {"names": list(self.names),
                "exp_avg": [st["exp_avg"] for st in per],
                "exp_avg_sq": [st["exp_avg_sq"] for st in per],
                "step": [st["step"] for st in per],
                "acc": self._acc, "mini": self._mini,
                "streak": self._streak, "updates": self._updates}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore ``state_dict()``'s contents in place: ``acc`` into the
        buffer the gradients' running mean lives in, Adam's tensors into
        its per-parameter state (made on first use, as fused Adam makes
        it: the moments like the parameter, ``step`` a float32 scalar on
        its device), and the three device scalars rebound on this
        optimizer's device.  Raises on other parameter names or
        shapes."""
        if list(state["names"]) != self.names:
            raise ValueError(
                "optimizer state of other parameters: saved "
                f"{sorted(set(state['names']) ^ set(self.names))[:8]} "
                "differ from this phase's trainable parameters")
        dev = self._acc.device
        for name, p, m, v, k in zip(self.names, self.params,
                                    state["exp_avg"], state["exp_avg_sq"],
                                    state["step"]):
            if m.shape != p.shape or v.shape != p.shape:
                raise ValueError(f"optimizer state of {name}: shape "
                                 f"{tuple(m.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            st = self.adam.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=torch.float32,
                                         device=p.device)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            st["exp_avg"].copy_(m)
            st["exp_avg_sq"].copy_(v)
            st["step"].copy_(k)
        if state["acc"].shape != self._acc.shape:
            raise ValueError(f"accumulated gradients of "
                             f"{state['acc'].numel()} values, this phase "
                             f"has {self._acc.numel()}")
        self._acc.copy_(state["acc"])
        self._mini = state["mini"].to(dev, torch.int64).clone()
        self._streak = state["streak"].to(dev, torch.int64).clone()
        self._updates = state["updates"].to(dev, torch.float32).clone()
