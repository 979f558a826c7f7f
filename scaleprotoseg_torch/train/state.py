"""Train state of one phase."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from scaleprotoseg_torch.train.optim import PhaseOptimizer


@dataclasses.dataclass
class TrainState:
    """The model (all parameters, trainable and frozen, and the BN
    statistics: frozen, or with ``freeze_type = 'none'`` the running ones
    a relaunch resumes on), the phase optimizer over its trainable
    partition, and the count of micro-steps taken."""

    model: torch.nn.Module
    optimizer: PhaseOptimizer
    step: int = 0
    # host-side values that ride along in a checkpoint (JSON): the
    # runner's partial train metrics of a preempted validation interval
    extra: Dict = dataclasses.field(default_factory=dict)

    def state_dict(self) -> Dict:
        """Everything a micro-step reads, as live tensors (the
        checkpoint writer snapshots them): ``model`` (every entry of the
        model's ``state_dict``), ``optimizer`` (``PhaseOptimizer``'s) and
        ``step``."""
        return {"step": int(self.step), "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "extra": dict(self.extra)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Write ``state`` into this state in place: the model's tensors
        are ``copy_``'d (their version counters move, so caches keyed on
        them, K2's packed weights, rebuild), then the optimizer's; raises
        on other names or shapes before writing anything."""
        names = list(state["optimizer"]["names"])
        if names != self.optimizer.names:
            differ = sorted(set(names) ^ set(self.optimizer.names))
            raise ValueError("train state of another phase: trainable "
                             f"parameters {differ[:8]} differ")
        own = self.model.state_dict()
        saved = state["model"]
        if set(saved) != set(own):
            raise ValueError(
                "train state of another model: names "
                f"{sorted(set(saved) ^ set(own))[:8]} differ")
        for name, t in own.items():
            if saved[name].shape != t.shape:
                raise ValueError(f"train state of another model: {name} "
                                 f"is {tuple(saved[name].shape)}, the model "
                                 f"has {tuple(t.shape)}")
        for name, t in own.items():
            t.copy_(saved[name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.extra = dict(state.get("extra") or {})
