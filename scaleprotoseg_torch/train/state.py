"""Train state of one phase."""

from __future__ import annotations

import dataclasses

import torch

from scaleprotoseg_torch.train.optim import PhaseOptimizer


@dataclasses.dataclass
class TrainState:
    """The model (all parameters, trainable and frozen, and the frozen BN
    statistics), the phase optimizer over its trainable partition, and
    the count of micro-steps taken."""

    model: torch.nn.Module
    optimizer: PhaseOptimizer
    step: int = 0
