"""Train and eval steps of the prototype phase: loss assembly and the
micro-step update.

The label map is resized to the logit grid inside the step (PIL-NEAREST
indices, ``ops.resize.resize_label_nearest``), the losses are the JAX
package's, and a micro-step is forward, backward and
``PhaseOptimizer.step``.  Nothing here waits for the device: the metrics
come back as device scalars, for the caller to fetch in bulk.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from scaleprotoseg_torch.losses import losses as L
from scaleprotoseg_torch.models.ppnet import PPNet, PPNetOutput
from scaleprotoseg_torch.ops.resize import resize_label_nearest
from scaleprotoseg_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The prototype phase's loss weights (config
    ``PatchClassificationModuleMultiScale.loss_weight_*``)."""

    crs_ent: float = 1.0
    l1: float = 1e-4
    kld: float = 0.0
    entropy: float = 0.0
    norm: float = 0.0


def compute_losses(model: PPNet, out: PPNetOutput, target_full: torch.Tensor,
                   weights: LossWeights, ignore_void: bool = True,
                   class_weights: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Total loss and metrics of one output against (B, H, W) labels."""
    if model.grouped:
        raise NotImplementedError("the group losses (finetune_wandb_group) "
                                  "are not ported yet")
    spec = model.spec
    target = resize_label_nearest(target_full, out.logits.shape[1],
                                  out.logits.shape[2])
    ce, correct, _ = L.pixel_wise_cross_entropy(
        out.logits, target, ignore_void=ignore_void,
        class_weights=class_weights)
    zero = torch.zeros((), device=ce.device)
    kld = L.kld_loss(out.distances, target, spec) if weights.kld > 0 \
        else zero
    # the active rows only: dangling bank rows never reach the logits
    a = spec.num_active_prototypes
    l1 = L.last_layer_l1(model.last_layer.weight.t()[:a],
                         L.loss_tables(spec, ce.device)["identity"])
    ent = L.entropy_sampl_loss(out.activations, target, spec) \
        if weights.entropy > 0 else zero
    nrm = L.norm_loss(out.activations, target, spec) if weights.norm > 0 \
        else zero
    total = weights.crs_ent * ce + weights.kld * kld + weights.l1 * l1 + \
        weights.entropy * ent + weights.norm * nrm
    return total, {"loss": total, "cross_entropy": ce,
                   "n_correct": correct.sum(),
                   "n_patches": torch.full((), float(correct.numel()),
                                           device=ce.device),
                   "kld_loss": kld, "l1": l1, "ent_loss": ent,
                   "norm_loss": nrm}


def make_train_step(weights: LossWeights, ignore_void: bool = True,
                    class_weights: Optional[torch.Tensor] = None
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                  Metrics]:
    """``step(state, image, target) -> metrics``: one micro-step of
    ``state.model`` on (B, H, W, 3) images and (B, H, W) labels, both on
    the model's device."""

    def step(state: TrainState, image: torch.Tensor,
             target: torch.Tensor) -> Metrics:
        state.model.train()
        out = state.model(image)
        loss, metrics = compute_losses(state.model, out, target, weights,
                                       ignore_void, class_weights)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(weights: LossWeights, ignore_void: bool = True,
                   class_weights: Optional[torch.Tensor] = None
                   ) -> Callable[[PPNet, torch.Tensor, torch.Tensor],
                                 Metrics]:
    """``step(model, image, target) -> metrics`` without gradients."""

    @torch.no_grad()
    def step(model: PPNet, image: torch.Tensor,
             target: torch.Tensor) -> Metrics:
        model.eval()
        out = model(image)
        return compute_losses(model, out, target, weights, ignore_void,
                              class_weights)[1]

    return step
