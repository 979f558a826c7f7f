"""Train and eval steps of the prototype and group phases: loss assembly
and the micro-step update.

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
from torch.utils.checkpoint import checkpoint

from scaleprotoseg_torch.losses import losses as L
from scaleprotoseg_torch.models.ppnet import PPNet, PPNetOutput
from scaleprotoseg_torch.ops.resize import resize_label_nearest
from scaleprotoseg_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The loss weights (config
    ``PatchClassificationModuleMultiScale.loss_weight_*``); ``kld`` weighs
    the prototype KLD in the prototype phase and the group KLD in the group
    phase."""

    crs_ent: float = 1.0
    l1: float = 1e-4
    kld: float = 0.0
    entropy: float = 0.0
    spatial_entropy: float = 0.0
    norm: float = 0.0
    crs_ent_group: float = 0.0
    scale_max: float = 0.0
    group_ent: float = 0.0


def compute_losses(model: PPNet, out: PPNetOutput, target_full: torch.Tensor,
                   weights: LossWeights, ignore_void: bool = True,
                   class_weights: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Total loss and metrics of one output against (B, H, W) labels."""
    spec = model.spec
    target = resize_label_nearest(target_full, out.logits.shape[1],
                                  out.logits.shape[2])
    ce, correct, _ = L.pixel_wise_cross_entropy(
        out.logits, target, ignore_void=ignore_void,
        class_weights=class_weights)
    zero = torch.zeros((), device=ce.device)
    w = weights
    on = lambda weight, fn, *args: fn(*args, spec) if weight > 0 \
        else zero  # noqa: E731
    nrm = on(w.norm, L.norm_loss, out.activations, target)
    if model.grouped:
        gw, glw = model.group_weights()
        kld = on(w.kld, L.kld_group_loss, out.group_activations, target)
        l1 = L.last_layer_l1(glw, L.loss_tables(spec, ce.device)["gci"])
        terms = {"kld_loss": kld, "l1": l1,
                 "spat_ent_loss": on(w.spatial_entropy, L.entropy_spat_loss,
                                     out.activations, target),
                 "norm_loss": nrm,
                 "cross_entropy_group": on(w.crs_ent_group,
                                           L.cross_entropy_group_loss, gw),
                 "scale_max_loss": on(w.scale_max, L.scale_max_loss, gw),
                 "group_ent_loss": on(w.group_ent, L.entropy_group_loss, gw)}
        factors = (w.kld, w.l1, w.spatial_entropy, w.norm, w.crs_ent_group,
                   w.scale_max, w.group_ent)
    else:
        # the active rows only: dangling bank rows never reach the logits
        a = spec.num_active_prototypes
        l1 = L.last_layer_l1(model.last_layer.weight.t()[:a],
                             L.loss_tables(spec, ce.device)["identity"])
        terms = {"kld_loss": on(w.kld, L.kld_loss, out.distances, target),
                 "l1": l1,
                 "ent_loss": on(w.entropy, L.entropy_sampl_loss,
                                out.activations, target),
                 "norm_loss": nrm}
        factors = (w.kld, w.l1, w.entropy, w.norm)
    total = w.crs_ent * ce
    for f, v in zip(factors, terms.values()):
        total = total + f * v
    return total, {"loss": total, "cross_entropy": ce,
                   "n_correct": correct.sum(),
                   "n_patches": torch.full((), float(correct.numel()),
                                           device=ce.device), **terms}


def make_train_step(weights: LossWeights, ignore_void: bool = True,
                    class_weights: Optional[torch.Tensor] = None,
                    grad_mask_last_group: bool = False,
                    project_group_simplex: bool = False,
                    remat: bool = False
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                  Metrics]:
    """``step(state, image, target) -> metrics``: one micro-step of
    ``state.model`` on (B, H, W, 3) images and (B, H, W) labels, both on
    the model's device.  Group phase: ``grad_mask_last_group`` keeps only
    the own-class entries of the group last layer's gradient (the joint
    phase at incorrect_strength 0), ``project_group_simplex`` puts the
    group projections back on the simplex after the update (idempotent
    on accumulation micro-steps, which update nothing).

    ``remat``: the model's whole forward runs under non-reentrant
    ``torch.utils.checkpoint`` and is computed again in the backward, as
    ``jax.checkpoint`` over ``model.apply`` in the JAX package (BN is
    frozen in the port, so its ``not train_bn`` condition always holds).
    The numbers are the plain step's; K2's forward launches twice a
    micro-step (its packed weights come from the cache both times)."""

    def step(state: TrainState, image: torch.Tensor,
             target: torch.Tensor) -> Metrics:
        model = state.model
        if getattr(model.features.base, "quant8", False):
            raise ValueError(
                "model was built with quant8 (int8 serving convs: their "
                "round() has zero gradient, so training would silently "
                "freeze the backbone); reload without quant8 to train")
        model.train()
        out = checkpoint(model, image, use_reentrant=False) if remat \
            else model(image)
        loss, metrics = compute_losses(model, out, target, weights,
                                       ignore_void, class_weights)
        loss.backward()
        if grad_mask_last_group:
            model.mask_last_layer_group_grad_()
        state.optimizer.step()
        if project_group_simplex:
            model.project_group_simplex_()
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
