"""The prototype phase's losses, as dense masked tensors.

The port's copies of the JAX package's ``losses/losses.py``: validity
conditions become multiplicative masks and "the mean over contributing
items" is a safe masked mean (0 when nothing contributes).  Prototype
selections are one-hot contractions, so every backward is a product.

Conventions: ``targets`` are resized labels, 0 = void and class c stored
as c + 1 (every loss subtracts 1); ``distances``/``activations`` are
(B, H, W, Pa) NHWC float32.  The group phase's four losses are not
ported yet.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from scaleprotoseg_torch.spec import ProtoSpec

_NEG_BIG = -1e30


@lru_cache(maxsize=64)
def loss_tables(spec: ProtoSpec, device: torch.device) -> dict:
    """The spec's selection tables on ``device``, made once, so a step
    issues no host-to-device copy (a blocking copy waits for the card)."""
    as_t = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                     device=device)
    a = spec.num_active_prototypes
    return {"identity": as_t(spec.class_identity[:a]),
            "kmask": as_t(spec.class_scale_proto_mask),
            "ksel": as_t(spec.class_scale_proto_onehot),
            "kcounts": as_t(spec.class_scale_counts),
            "pcmask": as_t(spec.class_proto_mask),
            "psel": as_t(spec.class_proto_onehot)}


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over entries with mask == 1; 0 when nothing contributes."""
    total = (values * mask).sum()
    count = mask.sum()
    return torch.where(count > 0, total / count.clamp_min(1.0),
                       torch.zeros_like(total))


def _flatten_pixels(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, K) -> (B, N, K) float32."""
    return x.reshape(x.shape[0], -1, x.shape[-1]).float()


def _class_pixel_mask(targets: torch.Tensor, num_classes: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B, C, N) float mask of class pixels, (B, C) counts)."""
    t = targets.reshape(targets.shape[0], -1).long() - 1
    classes = torch.arange(num_classes, device=targets.device)
    mask = (t[:, None, :] == classes[None, :, None]).float()
    return mask, mask.sum(-1)


def _masked_log_softmax(z: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """log_softmax over the last axis restricted to mask == 1; entries
    outside the mask are finite garbage to be multiplied by the mask."""
    zm = torch.where(mask > 0, z, torch.full_like(z, _NEG_BIG))
    zs = zm - zm.amax(-1, keepdim=True).detach()
    return zs - torch.log(torch.exp(zs).sum(-1, keepdim=True))


def pixel_wise_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                             ignore_void: bool = True,
                             class_weights: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(scalar loss, (N,) correct float mask, (N,) valid float mask) for
    (..., C) logits and (...) raw labels (0 = void)."""
    num_classes = logits.shape[-1]
    flat = logits.reshape(-1, num_classes).float()
    t = targets.reshape(-1).long() - 1
    valid = (t >= 0) if ignore_void else torch.ones_like(t, dtype=torch.bool)
    t_safe = t.clamp(0, num_classes - 1)
    logp = F.log_softmax(flat, dim=-1)
    classes = torch.arange(num_classes, device=flat.device)
    nll = -(logp * (t_safe[:, None] == classes).float()).sum(-1)
    w = valid.float() if class_weights is None else \
        class_weights.float()[t_safe] * valid.float()
    loss = (nll * w).sum() / w.sum().clamp_min(1e-12)
    correct = (flat.argmax(-1) == t_safe) & valid
    return loss, correct.float(), valid.float()


def kld_loss(distances: torch.Tensor, targets: torch.Tensor,
             spec: ProtoSpec) -> torch.Tensor:
    """Mean over same-class same-scale prototype pairs of exp(-symKL) of
    their distance maps softmaxed over the class's pixels; a pair counts
    where the class has >= 2 pixels in the image."""
    t = loss_tables(spec, distances.device)
    d = _flatten_pixels(distances)                            # (B, N, P)
    pixmask, counts = _class_pixel_mask(targets, spec.num_classes)
    d_sel = torch.einsum("bnp,cskp->bcskn", d, t["ksel"])     # (B,C,S,k,N)
    pm = pixmask[:, :, None, None, :]
    logp = _masked_log_softmax(d_sel, pm)
    prob = torch.exp(logp) * pm
    ent = (prob * logp).sum(-1)                               # (B,C,S,k)
    cross = torch.einsum("bcskn,bcsln->bcskl", prob, logp)
    kl = ent[..., :, None] - cross                            # KL(j||l)
    value = torch.exp(-0.5 * (kl + kl.transpose(-1, -2)))
    kmask = t["kmask"]
    k = kmask.shape[-1]
    upper = torch.triu(torch.ones((k, k), device=d.device), 1)
    pair_mask = kmask[..., :, None] * kmask[..., None, :] * upper
    has_pixels = (counts >= 2).float()
    return _masked_mean(value, pair_mask[None] *
                        has_pixels[:, :, None, None, None])


def entropy_sampl_loss(activations: torch.Tensor, targets: torch.Tensor,
                       spec: ProtoSpec) -> torch.Tensor:
    """Entropy across a class-scale's prototypes at each class pixel over
    log(k), averaged over class pixels, then over (image, present class,
    scale) cells."""
    t = loss_tables(spec, activations.device)
    a = _flatten_pixels(activations)
    kmask, kcounts = t["kmask"], t["kcounts"]
    pixmask, counts = _class_pixel_mask(targets, spec.num_classes)
    a_sel = torch.einsum("bnp,cskp->bncsk", a, t["ksel"])
    logp = _masked_log_softmax(a_sel, kmask[None, None])
    prob = torch.exp(logp) * kmask[None, None]
    log_norm = torch.log(kcounts.clamp_min(2.0))
    ent = -(prob * logp).sum(-1) / log_norm[None, None]      # (B,N,C,S)
    pm = pixmask.transpose(1, 2)[..., None]                   # (B,N,C,1)
    per_cell = (ent * pm).sum(1) / counts[..., None].clamp_min(1.0)
    cell_valid = ((counts[..., None] >= 1) & (kcounts[None] >= 1)).float()
    return _masked_mean(per_cell, cell_valid)


def norm_loss(activations: torch.Tensor, targets: torch.Tensor,
              spec: ProtoSpec, norm_type: str = "l1") -> torch.Tensor:
    """Mean L1 (or L-inf) of class-prototype activations over the class's
    pixels, averaged over prototypes, then over (image, present class)."""
    t = loss_tables(spec, activations.device)
    a = _flatten_pixels(activations)
    pcmask = t["pcmask"]
    pixmask, counts = _class_pixel_mask(targets, spec.num_classes)
    a_sel = torch.einsum("bnp,cqp->bcqn", a, t["psel"])       # (B,C,Pc,N)
    pm = pixmask[:, :, None, :]
    if norm_type == "l1":
        per_proto = (a_sel.abs() * pm).sum(-1) / \
            counts[:, :, None].clamp_min(1.0)
    elif norm_type == "linf":
        per_proto = (a_sel.abs() * pm).amax(-1)
    else:
        raise ValueError(norm_type)
    n_protos = pcmask.sum(-1)[None]
    per_bc = (per_proto * pcmask[None]).sum(-1) / n_protos.clamp_min(1.0)
    valid = ((counts >= 1) & (n_protos >= 1)).float()
    return _masked_mean(per_bc, valid)


def last_layer_l1(last_layer_weight: torch.Tensor,
                  identity: torch.Tensor) -> torch.Tensor:
    """L1 norm of the (in_features, C) last-layer weights on other-class
    connections; ``identity`` is the (in_features, C) own-class one-hot."""
    return (last_layer_weight * (1.0 - identity)).abs().sum()
