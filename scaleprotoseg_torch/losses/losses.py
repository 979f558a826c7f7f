"""The losses of the prototype and group phases, as dense masked tensors.

The port's copies of the JAX package's ``losses/losses.py``: validity
conditions become multiplicative masks and "the mean over contributing
items" is a safe masked mean (0 when nothing contributes).  Prototype
selections are one-hot contractions, so every backward is a product.

Conventions: ``targets`` are resized labels, 0 = void and class c stored
as c + 1 (every loss subtracts 1); ``distances``/``activations`` are
(B, H, W, Pa) NHWC float32; the group-weight losses take the dense
(C, G, Pc_max) view of the packed group projection
(``PPNet.group_weights``), padded slots 0.
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
            "psel": as_t(spec.class_proto_onehot),
            "counts": as_t(spec.class_counts),
            "has": as_t(spec.class_has_protos),
            "smask": as_t(spec.class_proto_scale_mask),
            "gci": as_t(spec.group_class_identity)}


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


def entropy_spat_loss(activations: torch.Tensor, targets: torch.Tensor,
                      spec: ProtoSpec) -> torch.Tensor:
    """Entropy of each class prototype's activations softmaxed over the
    class's pixels, over log(pixels), averaged over the class's
    prototypes, then over (image, class) with >= 2 class pixels."""
    t = loss_tables(spec, activations.device)
    a = _flatten_pixels(activations)
    pcmask = t["pcmask"]
    pixmask, counts = _class_pixel_mask(targets, spec.num_classes)
    a_sel = torch.einsum("bnp,cqp->bcqn", a, t["psel"])       # (B,C,Pc,N)
    pm = pixmask[:, :, None, :]
    logp = _masked_log_softmax(a_sel, pm)
    prob = torch.exp(logp) * pm
    ent = -(prob * logp).sum(-1) / torch.log(counts.clamp_min(2.0))[..., None]
    n_protos = pcmask.sum(-1)[None]
    per_bc = (ent * pcmask[None]).sum(-1) / n_protos.clamp_min(1.0)
    valid = ((counts >= 2) & (n_protos >= 1)).float()
    return _masked_mean(per_bc, valid)


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


def entropy_group_loss(group_weights: torch.Tensor, spec: ProtoSpec,
                       epsilon: float = 1e-5) -> torch.Tensor:
    """Entropy of each group's weight row over log(P_c), averaged over the
    (class, group) rows of classes with prototypes; padded slots are 0 and
    add 0 * log(eps)."""
    t = loss_tables(spec, group_weights.device)
    w = group_weights.float()
    ent = -(w * torch.log(w + epsilon)).sum(-1) / \
        torch.log(t["counts"].clamp_min(2.0))[:, None]          # (C, G)
    return _masked_mean(ent, t["has"][:, None].expand_as(ent))


def cross_entropy_group_loss(group_weights: torch.Tensor, spec: ProtoSpec,
                             epsilon: float = 1e-5) -> torch.Tensor:
    """Mean over a class's ordered group pairs i != j of
    sum_p w_i log(max(w_j, eps)): minimizing it pulls the rows apart."""
    t = loss_tables(spec, group_weights.device)
    w = group_weights.float()
    cross = torch.einsum("cip,cjp->cij", w, torch.log(w.clamp_min(epsilon)))
    g = w.shape[1]
    offdiag = 1.0 - torch.eye(g, device=w.device)
    return _masked_mean(cross, t["has"][:, None, None] * offdiag)


def scale_max_loss(group_weights: torch.Tensor, spec: ProtoSpec
                   ) -> torch.Tensor:
    """Minus the mean over (class, scale) of the group-averaged largest
    weight in the scale's column block: every group should weight every
    scale."""
    t = loss_tables(spec, group_weights.device)
    w = group_weights.float()                                 # (C, G, Pc)
    smask = t["smask"]                                        # (C, S, Pc)
    masked = torch.where(smask[:, :, None, :] > 0, w[:, None],
                         torch.full_like(w[:, None], _NEG_BIG))
    per_cell = masked.amax(-1).mean(-1)                       # (C, S)
    valid = (smask.sum(-1) >= 1).float() * t["has"][:, None]
    return -_masked_mean(per_cell, valid)


def kld_group_loss(group_activations: torch.Tensor, targets: torch.Tensor,
                   spec: ProtoSpec) -> torch.Tensor:
    """Mean of exp(-symKL) over a class's group pairs, each group's
    activations softmaxed over the class's pixels, for (image, class) with
    >= 2 class pixels; ``group_activations`` is (B, H, W, C, G)."""
    t = loss_tables(spec, group_activations.device)
    b, g = group_activations.shape[0], group_activations.shape[-1]
    a = group_activations.reshape(b, -1, spec.num_classes, g) \
        .permute(0, 2, 3, 1).float()                          # (B,C,G,N)
    pixmask, counts = _class_pixel_mask(targets, spec.num_classes)
    pm = pixmask[:, :, None, :]
    logp = _masked_log_softmax(a, pm)
    prob = torch.exp(logp) * pm
    ent = (prob * logp).sum(-1)                               # (B,C,G)
    kl = ent[..., :, None] - torch.einsum("bcgn,bchn->bcgh", prob, logp)
    value = torch.exp(-0.5 * (kl + kl.transpose(-1, -2)))
    upper = torch.triu(torch.ones((g, g), device=a.device), 1)
    valid = (counts >= 2).float()[:, :, None, None] * \
        t["has"][None, :, None, None] * upper
    return _masked_mean(value, valid)


def last_layer_l1(last_layer_weight: torch.Tensor,
                  identity: torch.Tensor) -> torch.Tensor:
    """L1 norm of the (in_features, C) last-layer weights on other-class
    connections; ``identity`` is the (in_features, C) own-class one-hot
    (the prototypes' or, for the dense group last layer, the spec's
    ``group_class_identity``)."""
    return (last_layer_weight * (1.0 - identity)).abs().sum()
