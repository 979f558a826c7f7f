"""Euclidean projection onto the probability simplex, in plain PyTorch.

The port's copies of the JAX package's ``ops/simplex.py``: the reference's
sort-based algorithm, applied to the group-projection rows at init and
after every optimizer step of the group phase.  The port stores the group
projection packed, one ``(G, Pc)`` weight per non-empty class, so its
training path takes the plain form; the masked form is that of the dense
``(C, G, Pc_max)`` layout (padded slots masked out), which the packed
rows must reproduce.
"""

from __future__ import annotations

import torch

_NEG_BIG = -1e30


def projection_simplex_sort(v: torch.Tensor, z: float = 1.0
                            ) -> torch.Tensor:
    """Project each row of ``v`` (..., n) onto {w >= 0, sum w = z}."""
    n = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values
    cssv = torch.cumsum(u, dim=-1) - z
    ind = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
    rank = ind * ((u - cssv / ind) > 0)
    # rho: the largest 1-based index where the condition holds
    rho, at = rank.max(dim=-1)
    theta = cssv.gather(-1, at[..., None])[..., 0] / rho
    return torch.clamp_min(v - theta[..., None], 0.0)


def projection_simplex_sort_masked(v: torch.Tensor, mask: torch.Tensor,
                                   z: float = 1.0) -> torch.Tensor:
    """Project the entries of each row with ``mask == 1`` onto the
    simplex; masked-out entries come back 0."""
    n = v.shape[-1]
    valid = mask > 0
    vm = torch.where(valid, v, torch.full_like(v, _NEG_BIG))
    u = torch.sort(vm, dim=-1, descending=True).values
    u_safe = torch.where(u <= _NEG_BIG / 2, torch.zeros_like(u), u)
    cssv = torch.cumsum(u_safe, dim=-1) - z
    ind = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
    in_range = ind <= valid.sum(-1, keepdim=True)
    rank = ind * (((u_safe - cssv / ind) > 0) & in_range)
    rho, at = rank.max(dim=-1)
    theta = cssv.gather(-1, at[..., None])[..., 0] / rho.clamp_min(1.0)
    w = torch.clamp_min(v - theta[..., None], 0.0)
    return torch.where(valid, w, torch.zeros_like(w))
