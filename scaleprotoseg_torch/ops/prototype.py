"""Prototype-distance ops: per-scale squared L2 distances and the log
similarity, in float32 (eps = 1e-4 is below bf16 resolution near d = 0).

``d = relu(||x_s||^2 - 2 x_s.p + ||p||^2)`` for each pixel against the
prototypes of its own scale, then ``log((d + 1) / (d + eps))``.  Features
of any float dtype are upcast to float32 first; the JAX package's bf16
block-diagonal training form waits for the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

EPSILON = 1e-4


def scale_l2_distances(features: torch.Tensor, prototypes: torch.Tensor,
                       scale_bounds: Tuple[Tuple[int, int], ...]
                       ) -> torch.Tensor:
    """(B, H, W, S*D) features, (P, D) bank -> (B, H, W, Pa) float32
    ReLU-clamped distances in bank order, Pa = ``scale_bounds[-1][1]``."""
    num_scales = len(scale_bounds)
    depth = features.shape[-1] // num_scales
    x32 = features.float()
    p32 = prototypes.float()
    sizes = {hi - lo for lo, hi in scale_bounds}
    num_active = scale_bounds[-1][1]
    if len(sizes) == 1 and num_active == num_scales * next(iter(sizes)):
        # regular bank: every scale at once
        xs = x32.reshape(*x32.shape[:-1], num_scales, depth)
        ps = p32[:num_active].reshape(num_scales, -1, depth)
        x_sq = (xs * xs).sum(-1, keepdim=True)
        p_sq = (ps * ps).sum(-1)
        cross = torch.einsum("bhwsd,spd->bhwsp", xs, ps)
        dist = x_sq - 2.0 * cross + p_sq
        return torch.relu(dist).reshape(*x32.shape[:-1], -1)
    out = []
    for s, (lo, hi) in enumerate(scale_bounds):
        xs = x32[..., s * depth:(s + 1) * depth]
        ps = p32[lo:hi]
        x_sq = (xs * xs).sum(-1, keepdim=True)
        p_sq = (ps * ps).sum(-1)
        cross = torch.einsum("bhwd,pd->bhwp", xs, ps)
        out.append(torch.relu(x_sq - 2.0 * cross + p_sq))
    return torch.cat(out, dim=-1)


def distance_to_similarity(distances: torch.Tensor, activation: str = "log",
                           epsilon: float = EPSILON) -> torch.Tensor:
    if activation == "log":
        d32 = distances.float()
        return torch.log((d32 + 1.0) / (d32 + epsilon))
    if activation == "linear":
        return -distances
    raise ValueError(f"Unknown prototype activation: {activation}")
