"""Prototype-distance ops: per-scale squared L2 distances and the log
similarity, in float32 (eps = 1e-4 is below bf16 resolution near d = 0).

``d = relu(||x_s||^2 - 2 x_s.p + ||p||^2)`` for each pixel against the
prototypes of its own scale, then ``log((d + 1) / (d + eps))``.

bf16 features (the bf16 training recipe) take the JAX package's
block-diagonal form: the prototypes rounded to bf16 fill a (S*D, Pa)
block-diagonal matrix, so the cross term is one product, and ||x||^2 goes
through the factored channel->scale and scale->prototype masks; its
backward (``_BlockDiagDistances``) keeps dx in bf16 and accumulates the
prototype gradient in float32.  JAX asks for float32 products of the bf16
operands (``preferred_element_type``); a torch bf16 matmul would round its
output to bf16 and ruin ``||x||^2 - 2 x.p + ||p||^2`` by cancellation, so
the products here run on float32 copies of the bf16 values (exact: a
product of two bf16 numbers fits in float32) with TF32 off.  Other
feature dtypes are upcast to float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

EPSILON = 1e-4


def _blockdiag_mats(p: torch.Tensor, scale_bounds, depth: int):
    """float32 (S*D, Pa) block-diagonal matrix of the bf16-rounded
    prototypes, and the 0/1 masks channel->scale (S*D, S) and
    scale->prototype (S, Pa)."""
    num_active = scale_bounds[-1][1]
    num_scales = len(scale_bounds)
    kw = dict(dtype=torch.float32, device=p.device)
    w = torch.zeros((num_scales * depth, num_active), **kw)
    m_cs = torch.zeros((num_scales * depth, num_scales), **kw)
    o_sp = torch.zeros((num_scales, num_active), **kw)
    pb = p.detach().to(torch.bfloat16).float()
    for s, (lo, hi) in enumerate(scale_bounds):
        w[s * depth:(s + 1) * depth, lo:hi] = pb[lo:hi].t()
        m_cs[s * depth:(s + 1) * depth, s] = 1.0
        o_sp[s, lo:hi] = 1.0
    return w, m_cs, o_sp


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class _BlockDiagDistances(torch.autograd.Function):
    """The JAX package's ``_blockdiag_distances_bf16`` and its VJP."""

    @staticmethod
    def forward(ctx, x, p, scale_bounds):
        depth = x.shape[-1] // len(scale_bounds)
        num_active = scale_bounds[-1][1]
        w, m_cs, o_sp = _blockdiag_mats(p, scale_bounds, depth)
        xb = x.to(torch.bfloat16)
        p32 = p[:num_active].float()
        p_sq = (p32 * p32).sum(-1)
        x2s = (xb * xb).float() @ m_cs                  # per-scale ||x||^2
        sq = _bf16_round(x2s) @ o_sp
        cross = xb.float() @ w
        dist = torch.relu(sq - 2.0 * cross + p_sq)
        ctx.scale_bounds = scale_bounds
        ctx.save_for_backward(x, p, dist)
        return dist

    @staticmethod
    def backward(ctx, g):
        x, p, dist = ctx.saved_tensors
        scale_bounds = ctx.scale_bounds
        depth = x.shape[-1] // len(scale_bounds)
        w, m_cs, o_sp = _blockdiag_mats(p, scale_bounds, depth)
        g = g * (dist > 0)
        gb = g.to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        gb32 = gb.float()
        # dx = 2x * (g routed back through the scale masks) - 2 g W^T,
        # bf16 at full resolution
        gs = _bf16_round(gb32 @ o_sp.t())
        gm = (gs @ m_cs.t()).to(torch.bfloat16)
        gw = (gb32 @ w.t()).to(torch.bfloat16)
        dx = (2.0 * (xb * gm - gw)).to(x.dtype)
        # prototype grads accumulate in float32 (the parameters are)
        c = x.shape[-1]
        dcross = xb.float().reshape(-1, c).t() @ gb32.reshape(-1,
                                                              g.shape[-1])
        g_sum = g.float().reshape(-1, g.shape[-1]).sum(0)
        dp = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for s, (lo, hi) in enumerate(scale_bounds):
            blk = dcross[s * depth:(s + 1) * depth, lo:hi].t()
            dp[lo:hi] = -2.0 * blk + 2.0 * p[lo:hi].float() * \
                g_sum[lo:hi, None]
        return dx, dp.to(p.dtype), None


def scale_l2_distances(features: torch.Tensor, prototypes: torch.Tensor,
                       scale_bounds: Tuple[Tuple[int, int], ...]
                       ) -> torch.Tensor:
    """(B, H, W, S*D) features, (P, D) bank -> (B, H, W, Pa) float32
    ReLU-clamped distances in bank order, Pa = ``scale_bounds[-1][1]``.
    bf16 features take the block-diagonal form (module docstring)."""
    if features.dtype == torch.bfloat16:
        return _BlockDiagDistances.apply(features, prototypes,
                                         tuple(tuple(b) for b in
                                               scale_bounds))
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


def pairwise_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2 distances (n, d) x (m, d) -> (n, m) float32,
    ReLU-clamped."""
    a32 = a.float()
    b32 = b.float()
    sq = (a32 * a32).sum(-1)[:, None] - 2.0 * a32 @ b32.t() + \
        (b32 * b32).sum(-1)[None, :]
    return torch.relu(sq)
