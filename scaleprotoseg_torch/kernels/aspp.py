"""K2: the concat-ASPP forward as one CUDA kernel (``csrc/aspp.cu``).

Replaces ``scaleprotoseg_tpu/ops/pallas_aspp.py::fused_aspp``: four 3x3
convolutions dilated at the given rates, C -> F each, over one NHWC bf16
map, fp32 accumulation, bias added, bf16 output with rate r in channels
``[r*F, (r+1)*F)``.

Bound on the H100: operations.  The flagship's 2 x 129 x 257 x 2048 input
needs ~0.56 TFLOP of bf16 tensor-core work against ~0.17 GB of traffic.
The kernel is an implicit GEMM fed by TMA and multiplied with ``wgmma``:
a work item is a 32 x 8 output patch of one rate, its input comes as TMA
boxes from the unpadded map, zero-filled by the hardware at the border
(so the TPU kernel's host-side pad and its ``pltpu.roll`` column
realignment have no counterpart here), and the three dy taps of a dx are
views of one staged column strip.

``fused_aspp`` launches the kernel for a CUDA tensor and runs
``aspp_plain`` for a CPU tensor; ``aspp_plain`` is the shifted-matmul form
of the JAX package's ``_xla_shifted_aspp`` with the same bf16 contract.

Training goes through ``aspp_trainable``, the counterpart of the JAX
package's ``fused_aspp_trainable``: the forward above (the shifted-matmul
form below ``KERNEL_MIN_C`` input channels) and the tap-packed backward
of ``csrc/aspp_bwd.cu``: ``aspp_grad_pack`` builds the shifted-gradient
family G once, ``aspp_grad_weight`` reduces dW = x^T G in fp32 (TMA-fed
``wgmma`` on both operands as they lie, skipping the rows where a tile of
G is zero, one fp32 partial per 4352 pixels of an image at most), dx = G
W_all^T is one bf16 ``torch.matmul`` (a plain large product, as XLA's in
the JAX package) and db a sum.  Each wrapper runs its plain version for
a CPU tensor and launches its kernel, or raises, for a CUDA one.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from scaleprotoseg_torch.kernels._build import check, library

# Below this input depth the model takes the shifted-matmul form (the JAX
# package's ``_KERNEL_MIN_C`` crossover, kept as the dispatch rule).
KERNEL_MIN_C = 512
_TILE = 64  # the kernel's channel chunk and output-channel tile
# csrc/aspp_bwd.cu's CHUNK: the weight gradient keeps one partial per this
# many pixels of an image, at most
_DW_CHUNK = 4352


def shifted_sum(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor],
                rates: Sequence[int]) -> torch.Tensor:
    """Nine shifted pointwise matmuls per rate off one zero-padded copy of
    ``x`` (B, H, W, C); weights (3, 3, C, F) are rounded to ``x``'s dtype,
    products and sums are float32.  Returns (B, H, W, R*F) float32."""
    m = max(rates)
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, m, m, m, m))
    outs = []
    for wt, bias, rate in zip(weights, biases, rates):
        wt = wt.to(x.dtype).float()
        acc = None
        for di in range(3):
            for dj in range(3):
                y0 = m + (di - 1) * rate
                x0 = m + (dj - 1) * rate
                xs = xp[:, y0:y0 + h, x0:x0 + w, :].float()
                t = torch.einsum("bhwc,cf->bhwf", xs, wt[di, dj])
                acc = t if acc is None else acc + t
        outs.append(acc + bias.float())
    return torch.cat(outs, dim=-1)


def aspp_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor],
               rates: Sequence[int] = (6, 12, 18, 24)) -> torch.Tensor:
    """The kernel's function in plain PyTorch: bf16 (B, H, W, R*F)."""
    return shifted_sum(x, weights, biases, rates).to(torch.bfloat16)


@lru_cache(maxsize=None)
def _launcher():
    fn = library("aspp").aspp_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_weights(weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rate (3, 3, C, F) weights and (F,) biases -> the kernel's
    (R, 9, F, C) bf16 weight stack (tap 3 * ky + kx; input channels
    contiguous, the K-major operand ``wgmma`` reads) and (R*F,) float32
    bias.  A model packs once per set of weights and hands the result to
    every call."""
    f = weights[0].shape[-1]
    wstack = torch.stack([wt.to(torch.bfloat16) for wt in weights]) \
        .reshape(len(weights), 9, -1, f).transpose(2, 3).contiguous()
    bias = torch.cat([bb.float().reshape(f) for bb in biases]).contiguous()
    return wstack, bias


def fused_aspp(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor],
               rates: Tuple[int, ...] = (6, 12, 18, 24),
               packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Concat-ASPP: x (B, H, W, C) -> (B, H, W, len(rates)*F) bf16.

    Weights are per-rate (3, 3, C, F), biases per-rate (F,); ``packed``
    is ``pack_weights(weights, biases)``, made once by the caller."""
    if x.device.type == "cpu":
        return aspp_plain(x, weights, biases, rates)
    if x.device.type != "cuda":
        raise ValueError(f"fused_aspp: unsupported device {x.device}")
    b, h, w, c = x.shape
    f = weights[0].shape[-1]
    n_rates = len(rates)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("fused_aspp: x must be contiguous bf16 NHWC")
    if c % _TILE or f % _TILE or not 1 <= n_rates <= 4:
        raise ValueError(f"fused_aspp: needs C and F multiples of {_TILE} "
                         f"and 1-4 rates, got C={c} F={f} rates={rates}")
    if len(weights) != n_rates or len(biases) != n_rates or any(
            tuple(wt.shape) != (3, 3, c, f) for wt in weights):
        raise ValueError("fused_aspp: one (3, 3, C, F) weight and one bias "
                         "per rate")
    wstack, bias = packed if packed is not None else \
        pack_weights(weights, biases)
    out = torch.empty((b, h, w, n_rates * f), dtype=torch.bfloat16,
                      device=x.device)
    r = list(rates) + [0] * (4 - n_rates)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _launcher()(x.data_ptr(), wstack.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), b, h, w, c, f, n_rates, *r, stream)
    check(library("aspp"), status, "aspp_forward")
    fused_aspp.launches += 1
    return out


fused_aspp.launches = 0


# ---------------------------------------------------------------------------
# Backward: shifted-gradient pack and weight gradient (csrc/aspp_bwd.cu)
# ---------------------------------------------------------------------------
def grad_pack_plain(g: torch.Tensor, rates: Sequence[int],
                    f: int) -> torch.Tensor:
    """``aspp_grad_pack``'s function in plain PyTorch, as the JAX
    package's backward builds it: pad g by the largest rate, take the
    R x 9 shifted (H, W) windows, concatenate.  g (B, H, W, R*F) ->
    G (B*H*W, R*9*F) in g's dtype, with ``G[q, (r, di, dj, f)] =
    g_r[q - ((di-1) r, (dj-1) r)]`` and zero outside the image."""
    halo = max(rates)
    b, h, w, _ = g.shape
    gp = F.pad(g, (0, 0, halo, halo, halo, halo))
    slices = []
    for ri, rate in enumerate(rates):
        gr = gp[..., ri * f:(ri + 1) * f]
        for di in range(3):
            for dj in range(3):
                y0 = halo - (di - 1) * rate
                x0 = halo - (dj - 1) * rate
                slices.append(gr[:, y0:y0 + h, x0:x0 + w, :])
    return torch.cat(slices, dim=-1).reshape(b * h * w, -1)


@lru_cache(maxsize=None)
def _bwd_launchers():
    lib = library("aspp_bwd")
    pack = lib.aspp_grad_pack
    pack.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    pack.restype = ctypes.c_int
    weight = lib.aspp_grad_weight
    weight.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    weight.restype = ctypes.c_int
    return pack, weight


def aspp_grad_pack(g: torch.Tensor, rates: Sequence[int],
                   f: int) -> torch.Tensor:
    """G (B*H*W, R*9*F) from the ASPP output gradient g (B, H, W, R*F);
    see ``grad_pack_plain``.  The kernel takes contiguous bf16 g."""
    if g.device.type == "cpu":
        return grad_pack_plain(g, rates, f)
    if g.device.type != "cuda":
        raise ValueError(f"aspp_grad_pack: unsupported device {g.device}")
    b, h, w, rf = g.shape
    n_rates = len(rates)
    if g.dtype != torch.bfloat16 or not g.is_contiguous():
        raise ValueError("aspp_grad_pack: g must be contiguous bf16 NHWC")
    if f % 8 or rf != n_rates * f or not 1 <= n_rates <= 4:
        raise ValueError(f"aspp_grad_pack: needs F % 8 == 0, 1-4 rates and "
                         f"R*F channels, got F={f} rates={rates} C={rf}")
    out = torch.empty((b * h * w, n_rates * 9 * f), dtype=torch.bfloat16,
                      device=g.device)
    r = list(rates) + [0] * (4 - n_rates)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    status = _bwd_launchers()[0](g.data_ptr(), out.data_ptr(), b, h, w, f,
                                 n_rates, *r, stream)
    check(library("aspp_bwd"), status, "aspp_grad_pack")
    aspp_grad_pack.launches += 1
    return out


aspp_grad_pack.launches = 0


def grad_weight_plain(x: torch.Tensor, packed_g: torch.Tensor
                      ) -> torch.Tensor:
    """``aspp_grad_weight``'s function in plain PyTorch: x (N, C) or (B,
    H, W, C) and G (N, K) -> x^T G (C, K) in float32 (exact products of
    the bf16 operands; on the card the caller turns TF32 off)."""
    return x.reshape(-1, x.shape[-1]).float().t() @ packed_g.float()


def aspp_grad_weight(x: torch.Tensor, packed_g: torch.Tensor,
                     rates: Sequence[int]) -> torch.Tensor:
    """dW_all = x^T G (C, K) float32 for x (B, H, W, C) and G =
    ``aspp_grad_pack(g, rates, f)`` (B*H*W, K = R*9*F).  The kernel skips
    the image rows in which a tile of G's columns is all zeros; it takes
    contiguous bf16 operands with C and K multiples of 8 (its tiles' edges
    are masked); its partials, one per ``_DW_CHUNK`` pixels of an image at
    most, are added in a fixed order."""
    if x.device.type == "cpu":
        return grad_weight_plain(x, packed_g)
    if x.device.type != "cuda":
        raise ValueError(f"aspp_grad_weight: unsupported device {x.device}")
    b, h, w, c = x.shape
    k = packed_g.shape[1]
    n_rates = len(rates)
    if x.dtype != torch.bfloat16 or packed_g.dtype != torch.bfloat16 or \
            not x.is_contiguous() or not packed_g.is_contiguous():
        raise ValueError("aspp_grad_weight: x and G must be contiguous bf16")
    if packed_g.shape[0] != b * h * w or c % 8 or k % 8 or \
            not 1 <= n_rates <= 4 or k % (9 * n_rates):
        raise ValueError(f"aspp_grad_weight: needs x (B, H, W, C) and G (N, "
                         f"K = R * 9 * F) with C and K multiples of 8, got "
                         f"{tuple(x.shape)} {tuple(packed_g.shape)} for "
                         f"rates {rates}")
    f = k // (9 * n_rates)
    r = list(rates) + [0] * (4 - n_rates)
    parts = b * -(-h * w // _DW_CHUNK)
    out = torch.empty((c, k), dtype=torch.float32, device=x.device)
    work = torch.empty((parts, c, k), dtype=torch.float32,
                       device=x.device) if parts > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _bwd_launchers()[1](
        x.data_ptr(), packed_g.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None, b, h, w, c, k, f,
        n_rates, *r, stream)
    check(library("aspp_bwd"), status, "aspp_grad_weight")
    aspp_grad_weight.launches += 1
    return out


aspp_grad_weight.launches = 0


def stack_weights_t(weights: Sequence[torch.Tensor],
                    dtype: torch.dtype) -> torch.Tensor:
    """W_all (R*9*F, C): row (r, di, dj, f) holds W_r[di, dj][:, f], the
    k order of G."""
    c, f = weights[0].shape[2], weights[0].shape[3]
    return torch.cat([wt.to(dtype).permute(0, 1, 3, 2).reshape(9 * f, c)
                      for wt in weights], dim=0)


class _TrainableASPP(torch.autograd.Function):
    """The concat-ASPP with the tap-packed backward.  Inputs: x, rates,
    the packed forward weights (or None), then the R per-rate (3, 3, C, F)
    weights and the R biases, so their gradients reach the parameters."""

    @staticmethod
    def forward(ctx, x, rates, packed, *params):
        n_rates = len(rates)
        weights, biases = params[:n_rates], params[n_rates:]
        if x.shape[-1] >= KERNEL_MIN_C:
            y = fused_aspp(x, weights, biases, rates, packed)
        else:
            y = aspp_plain(x, weights, biases, rates)
        ctx.rates = tuple(rates)
        ctx.save_for_backward(x, *weights)
        return y

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        rates = ctx.rates
        n_rates = len(rates)
        b, h, w, c = x.shape
        f = weights[0].shape[-1]
        cdt = x.dtype          # the products follow the input dtype
        packed_g = aspp_grad_pack(g.to(cdt).contiguous(), rates, f)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (packed_g @ stack_weights_t(weights, cdt)) \
                .reshape(b, h, w, c)
        dw_all = aspp_grad_weight(x.contiguous(), packed_g, rates) \
            .reshape(c, n_rates, 3, 3, f)
        dws = [dw_all[:, ri].permute(1, 2, 0, 3).to(weights[ri].dtype)
               for ri in range(n_rates)]
        dbs = list(g.float().reshape(-1, n_rates, f).sum(0))
        return (dx, None, None, *dws, *dbs)


def aspp_trainable(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor],
                   rates: Tuple[int, ...] = (6, 12, 18, 24),
                   packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Concat-ASPP x (B, H, W, C) -> (B, H, W, R*F) bf16, differentiable
    in x, the per-rate (3, 3, C, F) weights and the (F,) biases through
    the tap-packed backward.  ``packed`` as for ``fused_aspp``."""
    return _TrainableASPP.apply(x, tuple(rates), packed, *weights, *biases)
