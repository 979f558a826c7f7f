"""K2: the concat-ASPP forward as one CUDA kernel (``csrc/aspp.cu``).

Replaces ``scaleprotoseg_tpu/ops/pallas_aspp.py::fused_aspp``: four 3x3
convolutions dilated at the given rates, C -> F each, over one NHWC bf16
map, fp32 accumulation, bias added, bf16 output with rate r in channels
``[r*F, (r+1)*F)``.

Bound on the H100: operations.  The flagship's 2 x 129 x 257 x 2048 input
needs ~0.63 TFLOP of bf16 tensor-core work against ~0.3 GB of traffic.
The kernel is an implicit GEMM on ``wmma`` bf16 fragments that reads each
tap's shifted input tile straight from the unpadded map (zero-filled at
the border), so the TPU kernel's host-side pad and its ``pltpu.roll``
column realignment have no counterpart here.

``fused_aspp`` launches the kernel for a CUDA tensor and runs
``aspp_plain`` for a CPU tensor; ``aspp_plain`` is the shifted-matmul form
of the JAX package's ``_xla_shifted_aspp`` with the same bf16 contract.
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
    (R, 9, C, F) bf16 weight stack and (R*F,) float32 bias.  A model packs
    once per set of weights and hands the result to every call."""
    f = weights[0].shape[-1]
    wstack = torch.stack([wt.to(torch.bfloat16) for wt in weights]) \
        .reshape(len(weights), 9, -1, f).contiguous()
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
