"""K1: the multi-scale prototype head as one CUDA kernel (``csrc/proto.cu``).

Replaces ``scaleprotoseg_tpu/ops/pallas_proto.py::fused_proto_logits``:
per pixel and scale, ``d = relu(|x_s|^2 - 2 x_s.p + |p|^2)`` against that
scale's prototypes, ``act = log((d + 1) / (d + 1e-4))``, then either the
group head ``exp(act @ Gw) @ Glw`` (rows of empty classes zeroed) or the
plain head ``act @ W[:A]``; fp32 throughout, no TF32.

Bound on the H100: operations on the fp32 pipes (~2 GFLOP at the
flagship's 66306 pixels) over a small memory footprint (~39 MB moved).
The TPU kernel packed the bank block-diagonally to give the MXU one big
matmul; on the card that would quadruple the distance work, so the kernel
instead walks each pixel's own scale with the features in registers and
the bank staged in shared memory (64 rows at a time, read by broadcast),
and accumulates the head per class in shared memory without writing
distances or activations to device memory.

``fused_proto_logits`` launches the kernel for a CUDA tensor and runs
``proto_plain`` for a CPU tensor.  The kernel reads bf16 features, the
add-on output of the bf16 fast path.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from scaleprotoseg_torch.kernels._build import check, library
from scaleprotoseg_torch.ops.prototype import (EPSILON,
                                               distance_to_similarity,
                                               scale_l2_distances)
from scaleprotoseg_torch.spec import ProtoSpec

_DEPTH = 64                   # the kernel's compiled per-scale depth
_CHUNK = 64                   # bank rows the kernel stages at a time (PT)
_SMEM_LIMIT = 232448          # bytes of shared memory a block may use


@lru_cache(maxsize=64)
def spec_tensors(spec: ProtoSpec, device: torch.device) -> dict:
    """Device copies of the spec's static index tables, made once per
    (spec, device) so the forward issues no host-to-device copies."""
    idx = spec.class_proto_index
    c_of, q_of = np.nonzero(idx >= 0)
    bounds = [lo for lo, _ in spec.scale_bounds] + \
        [spec.num_active_prototypes]
    a = spec.num_active_prototypes
    as_t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=device)  # noqa: E731
    return {
        "onehot": as_t(spec.class_proto_onehot, torch.float32),
        "has": as_t(spec.class_has_protos, torch.float32),
        "bounds": as_t(np.asarray(bounds, np.int32), torch.int32),
        "cls": as_t(np.asarray(spec.class_ids[:a], np.int32), torch.int32),
        # (class, slot) -> prototype, to gather per-prototype group weights
        "member_c": as_t(c_of, torch.long),
        "member_q": as_t(q_of, torch.long),
        "member_p": as_t(idx[c_of, q_of], torch.long),
    }


def group_activations(act: torch.Tensor, group_projection: torch.Tensor,
                      spec: ProtoSpec) -> torch.Tensor:
    """exp of the per-class group projection of the activations,
    (..., Pa) -> (..., C, G), zero for classes without prototypes."""
    t = spec_tensors(spec, act.device)
    w_full = torch.einsum("cgq,cqp->cgp", group_projection.float(),
                          t["onehot"])
    scores = torch.einsum("...p,cgp->...cg", act, w_full)
    return torch.exp(scores) * t["has"][:, None]


def proto_plain(features: torch.Tensor, prototypes: torch.Tensor,
                last_layer: Optional[torch.Tensor], spec: ProtoSpec,
                group_projection: Optional[torch.Tensor] = None,
                last_layer_group: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (float32)."""
    d = scale_l2_distances(features, prototypes, spec.scale_bounds)
    act = distance_to_similarity(d)
    if group_projection is not None:
        group = group_activations(act, group_projection, spec)
        return group.flatten(-2) @ last_layer_group.float()
    return act @ last_layer[:spec.num_active_prototypes].float()


class ProtoHead(NamedTuple):
    """The head's weights in the form the kernel reads, derived from the
    model's parameters by ``pack_head``."""
    protos: torch.Tensor     # (A, D) float32, active prototypes
    pnorm: torch.Tensor      # (A,) |p|^2
    head_w: torch.Tensor     # (A, G) per-prototype group weights | (A, C)
    glw: torch.Tensor        # (C*G, C), rows of empty classes zeroed
    groups: int              # G, 0 for the plain head


def pack_head(prototypes: torch.Tensor, last_layer: Optional[torch.Tensor],
              spec: ProtoSpec, group_projection: Optional[torch.Tensor] = None,
              last_layer_group: Optional[torch.Tensor] = None) -> ProtoHead:
    """The kernel's view of the head weights (the counterpart of the JAX
    package's ``pack_prototype_bank``).  A model packs once per set of
    weights and hands the result to every call as ``head``."""
    t = spec_tensors(spec, prototypes.device)
    a = spec.num_active_prototypes
    protos = prototypes[:a].float().contiguous()
    pnorm = (protos * protos).sum(-1)
    if group_projection is None:
        head_w = last_layer[:a].float().contiguous()
        return ProtoHead(protos, pnorm, head_w, head_w, 0)
    g = spec.num_groups
    per_proto = torch.zeros((a, g), dtype=torch.float32,
                            device=prototypes.device)
    per_proto[t["member_p"]] = group_projection.float()[
        t["member_c"], :, t["member_q"]]
    rows_has = t["has"].repeat_interleave(g)[:, None]
    glw = (last_layer_group.float() * rows_has).contiguous()
    return ProtoHead(protos, pnorm, per_proto, glw, g)


@lru_cache(maxsize=None)
def _launcher():
    fn = library("proto").proto_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _threads(words_per_thread: int, words_fixed: int) -> int:
    for t in (128, 64, 32):
        if (words_fixed + words_per_thread * t) * 4 <= _SMEM_LIMIT:
            return t
    raise ValueError(f"fused_proto_logits: a head of {words_per_thread} "
                     "accumulators per pixel exceeds shared memory")


def fused_proto_logits(features: torch.Tensor, prototypes: torch.Tensor,
                       last_layer: Optional[torch.Tensor], spec: ProtoSpec,
                       group_projection: Optional[torch.Tensor] = None,
                       last_layer_group: Optional[torch.Tensor] = None,
                       head: Optional[ProtoHead] = None) -> torch.Tensor:
    """(B, H, W, S*D) post-add-on features -> (B, H, W, C) float32 logits.

    Plain head: ``last_layer`` (P, C).  Group head: ``group_projection``
    (C, G, Pc_max) and ``last_layer_group`` (C*G, C).  ``head``: these
    weights already packed by ``pack_head``; the kernel then reads it
    instead of packing them anew.  The kernel takes bf16 features."""
    if features.device.type == "cpu":
        return proto_plain(features, prototypes, last_layer, spec,
                           group_projection, last_layer_group)
    if features.device.type != "cuda":
        raise ValueError(f"fused_proto_logits: unsupported device "
                         f"{features.device}")
    b, h, w, cf = features.shape
    if cf != spec.feature_depth or spec.proto_depth != _DEPTH:
        raise ValueError(f"fused_proto_logits: the kernel takes "
                         f"{spec.num_scales} x {_DEPTH} features, got {cf} "
                         f"channels at depth {spec.proto_depth}")
    if features.dtype != torch.bfloat16 or not features.is_contiguous():
        raise ValueError("fused_proto_logits: features must be contiguous "
                         f"bf16, got {features.dtype}")
    if head is None:
        head = pack_head(prototypes, last_layer, spec, group_projection,
                         last_layer_group)
    t = spec_tensors(spec, features.device)
    c = spec.num_classes
    kw = head.groups or c                # head weights per prototype
    threads = _threads(c * head.groups + c if head.groups else c,
                       _CHUNK * (_DEPTH + 2 + kw))
    n = b * h * w
    out = torch.empty((n, c), dtype=torch.float32, device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    status = _launcher()(
        features.data_ptr(), head.protos.data_ptr(), head.pnorm.data_ptr(),
        t["bounds"].data_ptr(), t["cls"].data_ptr(),
        head.head_w.data_ptr(), head.glw.data_ptr(), out.data_ptr(),
        n, spec.num_scales, c, head.groups, EPSILON, threads, stream)
    check(library("proto"), status, "proto_forward")
    fused_proto_logits.launches += 1
    return out.reshape(b, h, w, c)


fused_proto_logits.launches = 0
