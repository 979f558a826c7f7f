"""K1: the multi-scale prototype head as one CUDA kernel (``csrc/proto.cu``).

Replaces ``scaleprotoseg_tpu/ops/pallas_proto.py::fused_proto_logits``:
per pixel and scale, ``d = relu(|x_s|^2 - 2 x_s.p + |p|^2)`` against that
scale's prototypes, ``act = log((d + 1) / (d + 1e-4))``, then either the
group head ``exp(act @ Gw) @ Glw`` (rows of empty classes zeroed) or the
plain head ``act @ W[:A]``; fp32-accurate throughout, no TF32.

Bound on the H100: bytes (~39 MB moved at the flagship's 66306 pixels),
once the cross term runs on the tensor cores as three bf16 products: each
fp32 prototype is split here into bf16 pieces hi + mid + lo that hold its
24 mantissa bits, and the kernel sums ``x_s . (hi + mid + lo)`` in fp32
with ``wgmma``.  The TPU kernel packed the bank block-diagonally to give
the MXU one big matmul; that would quadruple the work, so a 64-pixel tile
meets each scale's own prototypes only.  ``pack_head`` builds, once per
set of weights, everything the kernel walks: the split bank in chunks of
64 prototypes (class-sorted within a scale, zero-padded), their |p|^2, the
per-prototype head tables, and the step table (pass, scale, chunk) that
the producer and the consumers follow alike.  A head wider than 64 scores
runs in passes over class windows (group head) or output-column windows
(plain head).

``fused_proto_logits`` runs the registered op
``scaleprotoseg::fused_proto_logits``: the kernel for a CUDA tensor,
``proto_plain`` for a CPU tensor.  The kernel reads bf16 features, the
add-on output of the bf16 fast path.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from scaleprotoseg_torch.kernels._build import check, library
from scaleprotoseg_torch.ops.prototype import (EPSILON,
                                               distance_to_similarity,
                                               scale_l2_distances)
from scaleprotoseg_torch.spec import ProtoSpec

_DEPTH = 64                   # the kernel's compiled per-scale depth
_CHUNK = 64                   # prototypes per bank chunk (CHUNK)


def spec_tensors(spec: ProtoSpec, device: torch.device) -> dict:
    """Device copies of the spec's static index tables, made once per
    (spec, device) so the forward makes no host-to-device copies.  While
    ``torch.export`` traces they are made anew and not kept: a table made
    then is a fake tensor (the trace lifts it as a constant)."""
    if torch.compiler.is_exporting():
        return _spec_tensors.__wrapped__(spec, device)
    return _spec_tensors(spec, device)


@lru_cache(maxsize=64)
@torch.inference_mode(False)
def _spec_tensors(spec: ProtoSpec, device: torch.device) -> dict:
    # never inference tensors: a table first made while serving is kept
    # for the training steps on the same spec, which save it for backward
    idx = spec.class_proto_index
    c_of, q_of = np.nonzero(idx >= 0)
    as_t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=device)  # noqa: E731
    return {
        "onehot": as_t(spec.class_proto_onehot, torch.float32),
        "has": as_t(spec.class_has_protos, torch.float32),
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
    w_full = torch.einsum("cgq,cqp->cgp", group_projection.to(act.dtype),
                          t["onehot"].to(act.dtype))
    scores = torch.einsum("...p,cgp->...cg", act, w_full)
    return torch.exp(scores) * t["has"].to(act.dtype)[:, None]


def proto_plain(features: torch.Tensor, prototypes: torch.Tensor,
                last_layer: Optional[torch.Tensor], spec: ProtoSpec,
                group_projection: Optional[torch.Tensor] = None,
                last_layer_group: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (float32, the features
    upcast exactly, as the kernel reads them)."""
    d = scale_l2_distances(features.float(), prototypes, spec.scale_bounds)
    act = distance_to_similarity(d)
    if group_projection is not None:
        group = group_activations(act, group_projection, spec)
        return group.flatten(-2) @ last_layer_group.float()
    return act @ last_layer[:spec.num_active_prototypes].float()


def proto_float64(features: torch.Tensor, prototypes: torch.Tensor,
                  last_layer: Optional[torch.Tensor], spec: ProtoSpec,
                  group_projection: Optional[torch.Tensor] = None,
                  last_layer_group: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The same function and formula in float64: the yardstick for the
    fp32 rounding of the kernel and of ``proto_plain``.  At a pushed
    prototype (d ~ 0) the activation's slope, -1e4, magnifies that
    rounding, and only a wider type shows which of the two is nearer."""
    d = distances_float64(features, prototypes, spec)
    act = torch.log((d + 1.0) / (d + EPSILON))
    if group_projection is not None:
        group = group_activations(act, group_projection, spec)
        return group.flatten(-2) @ last_layer_group.double()
    return act @ last_layer[:spec.num_active_prototypes].double()


def distances_float64(features: torch.Tensor, prototypes: torch.Tensor,
                      spec: ProtoSpec) -> torch.Tensor:
    """(..., S*D) features -> (..., A) relu(|x_s|^2 - 2 x_s.p + |p|^2)
    per scale, in float64."""
    x, p = features.double(), prototypes.double()
    depth = spec.proto_depth
    out = []
    for s, (lo, hi) in enumerate(spec.scale_bounds):
        xs = x[..., s * depth:(s + 1) * depth]
        ps = p[lo:hi]
        out.append(torch.relu((xs * xs).sum(-1, keepdim=True)
                              - 2.0 * (xs @ ps.t()) + (ps * ps).sum(-1)))
    return torch.cat(out, -1)


def distance_error(act: torch.Tensor, features: torch.Tensor,
                   prototypes: torch.Tensor, spec: ProtoSpec) -> float:
    """The largest error of the distances behind activations ``act``
    (..., A) (e.g. the kernel's logits under an identity plain head),
    against float64 distances, in units of fp32 rounding of the
    distance's terms: |d - d64| / (2^-24 (|x_s| + |p|)^2).  ``d`` is
    recovered from ``act`` in float64 (the activation is monotone), so
    this reads the cross term's accuracy without the head's rounding or
    the activation's slope in the way."""
    q = torch.exp(act.double())
    d = (1.0 - EPSILON * q) / (q - 1.0)
    x, p = features.double(), prototypes.double()
    depth = spec.proto_depth
    scale = torch.cat([
        (x[..., s * depth:(s + 1) * depth].norm(dim=-1, keepdim=True)
         + p[lo:hi].norm(dim=-1)) ** 2
        for s, (lo, hi) in enumerate(spec.scale_bounds)], -1)
    err = (d - distances_float64(features, prototypes, spec)).abs()
    return float((err / (2.0 ** -24 * scale)).max())


class ProtoHead(NamedTuple):
    """The head's weights in the form the kernel reads, derived from the
    model's parameters by ``pack_head``.  The kernel's fields (``bank`` on)
    are None where the prototype depth is not the kernel's."""
    protos: torch.Tensor     # (A, D) float32, active prototypes
    pnorm: torch.Tensor      # (A,) |p|^2
    head_w: torch.Tensor     # (A, G) per-prototype group weights | (A, C)
    glw: torch.Tensor        # (C*G, C), rows of empty classes zeroed
    groups: int              # G, 0 for the plain head
    bank: Optional[torch.Tensor] = None     # (K*192, 64) bf16 hi/mid/lo
    columns: Optional[torch.Tensor] = None  # (K, 64) prototype, -1 pad
    chunk_pn: Optional[torch.Tensor] = None  # (K, 64) |p|^2, 0 pad
    steps: Optional[torch.Tensor] = None    # (n_steps, 8) int32
    table: Optional[torch.Tensor] = None    # entries (E, 8) | (blocks, 64, 2, 32)
    glw_pad: Optional[torch.Tensor] = None  # (C*G, cp4) group last layer


# step flags and table layout, as csrc/proto.cu reads them
NEW_X, FREE_X, OPEN, CLOSE, WRITE = 1, 2, 4, 8, 16
_SCORE_ROWS = 64          # scores per pixel in one pass (SCORE_ROWS)
_MAX_G = 4
_META_FLUSH = 64


def split_bf16(p: torch.Tensor) -> torch.Tensor:
    """(..., D) float32 -> (3, ..., D) bf16 pieces hi, mid, lo with
    hi + mid + lo == p: each piece is the round-to-nearest bf16 of what
    the pieces before it left, and three 8-bit significands cover fp32's
    24."""
    hi = p.to(torch.bfloat16)
    rest = p - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def _passes(spec: ProtoSpec, groups: int) -> list:
    """[(first score row / output column, scores / outputs, prototypes
    per scale)] in walk order.  Group head: windows of 64 // G classes,
    each scale's prototypes of the window sorted by class; plain head:
    windows of 64 output columns over every active prototype."""
    cls = np.asarray(spec.class_ids)
    c = spec.num_classes
    out = []
    if groups:
        per = _SCORE_ROWS // groups
        for c0 in range(0, c, per):
            c1 = min(c, c0 + per)
            cols = [sorted((p for p in range(lo, hi) if c0 <= cls[p] < c1),
                           key=lambda p: (cls[p], p))
                    for lo, hi in spec.scale_bounds]
            if any(cols):
                out.append((c0 * groups, (c1 - c0) * groups, cols))
    else:
        cols = [list(range(lo, hi)) for lo, hi in spec.scale_bounds]
        for k0 in range(0, c, _SCORE_ROWS):
            out.append((k0, min(_SCORE_ROWS, c - k0), cols))
    return out


def _split_at_class(cls_run: np.ndarray) -> int:
    """The class boundary of a class-sorted run nearest its middle: the
    two walking threads of a pixel take one side each, and never add into
    the same class's scores."""
    n = len(cls_run)
    cuts = [0] + [i for i in range(1, n) if cls_run[i] != cls_run[i - 1]] \
        + [n]
    return min(cuts, key=lambda b: (abs(2 * b - n), b))


def _kernel_tables(spec: ProtoSpec, protos: np.ndarray, pnorm: np.ndarray,
                   head_w: np.ndarray, glw: np.ndarray, groups: int) -> dict:
    """The kernel's chunks, step table and head tables (numpy)."""
    cls = np.asarray(spec.class_ids)
    c = spec.num_classes
    passes = _passes(spec, groups)
    chunks, steps, entries, blocks = [], [], [], []
    plain_chunks = None
    for pi, (win0, wins, per_scale) in enumerate(passes):
        pass_steps = []
        if not groups and plain_chunks is None:
            plain_chunks = []
            for cols in per_scale:
                ids = []
                for i in range(0, len(cols), _CHUNK):
                    ids.append(len(chunks))
                    chunks.append(cols[i:i + _CHUNK])
                plain_chunks.append(ids)
        for s, cols in enumerate(per_scale):
            if groups:
                ids = []
                for i in range(0, len(cols), _CHUNK):
                    ids.append(len(chunks))
                    chunks.append(cols[i:i + _CHUNK])
            else:
                ids = plain_chunks[s]
            for qi, q in enumerate(ids):
                flags = (NEW_X if qi == 0 else 0) | \
                    (FREE_X if qi == len(ids) - 1 else 0)
                run = chunks[q]
                if groups:
                    e0 = len(entries)
                    run_cls = cls[run]
                    b = _split_at_class(run_cls)
                    for j, p in enumerate(run):
                        flush = j == len(run) - 1 or run_cls[j + 1] != \
                            run_cls[j]
                        meta = j | (_META_FLUSH if flush else 0) | \
                            (((run_cls[j] * groups) - win0) << 8)
                        w = np.zeros(8, np.float32)
                        w[:groups] = head_w[p]
                        w[4] = np.array(meta, np.int32).view(np.float32)
                        entries.append(w)
                    a = (s, q, e0, e0 + b)
                    f = (e0 + len(run), flags, win0, wins)
                else:
                    kb = (wins + 1) // 2
                    blk = np.zeros((_CHUNK, 2, 32), np.float32)
                    for j, p in enumerate(run):
                        blk[j, 0, :kb] = head_w[p, win0:win0 + kb]
                        blk[j, 1, :wins - kb] = \
                            head_w[p, win0 + kb:win0 + wins]
                    a = (s, q, len(blocks), len(run))
                    blocks.append(blk)
                    f = (0, flags, win0, wins)
                pass_steps.append([*a, *f])
        pass_steps[0][5] |= OPEN
        pass_steps[-1][5] |= CLOSE | (WRITE if pi == 0 else 0)
        steps += pass_steps
    k = len(chunks)
    columns = np.full((k, _CHUNK), -1, np.int64)
    for q, run in enumerate(chunks):
        columns[q, :len(run)] = run
    valid = columns >= 0
    chunk_pn = np.where(valid, pnorm[np.maximum(columns, 0)], 0) \
        .astype(np.float32)
    bank = np.where(valid[..., None], protos[np.maximum(columns, 0)], 0) \
        .astype(np.float32)
    if groups:
        table = np.stack(entries)
        cp4 = -(-c // 4) * 4
        glw_pad = np.zeros((glw.shape[0], cp4), np.float32)
        glw_pad[:, :c] = glw
    else:
        table = np.stack(blocks)
        glw_pad = np.zeros((1, 4), np.float32)
    return dict(bank=bank, columns=columns, chunk_pn=chunk_pn,
                steps=np.asarray(steps, np.int32), table=table,
                glw_pad=glw_pad)


def pack_head(prototypes: torch.Tensor, last_layer: Optional[torch.Tensor],
              spec: ProtoSpec, group_projection: Optional[torch.Tensor] = None,
              last_layer_group: Optional[torch.Tensor] = None) -> ProtoHead:
    """The kernel's view of the head weights (the counterpart of the JAX
    package's ``pack_prototype_bank``).  A model packs once per set of
    weights and hands the result to every call as ``head``."""
    t = spec_tensors(spec, prototypes.device)
    a = spec.num_active_prototypes
    dev = prototypes.device
    protos = prototypes[:a].float().contiguous()
    pnorm = (protos * protos).sum(-1)
    if group_projection is None:
        head_w = last_layer[:a].float().contiguous()
        glw, g = head_w, 0
    else:
        g = spec.num_groups
        head_w = torch.zeros((a, g), dtype=torch.float32, device=dev)
        head_w[t["member_p"]] = group_projection.float()[
            t["member_c"], :, t["member_q"]]
        rows_has = t["has"].repeat_interleave(g)[:, None]
        glw = (last_layer_group.float() * rows_has).contiguous()
    head = ProtoHead(protos, pnorm, head_w, glw, g)
    if spec.proto_depth != _DEPTH or g > _MAX_G or a == 0:
        return head
    host = lambda v: v.detach().cpu().numpy()  # noqa: E731
    tab = _kernel_tables(spec, host(protos), host(pnorm), host(head_w),
                         host(glw), g)
    pieces = split_bf16(torch.from_numpy(tab.pop("bank")))  # (3, K, 64, D)
    bank = pieces.transpose(0, 1).reshape(-1, _DEPTH)       # chunk-major
    to_dev = lambda v: torch.as_tensor(v, device=dev)  # noqa: E731
    return head._replace(bank=bank.to(dev).contiguous(),
                         **{k: to_dev(v).contiguous() for k, v in tab.items()})


@lru_cache(maxsize=None)
def _launcher():
    fn = library("proto").proto_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_proto_logits(features: torch.Tensor, prototypes: torch.Tensor,
                       last_layer: Optional[torch.Tensor], spec: ProtoSpec,
                       group_projection: Optional[torch.Tensor] = None,
                       last_layer_group: Optional[torch.Tensor] = None,
                       head: Optional[ProtoHead] = None) -> torch.Tensor:
    """(B, H, W, S*D) post-add-on features -> (B, H, W, C) float32 logits.

    Plain head: ``last_layer`` (P, C).  Group head: ``group_projection``
    (C, G, Pc_max) and ``last_layer_group`` (C*G, C).  ``head``: these
    weights already packed by ``pack_head`` (only its kernel tables are
    read); for a CUDA tensor without it they are packed anew.  Runs the
    registered op ``scaleprotoseg::fused_proto_logits``, which takes the
    dense weights (its CPU implementation, ``proto_plain``, reads them),
    the kernel's tables and the spec's fields one by one.  The kernel
    takes bf16 features."""
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_proto_logits: unsupported device "
                         f"{features.device}")
    if head is None and features.device.type == "cuda":
        head = pack_head(prototypes, last_layer, spec, group_projection,
                         last_layer_group)
    tables = [getattr(head, k) if head is not None else None
              for k in KERNEL_TABLES]
    return _proto_op(features, prototypes, last_layer, group_projection,
                     last_layer_group, *tables, spec.num_classes,
                     spec.proto_depth, spec.num_groups, list(spec.class_ids),
                     [i for b in spec.scale_bounds for i in b])


fused_proto_logits.launches = 0

# the ProtoHead fields the kernel reads, in the op's order
KERNEL_TABLES = ("bank", "steps", "chunk_pn", "table", "glw_pad")


@lru_cache(maxsize=64)
def _spec(num_classes: int, proto_depth: int, num_groups: int,
          class_ids: tuple, bounds: tuple) -> ProtoSpec:
    return ProtoSpec(num_classes=num_classes, num_scales=len(bounds) // 2,
                     proto_depth=proto_depth, class_ids=class_ids,
                     scale_bounds=tuple(zip(bounds[::2], bounds[1::2])),
                     num_groups=num_groups)


@torch.library.custom_op("scaleprotoseg::fused_proto_logits",
                         mutates_args=(), device_types="cpu")
def _proto_op(features: torch.Tensor, prototypes: torch.Tensor,
              last_layer: Optional[torch.Tensor],
              group_projection: Optional[torch.Tensor],
              last_layer_group: Optional[torch.Tensor],
              bank: Optional[torch.Tensor], steps: Optional[torch.Tensor],
              chunk_pn: Optional[torch.Tensor], table: Optional[torch.Tensor],
              glw_pad: Optional[torch.Tensor], num_classes: int,
              proto_depth: int, num_groups: int, class_ids: List[int],
              scale_bounds: List[int]) -> torch.Tensor:
    """K1 as one graph node; on the CPU its plain version from the dense
    weights (the tables unused)."""
    spec = _spec(num_classes, proto_depth, num_groups, tuple(class_ids),
                 tuple(scale_bounds))
    return proto_plain(features, prototypes, last_layer, spec,
                       group_projection, last_layer_group)


@_proto_op.register_kernel("cuda")
def _proto_cuda(features, prototypes, last_layer, group_projection,
                last_layer_group, bank, steps, chunk_pn, table, glw_pad,
                num_classes, proto_depth, num_groups, class_ids,
                scale_bounds):
    b, h, w, cf = features.shape
    num_scales = len(scale_bounds) // 2
    if cf != num_scales * proto_depth or proto_depth != _DEPTH:
        raise ValueError(f"fused_proto_logits: the kernel takes "
                         f"{num_scales} x {_DEPTH} features, got {cf} "
                         f"channels at depth {proto_depth}")
    if features.dtype != torch.bfloat16 or not features.is_contiguous():
        raise ValueError("fused_proto_logits: features must be contiguous "
                         f"bf16, got {features.dtype}")
    if bank is None:
        raise ValueError(f"fused_proto_logits: the kernel takes at most "
                         f"{_MAX_G} groups and at least one prototype")
    if features.data_ptr() % 16:
        raise ValueError("fused_proto_logits: features must be 16-byte "
                         "aligned")
    groups = num_groups if group_projection is not None else 0
    n = b * h * w
    out = torch.empty((n, num_classes), dtype=torch.float32,
                      device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    status = _launcher()(
        features.data_ptr(), bank.data_ptr(), steps.data_ptr(),
        chunk_pn.data_ptr(), table.data_ptr(), glw_pad.data_ptr(),
        out.data_ptr(), n, num_scales, steps.shape[0],
        bank.shape[0] // (3 * _CHUNK), num_classes, groups, glw_pad.shape[1],
        EPSILON, stream)
    check(library("proto"), status, "proto_forward")
    fused_proto_logits.launches += 1
    return out.reshape(b, h, w, num_classes)


@_proto_op.register_fake
def _proto_fake(features, prototypes, last_layer, group_projection,
                last_layer_group, bank, steps, chunk_pn, table, glw_pad,
                num_classes, proto_depth, num_groups, class_ids,
                scale_bounds):
    return features.new_empty((*features.shape[:-1], num_classes),
                              dtype=torch.float32)
