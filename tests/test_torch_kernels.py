"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (a CPU tensor never
launches a kernel), and the Pallas kernels run in interpret mode, as the
JAX package's own tests run them.  Tolerances:

- K1 prototype head: rtol = atol = 2e-4 (``tests/test_pallas_proto.py``'s);
- K2 ASPP: at most 2 bf16 ulps (both sides accumulate in fp32 in another
  order, then round to bf16);
- K3 upsample + argmax: labels equal wherever the top-two margin is at
  least 1e-5.

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scaleprotoseg_tpu.ops.pallas_aspp import _xla_shifted_aspp, fused_aspp
from scaleprotoseg_tpu.ops.pallas_proto import fused_proto_logits
from scaleprotoseg_tpu.ops.pallas_upsample import fused_upsample_argmax
from scaleprotoseg_tpu.ops.resize import (_bilinear_matrix,
                                          resize_bilinear_matrix)
from scaleprotoseg_tpu.spec import ProtoSpec
from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.kernels import _build
from scaleprotoseg_torch.kernels import aspp as taspp
from scaleprotoseg_torch.kernels import proto as tproto
from scaleprotoseg_torch.kernels import upsample as tup
from scaleprotoseg_torch.kernels.proto import pack_head, proto_plain
from scaleprotoseg_torch.models import deeplab as tdeeplab
from scaleprotoseg_torch.ops.prototype import (distance_to_similarity,
                                               scale_l2_distances)
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import emulate_proto_kernel as _emulate_proto_kernel
from torch_parity import labels_equal_outside_ties, port_spec


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in bf16 ulps of |want|; values below 2^-10 of
    the largest output are measured in the ulp at that floor."""
    mag = np.maximum(np.abs(want), np.abs(want).max() * 2.0 ** -10)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(got - want) / ulp).max())


# ---------------------------------------------------------------------------
# K1: prototype head
# ---------------------------------------------------------------------------
def _proto_problem(rng, grouped, spec, n_hw=(9, 9)):
    feats = rng.random((2, *n_hw, spec.feature_depth)).astype(np.float32)
    protos = rng.random((spec.num_prototypes, spec.proto_depth)) \
        .astype(np.float32)
    if grouped:
        mask = (spec.class_proto_index >= 0).astype(np.float32)
        gw = (rng.random((spec.num_classes, spec.num_groups,
                          spec.max_protos_per_class)) * mask[:, None, :]) \
            .astype(np.float32)
        glw = (rng.standard_normal((spec.num_classes * spec.num_groups,
                                    spec.num_classes)) * 0.1) \
            .astype(np.float32)
        return feats, protos, dict(group_projection=gw, last_layer_group=glw)
    w = rng.standard_normal((spec.num_prototypes, spec.num_classes)) \
        .astype(np.float32)
    return feats, protos, dict(last_layer=w)


def _proto_pair(feats, protos, spec, weights):
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    want = np.asarray(fused_proto_logits(
        jnp.asarray(feats), jnp.asarray(protos), jw.pop("last_layer", None),
        spec, interpret=True, tile_n=128, **jw))
    tw = {k: torch.from_numpy(v) for k, v in weights.items()}
    got = kernels.fused_proto_logits(
        torch.from_numpy(feats), torch.from_numpy(protos),
        tw.pop("last_layer", None), port_spec(spec), **tw).numpy()
    return got, want


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
@pytest.mark.parametrize("case", ["flagship_bank", "ragged_pixels",
                                  "empty_class"])
def test_proto_head_matches_pallas(rng, grouped, case):
    n_hw = (9, 9)
    if case == "flagship_bank":
        spec = ProtoSpec.equal_allocation(228, 16, num_classes=19,
                                          num_groups=3 if grouped else 0)
    else:
        spec = ProtoSpec.equal_allocation(24, 8, num_classes=3,
                                          num_groups=3 if grouped else 0)
    if case == "ragged_pixels":
        n_hw = (7, 5)            # 70 pixels: not a multiple of the tile
    if case == "empty_class":   # prune every prototype of class 1
        spec = spec.prune([p for p, c in enumerate(spec.class_ids) if c == 1])
        assert spec.class_counts[1] == 0
    feats, protos, weights = _proto_problem(rng, grouped, spec, n_hw)
    before = kernels.launch_counts()
    got, want = _proto_pair(feats, protos, spec, weights)
    assert kernels.launch_counts() == before
    assert got.shape == want.shape == (2, *n_hw, spec.num_classes)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _logits_from_packed(feats, head, spec):
    """The kernel's arithmetic in torch, from the packed head alone: each
    prototype's act * head_w[p] into its class's G scores, then exp and
    the group last layer (zero rows for empty classes)."""
    d = scale_l2_distances(feats, head.protos, spec.scale_bounds)
    act = distance_to_similarity(d)
    if not head.groups:
        return act @ head.head_w
    cls = torch.as_tensor(spec.class_ids[:spec.num_active_prototypes])
    onehot = torch.nn.functional.one_hot(cls.clamp(min=0),
                                         spec.num_classes).float()
    onehot *= (cls >= 0).float()[:, None]
    scores = torch.einsum("...p,pc,pg->...cg", act, onehot, head.head_w)
    return torch.exp(scores).flatten(-2) @ head.glw


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
@pytest.mark.parametrize("case", ["flagship_bank", "empty_class"])
def test_pack_head_carries_the_head(rng, grouped, case):
    """What K1 reads (``pack_head``) computes the plain head's logits."""
    spec = ProtoSpec.equal_allocation(228, 16, num_classes=19,
                                      num_groups=3 if grouped else 0)
    if case == "empty_class":
        spec = spec.prune([p for p, c in enumerate(spec.class_ids) if c == 4])
    tspec = port_spec(spec)
    feats, protos, weights = _proto_problem(rng, grouped, spec, (5, 7))
    tw = {k: torch.from_numpy(v) for k, v in weights.items()}
    last = tw.pop("last_layer", None)
    feats, protos = torch.from_numpy(feats), torch.from_numpy(protos)
    head = pack_head(protos, last, tspec, **tw)
    assert head.groups == (3 if grouped else 0)
    got = _logits_from_packed(feats, head, tspec)
    want = proto_plain(feats, protos, last, tspec, **tw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _kernel_bank(case, grouped):
    """Banks at the kernel's depth 64: the flagship's, the flagship's with
    prototypes pruned from every scale (uneven scale sizes, class 4
    empty), and COCO-Stuff's two banks over its 182 classes: the group
    config's 2054 (2052 active, two dangling rows), whose group head needs
    several passes over class windows and whose bank (36 chunks, ~860 KB
    split) streams through shared memory (the plain head: passes over
    output-column windows), and the prototype phase's 2184."""
    g = 3 if grouped else 0
    if case == "large_bank":
        return ProtoSpec.equal_allocation(2054, 64, num_classes=182,
                                          num_groups=g)
    if case == "coco_2184_bank":
        return ProtoSpec.equal_allocation(2184, 64, num_classes=182,
                                          num_groups=g)
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19, num_groups=g)
    if case == "pruned_bank":
        spec = spec.prune([3, 60, 61, 130] + [
            p for p, c in enumerate(spec.class_ids) if c == 4])
    return spec


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
@pytest.mark.parametrize("case", ["flagship_bank", "pruned_bank",
                                  "large_bank", "coco_2184_bank"])
def test_pack_head_splits_the_bank_exactly(rng, grouped, case):
    """K1's split bank: three bf16 pieces per prototype that sum back to
    the fp32 prototype (within 2^-24 relative), |p|^2 beside each column,
    and every prototype the head reads in exactly one column per pass."""
    spec = _kernel_bank(case, grouped)
    tspec = port_spec(spec)
    _, protos, weights = _proto_problem(rng, grouped, spec, (1, 1))
    tw = {k: torch.from_numpy(v) for k, v in weights.items()}
    head = pack_head(torch.from_numpy(protos), tw.pop("last_layer", None),
                     tspec, **tw)
    assert head.bank.dtype == torch.bfloat16
    k = head.columns.shape[0]
    assert head.bank.shape == (k * 3 * 64, 64)
    cols = head.columns.numpy()
    valid = cols >= 0
    summed = head.bank.double().reshape(k, 3, 64, 64).sum(1).numpy()
    want = np.where(valid[..., None], protos[np.maximum(cols, 0)], 0.0)
    np.testing.assert_allclose(summed, want, rtol=2.0 ** -24, atol=0)
    np.testing.assert_allclose(
        head.chunk_pn.numpy(),
        np.where(valid, (protos.astype(np.float64) ** 2).sum(-1)[
            np.maximum(cols, 0)], 0.0), rtol=1e-6)
    steps = head.steps.numpy()
    passes = np.cumsum(steps[:, 5] & tproto.OPEN > 0)
    a = tspec.num_active_prototypes
    reads = [p for p in range(a) if tspec.class_ids[p] >= 0 or not grouped]
    for pi in np.unique(passes):
        seen = np.concatenate([cols[q][cols[q] >= 0]
                               for q in steps[passes == pi, 1]])
        assert len(seen) == len(set(seen.tolist()))
        if not grouped:
            assert sorted(seen.tolist()) == reads
    if grouped:
        seen = np.concatenate([cols[q][cols[q] >= 0] for q in steps[:, 1]])
        assert sorted(seen.tolist()) == reads


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
@pytest.mark.parametrize("case", ["flagship_bank", "pruned_bank",
                                  "large_bank", "coco_2184_bank"])
def test_split_cross_term_matches_pallas(rng, grouped, case):
    """The split-bank cross term pushed through K1's formula and tables
    (``_emulate_proto_kernel``) against the JAX package's Pallas kernel
    in interpret mode, rtol = atol = 1e-4 (the card's tolerance)."""
    spec = _kernel_bank(case, grouped)
    tspec = port_spec(spec)
    feats, protos, weights = _proto_problem(rng, grouped, spec, (3, 5))
    feats = feats.astype(jnp.bfloat16).astype(np.float32)   # bf16 input
    _, want = _proto_pair(feats, protos, spec, weights)
    tw = {k: torch.from_numpy(v) for k, v in weights.items()}
    head = pack_head(torch.from_numpy(protos), tw.pop("last_layer", None),
                     tspec, **tw)
    got = _emulate_proto_kernel(torch.from_numpy(feats), head, tspec)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
def test_proto_float64_matches_pallas(rng, grouped):
    """The float64 head, the yardstick of K1's rounding, computes the
    Pallas kernel's function (interpret mode)."""
    spec = _kernel_bank("pruned_bank", grouped)
    feats, protos, weights = _proto_problem(rng, grouped, spec, (3, 5))
    _, want = _proto_pair(feats, protos, spec, weights)
    tw = {k: torch.from_numpy(v) for k, v in weights.items()}
    got = tproto.proto_float64(torch.from_numpy(feats),
                               torch.from_numpy(protos),
                               tw.pop("last_layer", None), port_spec(spec),
                               **tw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_distance_error_tells_two_bf16_pieces_from_three(rng):
    """On the sparse probe (features and prototypes non-zero on four
    coordinates a scale, under an identity plain head) the split cross
    term with three pieces reads within fp32 rounding of the float64
    distances, and one that leaves the lo piece out reads far off: the
    probe that holds the kernel's precision on the card."""
    a = 228
    spec = port_spec(ProtoSpec.equal_allocation(a, 64, num_classes=a))
    x = np.zeros((1, 24, 25, 4, 64), np.float32)
    x[..., :4] = 0.5 + 0.5 * rng.random((1, 24, 25, 4, 4))
    feats = torch.from_numpy(x.reshape(1, 24, 25, 256)).bfloat16().float()
    p = np.zeros((a, 64), np.float32)
    p[:, :4] = 0.5 + 0.5 * rng.random((a, 4))
    protos = torch.from_numpy(p)
    head = pack_head(protos, torch.eye(a), spec)
    three, two = (tproto.distance_error(
        _emulate_proto_kernel(feats, head, spec, pieces), feats, protos,
        spec) for pieces in (3, 2))
    assert three <= 2.0 and two >= 16.0, (three, two)


# ---------------------------------------------------------------------------
# K2: ASPP
# ---------------------------------------------------------------------------
def _aspp_problem(rng, c, f, hw=(11, 13), n_rates=4):
    x = rng.standard_normal((1, *hw, c)).astype(np.float32)
    weights = [(rng.standard_normal((3, 3, c, f)) * 0.02).astype(np.float32)
               for _ in range(n_rates)]
    biases = [rng.standard_normal((f,)).astype(np.float32)
              for _ in range(n_rates)]
    return x, weights, biases


def test_aspp_matches_pallas_at_kernel_depth(rng):
    rates = (6, 12, 18, 24)
    x, weights, biases = _aspp_problem(rng, 512, 64)
    want = np.asarray(fused_aspp(
        jnp.asarray(x, jnp.bfloat16), [jnp.asarray(w) for w in weights],
        [jnp.asarray(b) for b in biases], rates=rates,
        interpret=True)).astype(np.float32)
    got = kernels.fused_aspp(
        torch.from_numpy(x).to(torch.bfloat16),
        [torch.from_numpy(w) for w in weights],
        [torch.from_numpy(b) for b in biases], rates).float().numpy()
    assert got.shape == want.shape == (1, 11, 13, 256)
    assert bf16_ulps(got, want) <= 2


@pytest.mark.parametrize("c,expect_kernel", [(256, False), (512, True)])
def test_aspp_module_dispatch(rng, monkeypatch, c, expect_kernel):
    """fast + bf16 takes the K2 wrapper from C = 512 up and the
    shifted-matmul form below (both inside ``aspp_trainable``); both keep
    the bf16 contract of ``_xla_shifted_aspp`` and hand float32 on."""
    rates = (2, 4, 6, 8)
    x, weights, biases = _aspp_problem(rng, c, 16, hw=(9, 10))
    calls = []
    real = taspp.fused_aspp
    monkeypatch.setattr(taspp, "fused_aspp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    module = tdeeplab.ASPP(c, 16, rates, "concat", fast=True)
    with torch.no_grad():
        for i, (w, b) in enumerate(zip(weights, biases)):
            branch = getattr(module, f"c{i}")
            branch.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
            branch.bias.copy_(torch.from_numpy(b))
        xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
        got = module(xt).permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float32
    assert bool(calls) == expect_kernel
    want = np.asarray(_xla_shifted_aspp(
        jnp.asarray(x, jnp.bfloat16), [jnp.asarray(w) for w in weights],
        [jnp.asarray(b) for b in biases], rates)).astype(np.float32)
    assert bf16_ulps(got, want) <= 2


def test_aspp_module_packs_its_weights_once(rng, monkeypatch):
    """The K2 branch packs the weight stack on first use and again only
    after a weight changes."""
    rates = (2, 4, 6, 8)
    packs = []
    real = tdeeplab.pack_weights
    monkeypatch.setattr(tdeeplab, "pack_weights",
                        lambda *a: packs.append(1) or real(*a))
    module = tdeeplab.ASPP(512, 16, rates, "concat", fast=True)
    x = torch.from_numpy(rng.standard_normal((1, 512, 9, 10))
                         .astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        first = module(x)
        module(x)
        assert len(packs) == 1
    with torch.no_grad():
        module.c2.bias.add_(1.0)
    with torch.inference_mode():
        second = module(x)
    assert len(packs) == 2
    assert not torch.equal(first, second)


@pytest.mark.parametrize("c,f,n_rates", [(128, 64, 3), (64, 128, 4),
                                         (512, 64, 1)])
def test_pack_weights_is_k_major_and_round_trips(rng, c, f, n_rates):
    """The kernel's weight stack is (R, 9, F, C), input channels contiguous
    (the K-major operand ``wgmma`` reads), tap 3 * ky + kx; transposed back
    it is the per-rate (3, 3, C, F) weights rounded to bf16, and the bias
    is the per-rate biases in rate order."""
    _, weights, biases = _aspp_problem(rng, c, f, n_rates=n_rates)
    tw = [torch.from_numpy(w) for w in weights]
    wstack, bias = taspp.pack_weights(tw, [torch.from_numpy(b)
                                           for b in biases])
    assert wstack.shape == (n_rates, 9, f, c) and wstack.dtype == torch.bfloat16
    assert wstack.is_contiguous() and bias.dtype == torch.float32
    for ri, w in enumerate(tw):
        back = wstack[ri].transpose(1, 2).reshape(3, 3, c, f)
        assert torch.equal(back, w.to(torch.bfloat16))
        assert torch.equal(wstack[ri, 5, 7], w[1, 2, :, 7].to(torch.bfloat16))
    np.testing.assert_array_equal(bias.numpy(), np.concatenate(biases))


def _source_constant(name, source="aspp"):
    """``constexpr int <name> = <value>;`` of ``csrc/<source>.cu``."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _aspp_item(item, n_tiles, n_rates, npx, npy, ph, pw, bn):
    """``csrc/aspp.cu::decode_item``: block index -> (batch, y0, x0, rate
    index, n0), rate and output-channel tile fastest."""
    p, q = divmod(item, n_rates * n_tiles)
    ri, tile = divmod(q, n_tiles)
    p, px = divmod(p, npx)
    bi, py = divmod(p, npy)
    return bi, py * ph, px * pw, ri, tile * bn


@pytest.mark.parametrize("b,h,w,f,n_rates", [
    (2, 129, 257, 64, 4),       # serving and evaluation
    (2, 65, 65, 64, 4),         # training and validation
    (1, 21, 37, 64, 4),         # no multiple of the patch
    (1, 3, 5, 128, 1),          # smaller than a patch, two channel tiles
    (2, 33, 16, 64, 3),         # one row past a patch edge
    (1, 32, 9, 192, 2),         # one column past a patch edge
    (3, 32, 8, 64, 1),          # exactly one patch an image
    (1, 1, 1, 64, 2),           # one pixel
    (2, 31, 7, 128, 4),         # one short of a patch both ways
    (1, 64, 17, 256, 3),        # two patch rows, four channel tiles
])
def test_aspp_tile_plan_covers_every_output_once(b, h, w, f, n_rates):
    """The kernel's grid (its launcher's item count, each block decoded as
    ``decode_item`` does, with the patch and tile sizes read from the
    source), clipped to the image as the epilogue clips it, writes every
    (batch, y, x, rate, channel) exactly once."""
    ph, pw, bn = (_source_constant(n) for n in ("PH", "PW", "BN"))
    npy, npx, n_tiles = -(-h // ph), -(-w // pw), f // bn
    items = [_aspp_item(i, n_tiles, n_rates, npx, npy, ph, pw, bn)
             for i in range(b * npy * npx * n_rates * n_tiles)]
    seen = np.zeros((b, h, w, n_rates, f), np.int32)
    for bi, y0, x0, ri, n0 in items:
        seen[bi, y0:y0 + ph, x0:x0 + pw, ri, n0:n0 + bn] += 1
    assert (seen == 1).all()
    # rate and channel tile run fastest: a patch's items are neighbours
    assert items[0][:3] == items[n_rates * n_tiles - 1][:3]


@pytest.mark.parametrize("b,h,w,n", [
    (2, 129, 257, 256),         # layer4 at the serving grid
    (2, 129, 257, 512),         # layer5
    (2, 3, 5, 128),             # smaller than a patch
    (1, 33, 17, 256),           # one row and one column past a patch
    (1, 40, 44, 384),           # three channel tiles
])
def test_int8_conv3x3_grid_covers_every_output_once(b, h, w, n):
    """``csrc/int8_mm.cu``'s conv: its launcher's item count, each item
    decoded as ``decode_patch`` does (channel tile fastest) with the patch
    and tile read from the source, clipped to the image as the epilogue
    clips it, writes every (batch, y, x, channel) exactly once; and the
    wrapper's channel limit is the kernel's tile."""
    ph, pw, cn = (_source_constant(k, "int8_mm") for k in ("PH", "PW", "CN"))
    assert kernels.int8._TILE_N == cn
    npy, npx, n_tiles = -(-h // ph), -(-w // pw), n // cn
    seen = np.zeros((b, h, w, n), np.int32)
    for item in range(b * npy * npx * n_tiles):
        p, tile = divmod(item, n_tiles)
        p, px = divmod(p, npx)
        bi, py = divmod(p, npy)
        seen[bi, py * ph:(py + 1) * ph, px * pw:(px + 1) * pw,
             tile * cn:(tile + 1) * cn] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,hw,rates,f", [
    (2, (65, 65), (6, 12, 18, 24), 64),   # the training shape
    (1, (7, 30), (1, 2, 3, 9), 64),       # rate 9 empties whole tiles
    (3, (33, 17), (2, 20), 64),
    (1, (9, 11), (1, 3), 32),             # a tile spans two di
    (2, (5, 70), (4,), 16),               # one tile holds every tap
    (1, (70, 65), (6, 12, 18, 24), 16),   # two partials of the image
])
def test_grad_weight_row_skipping_is_exact(rng, b, hw, rates, f):
    """The weight gradient's k tiles (width, stage depth and partial size
    read from ``csrc/aspp_bwd.cu``): the nonzero rows of each tile of the
    packed G are one row range per image, and walking only that range, in
    whole stages from its first row, one partial per CHUNK pixels of it
    (the last stage reads on into rows where the tile is zero, or past
    the image), sums to x^T G exactly with every pixel in one partial; at
    the training shape ~15% of the rows are left out.  The wrapper's
    partial size is the kernel's, and an image needs no more partials
    than the wrapper makes room for."""
    bn, bp, chunk = (_source_constant(k, "aspp_bwd")
                     for k in ("BN", "BP", "CHUNK"))
    assert taspp._DW_CHUNK == chunk and chunk % bp == 0
    h, w = hw
    x = rng.random((b, h * w, 8))
    g = torch.from_numpy(rng.standard_normal((b, h, w, len(rates) * f)))
    pg = taspp.grad_pack_plain(g, rates, f).numpy().reshape(b, h * w, -1)
    k_cols = pg.shape[-1]
    want = np.einsum("bqc,bqk->ck", x, pg)
    got = np.zeros_like(want)
    walked = 0
    for k0 in range(0, k_cols, bn):
        cols = slice(k0, k0 + bn)
        live = pg[:, :, cols].reshape(b, h, -1).any(-1)     # (b, h)
        assert (live == live[0]).all()
        rows = np.flatnonzero(live[0])
        lo, hi = (rows[0], rows[-1] + 1) if rows.size else (0, 0)
        assert (rows == np.arange(lo, hi)).all()
        for bi in range(b):
            seen = np.zeros(h * w + bp, np.int32)
            for s in range(-(-h * w // chunk)):
                p0 = lo * w + s * chunk
                for p in range(p0, min(hi * w, p0 + chunk), bp):
                    assert p + bp <= p0 + chunk   # past the image: zeros
                    seen[p:p + bp] += 1
                    got[:, cols] += x[bi, p:p + bp].T @ pg[bi, p:p + bp, cols]
            assert seen.max(initial=0) <= 1 and seen[lo * w:hi * w].all()
            walked += (hi - lo) * w * min(bn, k_cols - k0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    if hw == (65, 65):
        assert 0.13 < 1 - walked / (b * h * w * k_cols) < 0.17


def test_library_hash_covers_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source, every ``csrc/*.cuh`` and the
    flags: an edited shared header must not reuse a stale build."""
    assert (_build.CSRC / "hopper.cuh").exists()
    assert str(_build.CSRC) in _build.NVCC_FLAGS
    assert "-v" in _build.NVCC_FLAGS
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "other.cu").write_text("// another kernel\n")
    (csrc / "shared.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (csrc / "other.cu").write_text("// another kernel, edited\n")
    assert _build.library_path("k") == first
    (csrc / "shared.cuh").write_text("// header, edited\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "k.cu").write_text("// kernel, edited\n")
    third = _build.library_path("k")
    assert third not in (first, second)
    (csrc / "new.cuh").write_text("// a second header\n")
    assert _build.library_path("k") != third


# ---------------------------------------------------------------------------
# K3: upsample + argmax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("out_size,in_size", [(1024, 129), (2048, 257),
                                              (33, 9), (16, 8), (5, 5)])
def test_interp_taps_rebuild_the_matrix(out_size, in_size):
    idx, wts = tup.interp_taps(out_size, in_size)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    m[rows, idx[:, 0]] += wts[:, 0]
    m[rows, idx[:, 1]] += wts[:, 1]
    np.testing.assert_array_equal(m, _bilinear_matrix(out_size, in_size))


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 9, 13, 5), (33, 40)),
    ((1, 17, 11, 3), (65, 65)),
    ((3, 8, 8, 2), (16, 16)),
])
def test_upsample_argmax_matches_pallas(shape, out_hw):
    rng = np.random.default_rng(11)
    lg = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(fused_upsample_argmax(jnp.asarray(lg), *out_hw,
                                            interpret=True))
    got = kernels.fused_upsample_argmax(torch.from_numpy(lg),
                                        *out_hw).numpy()
    assert got.shape == (shape[0], *out_hw) and got.dtype == np.uint8
    up = np.asarray(resize_bilinear_matrix(jnp.asarray(lg), *out_hw))
    labels_equal_outside_ties(got, want, up)


def test_upsample_argmax_tie_first_max_wins():
    lg = np.ones((1, 6, 6, 4), np.float32)
    want = np.asarray(fused_upsample_argmax(jnp.asarray(lg), 12, 12,
                                            interpret=True))
    got = kernels.fused_upsample_argmax(torch.from_numpy(lg), 12, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).all()


def test_upsample_label_dtype_widens_past_255_classes(rng):
    lg = rng.standard_normal((1, 4, 4, 300)).astype(np.float32)
    got = kernels.fused_upsample_argmax(torch.from_numpy(lg), 8, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), tup.upsample_argmax_plain(torch.from_numpy(lg), 8, 8))


@pytest.mark.parametrize("hw,out_hw,c", [
    ((129, 257), (1024, 2048), 19),    # the flagship
    ((65, 65), (513, 513), 19),        # a 513 x 513 eval crop
    ((65, 65), (513, 513), 182),       # COCO-Stuff's classes
    ((61, 81), (480, 640), 182),       # and its image sizes
    ((81, 61), (640, 480), 182),
    ((54, 81), (427, 640), 182),
    ((41, 41), (321, 321), 182),       # its training crop
    ((17, 23), (131, 187), 2),         # odd sizes: ragged bands and spans
])
def test_upsample_band_plan_covers_every_output_once(hw, out_hw, c):
    """``csrc/upsample.cu``'s blocks (band height read from the source,
    span width from ``plan``): every output pixel belongs to one block;
    the taps never step back, so the source rows and columns the pixels
    of a block reach form one window from their least to their greatest
    tap, and that window is no larger than the planned counts; the
    planned window fits a block's shared memory."""
    (h, w), (hh, ww) = hw, out_hw
    band = _source_constant("BH", "upsample")
    assert band == tup._BAND
    span, max_rows, max_cols = tup.plan(h, w, hh, ww, c)
    assert span % 32 == 0 and span <= _source_constant("THREADS_MAX",
                                                       "upsample")
    staged = max_rows * ((max_cols * c + 6) // 4 * 4) * 4
    assert staged <= tup._SMEM_BUDGET <= 232448
    yi, _ = tup.interp_taps(hh, h)
    xi, _ = tup.interp_taps(ww, w)
    for idx in (yi, xi):
        assert (np.diff(idx, axis=0) >= 0).all()
    seen = np.zeros((hh, ww), np.int32)
    for y0 in range(0, hh, band):
        rows = yi[y0:y0 + band]
        assert rows.max() - rows.min() + 1 <= max_rows
        for x0 in range(0, ww, span):
            cols = xi[x0:x0 + span]
            assert cols.max() - cols.min() + 1 <= max_cols
            seen[y0:y0 + band, x0:x0 + span] += 1
    assert (seen == 1).all()


def test_spec_tables_made_while_serving_serve_training_too():
    """The spec's device tables are cached per (spec, device); a table
    first made under ``inference_mode`` (serving) is kept for a training
    step on the same spec, which saves it for backward: it must not be an
    inference tensor."""
    spec = port_spec(ProtoSpec.equal_allocation(24, 16, num_classes=3,
                                                num_groups=2))
    with torch.inference_mode():
        tables = tproto.spec_tensors(spec, torch.device("cpu"))
    assert not any(t.is_inference() for t in tables.values())
    act = torch.rand(2, 5, spec.num_active_prototypes, requires_grad=True)
    gw = torch.rand(spec.num_classes, 2, int(max(spec.class_counts)),
                    requires_grad=True)
    tproto.group_activations(act, gw, spec).sum().backward()
    assert gw.grad is not None and torch.isfinite(gw.grad).all()


@pytest.mark.parametrize("bank", [(228, 19), (2054, 182), (1800, 150)])
def test_rounding_bound_holds_for_the_plain_head(bank):
    """``rounding_bound``, the bound the card holds K1 to at pushed
    prototypes: on the card test's construction (2 x 13 x 17 bf16
    features, every prototype a seeded pixel's features, a group head of 3
    groups with rows on the simplex) the fp32 plain head lies within it of
    the float64 head, at 3 units of fp32 rounding a distance; with the
    prototypes moved off the pixels (d >= 0.5) the same bound falls two
    orders, below 1e-3: the worst-case rounding of the head's own sums."""
    p, c = bank
    gen = np.random.default_rng(7)
    tspec = port_spec(ProtoSpec.equal_allocation(p, 64, num_classes=c,
                                                 num_groups=3))
    feats = torch.from_numpy(gen.random((2, 13, 17, 256), np.float32)).to(
        torch.bfloat16)
    flat = feats.reshape(-1, 256).float()
    at = gen.integers(0, flat.shape[0], p)
    protos = torch.stack([flat[i, s * 64:(s + 1) * 64] for s, (lo, hi) in
                          enumerate(tspec.scale_bounds) for i in at[lo:hi]])
    mask = (tspec.class_proto_index >= 0).astype(np.float32)
    gw = gen.random((c, 3, tspec.max_protos_per_class)) * mask[:, None, :]
    kw = dict(group_projection=torch.from_numpy(
        (gw / gw.sum(-1, keepdims=True)).astype(np.float32)),
        last_layer_group=torch.from_numpy(gen.standard_normal(
            (c * 3, c)).astype(np.float32) * 0.1))
    want = tproto.proto_float64(feats, protos, None, tspec, **kw)
    err = ((proto_plain(feats, protos, None, tspec, **kw) - want).abs().max()
           / want.abs().max()).item()
    bound = tproto.rounding_bound(feats, protos, None, tspec, **kw)
    assert err <= bound < 0.2, (err, bound)
    far = protos + 0.1
    assert tproto.rounding_bound(feats, far, None, tspec, **kw) < 1e-3
