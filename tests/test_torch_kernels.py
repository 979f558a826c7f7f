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
from scaleprotoseg_torch.kernels import upsample as tup
from scaleprotoseg_torch.kernels.proto import pack_head, proto_plain
from scaleprotoseg_torch.models import deeplab as tdeeplab
from scaleprotoseg_torch.ops.prototype import (distance_to_similarity,
                                               scale_l2_distances)
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
    shifted-matmul form below; both keep the bf16 contract of
    ``_xla_shifted_aspp`` and hand float32 on."""
    rates = (2, 4, 6, 8)
    x, weights, biases = _aspp_problem(rng, c, 16, hw=(9, 10))
    calls = []
    real = tdeeplab.fused_aspp
    monkeypatch.setattr(tdeeplab, "fused_aspp",
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
