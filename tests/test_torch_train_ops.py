"""The training slice's ops against the JAX package, on the CPU.

- K2 with its tap-packed backward (``kernels.aspp.aspp_trainable``, whose
  wrappers run their plain versions on CPU tensors) against the VJP of
  JAX's ``fused_aspp_trainable`` (``interpret=True``) at the shapes of
  ``tests/test_pallas_aspp.py``: dx, dW and db within rtol = atol = 1e-3
  for float32 x; for bf16 x, dW and db within 1e-3 and dx within 2 bf16
  ulps (both round a float32 sum once).  The shifted-gradient pack G must
  equal JAX's bit for bit: a one-hot x makes JAX's own dW = x^T G hand G
  out exactly.
- The bf16 block-diagonal distance head and its backward against JAX's
  ``_blockdiag_distances_bf16``: rtol 1e-2 (bf16 inputs).
- The five prototype-phase losses within 1e-5.
- The PIL-NEAREST index table equal to JAX's (which samples PIL) on
  every (out, in) pair up to 300 and the Cityscapes pairs.
- The augmentation pipeline against JAX's ``_python_aug`` with
  ``random`` seeded alike: labels equal, images within atol 2.5e-2 with
  a mean below 8e-3 (float bilinear against cv2's fixed-point one, as
  ``tests/test_native_aug.py`` allows).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scaleprotoseg_tpu.data.dataset import \
    PatchClassificationDataset as JDataset
from scaleprotoseg_tpu.losses import losses as jl
from scaleprotoseg_tpu.ops.pallas_aspp import fused_aspp_trainable
from scaleprotoseg_tpu.ops.prototype import _blockdiag_distances_bf16
from scaleprotoseg_tpu.ops.resize import _nearest_index as j_nearest
from scaleprotoseg_tpu.spec import ProtoSpec
from scaleprotoseg_torch.data.dataset import \
    PatchClassificationDataset as TDataset
from scaleprotoseg_torch.kernels.aspp import aspp_trainable, grad_pack_plain
from scaleprotoseg_torch.losses import losses as tl
from scaleprotoseg_torch.ops.prototype import pairwise_l2, scale_l2_distances
from scaleprotoseg_torch.ops.resize import _nearest_index as t_nearest
from scaleprotoseg_torch.ops.resize import resize_label_nearest
from test_torch_kernels import bf16_ulps
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import port_spec

RATES = (2, 4, 6, 8)


# ---------------------------------------------------------------------------
# K2 backward
# ---------------------------------------------------------------------------
def _aspp_problem(rng, shape=(2, 12, 17, 256)):
    x = (rng.random(shape) - 0.5).astype(np.float32)
    ws = [(rng.random((3, 3, shape[-1], 64)) * 0.05).astype(np.float32)
          for _ in RATES]
    bs = [rng.random((64,)).astype(np.float32) for _ in RATES]
    cot = rng.standard_normal(shape[:3] + (256,)).astype(np.float32)
    return x, ws, bs, cot


def _jax_vjp(x, ws, bs, cot, dtype):
    def loss(x, w, b):
        y = fused_aspp_trainable(x, w, b, rates=RATES, tile_rows=4,
                                 interpret=True)
        return jnp.sum(y.astype(jnp.float32) * cot)

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, dtype), tuple(jnp.asarray(w) for w in ws),
        tuple(jnp.asarray(b) for b in bs))


def _port_vjp(x, ws, bs, cot, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    bt = [torch.from_numpy(b).requires_grad_() for b in bs]
    y = aspp_trainable(xt, wt, bt, RATES)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    return xt.grad, [w.grad for w in wt], [b.grad for b in bt]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aspp_backward_matches_jax(rng, dtype):
    x, ws, bs, cot = _aspp_problem(rng)
    jdx, jdw, jdb = _jax_vjp(x, ws, bs, cot, getattr(jnp, dtype))
    dx, dw, db = _port_vjp(x, ws, bs, cot, getattr(torch, dtype))
    assert dx.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-3,
                                   atol=1e-3)
    else:
        assert bf16_ulps(dx.float().numpy(),
                         np.asarray(jdx.astype(jnp.float32))) <= 2
    for got, want in zip(dw + db, list(jdw) + list(jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3)


def test_aspp_grad_pack_equals_jax_shifted_gradients(rng):
    """With x one-hot over pixels (x[q, c] = [c == q]), JAX's dW_all =
    x^T G is G itself, exact in float32."""
    b, h, w, c = 1, 12, 17, 256
    x = np.zeros((b * h * w, c), np.float32)
    x[np.arange(b * h * w), np.arange(b * h * w)] = 1.0
    x = x.reshape(b, h, w, c)
    _, ws, bs, cot = _aspp_problem(rng, (b, h, w, c))
    _, jdw, _ = _jax_vjp(x, ws, bs, cot, jnp.bfloat16)
    # dW_r[di, dj, q, f] = G[q, (r, di, dj, f)]
    want = np.concatenate([np.asarray(d).transpose(2, 0, 1, 3).reshape(c, -1)
                           for d in jdw], axis=1)[:b * h * w]
    g = torch.from_numpy(cot).to(torch.bfloat16)
    got = grad_pack_plain(g, RATES, 64)
    assert got.dtype == torch.bfloat16 and got.shape == (b * h * w, 2304)
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# bf16 block-diagonal distance head
# ---------------------------------------------------------------------------
def _flagship_spec(pruned: bool):
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19)
    return spec.prune([3, 60, 61, 200]) if pruned else spec


@pytest.mark.parametrize("pruned", [False, True], ids=["regular", "pruned"])
def test_blockdiag_head_matches_jax(rng, pruned):
    spec = _flagship_spec(pruned)
    sb = tuple(tuple(bd) for bd in spec.scale_bounds)
    x = rng.random((2, 9, 11, 256)).astype(np.float32)
    p = rng.random((spec.num_prototypes, 64)).astype(np.float32)
    cot = rng.standard_normal((2, 9, 11, spec.num_active_prototypes)) \
        .astype(np.float32)
    out, vjp = jax.vjp(lambda a, q: _blockdiag_distances_bf16(a, q, sb),
                       jnp.asarray(x, jnp.bfloat16), jnp.asarray(p))
    jdx, jdp = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    pt = torch.from_numpy(p).requires_grad_()
    d = scale_l2_distances(xt, pt, spec.scale_bounds)
    (d * torch.from_numpy(cot)).sum().backward()
    assert d.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(out),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jdp), rtol=1e-2,
                               atol=1e-2 * np.abs(np.asarray(jdp)).max())


def test_pairwise_l2_matches_jax(rng):
    from scaleprotoseg_tpu.ops.prototype import pairwise_l2 as jpair
    a = rng.random((57, 64)).astype(np.float32)
    b = rng.random((40, 64)).astype(np.float32)
    np.testing.assert_allclose(
        pairwise_l2(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jpair(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5,
        atol=1e-5)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(5)
    spec = _flagship_spec(pruned=True)
    a = spec.num_active_prototypes
    d = (rng.random((2, 9, 11, a)) * 3).astype(np.float32)
    act = np.log((d + 1) / (d + 1e-4)).astype(np.float32)
    logits = rng.standard_normal((2, 9, 11, 19)).astype(np.float32)
    # 0 = void; label 6 on one pixel of image 0 only (a class the
    # pair losses skip there for having fewer than 2 pixels)
    t = rng.integers(0, 20, (2, 9, 11)).astype(np.int32)
    t[t == 6] = 7
    t[0, 0, 0] = 6
    last = rng.standard_normal((spec.num_prototypes, 19)).astype(np.float32)
    return spec, d, act, logits, t, last


@pytest.mark.parametrize("name", ["cross_entropy", "kld", "entropy_sampl",
                                  "norm", "last_layer_l1"])
def test_losses_match_jax(loss_inputs, name):
    spec, d, act, logits, t, last = loss_inputs
    tspec = port_spec(spec)
    T = torch.from_numpy
    if name == "cross_entropy":
        want = jl.pixel_wise_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(t))
        got = tl.pixel_wise_cross_entropy(T(logits), T(t))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(-1)
                                       if np.ndim(w) else np.asarray(w),
                                       rtol=1e-5, atol=1e-5)
        return
    if name == "kld":
        want = jl.kld_loss(jnp.asarray(d), jnp.asarray(t), spec)
        got = tl.kld_loss(T(d), T(t), tspec)
    elif name == "entropy_sampl":
        want = jl.entropy_sampl_loss(jnp.asarray(act), jnp.asarray(t), spec)
        got = tl.entropy_sampl_loss(T(act), T(t), tspec)
    elif name == "norm":
        want = jl.norm_loss(jnp.asarray(act), jnp.asarray(t), spec)
        got = tl.norm_loss(T(act), T(t), tspec)
    else:
        ident = spec.class_identity
        want = jl.last_layer_l1(jnp.asarray(last), ident)
        got = tl.last_layer_l1(T(last), T(ident))
    assert float(want) != 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# label resize
# ---------------------------------------------------------------------------
def _cityscapes_pairs():
    pairs = {(65, 513)}
    for s in np.linspace(0.5, 1.5, 41):
        for full in (1024, 2048):
            pairs.add((int(full * s), full))
    return sorted(pairs)


def test_nearest_index_equals_pil_sampled_table():
    bad = [(o, i) for o in range(1, 301) for i in range(1, 301)
           if not np.array_equal(t_nearest(o, i), j_nearest(o, i))]
    bad += [(o, i) for o, i in _cityscapes_pairs()
            if not np.array_equal(t_nearest(o, i), j_nearest(o, i))]
    assert not bad, bad[:10]


def test_resize_label_nearest_matches_jax(rng):
    from scaleprotoseg_tpu.ops.resize import resize_label_nearest as jresize
    lab = rng.integers(0, 20, (2, 513, 513)).astype(np.int32)
    got = resize_label_nearest(torch.from_numpy(lab), 65, 65).numpy()
    np.testing.assert_array_equal(got, np.asarray(jresize(jnp.asarray(lab),
                                                          65, 65)))


# ---------------------------------------------------------------------------
# augmentation pipeline
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    """Three Cityscapes-layout images (category-index labels 0-34)."""
    root = tmp_path_factory.mktemp("city")
    rng = np.random.default_rng(9)
    ids = []
    for i, (h, w) in enumerate([(96, 192), (64, 128), (101, 203)]):
        os.makedirs(root / "annotations" / "train", exist_ok=True)
        os.makedirs(root / "img_with_margin_0" / "train", exist_ok=True)
        ids.append(f"img{i}")
        np.save(root / "annotations" / "train" / f"img{i}.npy",
                rng.integers(0, 35, (h, w)).astype(np.uint8))
        np.save(root / "img_with_margin_0" / "train" / f"img{i}.npy",
                rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    with open(root / "all_images.json", "w") as f:
        json.dump({"train": ids}, f)
    return str(root)


def test_dataset_matches_jax_python_aug(city_root):
    kw = dict(data_type="cityscapes", mean=[0.485, 0.456, 0.406],
              std=[0.229, 0.224, 0.225], image_margin_size=0,
              window_size=(65, 97), scales=(0.5, 1.5), root=city_root)
    jds = JDataset("train", is_eval=False, native=False, **kw)
    tds = TDataset("train", **kw)
    for seed in range(6):
        for i in range(len(tds)):
            random.seed(seed)
            want_img, want_lab = jds[i]
            random.seed(seed)
            got_img, got_lab = tds[i]
            assert got_img.dtype == np.float32 and got_lab.dtype == np.int32
            np.testing.assert_array_equal(got_lab, want_lab)
            err = np.abs(got_img - want_img)
            assert err.max() <= 2.5e-2 and err.mean() < 8e-3, \
                (seed, i, err.max(), err.mean())
