"""The port's flagship model against the JAX package, on the CPU in fp32.

Weights: ``synthetic_init`` on the JAX side, carried over by the port's
``ppnet_params_to_statedict`` and loaded with ``strict=True``.  The
tolerance for logits is rtol 1e-4 (float32 through a ResNet: summation
order differs between XLA:CPU and PyTorch's kernels).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scaleprotoseg_tpu.ops.pallas_proto import fused_proto_logits
from scaleprotoseg_tpu.ops.pallas_upsample import fused_upsample_argmax
from scaleprotoseg_tpu.ops.resize import resize_bilinear_matrix
from scaleprotoseg_torch.kernels import launch_counts
from scaleprotoseg_torch.models import ppnet as tppnet
from scaleprotoseg_torch.serving.export import make_serving_fn
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import jax_flagship, labels_equal_outside_ties, port_model

SIDE = 33


@pytest.fixture(scope="module", params=[True, False],
                ids=["group_head", "plain_head"])
def pair(request):
    model, spec, variables = jax_flagship(grouped=request.param, side=SIDE)
    return model, spec, variables, port_model(model, spec, variables)


def _images(n=2, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, SIDE, SIDE, 3)).astype(np.float32)


def test_logits_match_jax(pair):
    model, _, variables, tm = pair
    x = _images()
    want = np.asarray(model.apply(variables, jnp.asarray(x),
                                  train=False).logits)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).logits.numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_fast_path_matches_jax_kernel_composition(pair):
    """The port's fast serving path (on the CPU each wrapper runs its
    plain version) against the JAX composition conv_features ->
    fused_proto_logits -> fused_upsample_argmax, both Pallas kernels in
    interpret mode."""
    model, spec, variables, tm = pair
    x = _images(seed=5)
    feats = model.apply(variables, jnp.asarray(x), method="conv_features")
    if model.grouped:
        params = variables["params"]
        low = fused_proto_logits(
            feats, params["prototype_vectors"], None, spec,
            group_projection=params["group_projection"],
            last_layer_group=params["last_layer_group"], interpret=True)
    else:
        low = fused_proto_logits(feats, variables["params"]["prototype_vectors"],
                                 variables["params"]["last_layer"], spec,
                                 interpret=True)
    want = np.asarray(fused_upsample_argmax(low, SIDE, SIDE, interpret=True))
    up = np.asarray(resize_bilinear_matrix(low, SIDE, SIDE))

    before = launch_counts()
    fn = make_serving_fn(tm, fast=True)
    got = fn(torch.from_numpy(x)).numpy()
    assert launch_counts() == before      # CPU tensors never launch
    assert got.dtype == np.uint8 and got.shape == (2, SIDE, SIDE)
    labels_equal_outside_ties(got, want, up)


def test_fast_path_packs_its_head_once(pair, monkeypatch):
    """``fast_logits`` packs K1's head on first use and again only after
    a head weight changes; the repacked head holds the new weights."""
    tm = pair[3]
    packs = []
    real = tppnet.pack_head
    monkeypatch.setattr(tppnet, "pack_head",
                        lambda *a, **k: packs.append(1) or real(*a, **k))
    monkeypatch.setattr(tm, "_head", tppnet.WeightCache())
    x = torch.from_numpy(_images(n=1))
    with torch.inference_mode():
        tm.fast_logits(x)
        tm.fast_logits(x)
    assert len(packs) == 1
    pv = tm.prototype_vectors
    orig = pv.detach().clone()
    try:
        with torch.no_grad():
            pv.add_(1.0)
        head = tm._head.get(tm._head_params(), tm._head_weights)["head"]
        assert len(packs) == 2
        a = tm.spec.num_active_prototypes
        torch.testing.assert_close(head.protos, pv.detach().flatten(1)[:a])
    finally:
        with torch.no_grad():
            pv.copy_(orig)
