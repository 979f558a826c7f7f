"""The port's resize and prototype-distance ops against the JAX package
(same numpy inputs on both sides; float32, tolerance 1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scaleprotoseg_tpu.ops import prototype as jproto
from scaleprotoseg_tpu.ops import resize as jresize
from scaleprotoseg_tpu.spec import ProtoSpec
from scaleprotoseg_torch.ops import prototype as tproto
from scaleprotoseg_torch.ops import resize as tresize
from torch_parity import port_spec


@pytest.mark.parametrize("out_size,in_size", [(33, 5), (1024, 129),
                                              (2048, 257), (7, 13)])
def test_bilinear_matrix_bit_equal(out_size, in_size):
    np.testing.assert_array_equal(tresize._bilinear_matrix(out_size, in_size),
                                  jresize._bilinear_matrix(out_size, in_size))


def test_resize_bilinear_matrix(rng):
    x = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear_matrix(jnp.asarray(x), 33, 40))
    got = tresize.resize_bilinear_matrix(torch.from_numpy(x), 33, 40).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _bank(rng, spec):
    feats = rng.random((2, 5, 7, spec.feature_depth)).astype(np.float32)
    protos = rng.random((spec.num_prototypes, spec.proto_depth)) \
        .astype(np.float32)
    return feats, protos


@pytest.mark.parametrize("layout", ["regular", "irregular", "dangling"])
def test_scale_l2_distances(rng, layout):
    if layout == "dangling":     # floor-division leftover rows (COCO-like)
        spec = ProtoSpec.equal_allocation(50, 8, num_classes=3, num_scales=4)
    else:
        spec = ProtoSpec.equal_allocation(48, 8, num_classes=3, num_scales=4)
    if layout == "irregular":    # post-prune: unequal per-scale widths
        spec = spec.prune([0, 1, 13, 30, 31, 32])
    feats, protos = _bank(rng, spec)
    want = np.asarray(jproto.scale_l2_distances(
        jnp.asarray(feats), jnp.asarray(protos), spec.scale_bounds))
    got = tproto.scale_l2_distances(
        torch.from_numpy(feats), torch.from_numpy(protos),
        port_spec(spec).scale_bounds).numpy()
    assert got.shape == want.shape == (2, 5, 7, spec.num_active_prototypes)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["log", "linear"])
def test_distance_to_similarity(rng, activation):
    d = (rng.random((3, 4, 17)) * 10).astype(np.float32)
    d[0, 0, :3] = 0.0            # d = 0 is where eps = 1e-4 matters
    want = np.asarray(jproto.distance_to_similarity(jnp.asarray(d),
                                                    activation))
    got = tproto.distance_to_similarity(torch.from_numpy(d),
                                        activation).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_spec_sidecar_roundtrip_matches_jax():
    from scaleprotoseg_tpu.checkpoints.io import _spec_meta, spec_from_meta
    from scaleprotoseg_torch.spec import ProtoSpec as TProtoSpec

    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19,
                                      num_groups=3).prune([5, 77])
    tspec = TProtoSpec.from_meta(_spec_meta(spec))
    assert tspec == port_spec(spec)
    assert spec_from_meta(tspec.to_meta()) == spec
    np.testing.assert_array_equal(tspec.class_proto_index,
                                  spec.class_proto_index)
    np.testing.assert_array_equal(tspec.class_proto_onehot,
                                  spec.class_proto_onehot)
