"""Each CUDA kernel of the port against its plain PyTorch version, and the
serving engine's device timing, on the card.  Skips where there is no GPU; imports nothing of JAX, so on the
machine with the card it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: K2 within 2 bf16 ulps of the fp32
accumulated plain form, K1 rtol = atol = 1e-4 without TF32, K3 labels
equal where the top-two margin is at least 1e-5.
"""

import numpy as np
import pytest
import torch

from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.kernels.aspp import aspp_plain
from scaleprotoseg_torch.kernels.proto import proto_plain
from scaleprotoseg_torch.kernels.upsample import upsample_argmax_plain
from scaleprotoseg_torch.ops.resize import resize_bilinear_matrix
from scaleprotoseg_torch.serving.engine import ServingEngine
from scaleprotoseg_torch.spec import ProtoSpec

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(7)


def _without(spec, drop):
    """``spec`` with the prototypes in ``drop`` removed (per-scale ranges
    re-packed), as a pruned checkpoint carries it."""
    drop = set(drop)
    keep = [p for p in range(spec.num_prototypes) if p not in drop]
    bounds, pos = [], 0
    for lo, hi in spec.scale_bounds:
        n = sum(lo <= p < hi for p in keep)
        bounds.append((pos, pos + n))
        pos += n
    return ProtoSpec(spec.num_classes, spec.num_scales, spec.proto_depth,
                     tuple(spec.class_ids[p] for p in keep), tuple(bounds),
                     spec.num_groups)


def _bf16_ulps(got, want):
    mag = np.maximum(np.abs(want), np.abs(want).max() * 2.0 ** -10)
    return float((np.abs(got - want)
                  / 2.0 ** (np.floor(np.log2(mag)) - 7)).max())


@pytest.mark.parametrize("hw,c,f", [((21, 37), 512, 64), ((9, 130), 1024, 128)])
def test_aspp_kernel_matches_plain(dev, gen, hw, c, f):
    x = torch.from_numpy(gen.random((2, *hw, c), np.float32)).to(
        dev, torch.bfloat16)
    ws = [torch.from_numpy(gen.standard_normal((3, 3, c, f)).astype(
        np.float32) * 0.02).to(dev) for _ in range(4)]
    bs = [torch.from_numpy(gen.standard_normal(f).astype(np.float32)).to(dev)
          for _ in range(4)]
    before = kernels.fused_aspp.launches
    got = kernels.fused_aspp(x, ws, bs).float().cpu().numpy()
    torch.cuda.synchronize()
    assert kernels.fused_aspp.launches == before + 1
    want = aspp_plain(x, ws, bs).float().cpu().numpy()
    assert _bf16_ulps(got, want) <= 2


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
@pytest.mark.parametrize("bank", ["cityscapes", "ade20k"])
def test_proto_kernel_matches_plain(dev, gen, grouped, bank):
    """Cityscapes' 228 prototypes with two pruned and class 4 emptied, and
    ADE20K's 1800 over 150 classes: 450 rows per scale, so the kernel
    stages each scale's bank in several chunks."""
    g = 3 if grouped else 0
    if bank == "cityscapes":
        spec = ProtoSpec.equal_allocation(228, 64, num_classes=19,
                                          num_groups=g)
        spec = _without(spec, [3, 100] + [
            p for p, c in enumerate(spec.class_ids) if c == 4])
    else:
        spec = ProtoSpec.equal_allocation(1800, 64, num_classes=150,
                                          num_groups=g)
    c = spec.num_classes
    feats = torch.from_numpy(gen.random((2, 13, 17, 256), np.float32)).to(
        dev, torch.bfloat16)
    protos = torch.from_numpy(gen.random((spec.num_prototypes, 64),
                                         np.float32)).to(dev)
    kw = {}
    if grouped:
        mask = (spec.class_proto_index >= 0).astype(np.float32)
        kw["group_projection"] = torch.from_numpy(
            gen.random((c, g, spec.max_protos_per_class), np.float32)
            * mask[:, None, :]).to(dev)
        kw["last_layer_group"] = torch.from_numpy(
            gen.standard_normal((c * g, c)).astype(np.float32) * 0.1).to(dev)
        last = None
    else:
        last = torch.from_numpy(gen.standard_normal(
            (spec.num_prototypes, c)).astype(np.float32)).to(dev)
    got = kernels.fused_proto_logits(feats, protos, last, spec, **kw)
    want = proto_plain(feats, protos, last, spec, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_proto_kernel_takes_bf16_features(dev, gen):
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19, num_groups=0)
    feats = torch.zeros((1, 3, 5, 256), device=dev)
    protos = torch.zeros((228, 64), device=dev)
    last = torch.zeros((228, 19), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        kernels.fused_proto_logits(feats, protos, last, spec)


def test_upsample_kernel_matches_plain(dev, gen):
    lg = torch.from_numpy(gen.standard_normal((2, 17, 33, 19)).astype(
        np.float32)).to(dev)
    got = kernels.fused_upsample_argmax(lg, 129, 257).cpu().numpy()
    want = upsample_argmax_plain(lg, 129, 257).cpu().numpy()
    top2 = torch.topk(resize_bilinear_matrix(lg, 129, 257), 2, dim=-1)[0]
    decided = ((top2[..., 0] - top2[..., 1]) >= 1e-5).cpu().numpy()
    assert got.dtype == np.uint8 and decided.mean() > 0.9
    np.testing.assert_array_equal(got[decided], want[decided])


def test_engine_times_the_device(dev):
    """On the card the engine adds up each batch's stream span."""
    w = torch.eye(512, device=dev)

    def predict(x):
        y = x.float().reshape(x.shape[0], -1)[:, :512]
        for _ in range(20):
            y = y @ w
        return y.sum(-1)

    engine = ServingEngine(predict, 2, device=dev)
    items = [(i, np.full((4, 128, 3), i, np.uint8)) for i in range(5)]
    got = [k for k, _ in engine.run(items)]
    assert got == list(range(5))
    assert engine.device_seconds > 0
