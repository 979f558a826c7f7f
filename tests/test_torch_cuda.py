"""Each CUDA kernel of the port against its plain PyTorch version, and the
serving engine's device timing, on the card.  Skips where there is no GPU; imports nothing of JAX, so on the
machine with the card it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: K2 within 2 bf16 ulps of the fp32
accumulated plain form, K1 rtol = atol = 1e-4 without TF32, K3 labels
equal where the top-two margin is at least 1e-5; the int8 products and
the quantize bit for bit, their bf16 epilogue within 1 bf16 ulp, the
bf16 arm of ``int8_mm`` within rtol = 1e-4, atol = 1e-3 of the float32
product without TF32.
"""

import numpy as np
import pytest
import torch

from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.kernels.aspp import (aspp_plain, aspp_trainable,
                                              grad_pack_plain,
                                              grad_weight_plain, shifted_sum)
from scaleprotoseg_torch.kernels.int8 import (absmax_plain,
                                              int8_conv3x3_plain,
                                              int8_mm_plain,
                                              quantize_int8_plain)
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


@pytest.mark.parametrize("hw,rates", [((65, 65), (6, 12, 18, 24)),
                                      ((7, 30), (1, 2, 3, 9))])
def test_aspp_grad_pack_is_bit_exact(dev, gen, hw, rates):
    g = torch.from_numpy(gen.standard_normal((2, *hw, 4 * 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    before = kernels.aspp_grad_pack.launches
    got = kernels.aspp_grad_pack(g, rates, 64)
    torch.cuda.synchronize()
    assert kernels.aspp_grad_pack.launches == before + 1
    assert torch.equal(got, grad_pack_plain(g, rates, 64))


@pytest.mark.parametrize("n,c,k", [(8450, 2048, 2304), (100, 256, 128),
                                   (4352, 128, 64)])
def test_aspp_grad_weight_matches_plain(dev, gen, n, c, k):
    """fp32 sums of exact bf16 products: within 1e-3 of the plain fp32
    product (TF32 off), and the same bits on a second run."""
    x = torch.from_numpy(gen.random((n, c), np.float32)).to(
        dev, torch.bfloat16)
    pg = torch.from_numpy(gen.standard_normal((n, k)).astype(
        np.float32)).to(dev, torch.bfloat16)
    got = kernels.aspp_grad_weight(x, pg)
    want = grad_weight_plain(x, pg)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got, kernels.aspp_grad_weight(x, pg))


@pytest.mark.parametrize("c", [2048, 256], ids=["kernel_fwd", "shifted_fwd"])
def test_aspp_trainable_backward_matches_plain(dev, gen, c):
    """The Function's gradients against autograd through the plain
    shifted-matmul form on x upcast to float32 (so the 36 tap gradients
    of dx add up in float32 and round to bf16 once, as the Function's
    product does) and on the bf16-rounded weights, the rounding passed
    straight through so that dW stays float32: dW and db within 1e-3
    relative to their scale, dx within 2 bf16 ulps."""
    rates = (6, 12, 18, 24)
    x = torch.from_numpy(gen.random((2, 33, 33, c), np.float32)).to(
        dev, torch.bfloat16)
    ws = [torch.from_numpy(gen.standard_normal((3, 3, c, 64)).astype(
        np.float32) * 0.02).to(dev) for _ in rates]
    bs = [torch.from_numpy(gen.standard_normal(64).astype(np.float32)).to(
        dev) for _ in rates]
    cot = torch.from_numpy(gen.standard_normal((2, 33, 33, 256)).astype(
        np.float32)).to(dev)

    def grads(fn):
        xs = x.clone().requires_grad_()
        wv = [w.clone().requires_grad_() for w in ws]
        bv = [b.clone().requires_grad_() for b in bs]
        (fn(xs, wv, bv).float() * cot).sum().backward()
        return xs.grad, [w.grad for w in wv], [b.grad for b in bv]

    counts = (kernels.aspp_grad_pack.launches,
              kernels.aspp_grad_weight.launches)
    gx, gw, gb = grads(lambda a, w, b: aspp_trainable(a, w, b, rates))
    assert (kernels.aspp_grad_pack.launches,
            kernels.aspp_grad_weight.launches) == (counts[0] + 1,
                                                   counts[1] + 1)
    rx, rw, rb = grads(lambda a, w, b: shifted_sum(
        a.float(), [wt + (wt.to(torch.bfloat16).float() - wt).detach()
                    for wt in w], b, rates).to(torch.bfloat16))
    assert _bf16_ulps(gx.float().cpu().numpy(),
                      rx.float().cpu().numpy()) <= 2
    for got, want in zip(gw + gb, rw + rb):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * scale)


def test_aspp_forward_follows_optimizer_updates(dev, gen):
    """After a fused-Adam update K2's forward reads the new weights: its
    packed weight stack is rebuilt, in training and in a no-grad pass."""
    from scaleprotoseg_torch.models.deeplab import ASPP
    from scaleprotoseg_torch.train.optim import OptimGroup, PhaseOptimizer
    rates = (6, 12, 18, 24)
    module = ASPP(512, 64, rates, "concat", fast=True).to(dev)
    opt = PhaseOptimizer(
        [(f"features.base.aspp.{n}", p) for n, p in module.named_parameters()],
        {"aspp_w": OptimGroup(1e-2), "aspp_b": OptimGroup(1e-2)})
    x = torch.from_numpy(gen.random((1, 512, 17, 19), np.float32)).to(
        dev, torch.bfloat16)
    before = kernels.fused_aspp.launches
    module(x).square().sum().backward()
    opt.step()
    with torch.no_grad():
        got = module(x).permute(0, 2, 3, 1).cpu().numpy()
        branches = [getattr(module, f"c{i}") for i in range(4)]
        want = aspp_plain(x.permute(0, 2, 3, 1).contiguous(),
                          [b.hwio() for b in branches],
                          [b.bias for b in branches], rates)
    assert kernels.fused_aspp.launches == before + 2
    assert _bf16_ulps(got, want.float().cpu().numpy()) <= 2


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


def _int8(gen, shape, dev):
    return torch.from_numpy(gen.integers(-127, 128, size=shape).astype(
        np.int8)).to(dev)


@pytest.mark.parametrize("m,k,n", [(8192, 512, 512), (1000, 256, 128),
                                   (2 * 17 * 33, 2048, 512),
                                   (70, 64, 256)])
def test_int8_mm_matches_plain(dev, gen, m, k, n):
    """The int32 product bit for bit (rows past M masked); the dequantized
    bf16 within 1 bf16 ulp and float32 bit for bit of ``float(acc) *
    (sx * sw)``."""
    a, bt = _int8(gen, (m, k), dev), _int8(gen, (n, k), dev)
    before = kernels.int8_mm.launches
    got = kernels.int8_mm(a, bt)
    torch.cuda.synchronize()
    assert kernels.int8_mm.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_mm_plain(a, bt))
    sx = torch.tensor(3e-3, device=dev)
    sw = torch.from_numpy(gen.random(n, np.float32) * 1e-3 + 1e-5).to(dev)
    want = int8_mm_plain(a, bt, sx, sw, torch.float32)
    assert torch.equal(kernels.int8_mm(a, bt, sx, sw, torch.float32), want)
    got_bf = kernels.int8_mm(a, bt, sx, sw, torch.bfloat16).float()
    assert _bf16_ulps(got_bf.cpu().numpy(), want.cpu().numpy()) <= 1
    assert torch.equal(got_bf, want.to(torch.bfloat16).float())


def test_int8_mm_bf16_arm_matches_plain(dev, gen):
    a = torch.from_numpy(gen.standard_normal((8192, 512)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bt = torch.from_numpy(gen.standard_normal((512, 512)).astype(
        np.float32)).to(dev, torch.bfloat16)
    got = kernels.int8_mm(a, bt)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, int8_mm_plain(a, bt), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("shape,dil", [((2, 17, 33, 256, 256), 2),
                                       ((1, 9, 130, 512, 512), 4),
                                       ((2, 3, 5, 64, 128), 4)])
def test_int8_conv3x3_matches_plain(dev, gen, shape, dil):
    """The nine-tap accumulator bit for bit against a float64 conv of the
    int8 values, including maps smaller than the dilation (every shifted
    tap partly outside), and the dequantized bf16 form."""
    b, h, w, c, n = shape
    x, wt = _int8(gen, (b, h, w, c), dev), _int8(gen, (9, n, c), dev)
    before = kernels.int8_conv3x3.launches
    got = kernels.int8_conv3x3(x, wt, dil)
    torch.cuda.synchronize()
    assert kernels.int8_conv3x3.launches == before + 1
    assert torch.equal(got, int8_conv3x3_plain(x, wt, dil))
    sx = torch.tensor(2e-3, device=dev)
    sw = torch.from_numpy(gen.random(n, np.float32) * 1e-3 + 1e-5).to(dev)
    assert torch.equal(
        kernels.int8_conv3x3(x, wt, dil, sx, sw, torch.bfloat16),
        int8_conv3x3_plain(x, wt, dil, sx, sw, torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_int8_matches_plain(dev, gen, dtype):
    """Both forms bit for bit: static (reciprocal multiply, saturating)
    and dynamic (the device scale from ``int8_absmax``, then division),
    with exact .5 cases for the half-to-even rounding."""
    x = torch.from_numpy(gen.standard_normal((2, 33, 65, 256)).astype(
        np.float32) * 4).to(dev, dtype)
    x.view(-1)[:8] = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5,
                                   126.5], device=dev, dtype=dtype)
    counts = (kernels.quantize_int8.launches, kernels.int8_absmax.launches)
    for scale in (torch.tensor(1.0, device=dev),
                  torch.tensor(0.03, device=dev)):
        assert torch.equal(kernels.quantize_int8(x, scale),
                           quantize_int8_plain(x, scale))
    s = kernels.int8_absmax(x)
    assert s.device.type == "cuda" and s.shape == ()
    assert torch.equal(s, absmax_plain(x))
    assert torch.equal(kernels.quantize_int8(x, s, divide=True),
                       quantize_int8_plain(x, s, divide=True))
    torch.cuda.synchronize()
    assert (kernels.quantize_int8.launches,
            kernels.int8_absmax.launches) == (counts[0] + 3, counts[1] + 1)


@pytest.mark.parametrize("quant8", ["static", True], ids=["static",
                                                          "dynamic"])
def test_quant_conv_kernel_path_matches_plain(dev, gen, quant8):
    """A layer5 block of the bf16 serving model: the kernel path
    (``int8_conv``) against the plain path (``static_int8_conv`` /
    ``dynamic_int8_conv``, float64 products) within 1 bf16 ulp."""
    from scaleprotoseg_torch.models.deeplab import Bottleneck
    from scaleprotoseg_torch.models.layers import QuantConvBN, cast_convs
    block = Bottleneck(1024, 512, 2048, 1, 4, shortcut=True, quant8=quant8)
    for m in block.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.data = torch.from_numpy(gen.standard_normal(
                m.weight.shape).astype(np.float32) * 0.02)
    block = cast_convs(block, torch.bfloat16).to(dev).eval()
    block.to(memory_format=torch.channels_last)
    x = torch.from_numpy(gen.random((1, 1024, 17, 33), np.float32)).to(
        dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    sites = [m for m in block.modules() if isinstance(m, QuantConvBN)]
    if quant8 == "static":
        for m in sites:
            m.calibrating = True
        with torch.no_grad():
            block(x)
        for m in sites:
            m.calibrating = False
    before = kernels.int8_mm.launches
    with torch.no_grad():
        got = block.conv3x3(block.reduce(x)).float().cpu().numpy()
        for m in sites:
            m.plain = True
        want = block.conv3x3(block.reduce(x)).float().cpu().numpy()
    assert kernels.int8_mm.launches == before + 1
    assert _bf16_ulps(got, want) <= 1


def test_int8_wrappers_refuse_misaligned_operands(dev):
    buf = torch.zeros(8 + 128 * 64, dtype=torch.int8, device=dev)
    a = buf[8:].view(128, 64)
    bt = torch.zeros((128, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        kernels.int8_mm(a, bt)
    x = torch.zeros(2 + 64, dtype=torch.float32, device=dev)[2:]
    with pytest.raises(ValueError, match="aligned"):
        kernels.quantize_int8(x, torch.tensor(1.0, device=dev))
