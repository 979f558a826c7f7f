"""Each CUDA kernel of the port against its plain PyTorch version, and the
serving engine's device timing, on the card.  Skips where there is no GPU;
imports nothing of JAX, so on the machine with the card it runs without
the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

K2's forward and ``int8_mm``'s int8 arm are TMA + ``wgmma`` kernels: they
build and run on ``sm_90a`` (H100/H200) only.  Tolerances as in
``chip_smoke.py``: K2 within 2 bf16 ulps of the fp32 accumulated plain
form and the same bits on a second run, K1 rtol = atol = 1e-4 without
TF32 (and against the float64 head: at pushed prototypes within
``kernels.proto.rounding_bound`` of the largest logit, the inputs'
conditioning times fp32 rounding, and Cityscapes' bank within
``PROTO_PUSHED_RTOL``; its distances on a sparse
probe within ``PROTO_DISTANCE_ERR`` units of fp32 rounding), K3 labels
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
from scaleprotoseg_torch.kernels.proto import (distance_error,
                                               proto_float64, proto_plain,
                                               rounding_bound)
from scaleprotoseg_torch.kernels.upsample import upsample_argmax_plain
from scaleprotoseg_torch.ops.resize import resize_bilinear_matrix
from scaleprotoseg_torch.serving.engine import ServingEngine
from scaleprotoseg_torch.spec import ProtoSpec

pytestmark = pytest.mark.cuda

# K1 against the float64 head, as chip_smoke.py holds it: the largest
# logit error at pushed prototypes over the largest float64 logit, the
# largest distance error on the sparse probe (units of fp32 rounding)
PROTO_PUSHED_RTOL = 2e-2
PROTO_DISTANCE_ERR = 3.0


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


@pytest.mark.parametrize("b,hw,c,f,rates", [
    (1, (3, 5), 512, 64, (6, 12, 18, 24)),     # smaller than a 32 x 8 patch
    (2, (33, 16), 512, 64, (6, 12, 18)),       # one row past a patch edge
    (1, (32, 9), 512, 64, (2, 3)),             # one column past a patch edge
    (2, (9, 40), 512, 128, (30,)),             # taps staged one by one; F = 128
    (1, (33, 31), 1024, 128, (1, 28, 29)),     # the largest strip, and past it
    (2, (65, 65), 2048, 64, (6, 12, 18, 24)),  # the training shape
])
def test_aspp_kernel_ragged_shapes_and_same_bits(dev, gen, b, hw, c, f, rates):
    """The TMA + wgmma forward where patches hang over the image's edge
    and whole taps fall outside it: within 2 bf16 ulps of the plain form
    and the same bits on a second run."""
    x = torch.from_numpy(gen.random((b, *hw, c), np.float32)).to(
        dev, torch.bfloat16)
    ws = [torch.from_numpy(gen.standard_normal((3, 3, c, f)).astype(
        np.float32) * 0.02).to(dev) for _ in rates]
    bs = [torch.from_numpy(gen.standard_normal(f).astype(np.float32)).to(dev)
          for _ in rates]
    got = kernels.fused_aspp(x, ws, bs, rates)
    torch.cuda.synchronize()
    want = aspp_plain(x, ws, bs, rates).float().cpu().numpy()
    assert got.shape == (b, *hw, len(rates) * f)
    assert _bf16_ulps(got.float().cpu().numpy(), want) <= 2
    assert torch.equal(got, kernels.fused_aspp(x, ws, bs, rates))


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


@pytest.mark.parametrize("b,hw,rates,f,c", [
    (1, (130, 65), (6, 12, 18, 24), 64, 2048),  # the training pixels, one image
    (1, (129, 257), (6, 12, 18, 24), 64, 256),  # a serving-size image: 8 partials
    (1, (5, 9), (2,), 16, 256),             # fewer pixels than a stage
    (1, (7, 13), (1,), 8, 200),             # K = 72 and C no multiple of a tile
    (2, (40, 25), (1, 3), 24, 200),         # K = 432: tiles span taps
])
def test_aspp_grad_weight_matches_plain(dev, gen, b, hw, rates, f, c):
    """fp32 sums of exact bf16 products over G = ``aspp_grad_pack``'s
    output: within 1e-3 of the plain fp32 product (TF32 off) at every
    image size (the partials cap how far a truncating sum runs), and the
    same bits on a second run."""
    x = torch.from_numpy(gen.random((b, *hw, c), np.float32)).to(
        dev, torch.bfloat16)
    g = torch.from_numpy(gen.standard_normal(
        (b, *hw, len(rates) * f)).astype(np.float32)).to(dev, torch.bfloat16)
    pg = grad_pack_plain(g, rates, f)
    got = kernels.aspp_grad_weight(x, pg, rates)
    want = grad_weight_plain(x, pg)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got, kernels.aspp_grad_weight(x, pg, rates))


@pytest.mark.parametrize("b,hw,rates,f", [
    (2, (65, 65), (6, 12, 18, 24), 64),   # the training shape
    (1, (7, 30), (1, 2, 3, 9), 64),       # rate 9 leaves whole tiles empty
    (3, (33, 17), (2, 20), 64),           # three images, most rows empty
    (1, (9, 11), (1, 3), 32),             # a 192-wide tile spans two di
])
def test_aspp_grad_weight_skips_zero_rows_exactly(dev, gen, b, hw, rates, f):
    """With the rates, each k tile walks only the image rows where its
    columns of the packed G can be nonzero: the product is the plain one
    (1e-3) and the same bits twice, over one partial per image."""
    c = 256
    x = torch.from_numpy(gen.random((b, *hw, c), np.float32)).to(
        dev, torch.bfloat16)
    g = torch.from_numpy(gen.standard_normal(
        (b, *hw, len(rates) * f)).astype(np.float32)).to(dev, torch.bfloat16)
    pg = grad_pack_plain(g, rates, f)
    got = kernels.aspp_grad_weight(x, pg, rates)
    torch.testing.assert_close(got, grad_weight_plain(x, pg), rtol=1e-3,
                               atol=1e-3)
    assert torch.equal(got, kernels.aspp_grad_weight(x, pg, rates))


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
@pytest.mark.parametrize("bank", ["cityscapes", "ade20k", "coco_stuff",
                                  "coco_stuff_2184"])
def test_proto_kernel_matches_plain(dev, gen, grouped, bank):
    """Cityscapes' 228 prototypes with two pruned and class 4 emptied,
    ADE20K's 1800 over 150 classes, COCO-Stuff's group bank of 2054 (2052
    active, two dangling rows) and its prototype-phase bank of 2184, over
    182 classes: banks of 4 to 36 chunks, heads that run in several passes
    over class or output-column windows."""
    g = 3 if grouped else 0
    if bank == "cityscapes":
        spec = ProtoSpec.equal_allocation(228, 64, num_classes=19,
                                          num_groups=g)
        spec = spec.prune([3, 100] + [
            p for p, c in enumerate(spec.class_ids) if c == 4])
    elif bank == "ade20k":
        spec = ProtoSpec.equal_allocation(1800, 64, num_classes=150,
                                          num_groups=g)
    else:
        spec = ProtoSpec.equal_allocation(
            2054 if bank == "coco_stuff" else 2184, 64, num_classes=182,
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


@pytest.mark.parametrize("bank", ["24x4", "24x4_group", "20x1"])
def test_proto_kernel_at_em_shapes(dev, gen, bank):
    """EM's banks on EM's grid: 2 x 512 x 512 pixels (the largest grid of
    any path: 134 M feature elements at 4 scales) against 24 prototypes
    over 4 scales of 3 a class (plain and 3 groups a class) and
    ``baseline_em``'s 20 on one scale, 2 classes."""
    scales = 1 if bank == "20x1" else 4
    g = 3 if bank.endswith("group") else 0
    spec = ProtoSpec.equal_allocation(20 if scales == 1 else 24, 64,
                                      num_classes=2, num_scales=scales,
                                      num_groups=g)
    feats = torch.rand((2, 512, 512, 64 * scales), device=dev,
                       generator=torch.Generator(dev).manual_seed(3)).to(
        torch.bfloat16)
    protos = torch.from_numpy(gen.random((spec.num_prototypes, 64),
                                         np.float32)).to(dev)
    kw, last = {}, None
    if g:
        mask = (spec.class_proto_index >= 0).astype(np.float32)
        gw = gen.random((2, g, spec.max_protos_per_class)) * mask[:, None, :]
        kw = dict(group_projection=torch.from_numpy(
            (gw / gw.sum(-1, keepdims=True)).astype(np.float32)).to(dev),
            last_layer_group=torch.from_numpy(gen.standard_normal(
                (2 * g, 2)).astype(np.float32) * 0.5).to(dev))
    else:
        last = torch.from_numpy(gen.standard_normal(
            (spec.num_prototypes, 2)).astype(np.float32)).to(dev)
    got = kernels.fused_proto_logits(feats, protos, last, spec, **kw)
    want = proto_plain(feats, protos, last, spec, **kw)
    assert got.shape == (2, 512, 512, 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


BANKS = {"cityscapes": (228, 19), "coco_stuff": (2054, 182),
         "ade20k": (1800, 150), "em": (24, 2)}


def _bank(name, groups):
    p, c = BANKS[name]
    return ProtoSpec.equal_allocation(p, 64, num_classes=c,
                                      num_groups=groups)


@pytest.mark.parametrize("seed", [7, 0, 1, 2, 3])
@pytest.mark.parametrize("bank", list(BANKS))
def test_proto_kernel_at_pushed_prototypes(dev, bank, seed):
    """Every prototype a pixel's features (d = 0 there, where the
    activation's slope is -1e4): the group head's logits against the
    float64 head, the kernel's and the fp32 plain head's error within
    ``rounding_bound`` of these inputs at ``PROTO_DISTANCE_ERR`` units
    (their conditioning times fp32 rounding), and Cityscapes' bank within
    ``PROTO_PUSHED_RTOL`` as before.  The banks of 1800-2054 put about
    four or five prototypes on each of the 442 pixels: the plain head's
    error there reaches 2.5e-2."""
    gen = np.random.default_rng(seed)
    spec = _bank(bank, 3)
    c, g = spec.num_classes, 3
    feats = torch.from_numpy(gen.random((2, 13, 17, 256), np.float32)).to(
        dev, torch.bfloat16)
    flat = feats.reshape(-1, 256).float()
    at = gen.integers(0, flat.shape[0], spec.num_prototypes)
    protos = torch.stack([flat[i, s * 64:(s + 1) * 64] for s, (lo, hi) in
                          enumerate(spec.scale_bounds) for i in at[lo:hi]])
    mask = (spec.class_proto_index >= 0).astype(np.float32)
    gw = gen.random((c, g, spec.max_protos_per_class)) * mask[:, None, :]
    kw = dict(group_projection=torch.from_numpy(
        (gw / gw.sum(-1, keepdims=True)).astype(np.float32)).to(dev),
        last_layer_group=torch.from_numpy(gen.standard_normal(
            (c * g, c)).astype(np.float32) * 0.1).to(dev))
    got = kernels.fused_proto_logits(feats, protos, None, spec, **kw)
    want = proto_float64(feats, protos, None, spec, **kw)
    scale = want.abs().max()
    err = ((got - want).abs().max() / scale).item()
    plain = ((proto_plain(feats, protos, None, spec, **kw) - want).abs()
             .max() / scale).item()
    bound = rounding_bound(feats, protos, None, spec, **kw,
                           units=PROTO_DISTANCE_ERR)
    if bank == "cityscapes":
        bound = min(bound, PROTO_PUSHED_RTOL)
    assert err <= bound and plain <= bound, (err, plain, bound)


@pytest.mark.parametrize("bank", list(BANKS))
def test_proto_kernel_distance_error(dev, gen, bank):
    """The sparse probe (features and prototypes non-zero on four
    coordinates a scale) under an identity plain head, whose logits are
    the activations: the distances behind them within
    ``PROTO_DISTANCE_ERR`` units of fp32 rounding of the float64 ones."""
    a = _bank(bank, 0).num_active_prototypes
    spec = ProtoSpec.equal_allocation(a, 64, num_classes=a)
    x = np.zeros((2, 13, 17, 4, 64), np.float32)
    x[..., :4] = 0.5 + 0.5 * gen.random((2, 13, 17, 4, 4))
    feats = torch.from_numpy(x.reshape(2, 13, 17, 256)).to(dev,
                                                            torch.bfloat16)
    p = np.zeros((a, 64), np.float32)
    p[:, :4] = 0.5 + 0.5 * gen.random((a, 4))
    protos = torch.from_numpy(p).to(dev)
    act = kernels.fused_proto_logits(feats, protos,
                                     torch.eye(a, device=dev), spec)
    assert distance_error(act, feats, protos, spec) <= PROTO_DISTANCE_ERR


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


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 65, 65, 19), (513, 513)),     # an eval crop: rows start unaligned
    ((1, 9, 11, 2), (70, 83)),         # two classes; ragged bands, spans
    ((2, 33, 41, 182), (257, 330)),    # COCO-Stuff's classes
    ((1, 61, 81, 182), (480, 640)),    # and one of its image sizes
    ((1, 5, 300, 7), (37, 2400)),      # spans of one band side by side
    ((2, 512, 512, 2), (512, 512)),    # EM: two classes at scale 1
])
def test_upsample_kernel_shapes(dev, gen, shape, out_hw):
    lg = torch.from_numpy(gen.standard_normal(shape).astype(
        np.float32)).to(dev)
    got = kernels.fused_upsample_argmax(lg, *out_hw).cpu().numpy()
    want = upsample_argmax_plain(lg, *out_hw).cpu().numpy()
    top2 = torch.topk(resize_bilinear_matrix(lg, *out_hw), 2, dim=-1)[0]
    decided = ((top2[..., 0] - top2[..., 1]) >= 1e-5).cpu().numpy()
    assert got.dtype == np.uint8 and decided.mean() > 0.9
    np.testing.assert_array_equal(got[decided], want[decided])


def test_upsample_kernel_int32_labels(dev, gen):
    lg = torch.from_numpy(gen.standard_normal((1, 6, 7, 300)).astype(
        np.float32)).to(dev)
    got = kernels.fused_upsample_argmax(lg, 45, 53)
    want = upsample_argmax_plain(lg, 45, 53)
    assert got.dtype == torch.int32
    top2 = torch.topk(resize_bilinear_matrix(lg, 45, 53), 2, dim=-1)[0]
    decided = (top2[..., 0] - top2[..., 1]) >= 1e-5
    assert torch.equal(got[decided], want[decided])


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
                                   (70, 64, 256),
                                   # the MSC pyramid's smallest map at a
                                   # 513 input (33 x 33): layer4 and 5
                                   (1089, 1024, 256), (1089, 512, 2048)])
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


@pytest.mark.parametrize("k,n", [(64, 128), (64, 2048), (2048, 128),
                                 (2048, 2048), (192, 384)])
@pytest.mark.parametrize("m", [1, 127, 129, 66306])
def test_int8_mm_edges_are_bit_exact(dev, gen, m, k, n):
    """Row counts around the 128-row tile and the path's 66306, one K step
    (K = 64: half a 128-byte chunk) and many, N of half a 256-column tile
    and of eight: all three modes bit for bit against the plain version."""
    a, bt = _int8(gen, (m, k), dev), _int8(gen, (n, k), dev)
    sx = torch.tensor(3e-3, device=dev)
    sw = torch.from_numpy(gen.random(n, np.float32) * 1e-3 + 1e-5).to(dev)
    for scales in ((), (sx, sw, torch.float32), (sx, sw, torch.bfloat16)):
        got = kernels.int8_mm(a, bt, *scales)
        torch.cuda.synchronize()
        assert torch.equal(got, int8_mm_plain(a, bt, *scales))


def test_int8_mm_bf16_arm_matches_plain(dev, gen):
    a = torch.from_numpy(gen.standard_normal((8192, 512)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bt = torch.from_numpy(gen.standard_normal((512, 512)).astype(
        np.float32)).to(dev, torch.bfloat16)
    got = kernels.int8_mm(a, bt)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, int8_mm_plain(a, bt), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("shape,dil", [
    ((2, 17, 33, 256, 256), 2),
    ((1, 9, 130, 512, 512), 4),
    ((2, 3, 5, 64, 128), 4),        # smaller than the dilation; C = 64
    ((1, 33, 17, 256, 256), 2),     # H = 1 mod 32, W = 1 mod 8, as 129 x 257
    ((2, 65, 9, 512, 512), 4),      # the same edges at layer5's width
    ((1, 40, 44, 192, 256), 20),    # taps staged one by one; C % 128 = 64
    ((1, 33, 33, 256, 256), 2),     # the MSC pyramid's smallest map at a
    ((1, 33, 33, 512, 512), 4),     # 513 input, layer4 and layer5
])
def test_int8_conv3x3_matches_plain(dev, gen, shape, dil):
    """The nine-tap accumulator bit for bit against a float64 conv of the
    int8 values, and the same bits on a second call; maps whose last patch
    holds one row and one column, maps smaller than the dilation (every
    shifted tap partly outside); the dequantized bf16 and fp32 forms bit
    for bit too."""
    b, h, w, c, n = shape
    x, wt = _int8(gen, (b, h, w, c), dev), _int8(gen, (9, n, c), dev)
    before = kernels.int8_conv3x3.launches
    got = kernels.int8_conv3x3(x, wt, dil)
    torch.cuda.synchronize()
    assert kernels.int8_conv3x3.launches == before + 1
    assert torch.equal(got, int8_conv3x3_plain(x, wt, dil))
    assert torch.equal(got, kernels.int8_conv3x3(x, wt, dil))
    sx = torch.tensor(2e-3, device=dev)
    sw = torch.from_numpy(gen.random(n, np.float32) * 1e-3 + 1e-5).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(
            kernels.int8_conv3x3(x, wt, dil, sx, sw, dtype),
            int8_conv3x3_plain(x, wt, dil, sx, sw, dtype))


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


# ---------------------------------------------------------------------------
# push and the group step on the card
# ---------------------------------------------------------------------------
def _narrow_group_model(spec, seed=0, grouped=True):
    """A one-block-per-stage DeepLabV2 (full ASPP widths, so K2 runs) with
    a group head (or with ``grouped=False`` the plain head) over ``spec``
    and seeded synthetic weights."""
    from scaleprotoseg_torch.models.deeplab import DeepLabV2
    from scaleprotoseg_torch.models.ppnet import PPNet
    from scaleprotoseg_torch.checkpoints.convert import synthetic_state_dict
    backbone = DeepLabV2(n_out=64, n_blocks=(1, 1, 1, 1),
                         atrous_rates=(6, 12, 18, 24), aspp_mode="concat")
    model = PPNet(backbone, spec, grouped=grouped)
    sd = synthetic_state_dict(model, seed)
    for key in sd:      # bounded activations, as chip_smoke.write_run
        if key.endswith(".increase.bn.weight"):
            sd[key] = sd[key] * np.float32(0.1)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def test_push_on_the_card_matches_the_cpu(dev, gen):
    """Push of a model in the bf16 training recipe (K2 on) runs the float32
    forward without K2 and TF32: on the card it finds the CPU's winners and
    vectors (atol 1e-5 where the best-to-second margin exceeds 1e-4), K2
    never launches, and the recipe is restored."""
    from scaleprotoseg_torch.push.push import push_prototypes
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19, num_groups=3)
    y = np.repeat(np.repeat(np.arange(20).reshape(4, 5), 17, 0), 14, 1)
    batches = [(gen.standard_normal((2, 65, 65, 3)).astype(np.float32),
                np.stack([np.roll(y[:65, :65], (i, 3 * s), (0, 1))
                          for s in (0, 1)]).astype(np.int32))
               for i in range(2)]
    cpu = _narrow_group_model(spec)
    card = _narrow_group_model(spec).to(dev)
    card.set_compute_dtype(torch.bfloat16)
    card.features.base.aspp.fast = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        want = push_prototypes(cpu, spec, _Loader(batches), dedup=False,
                               log=lambda _: None)
        before = kernels.fused_aspp.launches
        got = push_prototypes(card, spec, _Loader(batches), dedup=False,
                              log=lambda _: None)
        assert kernels.fused_aspp.launches == before
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert card.dtype == torch.bfloat16 and card.features.base.aspp.fast
    from scaleprotoseg_torch.ops.resize import resize_label_nearest
    cls = torch.as_tensor(spec.class_ids)
    masked = []
    with torch.no_grad():
        for x, t in batches:
            d = cpu.eval().push_forward(torch.from_numpy(x))[1]
            t = resize_label_nearest(torch.from_numpy(t), d.shape[1],
                                     d.shape[2]).long() - 1
            masked.append(torch.where(t[..., None] == cls, d, d + 1e10)
                          .reshape(-1, 228))
    two = torch.sort(torch.cat(masked), 0).values[:2]
    decided = ((two[1] - two[0]) > 1e-4 * (1 + two[0])).numpy()
    assert decided.mean() > 0.8, decided.mean()
    np.testing.assert_array_equal(got.winners[decided], want.winners[decided])
    np.testing.assert_array_equal(got.flat_idx[decided],
                                  want.flat_idx[decided])
    np.testing.assert_allclose(
        card.prototypes().detach().cpu().numpy()[decided],
        cpu.prototypes().detach().numpy()[decided], rtol=0, atol=1e-5)


def _analysis_run(root, gen, monkeypatch):
    """A tiny multiscale Cityscapes run (one ResNet block a stage, the
    config's bank) at ``push_final`` under ``root/results``, and a val
    split of 3 images of 41 x 81 with part ids, under ``root/city``."""
    import json
    import os
    import shutil

    from scaleprotoseg_torch import configlib
    from scaleprotoseg_torch.checkpoints.convert import (
        save_checkpoint, synthetic_state_dict)
    from scaleprotoseg_torch.cli_common import CONFIGS_DIR
    from scaleprotoseg_torch.constants import CITYSCAPES_19_EVAL_CATEGORIES
    from scaleprotoseg_torch.models import factory
    for name, (cfg, _, mode) in list(factory._BACKBONES.items()):
        monkeypatch.setitem(factory._BACKBONES, name,
                            (cfg, (1, 1, 1, 1), mode))
    config = os.path.join(CONFIGS_DIR, "scaleproto_cityscapes.gin")
    bindings = configlib.parse_config_file(config)
    q = bindings["construct_PPNet"]
    model, spec = factory.construct_ppnet(
        "multiscale", q["base_architecture"], tuple(q["prototype_shape"]),
        q["num_classes"], bindings=bindings)
    run = os.path.join(root, "results", "run")
    os.makedirs(os.path.join(run, "checkpoints"))
    shutil.copyfile(config, os.path.join(run, "config.gin"))
    save_checkpoint(os.path.join(run, "checkpoints", "push_final"),
                    synthetic_state_dict(model, seed=5), spec,
                    extra={"variant": "multiscale"})
    data = os.path.join(root, "city")
    for sub in ("img_with_margin_0", "annotations", "annotations_PIDS"):
        os.makedirs(os.path.join(data, sub, "val"))
    cats = [k for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items() if v > 0]
    ids = [f"val_{i}" for i in range(3)]
    for img_id in ids:
        label = np.repeat(np.repeat(gen.choice(cats, (2, 4)).astype(
            np.uint8), 21, 0), 21, 1)[:41, :81]
        parts = np.repeat(np.repeat(gen.integers(-1, 5, (6, 9)), 7, 0),
                          9, 1)[:41, :81].astype(np.int32)
        for sub, a in (("annotations", label), ("annotations_PIDS", parts),
                       ("img_with_margin_0", gen.integers(
                           0, 256, (41, 81, 3), dtype=np.uint8))):
            np.save(os.path.join(data, sub, "val", img_id + ".npy"), a)
    with open(os.path.join(data, "all_images.json"), "w") as f:
        json.dump({"train": [], "val": ids}, f)
    monkeypatch.setenv("RESULTS_DIR", os.path.join(root, "results"))
    monkeypatch.setenv("DATA_PATH_CITY", data)
    return run


def test_analysis_cli_turns_tf32_off_itself(dev, gen, tmp_path,
                                            monkeypatch):
    """An analysis CLI (consistency) entered with TF32 on, the library's
    default, runs every forward with TF32 off, writes the rows of one
    entered with it off, and leaves both flags as it found them."""
    import os

    from scaleprotoseg_torch.analysis.metrics import consistency
    from scaleprotoseg_torch.models.ppnet import PPNet
    run = _analysis_run(str(tmp_path), gen, monkeypatch)
    seen = []
    real = PPNet.push_forward

    def push_forward(self, x):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(self, x)

    monkeypatch.setattr(PPNet, "push_forward", push_forward)
    csv = os.path.join(run, "metrics", "push_final",
                       "part_presence_th_0.8_qt_0.8.csv")
    rows, scores = {}, {}
    for on in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            scores[on] = consistency.main(["run", "push_final", "cityscapes",
                                           "--device", "cuda"])
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (on, on)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        with open(csv) as f:
            rows[on] = f.read()
    assert seen and set(seen) == {(False, False)}
    assert rows[True] == rows[False] and rows[True].count("\n") > 3
    assert scores[True] == scores[False]


def test_group_step_projects_and_k1_follows(dev, gen):
    """A group joint micro-step on the card: the rows stay on the simplex
    after the projection, and K1's packed head (cached on the parameter
    versions) serves the projected weights, rtol = atol = 1e-4 against the
    plain head."""
    from scaleprotoseg_torch.train.optim import PhaseOptimizer, phase_groups
    from scaleprotoseg_torch.train.state import TrainState
    from scaleprotoseg_torch.train.steps import LossWeights, make_train_step
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19,
                                      num_groups=3).prune([3, 60, 61, 130])
    model = _narrow_group_model(spec).to(dev)
    model.set_compute_dtype(torch.bfloat16)
    model.features.base.aspp.fast = True
    hp = dict(joint_lr_group=1e-2, last_layer_lr=1e-2)
    opt = PhaseOptimizer(model.named_parameters(),
                         phase_groups("group", 1, hp))
    state = TrainState(model, opt)
    step = make_train_step(LossWeights(l1=1e-3, group_ent=0.05),
                           project_group_simplex=True)
    x = torch.from_numpy(gen.standard_normal((2, 65, 65, 3))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(gen.integers(0, 20, (2, 65, 65))
                         .astype(np.int32)).to(dev)
    with torch.no_grad():
        model.eval().fast_logits(x.to(torch.bfloat16))   # head cached
    before = [m.weight.detach().clone() for m in model.group_projection]
    metrics = step(state, x, y)
    assert torch.isfinite(metrics["loss"])
    rows = [m.weight.detach() for m in model.group_projection]
    assert not all(torch.equal(a, b) for a, b in zip(rows, before))
    for w in rows:
        assert bool((w >= 0).all())
        torch.testing.assert_close(w.sum(-1), torch.ones_like(w[:, 0]),
                                   rtol=0, atol=1e-5)
    model.eval()
    with torch.no_grad():
        xb = x.to(torch.bfloat16)
        got = model.fast_logits(xb)
        feats = model.conv_features(xb).contiguous()
        gw, glw = model.group_weights()
        want = proto_plain(feats, model.prototypes(), None, spec,
                           group_projection=gw, last_layer_group=glw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# purity pruning, its last-layer re-finetune and group thresholding
# ---------------------------------------------------------------------------
def _purity_pruned_spec(groups=0):
    """Cityscapes' bank with scattered prototypes and all of class 4 gone,
    as purity pruning leaves it."""
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19,
                                      num_groups=groups)
    return spec.prune([3, 60, 61, 130, 227] + [
        p for p, c in enumerate(spec.class_ids) if c == 4])


def _head_kw(model):
    if model.grouped:
        gw, glw = model.group_weights()
        return dict(last_layer=None, group_projection=gw,
                    last_layer_group=glw)
    return dict(last_layer=model.last_layer.weight.t())


def test_last_layer_step_rebuilds_k1_head(dev, gen):
    """A phase-2 micro-step (the pruned re-finetune) on the card writes the
    last layer in place: K1's packed head, cached before the step, is
    rebuilt, and ``fast_logits`` after the step equals the plain head on
    the new weights (rtol = atol = 1e-4); nothing else moved."""
    from scaleprotoseg_torch.train.optim import PhaseOptimizer, phase_groups
    from scaleprotoseg_torch.train.state import TrainState
    from scaleprotoseg_torch.train.steps import LossWeights, make_train_step
    spec = _purity_pruned_spec()
    model = _narrow_group_model(spec, grouped=False).to(dev)
    model.set_compute_dtype(torch.bfloat16)
    model.features.base.aspp.fast = True
    state = TrainState(model, PhaseOptimizer(
        model.named_parameters(),
        phase_groups("multiscale", 2, dict(last_layer_lr=1e-2))))
    step = make_train_step(LossWeights(l1=1e-4))
    x = torch.from_numpy(gen.standard_normal((2, 65, 65, 3))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(gen.integers(0, 20, (2, 65, 65))
                         .astype(np.int32)).to(dev)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        stale = model.eval().fast_logits(xb)           # head cached
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    grads = (kernels.aspp_grad_pack.launches,
             kernels.aspp_grad_weight.launches)
    assert torch.isfinite(step(state, x, y)["loss"])
    assert (kernels.aspp_grad_pack.launches,
            kernels.aspp_grad_weight.launches) == grads
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) != (k == "last_layer.weight"), k
    model.eval()
    with torch.no_grad():
        got = model.fast_logits(xb)
        feats = model.conv_features(xb).contiguous()
        want = proto_plain(feats, model.prototypes(), spec=spec,
                           **_head_kw(model))
    assert not torch.allclose(got, stale, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("head", ["purity_pruned", "thresholded_group"])
def test_k1_at_pruned_and_thresholded_heads(dev, gen, head):
    """K1 at the heads of this slice's checkpoints: a purity-pruned plain
    head (class 4 emptied) and a group head whose projection entries below
    0.1 are zeroed, rows not re-normalised.  On the model's own features,
    against the plain head (rtol = atol = 1e-4) and, with every prototype
    moved onto a pixel's features (d = 0 there), against the float64 head
    within ``PROTO_PUSHED_RTOL`` of its largest logit."""
    grouped = head == "thresholded_group"
    spec = _purity_pruned_spec(3 if grouped else 0)
    model = _narrow_group_model(spec, grouped=grouped).to(dev).eval()
    model.set_compute_dtype(torch.bfloat16)
    model.features.base.aspp.fast = True
    if grouped:
        with torch.no_grad():
            for m in model.group_projection:
                m.weight.copy_(torch.where(m.weight < 0.1,
                                           torch.zeros_like(m.weight),
                                           m.weight))
        sums = torch.cat([m.weight.sum(-1) for m in model.group_projection])
        assert bool((sums < 1 - 1e-6).any())
    x = torch.from_numpy(gen.standard_normal((2, 65, 65, 3))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    with torch.no_grad():
        feats = model.conv_features(x).contiguous()
        got = model.fast_logits(x)
        want = proto_plain(feats, model.prototypes(), spec=spec,
                           **_head_kw(model))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        flat = feats.reshape(-1, 256).float()
        at = gen.integers(0, flat.shape[0], spec.num_prototypes)
        pushed = torch.stack([flat[at[p], s * 64:(s + 1) * 64]
                              for s, (lo, hi) in enumerate(spec.scale_bounds)
                              for p in range(lo, hi)])
        model.prototype_vectors.copy_(pushed.view_as(model.prototype_vectors))
        got = model.fast_logits(x)
        exact = proto_float64(feats, model.prototypes(), spec=spec,
                              **_head_kw(model))
    err = ((got - exact).abs().max() / exact.abs().max()).item()
    assert err <= PROTO_PUSHED_RTOL, err


def test_find_nearest_on_the_card_matches_the_cpu(dev, gen):
    """The k-nearest-patch scan of a model in the bf16 recipe runs the
    float32 forward without K2 and TF32: on the card it finds the CPU's
    images, pixels and labels wherever the CPU's distances decide them
    (1e-4 (1 + d) apart), its distances within 1e-5 relative, and K2
    never launches."""
    from scaleprotoseg_torch.find_nearest import (
        find_k_nearest_patches_to_prototypes, nearest_patches)
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19)
    y = np.repeat(np.repeat(np.arange(20).reshape(4, 5), 17, 0), 14, 1)
    batches = [(gen.standard_normal((2, 65, 65, 3)).astype(np.float32),
                np.stack([np.roll(y[:65, :65], (5 * i, 3 * s), (0, 1))
                          for s in (0, 1)]).astype(np.int32))
               for i in range(4)]
    cpu = _narrow_group_model(spec, grouped=False)
    card = _narrow_group_model(spec, grouped=False).to(dev)
    card.set_compute_dtype(torch.bfloat16)
    card.features.base.aspp.fast = True
    loader = _Loader(batches)
    quiet = dict(log=lambda _: None)
    want = nearest_patches(loader, cpu, spec, 6, **quiet)
    want_labels = find_k_nearest_patches_to_prototypes(loader, cpu, spec,
                                                       **quiet)
    before = kernels.fused_aspp.launches
    got = nearest_patches(loader, card, spec, 6, **quiet)
    got_labels = find_k_nearest_patches_to_prototypes(loader, card, spec,
                                                      **quiet)
    assert kernels.fused_aspp.launches == before
    assert card.dtype == torch.bfloat16 and card.features.base.aspp.fast
    d = want[0]
    gap = np.diff(np.concatenate([d, np.full((len(d), 1), np.inf)], 1), 1)
    ok = gap > 1e-4 * (1 + d)
    ok &= np.concatenate([np.ones((len(d), 1), bool), ok[:, :-1]], 1)
    assert ok.mean() > 0.8, ok.mean()
    np.testing.assert_allclose(got[0], d, rtol=1e-5)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g[ok], w[ok])
    np.testing.assert_array_equal(got_labels[ok], want_labels[ok])


def _op_case(name, gen, dev):
    """(wrapper call, the same work as a direct ``scaleprotoseg::`` op call,
    the wrapper whose count a launch raises) at small shapes."""
    ops = torch.ops.scaleprotoseg
    t = lambda a, dt=None: torch.from_numpy(a).to(dev, dt)  # noqa: E731
    if name == "fused_aspp":
        x = t(gen.random((2, 21, 37, 512), np.float32), torch.bfloat16)
        ws = [t(gen.standard_normal((3, 3, 512, 64)).astype(np.float32)
                * 0.02) for _ in range(4)]
        bs = [t(gen.standard_normal(64).astype(np.float32))
              for _ in range(4)]
        return (lambda: kernels.fused_aspp(x, ws, bs),
                lambda: ops.fused_aspp(x, ws, bs, [6, 12, 18, 24], None,
                                       None), kernels.fused_aspp)
    if name == "fused_proto_logits":
        from scaleprotoseg_torch.kernels.proto import pack_head
        spec = ProtoSpec.equal_allocation(228, 64, num_classes=19,
                                          num_groups=3)
        feats = t(gen.random((2, 13, 17, 256), np.float32), torch.bfloat16)
        protos = t(gen.random((228, 64), np.float32))
        mask = (spec.class_proto_index >= 0).astype(np.float32)
        gw = t(gen.random((19, 3, spec.max_protos_per_class), np.float32)
               * mask[:, None, :])
        glw = t(gen.standard_normal((57, 19)).astype(np.float32) * 0.1)
        head = pack_head(protos, None, spec, gw, glw)
        bounds = [i for b in spec.scale_bounds for i in b]
        return (lambda: kernels.fused_proto_logits(feats, protos, None, spec,
                                                   gw, glw, head=head),
                lambda: ops.fused_proto_logits(
                    feats, protos, None, gw, glw, head.bank, head.steps,
                    head.chunk_pn, head.table, head.glw_pad, 19, 64, 3,
                    list(spec.class_ids), bounds),
                kernels.fused_proto_logits)
    if name == "fused_upsample_argmax":
        logits = t(gen.standard_normal((2, 9, 11, 19)).astype(np.float32))
        return (lambda: kernels.fused_upsample_argmax(logits, 65, 81),
                lambda: ops.fused_upsample_argmax(logits, 65, 81),
                kernels.fused_upsample_argmax)
    if name == "int8_mm":
        a = t(gen.integers(-127, 128, (1000, 256)).astype(np.int8))
        bt = t(gen.integers(-127, 128, (128, 256)).astype(np.int8))
        sx = t(np.array(0.02, np.float32))
        sw = t(gen.random(128, np.float32) * 0.01)
        return (lambda: kernels.int8_mm(a, bt, sx, sw, torch.bfloat16),
                lambda: ops.int8_mm(a, bt, sx, sw, torch.bfloat16),
                kernels.int8_mm)
    if name == "int8_conv3x3":
        x = t(gen.integers(-127, 128, (2, 9, 10, 64)).astype(np.int8))
        wt = t(gen.integers(-127, 128, (9, 128, 64)).astype(np.int8))
        return (lambda: kernels.int8_conv3x3(x, wt, 2),
                lambda: ops.int8_conv3x3(x, wt, 2, None, None, None),
                kernels.int8_conv3x3)
    x = t(gen.standard_normal(4096).astype(np.float32), torch.bfloat16)
    if name == "quantize_int8":
        scale = t(np.array(0.03, np.float32))
        return (lambda: kernels.quantize_int8(x, scale),
                lambda: ops.quantize_int8(x, scale, False),
                kernels.quantize_int8)
    return (lambda: kernels.int8_absmax(x), lambda: ops.int8_absmax(x),
            kernels.int8_absmax)


@pytest.mark.parametrize("name", ["fused_aspp", "fused_proto_logits",
                                  "fused_upsample_argmax", "int8_mm",
                                  "int8_conv3x3", "quantize_int8",
                                  "int8_absmax"])
def test_registered_op_launches_the_kernel(dev, gen, name):
    """Each ``scaleprotoseg::`` op called directly on CUDA tensors is the
    wrapper's kernel: one launch counted, the same bits."""
    wrapper, op, counted = _op_case(name, gen, dev)
    want = wrapper()
    before = counted.launches
    got = op()
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


def _tiny_flagship(seed=0, dtype=torch.float32):
    """The flagship at full widths and tiny depth, seeded weights; the
    add-on computes in ``dtype``."""
    from scaleprotoseg_torch.checkpoints.convert import (synthetic_state_dict,
                                                         to_tensors)
    from scaleprotoseg_torch.models.deeplab import DeepLabV2
    from scaleprotoseg_torch.models.ppnet import PPNet
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19, num_groups=3)
    model = PPNet(DeepLabV2(n_out=64, n_blocks=(1, 1, 2, 1)), spec,
                  grouped=True, dtype=dtype)
    model.load_state_dict(to_tensors(synthetic_state_dict(model, seed)))
    return model.eval()


def test_fast_artifact_round_trip_on_the_card(dev, gen, tmp_path):
    """A bf16 fast artifact exported on the card holds K1, K2 and K3 as op
    nodes; loaded again it launches each once a batch and gives the eager
    fast path's labels bit for bit."""
    from scaleprotoseg_torch.models.layers import cast_convs
    from scaleprotoseg_torch.serving.export import (export_serving,
                                                    load_artifact,
                                                    make_serving_fn,
                                                    save_artifact)
    model = cast_convs(_tiny_flagship(dtype=torch.bfloat16),
                       torch.bfloat16).to(dev)
    model.features.base.aspp.fast = True
    raw = torch.from_numpy(gen.integers(0, 256, (2, 65, 81, 3)).astype(
        np.uint8)).to(dev)
    want = make_serving_fn(model, fast=True, normalize_to=torch.bfloat16)(raw)
    exported = export_serving(model, height=65, width=81, batch=2,
                              input_dtype=torch.bfloat16, fast=True,
                              device_preprocess=True)
    save_artifact(str(tmp_path), exported, spec=model.spec)
    served = load_artifact(str(tmp_path))
    assert served.meta["platforms"] == ["cuda"]
    kernels.reset_launch_counts()
    got = served.predict(raw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["aspp"], counts["proto"], counts["upsample"]) == (1, 1, 1)
    assert torch.equal(got, want)


def test_cpu_exported_plain_artifact_moves_to_the_card(dev, gen, tmp_path):
    """A float32 plain artifact exported on the CPU for both platforms
    serves on the card (``move_to_device_pass``) with the labels of the
    same model's eager forward there."""
    from scaleprotoseg_torch.serving.export import (export_serving,
                                                    load_artifact,
                                                    make_serving_fn,
                                                    save_artifact)
    model = _tiny_flagship(seed=1)
    exported = export_serving(model, height=33, width=33, batch=None,
                              input_dtype=torch.float32,
                              platforms=("cpu", "cuda"))
    save_artifact(str(tmp_path), exported, spec=model.spec)
    served = load_artifact(str(tmp_path), device="cuda")
    x = torch.from_numpy(gen.standard_normal((3, 33, 33, 3)).astype(
        np.float32)).to(dev)
    want = make_serving_fn(model.to(dev))(x)
    assert torch.equal(served.predict(x), want)
