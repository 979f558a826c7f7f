#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

1. device: torch / CUDA versions and the card's name and power limit;
2. build: every kernel from ``scaleprotoseg_torch/csrc``, one ``nvcc``
   per source, all started together;
3. kernels: K2 (ASPP), K1 (prototype head) and K3 (upsample + argmax) at
   the flagship serving shapes (batch 2 at 1024 x 2048), each against its
   plain PyTorch version on the same inputs: K2 within 2 bf16 ulps of
   the fp32-accumulated plain form, K1 rtol = atol = 1e-4 in fp32 with
   TF32 off on the plain side, K3 labels equal wherever the plain
   version's top-two margin is at least 1e-5.  K2's backward at the
   training shapes (batch 2 at 65 x 65 x 2048): ``aspp_grad_pack`` bit
   for bit against the plain pack, ``aspp_grad_weight`` within rtol =
   atol = 1e-3 of the fp32 plain product (TF32 off) and the same bits on
   a second run, and the whole ``aspp_trainable`` backward against
   autograd through the plain form (dx within 2 bf16 ulps, dW and db
   within 1e-3 of their scale).  Times are CUDA-event medians of 10 runs
   after warmup, beside the plain version, one PyTorch library call
   computing the same function (a yardstick the port never calls) and
   the least time the card could take;
4. serving slice: a temporary run directory (the Cityscapes group
   config, seeded synthetic weights for the full-depth ResNet-101
   flagship, 256 seeded uint8 1024 x 2048 images) served three times
   through ``scaleprotoseg_torch.serving.serve.main`` at batch 2, a timed
   window of several seconds each.  Every serving kernel must launch at
   least once per batch of every run, and the labels must agree with the
   port's plain path (same bf16 model, plain versions instead of kernels)
   on at least 99% of pixels.  Per run: img/s and the device's idle share
   of the timed window (``ServingEngine``'s per-batch stream spans);
5. training slice: a temporary Cityscapes-layout data root (24 train and
   4 val seeded uint8 1024 x 2048 images, raw category-index labels in
   blocks holding void and every train class) trained through
   ``scaleprotoseg_torch.train_wandb_multiscale.main --gpu-recipe`` on
   the full-depth flagship backbone: 20 warm-up and 40 joint micro-steps
   (``iter_size`` 5), a validation every 20.  Per phase: every micro-step's
   loss finite, K2's forward launched once per micro-step and validation
   batch, both backward kernels once per micro-step; training img/s,
   median step ms (CUDA events) and the device's idle share past the
   first 3 steps.  Then one micro-step of the kernel path against the
   plain path (same bf16 model and batch; plain K2 forward and backward):
   loss within 1e-3, ASPP-weight and prototype gradients within 2e-2
   relative L2.  Finally ``push_final`` loads through ``load_model`` and
   serves one finite batch;
6. one line per kernel with its times, bound and launches, the kernels
   line (K1-K4 with their status), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     save_checkpoint,
                                                     synthetic_state_dict)
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.constants import CITYSCAPES_19_EVAL_CATEGORIES
from scaleprotoseg_torch.kernels.aspp import (aspp_plain, aspp_trainable,
                                              grad_pack_plain,
                                              grad_weight_plain, pack_weights,
                                              shifted_sum)
from scaleprotoseg_torch.kernels.proto import pack_head, proto_plain
from scaleprotoseg_torch.kernels.upsample import upsample_argmax_plain
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.ops.prototype import EPSILON
from scaleprotoseg_torch.ops.resize import _bilinear_matrix
from scaleprotoseg_torch.serving import serve
from scaleprotoseg_torch.serving.export import make_serving_fn
from scaleprotoseg_torch.spec import ProtoSpec

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

B, HEIGHT, WIDTH = 2, 1024, 2048
FH, FW = 129, 257             # output-stride-8 grid of 1024 x 2048
TH = TW = 65                  # output-stride-8 grid of a 513 x 513 crop
RATES = (6, 12, 18, 24)
N_IMAGES = 256                # ~5 s of serving per run at ~50 img/s
SERVE_RUNS = 3
N_TRAIN, N_VAL = 24, 4
WARMUP_STEPS, JOINT_STEPS, VAL_EVERY = 20, 40, 20
SERVING_KERNELS = ("aspp", "proto", "upsample")
TRAINING_KERNELS = ("aspp", "aspp_grad_pack", "aspp_grad_weight")

CONFIG = """\
PPNetMultiScale.num_groups = 3
PPNetMultiScale.num_scales = 4
construct_PPNet_Group.add_on_layers_type = 'deeplab_simple'
construct_PPNet_Group.base_architecture = 'deeplabv2_resnet101_multiscale'
construct_PPNet_Group.num_classes = 19
construct_PPNet_Group.pretrained = False
construct_PPNet_Group.prototype_activation_function = 'log'
construct_PPNet_Group.prototype_shape = (228, 64, 1, 1)
construct_PPNet_Group.scale_head_type = None
deeplabv2_resnet101_features_multiscale.deeplab_n_features = 64
deeplabv2_resnet101_features_multiscale.scales = []
"""

STILL_TO_PORT = [{
    "name": "pallas_mm",
    "replaces": "benchmarks/bench_int8_mosaic.py:34 pallas_mm "
                "(pallas_call :48)"}]

BWD = "scaleprotoseg_tpu/ops/pallas_aspp.py:319 fused_aspp_trainable bwd"
SOURCES = {"aspp": "aspp", "aspp_grad_pack": "aspp_bwd",
           "aspp_grad_weight": "aspp_bwd", "proto": "proto",
           "upsample": "upsample"}
REPLACES = {
    "aspp": "scaleprotoseg_tpu/ops/pallas_aspp.py:68 fused_aspp "
            "(pallas_call :169)",
    "aspp_grad_pack": BWD + " (shifted-gradient pack G, :349-360)",
    "aspp_grad_weight": BWD + " (dW_all = x^T G, :369-370)",
    "proto": "scaleprotoseg_tpu/ops/pallas_proto.py:99 fused_proto_logits "
             "(pallas_call :173)",
    "upsample": "scaleprotoseg_tpu/ops/pallas_upsample.py:127 "
                "fused_upsample_argmax (_apply :62, pallas_call :96)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median CUDA-event time of ``fn()`` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------
def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return smi


def build_phase() -> None:
    t0 = time.perf_counter()
    report = kernels.build()
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build {name}: {r['seconds']:.1f} s  " + " | ".join(ptxas))
    log(f"build: {time.perf_counter() - t0:.1f} s wall")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_aspp(gen, dev) -> dict:
    c, f = 2048, 64
    x = torch.rand((B, FH, FW, c), generator=gen, device=dev) \
        .to(torch.bfloat16)
    std = math.sqrt(2.0 / (9 * c))
    ws = [torch.randn((3, 3, c, f), generator=gen, device=dev) * std
          for _ in RATES]
    bs = [torch.randn((f,), generator=gen, device=dev) * 0.1 for _ in RATES]
    # packed once, as the model packs its weights once
    packed = pack_weights(ws, bs)
    got = kernels.fused_aspp(x, ws, bs, RATES, packed).float()
    want = aspp_plain(x, ws, bs, RATES).float()
    mag = torch.maximum(want.abs(), want.abs().max() * 2.0 ** -10)
    ulps = ((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
            ).max().item()
    err = (got - want).abs().max().item()
    if not ulps <= 2:
        raise AssertionError(f"aspp: {ulps} bf16 ulps from the plain form")
    xc = x.permute(0, 3, 1, 2)                       # channels_last view
    w_oihw = [w.permute(3, 2, 0, 1).to(torch.bfloat16) for w in ws]
    b_bf = [b.to(torch.bfloat16) for b in bs]

    def library():
        return torch.cat([F.conv2d(xc, w, b, padding=r, dilation=r)
                          for w, b, r in zip(w_oihw, b_bf, RATES)], dim=1)

    # work the function must do: only taps that land inside the image
    flops = valid_tap_flops(FH, FW, c, f)
    moved = nbytes(x, got.to(torch.bfloat16)) + len(RATES) * (
        9 * c * f * 2 + f * 4)
    b_ms, b_by = bound(moved, flops, PEAK_BF16_FLOPS)
    return dict(
        name="aspp", max_abs_err=err,
        device_ms=device_kernel_ms(
            lambda: kernels.fused_aspp(x, ws, bs, RATES, packed),
            "aspp_kernel"),
        ms=time_ms(lambda: kernels.fused_aspp(x, ws, bs, RATES, packed)),
        plain_ms=time_ms(lambda: aspp_plain(x, ws, bs, RATES)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def check_proto(gen, dev) -> dict:
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19, num_groups=3)
    c, g, a = 19, 3, spec.num_active_prototypes
    feats = torch.rand((B, FH, FW, 256), generator=gen, device=dev) \
        .to(torch.bfloat16)
    protos = torch.rand((228, 64), generator=gen, device=dev)
    gw = torch.rand((c, g, spec.max_protos_per_class), generator=gen,
                    device=dev) + 1e-3
    gw = gw / gw.sum(-1, keepdim=True)
    glw = torch.randn((c * g, c), generator=gen, device=dev) * \
        math.sqrt(2.0 / (c * g))
    kw = dict(group_projection=gw, last_layer_group=glw)
    # packed once, as the model packs its head once
    head = pack_head(protos, None, spec, **kw)
    got = kernels.fused_proto_logits(feats, protos, None, spec, **kw,
                                     head=head)
    want = proto_plain(feats, protos, None, spec, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    err = (got - want).abs().max().item()

    # yardstick: the TPU kernel's block-diagonal matmul chain, in torch
    pd = torch.zeros((256, a), device=dev)
    mt = torch.zeros((256, a), device=dev)
    for s, (lo, hi) in enumerate(spec.scale_bounds):
        pd[s * 64:(s + 1) * 64, lo:hi] = protos[lo:hi].t()
        mt[s * 64:(s + 1) * 64, lo:hi] = 1.0
    pn = (protos[:a] ** 2).sum(-1)
    gw_dense = torch.zeros((a, c * g), device=dev)
    for cls in range(c):
        idx = spec.class_proto_index[cls]
        idx = idx[idx >= 0]
        gw_dense[idx, cls * g:(cls + 1) * g] = gw[cls, :, :len(idx)].t()

    def library():
        xf = feats.reshape(-1, 256).float()
        d = torch.relu((xf * xf) @ mt - 2.0 * (xf @ pd) + pn)
        act = torch.log((d + 1.0) / (d + EPSILON))
        return torch.exp(act @ gw_dense) @ glw

    n = B * FH * FW
    flops = n * (2 * 256 + a * (2 * 64 + 6) + a * g * 2 + c * g
                 + c * g * c * 2)
    moved = nbytes(feats, protos, gw, glw, got)
    b_ms, b_by = bound(moved, flops, PEAK_FP32_FLOPS)
    return dict(
        name="proto", max_abs_err=err,
        device_ms=device_kernel_ms(lambda: kernels.fused_proto_logits(
            feats, protos, None, spec, **kw, head=head), "proto_kernel"),
        ms=time_ms(lambda: kernels.fused_proto_logits(
            feats, protos, None, spec, **kw, head=head)),
        plain_ms=time_ms(lambda: proto_plain(feats, protos, None, spec,
                                             **kw)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def check_upsample(gen, dev) -> dict:
    c = 19
    lg = torch.randn((B, FH, FW, c), generator=gen, device=dev)
    got = kernels.fused_upsample_argmax(lg, HEIGHT, WIDTH)
    want = upsample_argmax_plain(lg, HEIGHT, WIDTH)
    # the plain version's upsampled values, for the top-two margin
    mx = torch.einsum("bhwc,pw->bhpc", lg, torch.as_tensor(
        _bilinear_matrix(WIDTH, FW), device=dev))
    up = torch.einsum("oh,bhpc->bopc", torch.as_tensor(
        _bilinear_matrix(HEIGHT, FH), device=dev), mx)
    top2 = torch.topk(up, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) >= 1e-5
    del mx, up, top2
    diff = got.int() != want.int()
    mismatch = int((diff & decided).sum())
    log(f"upsample: {int(diff.sum())} labels differ from the plain version, "
        f"{mismatch} of them where the margin is >= 1e-5; "
        f"{int((~decided).sum())} near-tie pixels")
    if mismatch:
        raise AssertionError(f"upsample: {mismatch} decided labels differ")
    err = float((got.int() - want.int()).abs()[decided].max())

    def library():
        return F.interpolate(lg.permute(0, 3, 1, 2), size=(HEIGHT, WIDTH),
                             mode="bilinear",
                             align_corners=False).argmax(dim=1)

    # separable interpolation: W taps per (class, source row, out column),
    # H taps and one comparison per (class, output pixel)
    flops = B * c * (FH * WIDTH * 3 + HEIGHT * WIDTH * 4)
    b_ms, b_by = bound(nbytes(lg, got), flops, PEAK_FP32_FLOPS)
    return dict(
        name="upsample", max_abs_err=err,
        device_ms=device_kernel_ms(
            lambda: kernels.fused_upsample_argmax(lg, HEIGHT, WIDTH),
            "upsample_argmax_kernel"),
        ms=time_ms(lambda: kernels.fused_upsample_argmax(lg, HEIGHT, WIDTH)),
        plain_ms=time_ms(lambda: upsample_argmax_plain(lg, HEIGHT, WIDTH)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def valid_tap_flops(h: int, w: int, c: int, f: int) -> float:
    """Operations of a concat-ASPP product over (h, w, c) -> 4 x f that
    only counts the taps landing inside the image, batch B."""
    taps = 0
    for r in RATES:
        for d in (-r, 0, r):
            for e in (-r, 0, r):
                taps += max(h - abs(d), 0) * max(w - abs(e), 0)
    return 2.0 * B * taps * c * f


def check_aspp_backward(gen, dev) -> list:
    """K2's backward kernels at the training shapes (batch 2, 65 x 65 x
    2048 bf16): the pack bit for bit, dW within 1e-3 of the fp32 plain
    product and deterministic, and the whole Function backward against
    autograd through the plain form."""
    c, f = 2048, 64
    x = torch.rand((B, TH, TW, c), generator=gen, device=dev) \
        .to(torch.bfloat16)
    std = math.sqrt(2.0 / (9 * c))
    ws = [torch.randn((3, 3, c, f), generator=gen, device=dev) * std
          for _ in RATES]
    bs = [torch.randn((f,), generator=gen, device=dev) * 0.1 for _ in RATES]
    g = torch.randn((B, TH, TW, len(RATES) * f), generator=gen,
                    device=dev).to(torch.bfloat16)
    x2d = x.reshape(-1, c)

    packed_g = kernels.aspp_grad_pack(g, RATES, f)
    if not torch.equal(packed_g, grad_pack_plain(g, RATES, f)):
        raise AssertionError("aspp_grad_pack differs from the plain pack")
    dw = kernels.aspp_grad_weight(x2d, packed_g)
    dw_plain = grad_weight_plain(x2d, packed_g)
    torch.testing.assert_close(dw, dw_plain, rtol=1e-3, atol=1e-3)
    if not torch.equal(dw, kernels.aspp_grad_weight(x2d, packed_g)):
        raise AssertionError("aspp_grad_weight is not deterministic")
    dw_err = (dw - dw_plain).abs().max().item()

    # the whole backward: the Function against autograd through the plain
    # form on x upcast (36 tap gradients added in fp32, rounded once) and
    # on the bf16-rounded weights (the rounding passed through, so dW
    # stays fp32)
    def grads(fn):
        xs = x.clone().requires_grad_()
        wv = [w.clone().requires_grad_() for w in ws]
        bv = [b.clone().requires_grad_() for b in bs]
        fn(xs, wv, bv).backward(g)
        return [xs.grad] + [w.grad for w in wv] + [b.grad for b in bv]

    got = grads(lambda a, w, b: aspp_trainable(a, w, b, RATES))
    want = grads(lambda a, w, b: shifted_sum(
        a.float(), [wt + (wt.to(torch.bfloat16).float() - wt).detach()
                    for wt in w], b, RATES).to(torch.bfloat16))
    gx, wx = got[0].float(), want[0].float()
    mag = torch.maximum(wx.abs(), wx.abs().max() * 2.0 ** -10)
    ulps = ((gx - wx).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
            ).max().item()
    if not ulps <= 2:
        raise AssertionError(f"aspp backward dx: {ulps} bf16 ulps")
    rel = []
    for a, b in zip(got[1:], want[1:]):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3 * scale)
        rel.append((a - b).abs().max().item() / scale)
    log(f"aspp backward: dx within {ulps:g} bf16 ulps, dW/db within "
        f"{max(rel):.3g} of their scale, of autograd through the plain form")
    del got, want

    # yardsticks: cuDNN's dilated convs, their weight gradient alone and
    # their whole backward, on the same tensors
    xc = x.permute(0, 3, 1, 2)                       # channels_last view
    gc = g.permute(0, 3, 1, 2)

    def cudnn_backward(x_grad: bool):
        xs = xc.detach().requires_grad_(x_grad)
        wv = [w.permute(3, 2, 0, 1).to(torch.bfloat16).requires_grad_()
              for w in ws]
        bv = [b.to(torch.bfloat16).requires_grad_() for b in bs]
        y = torch.cat([F.conv2d(xs, w, b, padding=r, dilation=r)
                       for w, b, r in zip(wv, bv, RATES)], dim=1)
        inputs = ([xs] if x_grad else []) + wv + bv
        return lambda: torch.autograd.grad(y, inputs, gc, retain_graph=True)

    xr = x.clone().requires_grad_()
    wr = [w.clone().requires_grad_() for w in ws]
    br = [b.clone().requires_grad_() for b in bs]
    y_fn = aspp_trainable(xr, wr, br, RATES)
    fn_bwd = lambda: torch.autograd.grad(  # noqa: E731
        y_fn, [xr] + wr + br, g, retain_graph=True)
    log(f"aspp backward ms: Function (dx, dW, db) "
        f"{time_ms(fn_bwd):.4f}; cuDNN dilated convs + cat, whole backward "
        f"{time_ms(cudnn_backward(True)):.4f}")

    n = B * TH * TW
    kc = packed_g.shape[1]
    pack_ms, pack_by = bound(nbytes(g, packed_g), 0.0, PEAK_BF16_FLOPS)
    w_ms, w_by = bound(nbytes(x, packed_g, dw),
                       valid_tap_flops(TH, TW, c, f), PEAK_BF16_FLOPS)
    log(f"aspp backward work: G {tuple(packed_g.shape)} over {n} pixels, "
        f"dW {c} x {kc}; all taps {2.0 * n * c * kc / 1e9:.1f} GFLOP, "
        f"inside the image {valid_tap_flops(TH, TW, c, f) / 1e9:.1f} GFLOP")
    return [
        dict(name="aspp_grad_pack", max_abs_err=0.0,
             device_ms=device_kernel_ms(
                 lambda: kernels.aspp_grad_pack(g, RATES, f),
                 "aspp_grad_pack_kernel"),
             ms=time_ms(lambda: kernels.aspp_grad_pack(g, RATES, f)),
             plain_ms=time_ms(lambda: grad_pack_plain(g, RATES, f)),
             library_ms=None, bound_ms=pack_ms, bound_by=pack_by),
        dict(name="aspp_grad_weight", max_abs_err=dw_err,
             device_ms=device_kernel_ms(
                 lambda: kernels.aspp_grad_weight(x2d, packed_g),
                 ("aspp_grad_weight_kernel", "split_sum_kernel")),
             ms=time_ms(lambda: kernels.aspp_grad_weight(x2d, packed_g)),
             plain_ms=time_ms(lambda: grad_weight_plain(x2d, packed_g)),
             library_ms=time_ms(cudnn_backward(False)), bound_ms=w_ms,
             bound_by=w_by)]


def device_kernel_ms(fn, symbol, iters: int = 5):
    """Device ms per call of the CUDA kernel whose name holds ``symbol``,
    from the profiler (None if the trace shows no such kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    symbols = (symbol,) if isinstance(symbol, str) else symbol
    total = None
    for evt in prof.key_averages():
        if any(sym in evt.key for sym in symbols):
            total = (total or 0.0) + _device_us(evt) / 1e3 / iters
    return total


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else getattr(evt, "self_cuda_time_total", 0)


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------
def write_run(root: str, seed: int) -> str:
    run = os.path.join(root, "city_flagship")
    os.makedirs(run)
    with open(os.path.join(run, "config.gin"), "w") as f:
        f.write(CONFIG)
    model, spec = construct_ppnet(
        "group", "deeplabv2_resnet101_multiscale", (228, 64, 1, 1), 19,
        add_on_layers_type="deeplab_simple", bindings=parse_config(CONFIG))
    save_checkpoint(os.path.join(run, "checkpoints", "push_final"),
                    synthetic_state_dict(model, seed=seed), spec,
                    extra={"variant": "group"})
    return run


def serve_run(run_root: str, img_dir: str, out_dir: str) -> dict:
    """One run of the main path through serve.main, launch counts from
    zero; every kernel must launch on every batch."""
    kernels.reset_launch_counts()
    record = serve.main(["city_flagship", "push_final", "--input", img_dir,
                         "--output", out_dir, "--batch", str(B),
                         "--raw-output", "--results-root", run_root,
                         "--workers", "4"])
    counts = kernels.launch_counts()
    batches = 1 + math.ceil(N_IMAGES / B)     # warmup + timed pass
    for name in SERVING_KERNELS:
        n = counts[name]
        if n < batches:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{batches} batches")
    if not record["fast"] or record["images"] != N_IMAGES:
        raise AssertionError(f"unexpected serve record {record}")
    return dict(record, counts=counts)


def serving_phase(dev, smi: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run = write_run(tmp, seed=0)
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        rng = np.random.default_rng(0)
        for i in range(N_IMAGES):
            np.save(os.path.join(img_dir, f"frame_{i:03d}.npy"),
                    rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8))
        log(f"slice: run directory and {N_IMAGES} images written in "
            f"{time.perf_counter() - t0:.1f} s")

        out_dir = os.path.join(tmp, "labels")
        runs = [serve_run(tmp, img_dir, out_dir) for _ in range(SERVE_RUNS)]
        counts = runs[0]["counts"]
        log(f"slice: launches per run {[r['counts'] for r in runs]} over "
            f"{1 + math.ceil(N_IMAGES / B)} batches each")

        # the plain path: the same bf16 model with every kernel replaced
        # by its plain version
        ckpt = os.path.join(run, "checkpoints", "push_final.ckpt")
        plain_model, _ = load_model(run, ckpt, dtype=torch.bfloat16,
                                    fast=False, device=dev)
        plain = make_serving_fn(plain_model, fast=False,
                                normalize_to=torch.bfloat16)
        agree = total = 0
        names = sorted(os.listdir(img_dir))
        for i in range(0, N_IMAGES, B):
            batch = np.stack([np.load(os.path.join(img_dir, n))
                              for n in names[i:i + B]])
            want = plain(torch.from_numpy(batch).to(dev)).cpu().numpy()
            got = np.stack([np.load(os.path.join(out_dir, n))
                            for n in names[i:i + B]])
            if got.shape != want.shape or got.dtype != np.uint8 \
                    or got.max() >= 19:
                raise AssertionError(f"labels {got.shape} {got.dtype}")
            agree += int((got == want).sum())
            total += got.size
        agreement = agree / total
        log(f"slice: labels agree with the plain path on "
            f"{100 * agreement:.4f}% of {total} pixels")
        if agreement < 0.99:
            raise AssertionError(f"agreement {agreement} < 0.99")
        del plain_model, plain

        # the device forward of one resident batch, and where it goes
        fast_model, _ = load_model(run, ckpt, dtype=torch.bfloat16,
                                   fast=True, device=dev)
        fast = make_serving_fn(fast_model, fast=True,
                               normalize_to=torch.bfloat16)
        x = torch.from_numpy(np.stack([np.load(os.path.join(img_dir, n))
                                       for n in names[:B]])).to(dev)
        logits = make_serving_fn(fast_model, output="logits", upsample=False,
                                 fast=True, normalize_to=torch.bfloat16)(x)
        if logits.shape != (B, FH, FW, 19) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"fast-path logits {tuple(logits.shape)} "
                                 "not finite or misshapen")
        batch_ms = time_ms(lambda: fast(x), warmup=2, iters=10)
        breakdown = profile_batch(lambda: fast(x))
        for i, r in enumerate(runs):
            log(f"slice: run {i + 1}: {r['img_per_s']} img/s through "
                f"serve.main ({N_IMAGES} images in {r['seconds']} s, batch "
                f"{B}, {HEIGHT}x{WIDTH}, full depth); device idle share "
                f"{r['device_idle_share']} on {smi}")
        rates = [r["img_per_s"] for r in runs]
        log(f"slice: img/s median {statistics.median(rates)} min "
            f"{min(rates)} max {max(rates)} spread "
            f"{(max(rates) - min(rates)) / statistics.median(rates)}; device "
            f"forward {batch_ms} ms per batch (CUDA-event median of 10)")
        log("slice: device time per batch by kernel: " + json.dumps(breakdown))
        return dict(counts=counts, img_per_s=rates, agreement=agreement,
                    batch_ms=batch_ms)


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------
def write_city_root(root: str, seed: int) -> str:
    """Cityscapes layout at Cityscapes size: uint8 1024 x 2048 images and
    raw category-index labels in a 4 x 5 grid of blocks, one void block
    and one per train class, shuffled per image."""
    rng = np.random.default_rng(seed)
    cats = [0] + [next(k for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items()
                       if v == c) for c in range(1, 20)]
    bh, bw = HEIGHT // 4, WIDTH // 5 + 1
    index = {}
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        ann = os.path.join(root, "annotations", split)
        img = os.path.join(root, "img_with_margin_0", split)
        os.makedirs(ann)
        os.makedirs(img)
        index[split] = [f"{split}_{i:03d}" for i in range(n)]
        for name in index[split]:
            grid = rng.permutation(cats).reshape(4, 5).astype(np.uint8)
            label = np.repeat(np.repeat(grid, bh, 0), bw, 1)[:HEIGHT, :WIDTH]
            np.save(os.path.join(ann, name + ".npy"),
                    np.ascontiguousarray(label))
            np.save(os.path.join(img, name + ".npy"),
                    rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8))
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


def micro_step_grads(model, batch, dev) -> tuple:
    """(loss, ASPP-weight gradient, prototype gradient) of one micro-step
    of ``model`` on ``batch``, every parameter trainable."""
    from scaleprotoseg_torch.train.steps import LossWeights, compute_losses
    model.zero_grad(set_to_none=True)
    for p in model.parameters():
        p.requires_grad_(True)
    x = torch.from_numpy(batch[0]).to(dev)
    t = torch.from_numpy(batch[1]).to(dev)
    loss, _ = compute_losses(model, model(x), t,
                             LossWeights(crs_ent=1.0, l1=1e-4, kld=0.25))
    loss.backward()
    aspp = torch.cat([p.grad.flatten() for n, p in model.named_parameters()
                      if ".aspp." in n and n.endswith("weight")])
    return loss.item(), aspp, model.prototype_vectors.grad.flatten().clone()


def training_phase(dev, smi: str) -> dict:
    from scaleprotoseg_torch import cli_common, train_wandb_multiscale

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = write_city_root(os.path.join(tmp, "city"), seed=1)
        log(f"train: {N_TRAIN} + {N_VAL} Cityscapes-size images written in "
            f"{time.perf_counter() - t0:.1f} s")
        gin = ["train.push_proto = False", "train.finetune_steps = 0",
               f"train.warmup_steps = {WARMUP_STEPS}",
               f"train.joint_steps = {JOINT_STEPS}",
               f"Trainer.val_check_interval = {VAL_EVERY}"]
        argv = ["scaleproto_cityscapes", "city_train", "--gpu-recipe",
                "--data-root", data, "--results-root", tmp]
        for line in gin:
            argv += ["--gin", line]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = train_wandb_multiscale.main(argv)
        counts = kernels.launch_counts()
        log(f"train: main took {time.perf_counter() - t0:.1f} s; launches "
            f"{counts}")
        val_batches = math.ceil(N_VAL / B)
        for phase, steps in ((0, WARMUP_STEPS), (1, JOINT_STEPS)):
            res = out["phases"][phase]
            n_val = res.validations * val_batches
            want = {"aspp": steps + n_val, "aspp_grad_pack": steps,
                    "aspp_grad_weight": steps}
            if res.steps_done != steps or len(res.losses) != steps or \
                    not all(math.isfinite(v) for v in res.losses):
                raise AssertionError(f"phase {phase}: {res.steps_done} "
                                     f"steps, losses {res.losses}")
            if res.launches != {**res.launches, **want}:
                raise AssertionError(f"phase {phase}: launches "
                                     f"{res.launches}, want {want}")
            log(f"train phase {phase}: {steps} micro-steps, "
                f"{res.validations} validations; launches {res.launches}; "
                f"losses first {res.losses[0]:.4f} last "
                f"{res.losses[-1]:.4f}, all finite")
            perf = res.perf
            log(f"train phase {phase}: {perf['img_per_s']} img/s, median "
                f"step {perf['step_ms_median']} ms (CUDA events), device "
                f"idle share {perf['device_idle_share']} over "
                f"{perf['steps_timed']} steps past the first 3; batch {B} "
                f"at 513 x 513, full depth, bf16 recipe, on {smi}")
        if sum(counts[k] for k in TRAINING_KERNELS) != sum(
                sum(out["phases"][p].launches[k] for k in TRAINING_KERNELS)
                for p in (0, 1)):
            raise AssertionError(f"launches outside the phases: {counts}")

        # one micro-step of the kernel path against the plain path, from
        # the trained weights and one batch
        run = os.path.join(tmp, "city_train")
        _, bindings = cli_common.load_config(os.path.join(run, "config.gin"))
        sd, _ = load_checkpoint(out["final"])
        batch = next(iter(cli_common.make_loaders(bindings, B, seed=5,
                                                  data_root=data)[0]))
        res = {}
        for fast in (False, True):
            model, _ = train_wandb_multiscale.build_model(bindings, 0)
            model.load_state_dict(sd, strict=True)
            model.set_compute_dtype(torch.bfloat16)
            model.features.base.aspp.fast = fast
            res[fast] = micro_step_grads(model.to(dev), batch, dev)
        step_profiles = profile_train_steps(model, bindings, batch, dev)
        del model
        (lk, ak, pk), (lp, ap, pp) = res[True], res[False]
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
        step_cmp = dict(loss_kernel=lk, loss_plain=lp,
                        loss_abs_err=abs(lk - lp),
                        aspp_grad_rel_l2=rel(ak, ap),
                        proto_grad_rel_l2=rel(pk, pp))
        log("train: one micro-step, kernel path vs plain path: "
            + json.dumps(step_cmp))
        if not (step_cmp["loss_abs_err"] <= 1e-3
                and step_cmp["aspp_grad_rel_l2"] <= 2e-2
                and step_cmp["proto_grad_rel_l2"] <= 2e-2):
            raise AssertionError(f"kernel vs plain micro-step {step_cmp}")

        # the trained model serves
        served, _ = load_model(run, out["final"] + ".pth",
                               dtype=torch.bfloat16, fast=True, device=dev)
        x = torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, (B, HEIGHT, WIDTH, 3), dtype=np.uint8)).to(dev)
        logits = make_serving_fn(served, output="logits", upsample=False,
                                 fast=True, normalize_to=torch.bfloat16)(x)
        if logits.shape != (B, FH, FW, 19) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("push_final does not serve finite logits")
        log(f"train: push_final serves {tuple(logits.shape)} finite logits")
        return dict(counts=counts, step_cmp=step_cmp, profiles=step_profiles,
                    perf={p: out["phases"][p].perf for p in (0, 1)})


def profile_train_steps(model, bindings, batch, dev) -> dict:
    """Where a micro-step's time goes, per phase, on a resident batch
    (no loader): the trainer's own step and phase optimizer, profiled."""
    from scaleprotoseg_torch.train.optim import (PhaseOptimizer,
                                                 phase_groups, poly_schedule)
    from scaleprotoseg_torch.train.runner import module_hparams
    from scaleprotoseg_torch.train.state import TrainState
    from scaleprotoseg_torch.train.steps import make_train_step
    hp = module_hparams(bindings, "multiscale")
    x = torch.from_numpy(batch[0]).to(dev)
    t = torch.from_numpy(batch[1]).to(dev)
    out = {}
    for phase in (0, 1):
        opt = PhaseOptimizer(
            model.named_parameters(),
            phase_groups("multiscale", phase, hp["hp"]),
            schedule=poly_schedule(hp["poly_lr_power"], 8),
            iter_size=hp["iter_size"], guard_nonfinite=50)
        state = TrainState(model, opt)
        step = make_train_step(hp["weights"])
        out[phase] = profile_batch(lambda: step(state, x, t),
                                   TRAINING_GROUPS, iters=5)
        log(f"train phase {phase}: one micro-step on a resident batch, "
            f"device ms by kernel: {json.dumps(out[phase])}")
    return out


SERVING_GROUPS = ("aspp_kernel", "proto_kernel", "upsample_argmax_kernel",
                  "conv", "batch_norm", "elementwise", "other")
TRAINING_GROUPS = ("aspp_kernel", "aspp_grad_pack_kernel",
                   "aspp_grad_weight_kernel", "split_sum_kernel", "adam",
                   "conv", "batch_norm", "elementwise", "other")


def profile_batch(fn, groups=SERVING_GROUPS, top: int = 12,
                  iters: int = 3) -> dict:
    """Device ms per call by group (a kernel named in ``groups``, else
    convolution/GEMM kernels, batch norm, other elementwise kernels, the
    rest), the ``top`` kernels by time, the host-clock ms per call of an
    unprofiled run (``wall_ms``), the share of it the card is busy, and
    the device operations (kernels and copies) per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    sums = dict.fromkeys(groups, 0.0)
    per_kernel = []
    calls = 0
    for evt in prof.key_averages():
        calls += evt.count
        ms = _device_us(evt) / 1e3 / iters
        key = evt.key
        low = key.lower()
        name = next((g for g in groups if g in low), None)
        if name is None:
            name = "conv" if any(t in low for t in (
                "conv", "gemm", "xmma", "fprop", "dgrad", "wgrad", "cutlass",
                "nvjet")) else "elementwise" if "elementwise" in low \
                else "other"
        sums[name] += ms
        per_kernel.append((ms, evt.count // iters, key[:90]))
    per_kernel.sort(reverse=True)
    out = {k: round(v, 4) for k, v in sums.items()}
    device = sum(sums.values())
    out.update(device_ms=round(device, 4), wall_ms=round(wall, 4),
               busy_share=round(device / wall, 4),
               kernels_per_call=calls / iters)
    out["top"] = [[round(ms, 4), n, key] for ms, n, key in per_kernel[:top]]
    return out


def main() -> None:
    smi = device_phase()
    log(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for check in (check_aspp, check_aspp_backward, check_proto,
                  check_upsample):
        out = check(gen, dev)
        for r in out if isinstance(out, list) else [out]:
            results[r["name"]] = r
        torch.cuda.empty_cache()
    log("kernel device ms per call (profiler): " + json.dumps(
        {name: r["device_ms"] for name, r in results.items()}))

    served = serving_phase(dev, smi)
    torch.cuda.empty_cache()
    trained = training_phase(dev, smi)
    by_path = {name: {"serving": served["counts"][name],
                      "training": trained["counts"][name]}
               for name in results}
    # each kernel's launches in the main path of its slice: the training
    # run for K2's forward and backward, the serving run for K1 and K3
    launches = {name: trained["counts"][name] if name in TRAINING_KERNELS
                else served["counts"][name] for name in results}
    for r in results.values():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        log(f"{r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) launches "
            f"{by_path[r['name']]} max_abs_err {r['max_abs_err']:.3g} "
            f"on {smi}")

    line = {"kernels": [dict(
        name=r["name"], status="ported", route="cuda",
        source=f"scaleprotoseg_torch/csrc/{SOURCES[r['name']]}.cu",
        replaces=REPLACES[r["name"]], launches=launches[r["name"]],
        launches_by_path=by_path[r["name"]],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"]) for r in results.values()] + [dict(
            name=k["name"], status="still to port", route=None, source=None,
            replaces=k["replaces"], launches=0, max_abs_err=None, ms=None,
            plain_ms=None, bound_ms=None, bound_by=None, library_ms=None)
            for k in STILL_TO_PORT]}
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
