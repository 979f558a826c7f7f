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
   version's top-two margin is at least 1e-5.  Times are CUDA-event
   medians of 10 runs after warmup, beside the plain version, one PyTorch
   library call computing the same function (a yardstick the port never
   calls) and the least time the card could take;
4. slice: a temporary run directory (the Cityscapes group config, seeded
   synthetic weights for the full-depth ResNet-101 flagship, 256 seeded
   uint8 1024 x 2048 images) served three times through
   ``scaleprotoseg_torch.serving.serve.main`` at batch 2, a timed window
   of several seconds each.  Every kernel must launch at least once per
   batch of every run, and the labels must agree with the port's plain
   path (same bf16 model, plain versions instead of kernels) on at least
   99% of pixels.  Per run: img/s and the device's idle share of the
   timed window (``ServingEngine``'s per-batch stream spans);
5. one line per kernel with its times, bound and launches, the kernels
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
from scaleprotoseg_torch.checkpoints.convert import (save_checkpoint,
                                                     synthetic_state_dict)
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.kernels.aspp import aspp_plain, pack_weights
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
RATES = (6, 12, 18, 24)
N_IMAGES = 256                # ~5 s of serving per run at ~50 img/s
SERVE_RUNS = 3

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

REPLACES = {
    "aspp": "scaleprotoseg_tpu/ops/pallas_aspp.py:68 fused_aspp "
            "(pallas_call :169)",
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
    taps = 0
    for r in RATES:
        for d in (-r, 0, r):
            for e in (-r, 0, r):
                taps += max(FH - abs(d), 0) * max(FW - abs(e), 0)
    flops = 2.0 * B * taps * c * f
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


def device_kernel_ms(fn, symbol: str, iters: int = 5):
    """Device ms per call of the CUDA kernel whose name holds ``symbol``,
    from the profiler (None if the trace shows no such kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = None
    for evt in prof.key_averages():
        if symbol in evt.key:
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
    for name, n in counts.items():
        if n < batches:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{batches} batches")
    if not record["fast"] or record["images"] != N_IMAGES:
        raise AssertionError(f"unexpected serve record {record}")
    return dict(record, counts=counts)


def slice_phase(dev, smi: str) -> dict:
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


def profile_batch(fn, top: int = 12) -> dict:
    """Device ms per call: the three kernels, convolution/GEMM kernels,
    batch norm, other elementwise kernels, the rest, and the ``top``
    kernels by time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    iters = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    groups = dict.fromkeys(("aspp_kernel", "proto_kernel",
                            "upsample_argmax_kernel", "conv", "batch_norm",
                            "elementwise", "other"), 0.0)
    per_kernel = []
    for evt in prof.key_averages():
        ms = _device_us(evt) / 1e3 / iters
        key = evt.key
        low = key.lower()
        name = next((g for g in groups if g in key), None)
        if name is None:
            name = "conv" if any(t in low for t in (
                "conv", "gemm", "xmma", "fprop", "cutlass", "nvjet")) \
                else "elementwise" if "elementwise" in low else "other"
        groups[name] += ms
        per_kernel.append((ms, evt.count // iters, key[:90]))
    per_kernel.sort(reverse=True)
    out = {k: round(v, 4) for k, v in groups.items()}
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
    for check in (check_aspp, check_proto, check_upsample):
        r = check(gen, dev)
        results[r["name"]] = r
        torch.cuda.empty_cache()
    log("kernel device ms per call (profiler): " + json.dumps(
        {name: r["device_ms"] for name, r in results.items()}))

    sl = slice_phase(dev, smi)
    for r in results.values():
        log(f"{r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) launches "
            f"{sl['counts'][r['name']]} max_abs_err {r['max_abs_err']:.3g} "
            f"on {smi}")

    line = {"kernels": [dict(
        name=r["name"], status="ported", route="cuda",
        source=f"scaleprotoseg_torch/csrc/{r['name']}.cu",
        replaces=REPLACES[r["name"]], launches=sl["counts"][r["name"]],
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
