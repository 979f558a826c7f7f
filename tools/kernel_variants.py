"""Time design variants of the TMA + ``wgmma`` kernels on the card.

    python tools/kernel_variants.py [aspp] [int8_mm] [int8_conv3x3]
                                    [aspp_grad_weight]

(all four without arguments).

A variant is the kernel's source with a few exact text substitutions (a
smaller block, a persistent or a plain grid, taps staged one by one,
another tile order or width, fewer stages, a load left out), compiled
beside the shipped one and timed in turns with it at the main path's
shapes: K2's forward at the serving and the training shape, ``int8_mm``
with its bf16 epilogue at the 1x1 conv shapes of a quant8 batch,
``int8_conv3x3`` with its bf16 epilogue at layer4's and layer5's 3x3
shapes, ``aspp_grad_weight`` at the training shape (with its error
against the fp32 product).  It answers "did this design step pay" with the
card's numbers.  It is a development script: nothing of the port calls it
and no test holds the kernels' sources to it.  A substitution whose anchor
no longer occurs in the source raises when the script runs, so a variant
cannot silently time the shipped kernel; after an edit near an anchor,
bring the anchor up to date or drop the variant.
Variants marked ``timing_only`` compute something else than the kernel
(they exist to price one part of it) and are not compared.
"""

from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scaleprotoseg_torch.kernels import _build  # noqa: E402

Subs = List[Tuple[str, str]]

_ASPP_ITEM = """  const Item it = decode_item(blockIdx.x, F / BN, R, npx, npy);
  const int rate = rates.r[it.ri];
  const int mask = tap_mask(it, rate, H, W);
  const int live = live_blocks(it, rate, H);
"""
_ASPP_NEXT_ITEM = """for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      it = decode_item(item, F / BN, R, npx, npy);
      rate = rates.r[it.ri];
      mask = tap_mask(it, rate, H, W);
      live = live_blocks(it, rate, H);
"""

ASPP_VARIANTS: Dict[str, Subs] = {
    "shipped": [],
    # step (a) undone: 128 pixels (16 x 8) per block, one consumer warpgroup
    "128px_per_block": [
        ("constexpr int PH = 32; ", "constexpr int PH = 16; "),
        ("constexpr int CONSUMER_WGS = 2;", "constexpr int CONSUMER_WGS = 1;"),
    ],
    # step (b): one block per SM walking the items round-robin, so that an
    # item's epilogue overlaps the next one's loads
    "persistent": [
        ("Rates rates, int npx,\n            int npy) {",
         "Rates rates, int npx,\n            int npy, int n_items) {"),
        ("C, F, R, rates, npx, npy);", "C, F, R, rates, npx, npy, (int)items);"),
        ("  aspp_kernel<<<(int)items, THREADS, SMEM_BYTES,",
         "  int sms = 0;\n"
         "  if (sm_count(&sms) != cudaSuccess) return 1;\n"
         "  aspp_kernel<<<items < sms ? (int)items : sms, "
         "THREADS, SMEM_BYTES,"),
        (_ASPP_ITEM, _ASPP_ITEM.replace("const ", "")),
        ("      for_each_stage(it, rate, mask, live, chunks,\n"
         "                     [&](int kc,",
         "      " + _ASPP_NEXT_ITEM +
         "      for_each_stage(it, rate, mask, live, chunks,\n"
         "                     [&](int kc,"),
        ("        if (++stage == STAGES) { stage = 0; phase ^= 1; }\n"
         "      });\n    }\n  } else {",
         "        if (++stage == STAGES) { stage = 0; phase ^= 1; }\n"
         "      });\n      }\n    }\n  } else {"),
        ("    float acc[2][32], sum[2][32];\n",
         "    " + _ASPP_NEXT_ITEM + "    float acc[2][32], sum[2][32];\n"),
        ("                make_uint4(w[0], w[1], w[2], w[3]);\n"
         "        }\n      }\n    }\n  }\n}\n",
         "                make_uint4(w[0], w[1], w[2], w[3]);\n"
         "        }\n      }\n    }\n    }\n  }\n}\n"),
    ],
    # step (c) undone: every tap staged on its own (same patch, same ring)
    "taps_one_by_one": [
        ("const bool strip = rate <= MAX_STRIP_RATE;",
         "const bool strip = false;")],
    # every m64 block and box of a tap that touches the image is processed
    "no_block_skipping": [
        ("      if (y + BOX_ROWS > 0 && y < H) live |=", "      live |=")],
    # what the weight tiles' share of the L2 -> shared stream costs
    "no_weight_loads(timing_only)": [
        ("__popc(boxes) * BOX_BYTES + __popc(taps) * B_BYTES);",
         "__popc(boxes) * BOX_BYTES);"),
        ("            tma_load_2d(a + A_BYTES + dyi * B_BYTES, &w_map, "
         "full + stage,\n                        kc * BK, "
         "(it.ri * 9 + 3 * dyi + dxi) * F + it.n0);\n", "            ;\n"),
    ],
    # the load pipeline alone: what the tensor cores' share costs
    "no_wgmma(timing_only)": [
        ("          if (!((live >> (4 * dyi + 2 * wg + mb)) & 1)) continue;\n",
         "          if (rate >= 0) continue;\n")],
}

_GEMM_GRID = "  const int grid = tiles < sms ? (int)tiles : sms;\n"

INT8_VARIANTS: Dict[str, Subs] = {
    "shipped": [],
    "one_tile_per_block": [(_GEMM_GRID, "  const int grid = (int)tiles;\n")],
    "m_tiles_fastest": [
        ("const int m0 = (tile / tiles_n) * TM;",
         "const int m0 = (tile % (n_tiles / tiles_n)) * TM;"),
        ("const int n0 = (tile % tiles_n) * TN;",
         "const int n0 = (tile / (n_tiles / tiles_n)) * TN;"),
    ],
    "3_stages": [("constexpr int G_STAGES = 4;", "constexpr int G_STAGES = 3;")],
}

_CONV_RELEASE = """        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == C_STAGES)"""

CONV_VARIANTS: Dict[str, Subs] = {
    "shipped": [],
    # one item per block: no overlap of an item's epilogue with the next
    # item's loads
    "one_item_per_block": [
        ("  const int grid = items < sms ? (int)items : sms;\n"
         "  int8_conv3x3_kernel", "  const int grid = (int)items;\n"
         "  int8_conv3x3_kernel")],
    # every m64 block and box of a tap that touches the image is processed
    "no_block_skipping": [
        ("      if (y + BOX_ROWS > 0 && y < H) live |= 1 << (4 * dyi + j);",
         "      live |= 1 << (4 * dyi + j);")],
    # every tap staged on its own (same patch, same ring)
    "taps_one_by_one": [("const bool strip = dil <= MAX_STRIP_DIL;",
                         "const bool strip = false;")],
    # a stage held until the next one is issued, as the GEMM's ring does
    "release_one_late": [
        (_CONV_RELEASE, """        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = stage;
        if (++stage == C_STAGES)"""),
        ("      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;\n",
         "      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;\n"
         "      int prev = -1;\n"),
        ("        if (++stage == C_STAGES) { stage = 0; phase ^= 1; }\n      });\n",
         "        if (++stage == C_STAGES) { stage = 0; phase ^= 1; }\n      });\n"
         "      wgmma_wait<0>();\n"
         "      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);\n")],
}

# each stage's sums start from zero and are added into the accumulators in
# round-to-nearest on the CUDA cores, the stage released when its batch is
# done
_DW_PROMOTE = [
    ("    float acc[BN / 2];\n", "    float acc[BN / 2], sums[BN / 2];\n"),
    ("""        wgmma_bf16_mn(acc, da + kk * (16 * 128 >> 4),
                      db + kk * (16 * 128 >> 4), 1);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();             // the previous stage's batch is done
        if (lane == 0) mbar_arrive(empty + prev);
      }
      prev = stage;
""", """        wgmma_bf16_mn(sums, da + kk * (16 * 128 >> 4),
                      db + kk * (16 * 128 >> 4), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + stage);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += sums[i];
""")]



def _wgmma_bf16_mn(n: int) -> str:
    """``hopper.cuh``'s ``wgmma_bf16_mn`` (m64n192k16, both operands
    MN-major) at width n, for the variants with other k tiles: the header
    holds only the width the kernel ships with."""
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    binds = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return f"""namespace hopper {{
__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[{regs}],
    uint64_t desc_a, uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{outs}}}, %{regs}, %{regs + 1}, p, 1, 1, 1, 1;\\n}}\\n"
      : {binds}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}
}}  // namespace hopper
"""


def _dw_width(n: int) -> Subs:
    """k tiles n wide, with the ``wgmma`` of that width."""
    return [("constexpr int BN = 192;", f"constexpr int BN = {n};"),
            ('#include "hopper.cuh"\n',
             '#include "hopper.cuh"\n' + _wgmma_bf16_mn(n))]


DW_VARIANTS: Dict[str, Subs] = {
    "shipped": [],
    # K2's remedy for wgmma's truncating sum
    "promotion": _DW_PROMOTE,
    "n128": _dw_width(128),
    "n128_promotion": _dw_width(128) + _DW_PROMOTE,
    # (48 KB stages: four fit)
    "n256": _dw_width(256) + [("constexpr int STAGES = 5;",
                               "constexpr int STAGES = 4;")],
    # every pixel of every k tile (every tile then as long: natural order)
    "no_row_skipping": [
        ("  return lo < hi ? make_int2(lo, hi) : make_int2(0, 0);",
         "  return make_int2(0, H);")],
    # the k tiles in their natural order, not longest first
    "natural_order": [("i > 0 && rows[i - 1] < r.y - r.x;",
                       "i > 0 && false;")],
    "4_stages": [("constexpr int STAGES = 5;", "constexpr int STAGES = 4;")],
    "3_stages": [("constexpr int STAGES = 5;", "constexpr int STAGES = 3;")],
}

# kernel -> (source, its variants, its __global__ function)
KERNELS = {"aspp": ("aspp", ASPP_VARIANTS, "aspp_kernel"),
           "int8_mm": ("int8_mm", INT8_VARIANTS, "int8_gemm_kernel"),
           "int8_conv3x3": ("int8_mm", CONV_VARIANTS, "int8_conv3x3_kernel"),
           "aspp_grad_weight": ("aspp_bwd", DW_VARIANTS,
                                "aspp_grad_weight_kernel")}
RATES = (6, 12, 18, 24)
ASPP_SHAPES = ((2, 129, 257, 2048, 64), (2, 65, 65, 2048, 64))
PIXELS = 2 * 129 * 257
# (K, N, convs per quant8 batch) of layer4/5's 1x1 convs
INT8_SHAPES = ((512, 256, 1), (512, 1024, 1), (256, 1024, 23),
               (1024, 256, 22), (1024, 512, 1), (1024, 2048, 1),
               (512, 2048, 3), (2048, 512, 2))
# (channels, dilation, convs per quant8 batch) of layer4/5's 3x3 convs
CONV_SHAPES = ((256, 2, 23), (512, 4, 3))


def variant_source(kernel: str, name: str) -> str:
    """``csrc/<kernel>.cu`` with the variant's substitutions applied; each
    anchor must occur exactly as written."""
    source, variants, _ = KERNELS[kernel]
    src = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in variants[name]:
        if old not in src:
            raise ValueError(f"{kernel} variant {name}: anchor not in the "
                             f"source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _ptxas_summary(log: str, function: str) -> str:
    """ptxas's stack frame and registers for each instantiation of the
    ``__global__`` function in an nvcc build log."""
    lines = log.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and function in line:
            found.append("; ".join(
                l.split(":", 1)[-1].strip() for l in lines[i + 1:i + 4]
                if "stack frame" in l or "Used" in l))
    return " | ".join(found) or "no ptxas report"


def _build_variants(kernel: str, symbol: str, argtypes) -> dict:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(KERNELS[kernel][1]):
        cu = out_dir / f"{kernel}_{i}.cu"
        cu.write_text(variant_source(kernel, name))
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{kernel} variant {name}:\n{log}")
        print(f"{kernel} variant {name} build: "
              f"{_ptxas_summary(log, KERNELS[kernel][2])}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _median_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
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


def _report(what: str, name: str, status: int, diff, ms: float) -> None:
    verdict = "not compared" if diff is None else \
        f"max |difference| from shipped {diff:g}"
    print(f"{what} {name}: status {status}, {verdict}, median {ms:.4f} ms",
          flush=True)


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def time_aspp(dev, gen) -> None:
    from scaleprotoseg_torch.kernels.aspp import pack_weights
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = _build_variants("aspp", "aspp_forward",
                          [ptr] * 4 + [i32] * 10 + [ptr])
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, w, c, f in ASPP_SHAPES:
        x = torch.rand((b, h, w, c), generator=gen, device=dev) \
            .to(torch.bfloat16)
        std = math.sqrt(2.0 / (9 * c))
        ws = [torch.randn((3, 3, c, f), generator=gen, device=dev) * std
              for _ in RATES]
        bs = [torch.randn((f,), generator=gen, device=dev) * 0.1
              for _ in RATES]
        wstack, bias = pack_weights(ws, bs)
        outs = {}
        for turn in range(2):
            for name, fn in fns.items():
                out = torch.zeros((b, h, w, len(RATES) * f),
                                  dtype=torch.bfloat16, device=dev)

                def call():
                    return fn(x.data_ptr(), wstack.data_ptr(),
                              bias.data_ptr(), out.data_ptr(), b, h, w, c, f,
                              len(RATES), *RATES, stream)

                status = call()
                torch.cuda.synchronize()
                outs[name] = out
                # another stage order rounds the fp32 sums elsewhere: a
                # variant is within a few bf16 steps of shipped, not equal
                diff = None if "timing_only" in name else \
                    _max_diff(out, outs["shipped"])
                _report(f"aspp {b}x{h}x{w}x{c} turn {turn}", name, status,
                        diff, _median_ms(call))


def time_int8(dev, gen) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = _build_variants("int8_mm", "int8_mm",
                          [ptr] * 5 + [i32] * 4 + [ptr])
    stream = torch.cuda.current_stream().cuda_stream
    total = dict.fromkeys(list(fns) + ["torch._int_mm", "bound"], 0.0)
    for k, n, per_batch in INT8_SHAPES:
        a = torch.randint(-127, 128, (PIXELS, k), generator=gen, device=dev,
                          dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.tensor([2e-3], device=dev)
        sw = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-5
        outs = {}
        for name, fn in fns.items():
            out = torch.zeros((PIXELS, n), dtype=torch.bfloat16, device=dev)

            def call():
                return fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(),
                          sx.data_ptr(), sw.data_ptr(), PIXELS, k, n, 1,
                          stream)

            status = call()
            torch.cuda.synchronize()
            outs[name] = out
            ms = _median_ms(call)
            total[name] += ms * per_batch
            _report(f"int8_mm {PIXELS}x{k}x{n} (x{per_batch})", name, status,
                    _max_diff(out, outs["shipped"]), ms)
        lib = _median_ms(lambda: torch._int_mm(a, bt.t()))
        bound = max((PIXELS * k + n * k + PIXELS * n * 2) / 3.35e12,
                    2.0 * PIXELS * k * n / 1979e12) * 1e3
        total["torch._int_mm"] += lib * per_batch
        total["bound"] += bound * per_batch
        print(f"int8_mm {PIXELS}x{k}x{n}: torch._int_mm (int32 out) "
              f"{lib:.4f} ms, bound {bound:.4f} ms", flush=True)
    print("int8_mm, the 54 1x1 convs of a batch, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in total.items()), flush=True)


def time_conv(dev, gen) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = _build_variants("int8_conv3x3", "int8_conv3x3",
                          [ptr] * 5 + [i32] * 7 + [ptr])
    stream = torch.cuda.current_stream().cuda_stream
    b, h, w = 2, 129, 257
    total = dict.fromkeys(list(fns) + ["bf16 cuDNN conv"], 0.0)
    for c, dil, per_batch in CONV_SHAPES:
        x = torch.randint(-127, 128, (b, h, w, c), generator=gen, device=dev,
                          dtype=torch.int8)
        wt = torch.randint(-127, 128, (9, c, c), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.tensor([2e-3], device=dev)
        sw = torch.rand((c,), generator=gen, device=dev) * 1e-3 + 1e-5
        outs = {}
        for turn in range(2):
            for name, fn in fns.items():
                out = torch.zeros((b, h, w, c), dtype=torch.bfloat16,
                                  device=dev)

                def call():
                    return fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                              sx.data_ptr(), sw.data_ptr(), b, h, w, c, c,
                              dil, 1, stream)

                status = call()
                torch.cuda.synchronize()
                outs[name] = out
                ms = _median_ms(call)
                total[name] += ms * per_batch / 2
                _report(f"int8_conv3x3 {b}x{h}x{w}x{c} d={dil} (x{per_batch}) "
                        f"turn {turn}", name, status,
                        _max_diff(out, outs["shipped"]), ms)
        xc = torch.randn((b, c, h, w), generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wc = (torch.randn((c, c, 3, 3), generator=gen, device=dev) * 0.02) \
            .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        lib = _median_ms(lambda: torch.nn.functional.conv2d(
            xc, wc, padding=dil, dilation=dil))
        total["bf16 cuDNN conv"] += lib * per_batch
        print(f"int8_conv3x3 {b}x{h}x{w}x{c} d={dil}: bf16 cuDNN conv "
              f"{lib:.4f} ms", flush=True)
    print("int8_conv3x3, the 26 3x3 convs of a batch, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in total.items()), flush=True)


def time_grad_weight(dev, gen) -> None:
    from scaleprotoseg_torch.kernels.aspp import (grad_pack_plain,
                                                  grad_weight_plain)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = _build_variants("aspp_grad_weight", "aspp_grad_weight",
                          [ptr] * 4 + [i32] * 11 + [ptr])
    stream = torch.cuda.current_stream().cuda_stream
    b, h, w, c, f = 2, 65, 65, 2048, 64
    x = torch.rand((b, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((b, h, w, len(RATES) * f), generator=gen,
                    device=dev).to(torch.bfloat16)
    pg = grad_pack_plain(g, RATES, f)
    k = pg.shape[1]
    want = grad_weight_plain(x, pg)
    scale = want.abs().max().item()
    work = torch.empty((b, c, k), dtype=torch.float32, device=dev)
    outs = {}
    for turn in range(2):
        for name, fn in fns.items():
            out = torch.zeros((c, k), dtype=torch.float32, device=dev)

            def call():
                return fn(x.data_ptr(), pg.data_ptr(), out.data_ptr(),
                          work.data_ptr(), b, h, w, c, k, f, len(RATES),
                          *RATES, stream)

            status = call()
            torch.cuda.synchronize()
            outs[name] = out
            err = (out - want).abs()
            tol = (err - 1e-3 * want.abs()).max().item()
            _report(f"aspp_grad_weight {b}x{h}x{w}x{c} K={k} turn {turn}",
                    name, status, _max_diff(out, outs["shipped"]),
                    _median_ms(call))
            print(f"    error against the fp32 product: max "
                  f"{err.max().item():.3g} ({err.max().item() / scale:.3g} of "
                  f"dW's scale {scale:.4g}); max |err| - 1e-3 |want| "
                  f"{tol:.3g} (within rtol = atol = 1e-3 when <= 1e-3)",
                  flush=True)
    x2, pg2 = x.reshape(-1, c), pg
    mm = _median_ms(lambda: torch.mm(x2.t(), pg2, out_dtype=torch.float32)) \
        if _has_out_dtype(x2, pg2) else None
    bf = _median_ms(lambda: torch.matmul(x2.t(), pg2))
    print(f"aspp_grad_weight yardsticks: one bf16 x bf16 -> fp32 GEMM "
          f"{'not available' if mm is None else f'{mm:.4f} ms'}, "
          f"torch.matmul (bf16 out) {bf:.4f} ms", flush=True)


def _has_out_dtype(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether this PyTorch's ``torch.mm`` takes ``out_dtype``."""
    try:
        torch.mm(a[:8, :8].t(), b[:8, :8], out_dtype=torch.float32)
        return True
    except TypeError:
        return False


TIMERS = {"aspp": time_aspp, "int8_mm": time_int8,
          "int8_conv3x3": time_conv, "aspp_grad_weight": time_grad_weight}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: CUDA is not available")
    names = sys.argv[1:] or list(TIMERS)
    unknown = set(names) - set(TIMERS)
    if unknown:
        raise SystemExit(f"kernel_variants: unknown kernels {sorted(unknown)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in names:
        TIMERS[name](dev, gen)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
