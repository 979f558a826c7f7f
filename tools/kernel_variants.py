"""Time design variants of the port's redesigned kernels on the card.

    python tools/kernel_variants.py [aspp] [int8_mm] [int8_conv3x3]
                                    [aspp_grad_weight] [proto] [upsample]
                                    [--proto-baseline OLD/csrc/proto.cu]

(all six without arguments).  ``--proto-baseline`` adds K1's
one-thread-per-pixel design, from an older commit's source, to K1's
turns, launched on the same inputs as its wrapper launched it.

A variant is the kernel's source with a few exact text substitutions (a
smaller block, a persistent or a plain grid, taps staged one by one,
another tile order or width, fewer stages, a load left out), compiled
beside the shipped one and timed in turns with it at the main path's
shapes: K2's forward at the serving and the training shape, ``int8_mm``
with its bf16 epilogue at the 1x1 conv shapes of a quant8 batch,
``int8_conv3x3`` with its bf16 epilogue at layer4's and layer5's 3x3
shapes, ``aspp_grad_weight`` at the training shape (with its error
against the fp32 product), K1 (``proto``) at the flagship's serving shape
and at COCO-Stuff's bank (with each variant's error against the fp32 and
the float64 plain head, also at pushed prototypes, where d ~ 0, and its
distance error under an identity head), K3 (``upsample``) at the
flagship's serving shape and a 513 x 513 crop.  It answers "did this
design step pay" with the card's numbers.  It is a development script:
nothing of the port calls it and no test holds the kernels' sources to
it.  A substitution whose anchor
no longer occurs in the source raises when the script runs, so a variant
cannot silently time the shipped kernel; after an edit near an anchor,
bring the anchor up to date or drop the variant.
Variants marked ``timing_only`` compute something else than the kernel
(they exist to price one part of it) and are not compared.
"""

from __future__ import annotations

import argparse
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
PROTO_VARIANTS: Dict[str, Subs] = {
    "shipped": [],
    # one consumer warpgroup: no second tile to run while one waits
    "one_warpgroup": [("constexpr int CONSUMER_WGS = 2;",
                       "constexpr int CONSUMER_WGS = 1;")],
    # three consumer warpgroups and a producer warp (no register
    # rebalancing), the bank streamed through two chunk slots and two
    # feature slabs per warpgroup to make room in shared memory
    "3_warpgroups": [
        ("constexpr int CONSUMER_WGS = 2;", "constexpr int CONSUMER_WGS = 3;"),
        ("constexpr int THREADS = 128 * (CONSUMER_WGS + 1);",
         "constexpr int THREADS = 128 * CONSUMER_WGS + 32;"),
        ("constexpr int X_SLOTS = 3;", "constexpr int X_SLOTS = 2;"),
        ("constexpr int BANK_SLOTS = 4;", "constexpr int BANK_SLOTS = 2;"),
        ("    reg_dealloc<40>();\n", ""),
        ("  reg_alloc<232>();\n", "")],
    # hi + mid only: a 16-bit prototype (error, not a candidate)
    "2_pieces": [
        ("for (int p = PIECES - 1; p >= 0; --p) {",
         "for (int p = PIECES - 2; p >= 0; --p) {"),
        ("p < PIECES - 1 || kk > 0", "p < PIECES - 2 || kk > 0")],
    # what the IEEE division and logf cost (MUFU approximations instead)
    "fast_log_div": [("  return logf(q);", "  return __logf(__fdividef(x, y));")],
    # the library's division (with its slow-path check and call)
    "fdiv_rn": [("  if (d < 1e30f) {\n    float rcp;",
                 "  if (d < 0.f) {\n    float rcp;")],
    # parts left out, to price them
    "no_wgmma(timing_only)": [
        ("for (int kk = 0; kk < D / 16; ++kk)\n          wgmma_m64n64k16_bf16(",
         "for (int kk = 0; kk < 0; ++kk)\n          wgmma_m64n64k16_bf16(")],
    "no_log_div(timing_only)": [
        ("acc[4 * i + j] = log_activation(d, eps);", "acc[4 * i + j] = d;")],
    "no_head_walk(timing_only)": [("int k = lo;", "int k = hi;")],
    "no_logits(timing_only)": [
        ("if (flags & CLOSE) {", "if ((flags & CLOSE) && flags < 0) {")],
}

UPSAMPLE_VARIANTS: Dict[str, Subs] = {
    "shipped": [],
    "band_8": [("constexpr int BH = 16;", "constexpr int BH = 8;")],
    "band_32": [("constexpr int BH = 16;", "constexpr int BH = 32;")],
    "classes_8_at_a_time": [("constexpr int CK = 4;", "constexpr int CK = 8;")],
    "2_blocks_per_sm": [("constexpr int MIN_BLOCKS = 3;",
                         "constexpr int MIN_BLOCKS = 2;")],
    "4_blocks_per_sm": [("constexpr int MIN_BLOCKS = 3;",
                         "constexpr int MIN_BLOCKS = 4;")],
    # parts left out, to price them
    "no_staging(timing_only)": [
        ("for (int k = 0; k < nrows; ++k) {\n    const long e0",
         "for (int k = 0; k < 0; ++k) {\n    const long e0")],
    "no_argmax(timing_only)": [
        ("    for (int c0 = 0; c0 < C; c0 += CK) {\n      if (c0 + CK <= C)",
         "    for (int c0 = 0; c0 < 0; c0 += CK) {\n      if (c0 + CK <= C)")],
    "no_label_stores(timing_only)": [
        ("for (int i = tid; i < bh * per_row; i += BW) {",
         "for (int i = tid; i < 0; i += BW) {"),
        ("for (int i = tid; i < bh * 32; i += BW) {",
         "for (int i = tid; i < 0; i += BW) {")],
}
UPSAMPLE_BANDS = {"band_8": 8, "band_32": 32}   # output rows per block

KERNELS = {"aspp": ("aspp", ASPP_VARIANTS, "aspp_kernel"),
           "int8_mm": ("int8_mm", INT8_VARIANTS, "int8_gemm_kernel"),
           "int8_conv3x3": ("int8_mm", CONV_VARIANTS, "int8_conv3x3_kernel"),
           "aspp_grad_weight": ("aspp_bwd", DW_VARIANTS,
                                "aspp_grad_weight_kernel"),
           "proto": ("proto", PROTO_VARIANTS, "proto_kernel"),
           "upsample": ("upsample", UPSAMPLE_VARIANTS,
                        "upsample_argmax_kernel")}
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


def _proto_case(dev, gen, spec, pixels, kind):
    """bf16 features, fp32 prototypes and a group head, or an identity
    plain head where the spec has no groups.  ``kind``: ``random``;
    ``pushed``, every prototype a copy of one pixel's features (d = 0
    there, as after a push, where the activation's slope is -1e4);
    ``sparse``, features and prototypes non-zero on four coordinates a
    scale (|x_s|^2 exact in fp32: the distance's error is the cross
    term's)."""
    from scaleprotoseg_torch.kernels.proto import pack_head
    c, g = spec.num_classes, spec.num_groups
    feats = torch.rand((pixels, spec.feature_depth), generator=gen,
                       device=dev).to(torch.bfloat16)
    if kind == "sparse":
        feats = torch.zeros((pixels, spec.num_scales, 64), device=dev)
        feats[..., :4] = 0.5 + 0.5 * torch.rand(
            (pixels, spec.num_scales, 4), generator=gen, device=dev)
        feats = feats.flatten(1).to(torch.bfloat16)
        protos = torch.zeros((spec.num_prototypes, 64), device=dev)
        protos[:, :4] = 0.5 + 0.5 * torch.rand(
            (spec.num_prototypes, 4), generator=gen, device=dev)
    elif kind == "pushed":
        protos = torch.empty((spec.num_prototypes, 64), device=dev)
        at = torch.randint(0, pixels, (spec.num_prototypes,), generator=gen,
                           device=dev)
        for s, (lo, hi) in enumerate(spec.scale_bounds):
            protos[lo:hi] = feats[at[lo:hi], s * 64:(s + 1) * 64].float()
    else:
        protos = torch.rand((spec.num_prototypes, 64), generator=gen,
                            device=dev)
    if not g:    # an identity plain head: the logits are the activations
        kw = dict(last_layer=torch.eye(spec.num_prototypes, device=dev))
        return feats, protos, kw, pack_head(protos, kw["last_layer"], spec)
    gw = torch.rand((c, g, spec.max_protos_per_class), generator=gen,
                    device=dev) + 1e-3
    gw = gw / gw.sum(-1, keepdim=True)
    glw = torch.randn((c * g, c), generator=gen, device=dev) * \
        math.sqrt(2.0 / (c * g))
    kw = dict(last_layer=None, group_projection=gw, last_layer_group=glw)
    return feats, protos, kw, pack_head(protos, spec=spec, **kw)


def _proto_baseline(path: str):
    """K1's one-thread-per-pixel design (``csrc/proto.cu`` of an older
    commit, at ``path``), built, and a function that launches it on a
    packed head as its wrapper did: (features, head, spec, out) ->
    status."""
    so = _build.BUILD_DIR / "variants" / "proto_baseline.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"proto baseline {path}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(f"proto baseline build: "
          f"{_ptxas_summary(proc.stdout + proc.stderr, 'proto_kernel')}",
          flush=True)
    fn = ctypes.CDLL(str(so)).proto_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(feats, head, spec, out):
        from scaleprotoseg_torch.ops.prototype import EPSILON
        a, c, g = spec.num_active_prototypes, spec.num_classes, head.groups
        dev = feats.device
        bounds = torch.tensor([lo for lo, _ in spec.scale_bounds] + [a],
                              dtype=torch.int32, device=dev)
        cls = torch.tensor(spec.class_ids[:a], dtype=torch.int32,
                           device=dev)
        fixed = 64 * (64 + 2 + (g or c))      # shared words: bank chunk
        per_thread = c * g + c if g else c    # shared words: one pixel
        threads = next(t for t in (128, 64, 32)
                       if (fixed + per_thread * t) * 4 <= 232448)
        return fn(feats.data_ptr(), head.protos.data_ptr(),
                  head.pnorm.data_ptr(), bounds.data_ptr(), cls.data_ptr(),
                  head.head_w.data_ptr(), head.glw.data_ptr(),
                  out.data_ptr(), feats.shape[0], spec.num_scales, c, g,
                  EPSILON, threads, torch.cuda.current_stream().cuda_stream)

    return launch


def time_proto(dev, gen, baseline=None) -> None:
    """K1's variants (and, with ``baseline``, the design of an older
    commit) in turns at the flagship's and COCO-Stuff's banks, random and
    pushed, each with its error against the fp32 plain head and against
    the float64 one; then each variant's distance error
    (``distance_error``) under an identity plain head at the flagship's
    bank, on the sparse probe and at pushed prototypes."""
    from scaleprotoseg_torch.kernels.proto import (distance_error,
                                                   proto_float64,
                                                   proto_plain)
    from scaleprotoseg_torch.ops.prototype import EPSILON
    from scaleprotoseg_torch.spec import ProtoSpec
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = _build_variants("proto", "proto_forward",
                          [ptr] * 7 + [i32] * 7 + [ctypes.c_float, ptr])
    stream = torch.cuda.current_stream().cuda_stream
    base = None if baseline is None else _proto_baseline(baseline)
    flagship = ProtoSpec.equal_allocation(228, 64, 19, num_groups=3)
    coco = ProtoSpec.equal_allocation(2054, 64, 171, num_groups=3)
    identity = ProtoSpec.equal_allocation(228, 64, 228, num_groups=0)
    cases = [("flagship", flagship, PIXELS, "random"),
             ("flagship", flagship, PIXELS, "pushed"),
             ("coco_stuff", coco, 2 * 65 * 65, "random"),
             ("coco_stuff", coco, 2 * 65 * 65, "pushed"),
             ("identity_head", identity, PIXELS, "sparse"),
             ("identity_head", identity, PIXELS, "pushed")]
    for label, spec, n, kind in cases:
        feats, protos, kw, head = _proto_case(dev, gen, spec, n, kind)
        c = spec.num_classes
        x4 = feats[None, None]
        want = proto_plain(x4, protos, **kw, spec=spec).reshape(n, c)
        want64 = proto_float64(x4, protos, **kw, spec=spec).reshape(n, c)
        what = f"proto {label} {n} px {kind}"
        line = (f"{what} fp32 plain head: max |err| against float64 "
                f"{(want - want64).abs().max().item():.3g} (float64 logits "
                f"up to {want64.abs().max().item():.4g})")
        if not head.groups:
            line += (f", distance error "
                     f"{distance_error(want, feats, protos, spec):.3g} "
                     f"(units of 2^-24 (|x_s| + |p|)^2)")
        print(line, flush=True)
        calls = {}
        for name, fn in fns.items():
            calls[name] = (lambda fn=fn, out=None: fn(
                feats.data_ptr(), head.bank.data_ptr(), head.steps.data_ptr(),
                head.chunk_pn.data_ptr(), head.table.data_ptr(),
                head.glw_pad.data_ptr(), out.data_ptr(), n, spec.num_scales,
                head.steps.shape[0], head.columns.shape[0], c, head.groups,
                head.glw_pad.shape[1], EPSILON, stream))
        if base is not None:
            calls["baseline"] = lambda out=None: base(feats, head, spec, out)
        outs = {}
        for turn in range(2 if kind == "random" else 1):
            for name, call in calls.items():
                out = torch.zeros((n, c), device=dev)
                status = call(out=out)
                torch.cuda.synchronize()
                outs[name] = out
                err = (out - want).abs()
                tol = (err - 1e-4 * want.abs()).max().item()
                same = "" if "timing_only" in name else \
                    f"max |difference| from shipped " \
                    f"{_max_diff(out, outs['shipped']):g}, "
                line = (f"{what} turn {turn} {name}: status {status}, {same}"
                        f"max |err| {err.max().item():.3g}, max |err| - "
                        f"1e-4 |want| {tol:.3g} (within rtol = atol = 1e-4 "
                        f"when <= 1e-4), max |err| against float64 "
                        f"{(out - want64).abs().max().item():.3g}")
                if head.groups:
                    ms = _median_ms(lambda: call(out=out))
                    line += f", median {ms:.4f} ms"
                elif "timing_only" not in name:
                    line += (f", distance error "
                             f"{distance_error(out, feats, protos, spec):.3g}")
                print(line, flush=True)


def time_upsample(dev, gen) -> None:
    from scaleprotoseg_torch.kernels import upsample as tup
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = _build_variants("upsample", "upsample_argmax_forward",
                          [ptr] * 6 + [i32] * 10 + [ptr])
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, w, c, hh, ww in ((2, 129, 257, 19, 1024, 2048),
                               (2, 65, 65, 19, 513, 513)):
        lg = torch.randn((b, h, w, c), generator=gen, device=dev)
        yi, yw = (torch.as_tensor(t, device=dev)
                  for t in tup.interp_taps(hh, h))
        xi, xw = (torch.as_tensor(t, device=dev)
                  for t in tup.interp_taps(ww, w))
        outs = {}
        for turn in range(2):
            for name, fn in fns.items():
                for span in (256, 128):
                    band = UPSAMPLE_BANDS.get(name, tup._BAND)
                    rows = tup._reach(yi.cpu().numpy(), band)
                    cols = tup._reach(xi.cpu().numpy(), span)
                    out = torch.zeros((b, hh, ww), dtype=torch.uint8,
                                      device=dev)

                    def call():
                        return fn(lg.data_ptr(), yi.data_ptr(), yw.data_ptr(),
                                  xi.data_ptr(), xw.data_ptr(),
                                  out.data_ptr(), 0, b, h, w, c, hh, ww,
                                  span, rows, cols, stream)

                    status = call()
                    torch.cuda.synchronize()
                    key = f"{name} span {span}"
                    outs[key] = out
                    diff = (out != outs["shipped span 256"]).sum().item()
                    print(f"upsample {b}x{h}x{w}x{c} -> {hh}x{ww} turn "
                          f"{turn} {key}: status {status}, {diff} labels "
                          f"differ from shipped, median "
                          f"{_median_ms(call):.4f} ms", flush=True)


def _has_out_dtype(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether this PyTorch's ``torch.mm`` takes ``out_dtype``."""
    try:
        torch.mm(a[:8, :8].t(), b[:8, :8], out_dtype=torch.float32)
        return True
    except TypeError:
        return False


TIMERS = {"aspp": time_aspp, "int8_mm": time_int8,
          "int8_conv3x3": time_conv, "aspp_grad_weight": time_grad_weight,
          "proto": time_proto, "upsample": time_upsample}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: CUDA is not available")
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("kernels", nargs="*", metavar="KERNEL",
                      help=f"any of {', '.join(TIMERS)} (default: all)")
    args.add_argument("--proto-baseline", metavar="PROTO_CU",
                      help="csrc/proto.cu of an older commit (the one-"
                      "thread-per-pixel design), timed in turns with K1's "
                      "variants")
    args = args.parse_args()
    names = args.kernels or list(TIMERS)
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
        if name == "proto":
            time_proto(dev, gen, args.proto_baseline)
        else:
            TIMERS[name](dev, gen)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
