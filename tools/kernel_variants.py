"""Time design variants of the two TMA + ``wgmma`` kernels on the card.

    python tools/kernel_variants.py

A variant is the kernel's source with a few exact text substitutions (a
smaller block, a persistent or a plain grid, taps staged one by one,
another tile order, fewer stages, a load left out), compiled beside the shipped one and timed in
turns with it at the main path's shapes: K2's forward at the serving and
the training shape, ``int8_mm`` with its bf16 epilogue at the 1x1 conv
shapes of a quant8 batch.  It answers "did this design step pay" with the
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

KERNELS = {"aspp": ASPP_VARIANTS, "int8_mm": INT8_VARIANTS}
RATES = (6, 12, 18, 24)
ASPP_SHAPES = ((2, 129, 257, 2048, 64), (2, 65, 65, 2048, 64))
PIXELS = 2 * 129 * 257
# (K, N, convs per quant8 batch) of layer4/5's 1x1 convs
INT8_SHAPES = ((512, 256, 1), (512, 1024, 1), (256, 1024, 23),
               (1024, 256, 22), (1024, 512, 1), (1024, 2048, 1),
               (512, 2048, 3), (2048, 512, 2))


def variant_source(kernel: str, name: str) -> str:
    """``csrc/<kernel>.cu`` with the variant's substitutions applied; each
    anchor must occur exactly as written."""
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    for old, new in KERNELS[kernel][name]:
        if old not in src:
            raise ValueError(f"{kernel} variant {name}: anchor not in the "
                             f"source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_variants(kernel: str, symbol: str, argtypes) -> dict:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(KERNELS[kernel]):
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    time_aspp(dev, gen)
    time_int8(dev, gen)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
