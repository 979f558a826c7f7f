// int8 tensor-core products of the quant8 serving path.
//
// Replaces benchmarks/bench_int8_mosaic.py::pallas_mm (K4, pallas_call :48):
// a tiled (M, K) @ (K, N) product, int8 x int8 -> int32 or bf16 x bf16 ->
// fp32, and its stage 2, the int8 dilated 3x3 conv (int8_dilated_conv,
// :63), which XLA's s8 conv lowering runs for scaleprotoseg_tpu/ops/quant.py
// (static_int8_conv / dynamic_int8_conv) on layer4/5 of the ResNet.
//
// Kernels:
//   int8_gemm_kernel     A (M, K) int8 @ Bt (N, K)^T int8 -> int32, or the
//                        dequantized bf16(float(acc) * (sx * sw[n])) or fp32:
//                        TMA-fed wgmma, see "int8 GEMM" below;
//   int8_conv3x3_kernel  the implicit-GEMM dilated 3x3 conv with the same
//                        outputs: TMA-fed wgmma on K2's strip design, see
//                        "int8 conv" below;
//   bf16_gemm_kernel     A (M, K) bf16 @ Bt (N, K)^T bf16 -> fp32
//                        (pallas_mm's other arm) on an mma.sync tile;
//   quantize_kernel    bf16/fp32 NHWC -> int8, static (x * (1 / max(s,
//                      1e-12))) or dynamic (x / s), rintf (half to even),
//                      clipped to +-127;
//   absmax_*_kernel    the dynamic scale max(max|x|, 1e-12) / 127 in two
//                      passes (per-block maxima, then one block), no atomics.
//
// Bound: the layer4/5 convs are operations-bound (~5.4 T int8 operations
// per 2 x 1024 x 2048 batch against a few GB of traffic), except the 1x1
// products with K = 256 or 512 into 1024 or 2048 channels, whose bf16
// output makes them bytes-bound; K4 at its own benchmark shape (8192 x 512 x
// 512) and the quantize passes are bytes-bound.
//
// int8 GEMM (int8_gemm_kernel).  Both operands are K-contiguous, the only
// form wgmma takes for 8-bit types, so two 2-D tensor maps feed it: a block
// owns a 128 x 256 output tile (int8 runs at twice bf16's rate and needs
// about twice the operations per staged byte: 171 per byte here against 128
// for a 128 x 128 tile) and walks K in 128-byte chunks; a stage is a 128 x
// 128 A box and a 256 x 128 B box (48 KB, 128-byte swizzle) in a 4-stage
// ring guarded by full/empty mbarriers.  Rows past M and columns past N
// arrive as zeros from TMA and are masked in the epilogue.  One producer
// warp starts the loads; two consumer warpgroups each own 64 rows: per
// stage four wgmma m64n256k32 s8 -> s32 with the 128 accumulators in
// registers, a stage released one step late so a batch is always in
// flight.  The grid is persistent (one block per SM, N tiles fastest so an
// A row block is reused from L2): while the consumers write a tile the
// producer already fills the ring for the next one, which is what the
// K = 256 and 512 shapes (2-4 chunks) live on.  The epilogue works from the
// registers: the scale product (staged in shared memory once per tile), one
// rounding, then a shuffle inside each quad so that every lane stores 16
// bytes (bf16: eight columns of one n8 block; int32/fp32: four) and every
// 32-byte sector is written whole.
//
// int8 conv (int8_conv3x3_kernel).  K2's design (csrc/aspp.cu) with s8
// operands.  A work item is a 32 x 8 output patch by 128 output channels;
// its input is 4-D TMA boxes of the unpadded NHWC map at the patch's
// coordinates shifted by the tap, signed, so that what lies outside the
// image arrives as zeros: the conv's zero padding (the int8 zero is the
// quantized zero).  A K chunk is 128 channels (128 bytes), so a strip row
// of 8 pixels is 1024 bytes, one period of the 128-byte swizzle, and the
// three dy taps of one dx are three views of one staged column strip of
// 32 + 2 * dil rows, dil rows apart (any row offset keeps a valid
// descriptor); above MAX_STRIP_DIL the taps are staged one by one.  A
// stage is the strip (8-row boxes of 8 KB: 40 KB at dil 4) and the three
// taps' 128 x 128-byte weight tiles (48 KB), ~290 int8 operations per
// staged byte, in a 2-stage ring (a third stage does not fit in shared
// memory).  Taps and m64 blocks wholly outside the image are skipped by
// producer and consumers alike (at 129 rows the last patch row holds one
// image row).  Two consumer warpgroups each own 16 patch rows (two m64
// blocks): wgmma m64n128k32 s8 -> s32, 128 accumulators a thread as in the
// GEMM (an n256 tile would need 256), exact in int32 over every stage, a
// stage released as soon as its batch is done (held one step longer, as
// the GEMM's 4-slot ring does, it cost 19% with two slots).  The grid is
// persistent with the output channel tile fastest: a layer4 item has only
// 6 stages (2 chunks x 3 dx), so the producer filling the ring for the
// next item while the consumers write this one is what keeps the tensor
// cores busy.  The epilogue is the
// GEMM's: scales staged once per item, one rounding, 16-byte stores, rows
// and columns past the image masked.
//
// mma.sync tile (bf16_gemm_kernel): a block owns BM = 128 output rows
// by BN = 128 output channels and walks K in 64-byte chunks (32 bf16),
// staging a 128 x 64-byte A tile and a 128 x 64-byte B tile with cp.async
// in a 4-stage ring (rows past M zero-filled: src-size 0).  Both operands
// are K-contiguous in shared memory (rows padded to 80 bytes:
// conflict-free ldmatrix), which is the row.col layout of mma.sync.  Eight
// warps each own a 64 x 32 piece: per 32-byte K slice 4 ldmatrix.x4 for A,
// 2 for B and 16 mma.sync m16n8k16 bf16 -> f32.  The epilogue writes from
// the fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BKB = 64;          // K bytes per stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int LDS = BKB + 16;    // shared row stride in bytes
constexpr int A_STAGE = BM * LDS;
constexpr int B_STAGE = BN * LDS;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);

enum Mode { RAW = 0, DEQUANT_BF16 = 1, DEQUANT_F32 = 2 };

template <int MODE>
constexpr int OUT_BYTES = MODE == DEQUANT_BF16 ? 2 : 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// mma.sync m16n8k16 bf16 -> f32, D += A B.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out (M, N) fp32 = a (M, Kb bytes of bf16) @ bt (N, Kb)^T.
__global__ void __launch_bounds__(THREADS) bf16_gemm_kernel(
    const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
    float* __restrict__ out, int M, int Kb, int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* As = smem;
  uint8_t* Bs = smem + STAGES * A_STAGE;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;

  // Loader mapping: 16-byte chunk `col` of rows `row` and `row + 64`.
  const int col = tid & 3;
  const int row = tid >> 2;
  const int KT = Kb / BKB;

  auto load_stage = [&](int stage, int it) {
    const int k0 = it * BKB + col * 16;
    uint8_t* as = As + stage * A_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + row + 64 * j;
      const bool v = m < M;
      cp_async16(as + (row + 64 * j) * LDS + col * 16,
                 v ? a + (size_t)m * Kb + k0 : a, v);
    }
    uint8_t* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = row + 64 * j;
      cp_async16(bs + n * LDS + col * 16, bt + (size_t)(n0 + n) * Kb + k0,
                 true);
    }
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // 2 warps along M, 64 rows each
  const int wn = warp >> 1;  // 4 warps along N, 32 columns each
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix lane addresses: A matrices (rows 0-7 | 8-15) x (bytes 0-15 |
  // 16-31) -> a0..a3; B matrices (n 0-7: bytes 0-15, 16-31; n 8-15: the
  // same) -> b0, b1 of two n8 tiles.
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int it = 0; it < KT; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < KT) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const uint8_t* as = As + (it % STAGES) * A_STAGE;
    const uint8_t* bs = Bs + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BKB; kk += 32) {
      uint32_t fa[4][4];
      uint32_t fb[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(fa[i], as + (wm * 64 + i * 16 + a_row) * LDS + kk + a_col);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4(fb[j], bs + (wn * 32 + j * 16 + b_row) * LDS + kk + b_col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], fa[i], fb[j >> 1][(j & 1) * 2],
                   fb[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Fragment (i, j): rows g and g + 8 of the m16 tile, columns 2 * tig and
  // 2 * tig + 1 of the n8 tile.
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + tig * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + g + h * 8;
        if (m < M)
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// Writes the two rows (h = 0, 1) that lane (g, t) of a warp holds of an
// m64 x 8 * NB int32 accumulator block in wgmma's layout (n8 block i:
// acc[4i + 2h], acc[4i + 2h + 1] at columns 8i + 2t, + 1): row h to
// `row[h]` (elements of the output type; nullptr where masked), its
// columns from 0 and the staged scales `sc` of the same columns, columns
// from `cols` on masked.  The scale product was formed first, as the
// reference forms it; one rounding; a shuffle inside each quad so that
// every lane stores 16 bytes (bf16: eight columns of one n8 block;
// int32/fp32: four) and every 32-byte sector is written whole.
template <int MODE, int NB>
__device__ __forceinline__ void store_acc_rows(const int32_t (&acc)[4 * NB],
                                               const float* sc,
                                               void* const (&row)[2],
                                               int cols) {
  const int t = threadIdx.x & 3;
  if constexpr (MODE == DEQUANT_BF16) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      float2 s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] = *reinterpret_cast<const float2*>(sc + 8 * (4 * q + j) + 2 * t);
      const int c = (4 * q + t) * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * q + j;
          __nv_bfloat162 v = __floats2bfloat162_rn(
              static_cast<float>(acc[4 * i + 2 * h]) * s[j].x,
              static_cast<float>(acc[4 * i + 2 * h + 1]) * s[j].y);
          w[j] = *reinterpret_cast<uint32_t*>(&v);
        }
        quad_transpose(w);
        if (row[h] != nullptr && c < cols)
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(row[h]) + c) =
              make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  } else {
    // 4-byte outputs: lanes t and t ^ 1 swap halves of two n8 blocks, the
    // even lane keeps four columns of block i, the odd of i + 1
    const bool odd = t & 1;
#pragma unroll
    for (int i = 0; i < NB; i += 2) {
      float s[2][2];
      if (MODE != RAW) {
#pragma unroll
        for (int jb = 0; jb < 2; ++jb) {
          const float2 v =
              *reinterpret_cast<const float2*>(sc + 8 * (i + jb) + 2 * t);
          s[jb][0] = v.x;
          s[jb][1] = v.y;
        }
      }
      const int c = odd ? 8 * (i + 1) + 2 * (t - 1) : 8 * i + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[2][2];
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int32_t a32 = acc[4 * (i + jb) + 2 * h + e];
            v[jb][e] = MODE == RAW
                ? static_cast<uint32_t>(a32)
                : __float_as_uint(static_cast<float>(a32) * s[jb][e]);
          }
        const uint32_t r0 =
            __shfl_xor_sync(0xffffffffu, odd ? v[0][0] : v[1][0], 1);
        const uint32_t r1 =
            __shfl_xor_sync(0xffffffffu, odd ? v[0][1] : v[1][1], 1);
        const uint4 o = odd ? make_uint4(r0, r1, v[1][0], v[1][1])
                            : make_uint4(v[0][0], v[0][1], r0, r1);
        if (row[h] != nullptr && c < cols)
          *reinterpret_cast<uint4*>(static_cast<uint32_t*>(row[h]) + c) = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// int8 GEMM: TMA-fed wgmma, persistent 128 x 256 tiles
// ---------------------------------------------------------------------------
constexpr int TM = 128;
constexpr int TN = 256;
constexpr int TKB = 128;           // K bytes per stage
constexpr int G_STAGES = 4;
constexpr int G_CONSUMER_WGS = 2;
constexpr int G_THREADS = 128 * (G_CONSUMER_WGS + 1);
constexpr int G_A_BYTES = TM * TKB;
constexpr int G_B_BYTES = TN * TKB;
constexpr int G_STAGE_BYTES = G_A_BYTES + G_B_BYTES;
constexpr int G_SCALE_BYTES = 2 * TN * 4;   // a tile's scales, two tiles deep
constexpr int G_SMEM_BYTES =
    G_STAGES * G_STAGE_BYTES + G_SCALE_BYTES + 1024 + 2 * G_STAGES * 8;

template <int MODE>
__global__ void __launch_bounds__(G_THREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,   // (M, K)
                 const __grid_constant__ CUtensorMap b_map,   // (N, K)
                 void* __restrict__ out, const float* __restrict__ sx,
                 const float* __restrict__ sw, int M, int K, int N,
                 int tiles_n, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* scales = reinterpret_cast<float*>(smem + G_STAGES * G_STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + G_STAGES * G_STAGE_BYTES + G_SCALE_BYTES);
  uint64_t* empty = full + G_STAGES;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, G_CONSUMER_WGS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int chunks = (K + TKB - 1) / TKB;

  if (wg == G_CONSUMER_WGS) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    if (threadIdx.x == G_CONSUMER_WGS * 128) {
      int stage = 0;
      uint32_t phase = 1;   // the ring starts empty: the first waits pass
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * TM;
        const int n0 = (tile % tiles_n) * TN;
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(empty + stage, phase);
          uint8_t* a = smem + stage * G_STAGE_BYTES;
          mbar_arrive_expect_tx(full + stage, G_STAGE_BYTES);
          tma_load_2d(a, &a_map, full + stage, kc * TKB, m0);
          tma_load_2d(a + G_A_BYTES, &b_map, full + stage, kc * TKB, n0);
          if (++stage == G_STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    reg_alloc<232>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2;
    const float s_x = MODE == RAW ? 0.0f : sx[0];
    int stage = 0;
    uint32_t phase = 0;
    int parity = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * TM;
      const int n0 = (tile % tiles_n) * TN;

      // the tile's 256 scales, the scale product first as the reference,
      // staged once by the 256 consumer threads: loading them from global
      // memory inside the epilogue left its latency exposed on every tile.
      // Two buffers and one barrier per tile: a thread that passes the
      // barrier of tile i + 1 has finished reading the buffer of tile i.
      const float* sc = scales + parity * TN;
      if (MODE != RAW) {
        const int n = n0 + threadIdx.x;
        scales[parity * TN + threadIdx.x] = n < N ? s_x * sw[n] : 0.0f;
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        parity ^= 1;
      }

      int32_t acc[128];
      int prev = -1;
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait(full + stage, phase);
        const uint8_t* base = smem + stage * G_STAGE_BYTES;
        const uint64_t da = wgmma_desc(base + wg * (64 * TKB));
        const uint64_t db = wgmma_desc(base + G_A_BYTES);
        wgmma_fence();
        if (K - kc * TKB >= TKB) {
#pragma unroll
          for (int kk = 0; kk < TKB / 32; ++kk)
            wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk,
                                (kc > 0 || kk > 0) ? 1 : 0);
        } else {
          // K % 128 == 64: the last chunk's upper half is TMA's zero fill
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk,
                                (kc > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();             // the previous stage's batch is done
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = stage;
        if (++stage == G_STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + prev);

      // epilogue from the registers: rows g and g + 8 of this warp's m16
      const int row0 = m0 + wg * 64 + warp * 16 + g;
      void* rows[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rows[h] = row0 + 8 * h < M
            ? static_cast<uint8_t*>(out) +
                  ((size_t)(row0 + 8 * h) * N + n0) * OUT_BYTES<MODE>
            : nullptr;
      store_acc_rows<MODE, TN / 8>(acc, sc, rows, N - n0);
    }
  }
}

template <int MODE>
int launch_gemm(const CUtensorMap& a_map, const CUtensorMap& b_map, void* out,
                const float* sx, const float* sw, int M, int K, int N,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G_SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_n = (N + TN - 1) / TN;
  const long tiles = (long)((M + TM - 1) / TM) * tiles_n;
  int sms = 0;
  e = hopper::sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = tiles < sms ? (int)tiles : sms;
  int8_gemm_kernel<MODE><<<grid, G_THREADS, G_SMEM_BYTES, stream>>>(
      a_map, b_map, out, sx, sw, M, K, N, tiles_n, (int)tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// int8 conv: TMA-fed wgmma over column strips, persistent
// ---------------------------------------------------------------------------
constexpr int PH = 32;             // patch rows
constexpr int PW = 8;              // patch columns: a strip row is 1024 bytes
constexpr int CN = 128;            // output channels per item
constexpr int CKB = 128;           // input channels (bytes) per stage
constexpr int C_STAGES = 2;
constexpr int C_CONSUMER_WGS = 2;
constexpr int C_THREADS = 128 * (C_CONSUMER_WGS + 1);
constexpr int BOX_ROWS = 8;                          // rows per TMA box
constexpr int BOX_BYTES = BOX_ROWS * PW * CKB;       // 8 KB
constexpr int MAX_BOXES = 8;                         // strip rows / 8
constexpr int MAX_STRIP_DIL = (MAX_BOXES * BOX_ROWS - PH) / 2;
constexpr int C_A_BYTES = MAX_BOXES * BOX_BYTES;
constexpr int C_B_BYTES = CN * CKB;                  // one tap's weight tile
constexpr int C_STAGE_BYTES = C_A_BYTES + 3 * C_B_BYTES;
constexpr int C_SCALE_BYTES = 2 * CN * 4;   // an item's scales, two deep
constexpr int C_SMEM_BYTES =
    C_STAGES * C_STAGE_BYTES + C_SCALE_BYTES + 1024 + 2 * C_STAGES * 8;
constexpr int ROW_BYTES = PW * CKB;
static_assert(ROW_BYTES == 1024 && (PH / C_CONSUMER_WGS) * PW == 128 &&
              PH % BOX_ROWS == 0 && C_STAGE_BYTES % 1024 == 0,
              "a strip row spans one swizzle period; a consumer warpgroup "
              "owns two m64 blocks of whole patch rows");
static_assert(C_SMEM_BYTES <= 232448, "one block's shared memory");

struct Patch {
  int b, y0, x0, n0;
};

// Item -> (batch, patch, output-channel tile), the channel tile fastest so
// the blocks running together read one patch's input from L2.
__device__ __forceinline__ Patch decode_patch(int item, int n_tiles, int npx,
                                              int npy) {
  Patch it;
  int p = item / n_tiles;
  it.n0 = (item - p * n_tiles) * CN;
  it.x0 = (p % npx) * PW;
  p /= npx;
  it.y0 = (p % npy) * PH;
  it.b = p / npy;
  return it;
}

// Bit t is set when tap t's shifted patch touches the image.
__device__ __forceinline__ int patch_taps(const Patch& it, int dil, int H,
                                          int W) {
  int mask = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int y = it.y0 + (tap / 3 - 1) * dil;
    const int x = it.x0 + (tap % 3 - 1) * dil;
    if (y + PH > 0 && y < H && x + PW > 0 && x < W) mask |= 1 << tap;
  }
  return mask;
}

// Bit 4 * dyi + j is set when the patch's m64 block j (rows 8j .. 8j + 7),
// shifted by (dyi - 1) * dil, has a row inside the image: a block outside
// reads only zeros, so its wgmma and, where no live block needs them, the
// boxes under it are left out (at 129 rows the last of five patch rows
// holds one image row).
__device__ __forceinline__ int patch_blocks(const Patch& it, int dil, int H) {
  int live = 0;
#pragma unroll
  for (int dyi = 0; dyi < 3; ++dyi)
#pragma unroll
    for (int j = 0; j < PH / BOX_ROWS; ++j) {
      const int y = it.y0 + j * BOX_ROWS + (dyi - 1) * dil;
      if (y + BOX_ROWS > 0 && y < H) live |= 1 << (4 * dyi + j);
    }
  return live;
}

// The stages of an item, in the order producer and consumers both walk:
// f(kc, dxi, first_row, boxes, taps, strip) with `taps` the dy bits (bit
// dyi: tap 3 * dyi + dxi) that read this stage, `first_row` the image row
// of its first strip row and `boxes` the bits of the 8-row boxes to load;
// in a strip tap dyi reads from strip row dyi * dil on, else from row 0.
template <typename Fn>
__device__ __forceinline__ void for_each_conv_stage(const Patch& it, int dil,
                                                    int mask, int live,
                                                    int chunks, Fn&& f) {
  const bool strip = dil <= MAX_STRIP_DIL;
  int strip_boxes = 0;
#pragma unroll
  for (int dyi = 0; dyi < 3; ++dyi)
#pragma unroll
    for (int j = 0; j < PH / BOX_ROWS; ++j)
      if ((live >> (4 * dyi + j)) & 1) {
        const int row = dyi * dil + j * BOX_ROWS;
        strip_boxes |= 1 << (row / BOX_ROWS);
        strip_boxes |= 1 << ((row + BOX_ROWS - 1) / BOX_ROWS);
      }
  for (int kc = 0; kc < chunks; ++kc) {
    for (int dxi = 0; dxi < 3; ++dxi) {
      const int taps = ((mask >> dxi) & 1) | (((mask >> (dxi + 3)) & 1) << 1) |
                       (((mask >> (dxi + 6)) & 1) << 2);
      for (int part = 0; part < (strip ? 1 : 3); ++part) {
        const int mine = strip ? taps : taps & (1 << part);
        if (mine == 0) continue;
        f(kc, dxi, it.y0 + (strip ? -dil : (part - 1) * dil),
          strip ? strip_boxes : (live >> (4 * part)) & 15, mine, strip);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(C_THREADS, 1)
int8_conv3x3_kernel(const __grid_constant__ CUtensorMap x_map,  // (B, H, W, C)
                    const __grid_constant__ CUtensorMap w_map,  // (9 * N, C)
                    void* __restrict__ out,                     // (B, H, W, N)
                    const float* __restrict__ sx,
                    const float* __restrict__ sw, int H, int W, int C, int N,
                    int dil, int npx, int npy, int n_items) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* scales = reinterpret_cast<float*>(smem + C_STAGES * C_STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + C_STAGES * C_STAGE_BYTES + C_SCALE_BYTES);
  uint64_t* empty = full + C_STAGES;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, C_CONSUMER_WGS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int chunks = (C + CKB - 1) / CKB;
  const int n_tiles = N / CN;

  if (wg == C_CONSUMER_WGS) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    if (threadIdx.x == C_CONSUMER_WGS * 128) {
      int stage = 0;
      uint32_t phase = 1;   // the ring starts empty: the first waits pass
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Patch it = decode_patch(item, n_tiles, npx, npy);
        const int mask = patch_taps(it, dil, H, W);
        const int live = patch_blocks(it, dil, H);
        for_each_conv_stage(it, dil, mask, live, chunks,
                            [&](int kc, int dxi, int first_row, int boxes,
                                int taps, bool) {
          mbar_wait(empty + stage, phase);
          uint8_t* a = smem + stage * C_STAGE_BYTES;
          mbar_arrive_expect_tx(full + stage, __popc(boxes) * BOX_BYTES +
                                                  __popc(taps) * C_B_BYTES);
          const int x = it.x0 + (dxi - 1) * dil;
          for (int k = 0; k < MAX_BOXES; ++k)
            if ((boxes >> k) & 1)
              tma_load_4d(a + k * BOX_BYTES, &x_map, full + stage, kc * CKB,
                          x, first_row + k * BOX_ROWS, it.b);
#pragma unroll
          for (int dyi = 0; dyi < 3; ++dyi)
            if ((taps >> dyi) & 1)
              tma_load_2d(a + C_A_BYTES + dyi * C_B_BYTES, &w_map,
                          full + stage, kc * CKB, (3 * dyi + dxi) * N + it.n0);
          if (++stage == C_STAGES) { stage = 0; phase ^= 1; }
        });
      }
    }
  } else {
    // ---------------- consumers ----------------
    reg_alloc<232>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2;
    const float s_x = MODE == RAW ? 0.0f : sx[0];
    int stage = 0;
    uint32_t phase = 0;
    int parity = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Patch it = decode_patch(item, n_tiles, npx, npy);
      const int mask = patch_taps(it, dil, H, W);
      const int live = patch_blocks(it, dil, H);

      // the item's scales, two buffers as in the GEMM
      const float* sc = scales + parity * CN;
      if (MODE != RAW) {
        if (threadIdx.x < CN)
          scales[parity * CN + threadIdx.x] = s_x * sw[it.n0 + threadIdx.x];
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        parity ^= 1;
      }

      int32_t acc[2][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
      for_each_conv_stage(it, dil, mask, live, chunks,
                          [&](int kc, int, int, int, int taps, bool strip) {
        mbar_wait(full + stage, phase);
        const uint8_t* a = smem + stage * C_STAGE_BYTES;
        // C % 128 == 64: the last chunk's upper half is TMA's zero fill
        const int slices = C - kc * CKB >= CKB ? CKB / 32 : 2;
        wgmma_fence();
#pragma unroll
        for (int dyi = 0; dyi < 3; ++dyi) {
          if (!((taps >> dyi) & 1)) continue;
          const int row = (strip ? dyi * dil : 0) + wg * (PH / C_CONSUMER_WGS);
          const uint64_t da = wgmma_desc(a + row * ROW_BYTES);
          const uint64_t db = wgmma_desc(a + C_A_BYTES + dyi * C_B_BYTES);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            if (!((live >> (4 * dyi + 2 * wg + mb)) & 1)) continue;
            for (int kk = 0; kk < slices; ++kk)
              wgmma_m64n128k32_s8(acc[mb], da + mb * (64 * CKB >> 4) + 2 * kk,
                                  db + 2 * kk, 1);
          }
        }
        // released as soon as its batch is done: with two slots, holding
        // one back until the next stage is issued left the producer idle
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == C_STAGES) { stage = 0; phase ^= 1; }
      });

      // epilogue: rows g and g + 8 of this warp's m16 in each m64 block
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        void* rows[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lp = wg * 128 + mb * 64 + warp * 16 + g + 8 * h;
          const int y = it.y0 + lp / PW;
          const int x = it.x0 + lp % PW;
          rows[h] = y < H && x < W
              ? static_cast<uint8_t*>(out) +
                    ((((size_t)it.b * H + y) * W + x) * N + it.n0) *
                        OUT_BYTES<MODE>
              : nullptr;
        }
        store_acc_rows<MODE, CN / 8>(acc[mb], sc, rows, CN);
      }
    }
  }
}

template <int MODE>
int launch_conv(const CUtensorMap& x_map, const CUtensorMap& w_map,
                void* out, const float* sx, const float* sw, int B, int H,
                int W, int C, int N, int dil, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_conv3x3_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C_SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int npx = (W + PW - 1) / PW;
  const int npy = (H + PH - 1) / PH;
  const long items = (long)B * npy * npx * (N / CN);
  if (items > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  e = hopper::sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = items < sms ? (int)items : sms;
  int8_conv3x3_kernel<MODE><<<grid, C_THREADS, C_SMEM_BYTES, stream>>>(
      x_map, w_map, out, sx, sw, H, W, C, N, dil, npx, npy, (int)items);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// quantize and the dynamic scale
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load8(const __nv_bfloat16* x, long i,
                                      float (&v)[8]) {
  uint4 raw = reinterpret_cast<const uint4*>(x)[i];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* x, long i, float (&v)[8]) {
  const float4* p = reinterpret_cast<const float4*>(x) + 2 * i;
  float4 a = p[0], b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                int8_t* __restrict__ q,
                                const float* __restrict__ scale, long n8,
                                int divide) {
  const float s = scale[0];
  const float inv = 1.0f / fmaxf(s, 1e-12f);
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n8;
       i += (long)gridDim.x * blockDim.x) {
    float v[8];
    load8(x, i, v);
    uint2 packed;
    int8_t* b = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float r = rintf(divide ? v[e] / s : v[e] * inv);
      b[e] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    }
    reinterpret_cast<uint2*>(q)[i] = packed;
  }
}

__device__ __forceinline__ float block_max(float m) {
  __shared__ float red[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = (threadIdx.x < (blockDim.x >> 5)) ? red[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

template <typename T>
__global__ void absmax_partial_kernel(const T* __restrict__ x,
                                      float* __restrict__ partials,
                                      long n8) {
  float m = 0.0f;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n8;
       i += (long)gridDim.x * blockDim.x) {
    float v[8];
    load8(x, i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

__global__ void absmax_final_kernel(const float* __restrict__ partials,
                                    int n, float* __restrict__ scale) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, partials[i]);
  m = block_max(m);
  if (threadIdx.x == 0) scale[0] = fmaxf(m, 1e-12f) / 127.0f;
}

constexpr int EW_THREADS = 256;

int ew_blocks(long n8) {
  long b = (n8 + EW_THREADS - 1) / EW_THREADS;
  return static_cast<int>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// a (M, K) int8, bt (N, K) int8 (the weight, K-contiguous), all contiguous.
// mode 0: out (M, N) int32 = a @ bt^T; mode 1: bf16 and mode 2: fp32
// float(acc) * (sx[0] * sw[n]).  Requires K % 64 == 0, N % 128 == 0 and
// 16-byte aligned operands (TMA).
extern "C" int int8_mm(const void* a, const void* bt, void* out,
                       const float* sx, const float* sw, int M, int K, int N,
                       int mode, void* stream) {
  if (M < 1 || K % 64 != 0 || N % 128 != 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, b_map;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t b_dims[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t a_box[2] = {TKB, TM};
  const uint32_t b_box[2] = {TKB, TN};
  if (!hopper::encode_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, a,
                          a_dims, a_box) ||
      !hopper::encode_map(&b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, bt,
                          b_dims, b_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == RAW)
    return launch_gemm<RAW>(a_map, b_map, out, sx, sw, M, K, N, s);
  if (mode == DEQUANT_BF16)
    return launch_gemm<DEQUANT_BF16>(a_map, b_map, out, sx, sw, M, K, N, s);
  return launch_gemm<DEQUANT_F32>(a_map, b_map, out, sx, sw, M, K, N, s);
}

// a (M, K) bf16, bt (N, K) bf16 -> out (M, N) fp32 = a @ bt^T.
// Requires K % 32 == 0, N % 128 == 0.
extern "C" int bf16_mm(const void* a, const void* bt, void* out, int M, int K,
                       int N, void* stream) {
  const int kb = 2 * K;
  if (M < 1 || kb % BKB != 0 || N % BN != 0 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      bf16_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(N / BN, (M + BM - 1) / BM);
  bf16_gemm_kernel<<<grid, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt),
      static_cast<float*>(out), M, kb, N);
  return static_cast<int>(cudaGetLastError());
}

// x (B, H, W, C) int8 NHWC, wt (9, N, C) int8 with tap t = 3 * ky + kx,
// zero padding = dil; out (B, H, W, N) as int8_mm's modes.  Requires
// C % 64 == 0, N % 128 == 0, 16-byte aligned operands (TMA).
extern "C" int int8_conv3x3(const void* x, const void* wt, void* out,
                            const float* sx, const float* sw, int B, int H,
                            int W, int C, int N, int dil, int mode,
                            void* stream) {
  if (B < 1 || H < 1 || W < 1 || dil < 1 || C % 64 != 0 || N % CN != 0 ||
      mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H,
                              (uint64_t)B};
  const uint32_t x_box[4] = {CKB, PW, BOX_ROWS, 1};
  const uint64_t w_dims[2] = {(uint64_t)C, (uint64_t)9 * N};
  const uint32_t w_box[2] = {CKB, CN};
  if (!hopper::encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, x,
                          x_dims, x_box) ||
      !hopper::encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, wt,
                          w_dims, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == RAW)
    return launch_conv<RAW>(x_map, w_map, out, sx, sw, B, H, W, C, N, dil, s);
  if (mode == DEQUANT_BF16)
    return launch_conv<DEQUANT_BF16>(x_map, w_map, out, sx, sw, B, H, W, C,
                                     N, dil, s);
  return launch_conv<DEQUANT_F32>(x_map, w_map, out, sx, sw, B, H, W, C, N,
                                  dil, s);
}

// x (n,) bf16 (in_bf16) or fp32 -> q (n,) int8 with scale[0]: divide = 0
// rounds x * (1 / max(s, 1e-12)), divide = 1 rounds x / s.  n % 8 == 0,
// 16-byte aligned.
extern "C" int quantize_int8(const void* x, void* q, const float* scale,
                             long n, int in_bf16, int divide, void* stream) {
  if (n < 8 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long n8 = n / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    quantize_kernel<<<ew_blocks(n8), EW_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), scale,
        n8, divide);
  else
    quantize_kernel<<<ew_blocks(n8), EW_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), scale, n8,
        divide);
  return static_cast<int>(cudaGetLastError());
}

// scale[0] = max(max|x|, 1e-12) / 127 over x (n,) bf16 or fp32; partials
// holds absmax_blocks(n) floats.
extern "C" int absmax_blocks(long n) { return ew_blocks(n / 8); }

extern "C" int int8_absmax(const void* x, float* partials, float* scale,
                           long n, int in_bf16, void* stream) {
  if (n < 8 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long n8 = n / 8;
  const int blocks = ew_blocks(n8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    absmax_partial_kernel<<<blocks, EW_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), partials, n8);
  else
    absmax_partial_kernel<<<blocks, EW_THREADS, 0, s>>>(
        static_cast<const float*>(x), partials, n8);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  absmax_final_kernel<<<1, 1024, 0, s>>>(partials, blocks, scale);
  return static_cast<int>(cudaGetLastError());
}
