// Concat-ASPP forward (K2): four dilated 3x3 convolutions over one NHWC
// bf16 feature map, fp32 accumulation, bias, bf16 output.
//
// Replaces scaleprotoseg_tpu/ops/pallas_aspp.py::fused_aspp.
//
// Bound: operations.  At the flagship shape (2 x 129 x 257 x 2048 -> 4 x 64)
// the work is ~0.56 TFLOP against ~0.17 GB of traffic, far above the card's
// ~295 flop/byte ridge.  What limits a kernel in practice is the staging
// traffic: every (rate, tap) reads its own shifted copy of the input, and
// with F = 64 a staged input byte serves only 64 multiply-adds, so the L2 ->
// shared-memory stream (tap by tap ~9 GB of input per call, ~6 GB as staged
// here, plus ~3 GB of weight tiles), not the tensor cores, sets the pace.
//
// Design: an implicit GEMM fed by TMA and multiplied with wgmma.
//  - A block owns one work item: (batch, 32 x 8 output patch, rate, 64
//    output channels), rate fastest, so the blocks running together share
//    the patches' halos in L2.  Items differ in cost (taps and blocks are
//    skipped at the border), and the hardware's block scheduler balances
//    them better than a persistent grid walking them round-robin, which
//    measured slower at both path shapes.  The patch is a box because the
//    input of a tap is then a few 4-D TMA loads at the patch's coordinates
//    shifted by (dy, dx) * rate: coordinates are signed, and what falls
//    outside the image arrives as zeros, which is the conv's zero padding.
//    256 pixels make one staged weight tile serve four m64 row blocks; 128
//    pixels per block measured slower.  Rows and columns of a patch past
//    the image are masked in the epilogue.
//  - The three dy taps of one dx share their input.  A stage holds, for one
//    64-channel chunk and one dx, the column strip of 32 + 2 * rate rows
//    (in 8-row boxes of 8 KB) around the patch, and the taps dy = -1, 0, +1
//    are three views of it, rate rows apart.  The patch is 8 columns wide
//    for exactly this: a row of the strip is then 8 pixels x 128 bytes =
//    1024 bytes, the period of the 128-byte swizzle, so any row offset
//    keeps a valid wgmma descriptor (a shift along x would not: 6, 12 or 18
//    pixels break the pattern).  For rates 6/12/18/24 the strips hold 48 +
//    56 + 72 + 80 rows where tap-by-tap staging read 4 x 96: a third less
//    input through L2, which is what bounds the kernel.  A rate whose strip
//    does not fit (above MAX_STRIP_RATE) stages its taps one by one.
//  - K runs over 64-channel chunks (outermost, so the shifted reads of a
//    chunk meet in L2), then dx.  A tap whose window lies wholly outside
//    the image is all zeros and is skipped by producer and consumers alike,
//    and so is every m64 block of a tap that does (see live_blocks).
//    A stage is the strip (up to 88 KB) and the weight tiles of its taps (3
//    x 8 KB, K-major), all with the 128-byte swizzle, in a 2-stage ring
//    guarded by full/empty mbarriers.
//  - One producer warp starts the loads; two consumer warpgroups each own
//    16 patch rows (128 pixels): per tap 4 k16 slices x 2 wgmma m64n64k16
//    with fp32 accumulators in registers.  No __syncthreads in the K loop.
//    wgmma adds into its fp32 accumulator with truncation, a bias that
//    grows with the 18432-deep sum, so the accumulators start from zero in
//    every stage and are then added, rounded to nearest, into a second set
//    of fp32 registers on the CUDA cores, while the other stage loads.
//    Measured and dropped: a 4-stage ring of 32-channel stages (64-byte
//    rows: the TMA unit moved them a quarter slower) and clusters of two
//    blocks sharing each weight tile by multicast (the lockstep of the pair
//    cost more than the halved weight traffic gained).
//  - Epilogue: bias added in fp32, one rounding to bf16, a quad transpose so
//    that each lane stores 16 bytes into channels [rate * F + n0, + 64) of
//    the NHWC output.  No split K and no atomics: the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int PH = 32;            // patch rows
constexpr int PW = 8;             // patch columns: a strip row is 1024 bytes
constexpr int BN = 64;            // output channels per item
constexpr int BK = 64;            // input channels per stage (128 bytes)
constexpr int STAGES = 2;
constexpr int CONSUMER_WGS = 2;
constexpr int THREADS = 128 * (CONSUMER_WGS + 1);
constexpr int BOX_ROWS = 8;                         // rows per TMA box
constexpr int BOX_BYTES = BOX_ROWS * PW * BK * 2;   // 8 KB
constexpr int MAX_BOXES = 11;                       // strip rows / 8
constexpr int MAX_STRIP_RATE = (MAX_BOXES * BOX_ROWS - PH) / 2;
constexpr int A_BYTES = MAX_BOXES * BOX_BYTES;
constexpr int B_BYTES = BN * BK * 2;                // one tap's weight tile
constexpr int STAGE_BYTES = A_BYTES + 3 * B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr int ROW_BYTES = PW * BK * 2;
static_assert(ROW_BYTES == 1024 && (PH / CONSUMER_WGS) * PW == 128 &&
              PH % BOX_ROWS == 0 && STAGE_BYTES % 1024 == 0,
              "a strip row spans one swizzle period; a consumer warpgroup "
              "owns two m64 blocks of whole patch rows");
static_assert(SMEM_BYTES <= 232448, "one block's shared memory");

struct Item {
  int b, y0, x0, ri, n0;
};

__device__ __forceinline__ Item decode_item(int item, int n_tiles, int R,
                                            int npx, int npy) {
  Item it;
  const int per_patch = R * n_tiles;
  int p = item / per_patch;
  const int q = item - p * per_patch;
  it.ri = q / n_tiles;
  it.n0 = (q - it.ri * n_tiles) * BN;
  it.x0 = (p % npx) * PW;
  p /= npx;
  it.y0 = (p % npy) * PH;
  it.b = p / npy;
  return it;
}

// Bit t is set when tap t's shifted patch touches the image.
__device__ __forceinline__ int tap_mask(const Item& it, int rate, int H,
                                        int W) {
  int mask = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int y = it.y0 + (tap / 3 - 1) * rate;
    const int x = it.x0 + (tap % 3 - 1) * rate;
    if (y + PH > 0 && y < H && x + PW > 0 && x < W) mask |= 1 << tap;
  }
  return mask;
}

// Bit 4 * dyi + j is set when the patch's m64 block j (rows 8j .. 8j + 7),
// shifted by (dyi - 1) * rate, has a row inside the image: a block that
// lies outside reads only zeros, so its wgmma and, where no live block
// needs them, the boxes under it are left out.  At 129 rows the last of
// five 32-row patches holds one image row, and every halo at the border is
// empty: a quarter of the strips' bytes would be zero fill, which costs the
// TMA unit time though it reads nothing.
__device__ __forceinline__ int live_blocks(const Item& it, int rate, int H) {
  int live = 0;
#pragma unroll
  for (int dyi = 0; dyi < 3; ++dyi)
#pragma unroll
    for (int j = 0; j < PH / BOX_ROWS; ++j) {
      const int y = it.y0 + j * BOX_ROWS + (dyi - 1) * rate;
      if (y + BOX_ROWS > 0 && y < H) live |= 1 << (4 * dyi + j);
    }
  return live;
}

// The stages of an item, in the order producer and consumers both walk:
// f(kc, dxi, first_row, boxes, taps, strip) with `taps` the dy bits (bit
// dyi: tap 3 * dyi + dxi) that read this stage, `first_row` the image row
// of its first strip row and `boxes` the bits of the 8-row boxes to load;
// in a strip tap dyi reads from strip row dyi * rate on, else from row 0.
template <typename F>
__device__ __forceinline__ void for_each_stage(const Item& it, int rate,
                                               int mask, int live, int chunks,
                                               F&& f) {
  const bool strip = rate <= MAX_STRIP_RATE;
  int strip_boxes = 0;
#pragma unroll
  for (int dyi = 0; dyi < 3; ++dyi)
#pragma unroll
    for (int j = 0; j < PH / BOX_ROWS; ++j)
      if ((live >> (4 * dyi + j)) & 1) {
        const int row = dyi * rate + j * BOX_ROWS;
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
        f(kc, dxi, it.y0 + (strip ? -rate : (part - 1) * rate),
          strip ? strip_boxes : (live >> (4 * part)) & 15, mine, strip);
      }
    }
  }
}

struct Rates {
  int r[4];
};

__global__ void __launch_bounds__(THREADS, 1)
aspp_kernel(const __grid_constant__ CUtensorMap x_map,   // (B, H, W, C)
            const __grid_constant__ CUtensorMap w_map,   // (R * 9 * F, C)
            const float* __restrict__ bias,              // (R, F)
            __nv_bfloat16* __restrict__ out,             // (B, H, W, R * F)
            int H, int W, int C, int F, int R, Rates rates, int npx,
            int npy) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WGS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int chunks = C / BK;
  const Item it = decode_item(blockIdx.x, F / BN, R, npx, npy);
  const int rate = rates.r[it.ri];
  const int mask = tap_mask(it, rate, H, W);
  const int live = live_blocks(it, rate, H);

  if (wg == CONSUMER_WGS) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    if (threadIdx.x == CONSUMER_WGS * 128) {
      int stage = 0;
      uint32_t phase = 1;   // the ring starts empty: the first waits pass
      for_each_stage(it, rate, mask, live, chunks,
                     [&](int kc, int dxi, int first_row, int boxes, int taps,
                         bool) {
        mbar_wait(empty + stage, phase);
        uint8_t* a = smem + stage * STAGE_BYTES;
        mbar_arrive_expect_tx(
            full + stage, __popc(boxes) * BOX_BYTES + __popc(taps) * B_BYTES);
        const int x = it.x0 + (dxi - 1) * rate;
        for (int k = 0; k < MAX_BOXES; ++k)
          if ((boxes >> k) & 1)
            tma_load_4d(a + k * BOX_BYTES, &x_map, full + stage, kc * BK, x,
                        first_row + k * BOX_ROWS, it.b);
#pragma unroll
        for (int dyi = 0; dyi < 3; ++dyi)
          if ((taps >> dyi) & 1)
            tma_load_2d(a + A_BYTES + dyi * B_BYTES, &w_map, full + stage,
                        kc * BK, (it.ri * 9 + 3 * dyi + dxi) * F + it.n0);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      });
    }
  } else {
    // ---------------- consumers ----------------
    reg_alloc<232>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int out_c = R * F;
    int stage = 0;
    uint32_t phase = 0;

    float acc[2][32], sum[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[0][i] = sum[1][i] = 0.0f;
    for_each_stage(it, rate, mask, live, chunks,
                   [&](int, int, int, int, int taps, bool strip) {
      mbar_wait(full + stage, phase);
      const uint8_t* a = smem + stage * STAGE_BYTES;
      int used[2] = {0, 0};   // a block's first wgmma overwrites its acc
      wgmma_fence();
#pragma unroll
      for (int dyi = 0; dyi < 3; ++dyi) {
        if (!((taps >> dyi) & 1)) continue;
        const int row = (strip ? dyi * rate : 0) + wg * (PH / CONSUMER_WGS);
        const uint64_t da = wgmma_desc(a + row * ROW_BYTES);
        const uint64_t db = wgmma_desc(a + A_BYTES + dyi * B_BYTES);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          if (!((live >> (4 * dyi + 2 * wg + mb)) & 1)) continue;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n64k16_bf16(acc[mb],
                                 da + mb * (64 * BK * 2 >> 4) + 2 * kk,
                                 db + 2 * kk, used[mb] | (kk > 0));
          used[mb] = 1;
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + stage);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
        if (used[mb]) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sum[mb][i] += acc[mb][i];
        }
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    });

    // epilogue: bias, bf16, 16-byte stores
    float bv[16];
    const float* bb = bias + it.ri * F + it.n0 + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bv[2 * i] = bb[8 * i];
      bv[2 * i + 1] = bb[8 * i + 1];
    }
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lp = wg * 128 + mb * 64 + warp * 16 + g + 8 * h;
        const int y = it.y0 + lp / PW;
        const int x = it.x0 + lp % PW;
        const bool valid = y < H && x < W;
        __nv_bfloat16* row = out +
            (((size_t)it.b * H + y) * W + x) * out_c + it.ri * F + it.n0;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 4 * q + j;
            __nv_bfloat162 v = __floats2bfloat162_rn(
                sum[mb][4 * i + 2 * h] + bv[2 * i],
                sum[mb][4 * i + 2 * h + 1] + bv[2 * i + 1]);
            w[j] = *reinterpret_cast<uint32_t*>(&v);
          }
          quad_transpose(w);
          if (valid)
            *reinterpret_cast<uint4*>(row + (4 * q + t) * 8) =
                make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  }
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x (B, H, W, C) bf16, w (R, 9, F, C) bf16 (tap t = 3 * ky + kx, input
// channels contiguous), bias (R, F) fp32, out (B, H, W, R * F) bf16; all
// contiguous and 16-byte aligned.  Requires C % 64 == 0, F % 64 == 0,
// 1 <= R <= 4.
extern "C" int aspp_forward(const void* x, const void* w, const void* bias,
                            void* out, int B, int H, int W, int C, int F,
                            int R, int r0, int r1, int r2, int r3,
                            void* stream) {
  if (C % BK != 0 || F % BN != 0 || R < 1 || R > 4 || B < 1 || H < 1 ||
      W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H,
                              (uint64_t)B};
  const uint32_t x_box[4] = {BK, PW, BOX_ROWS, 1};
  const uint64_t w_dims[2] = {(uint64_t)C, (uint64_t)R * 9 * F};
  const uint32_t w_box[2] = {BK, BN};
  if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, x, x_dims,
                  x_box) ||
      !encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, w, w_dims,
                  w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      aspp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int npx = (W + PW - 1) / PW;
  const int npy = (H + PH - 1) / PH;
  const long items = (long)B * npy * npx * R * (F / BN);
  if (items > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  Rates rates = {{r0, r1, r2, r3}};
  aspp_kernel<<<(int)items, THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, C, F, R, rates, npx, npy);
  return static_cast<int>(cudaGetLastError());
}
