// Concat-ASPP backward (K2's transpose): the shifted-gradient pack and the
// weight gradient.
//
// Replaces the tap-packed backward of
// scaleprotoseg_tpu/ops/pallas_aspp.py::fused_aspp_trainable.  The forward
// is y_r[p] = b_r + sum_{di,dj} x[p + off] W_r[di,dj], off = ((di-1) r,
// (dj-1) r).  Both reductions of the backward read one shifted-gradient
// family
//
//   G[q, (r, di, dj, f)] = g_r[q - off]      (zero where q - off is outside)
//
// so that dx = G W_all^T and dW_all = x^T G are one large product each.
//
// aspp_grad_pack: g (B, H, W, R*F) bf16 -> G (B*H*W, R*9*F) bf16.  Pure data
// movement, bound by bytes (at the training shape 2 x 65 x 65: 4.3 MB read,
// 38.9 MB written).  One thread per 16-byte chunk of G: it reads the chunk
// of g its tap points at, or writes zeros where the tap leaves the image.
// g is never padded, and the copy is bit-exact.
//
// aspp_grad_weight: dW_all[c, k] = sum_q x[q, c] G[q, k], x (N, C) and G
// (N, K) bf16, fp32 accumulation, fp32 output (the parameters are fp32; a
// bf16 product would round dW).  Bound by operations: 2 N C K = 79.7 GFLOP
// at the training shape (N = 8450, C = 2048, K = 2304), 57.5 GFLOP of it
// on taps that land in the image.  In practice the bound is the TMA stream
// into shared memory (~6.5 TB/s on this card), so the tile is as wide as
// the registers allow.  Design: TMA-fed wgmma, both operands MN-major.
//  - Both operands are reduced over their leading (pixel) dimension: A =
//    x^T has c contiguous, B = G has k contiguous.  TMA boxes of 64 pixel
//    rows x 128 bytes land them in shared memory as they lie in global
//    memory, and wgmma reads them through its transpose flags: no copy and
//    no transposed tensor.
//  - A block owns a 128 (c) x 192 (k) output tile of one image: two
//    consumer warpgroups each own 64 channels with wgmma m64n192k16 (96
//    fp32 accumulators a thread), one producer warp keeps a 5-stage ring
//    of 64-pixel stages (two x boxes and three G boxes, 40 KB) full.  79
//    operations per staged byte (a 128 x 128 tile: 64); 128- and 256-wide
//    k tiles both measured slower.
//  - wgmma adds into its fp32 accumulator with truncation (see K2,
//    csrc/aspp.cu).  Over one image's 4225 pixels that costs at most 5.5e-6 of
//    dW's scale at the training shape (1.3e-3 absolute against the rtol =
//    atol = 1e-3 test), so the accumulators run over a whole partial (below);
//    a second register set added in round-to-nearest per stage (K2's
//    remedy) gave 6e-7 and cost 20-27% of the kernel's time.  A stage is
//    released one step late, so a batch is always in flight.
//  - With F = 64 a 192-wide k tile is one (rate, di) triple of taps, whose
//    nonzero rows of G are one row range per image: max(0, (di - 1) r) to
//    H + min(0, (di - 1) r).  The block walks only that range (its last
//    stage reads past it into rows of zeros, or past the image, where TMA
//    fills zeros: 3-D maps (C or K, H * W, B) end at the image), ~15% of
//    the stages at rates 6/12/18/24 on 65 x 65.
//  - The pixel split: partial s of an image walks pixels [s CHUNK, (s + 1)
//    CHUNK) of the tile's range (CHUNK is whole stages, so no stage
//    crosses into the next partial); one partial per image at the
//    training shape.  It caps how many pixels a truncating sum runs over,
//    whatever the crop.  The partials are added in order by a second
//    pass.  No atomics: the same bits every run.
//    At the training shape that is 384 blocks, ~2.5 waves of work on 132
//    SMs: the k tiles launch longest first, so that the short ones fill
//    the last wave (in natural order the skipped rows gained 0-4%, with
//    this order 7-10%).  5 stages of 64 pixels (200 KB) measured faster
//    than 3 or 4.
//  - Rows past C and columns past K arrive as zeros and are masked; the
//    epilogue's quad shuffle gives every lane 16 contiguous bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// --------------------------------------------------------------------------
// pack
// --------------------------------------------------------------------------
__global__ void aspp_grad_pack_kernel(const __nv_bfloat16* __restrict__ g,
                                      __nv_bfloat16* __restrict__ G, int H,
                                      int W, int F, int R, int r0, int r1,
                                      int r2, int r3, long long chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const int K = R * 9 * F;
  const int kc = K / 8;
  const long long q = i / kc;
  const int k = (int)(i - q * kc) * 8;
  const int ri = k / (9 * F);
  const int rem = k - ri * 9 * F;
  const int tap = rem / F;
  const int f = rem - tap * F;
  const int rate = ri == 0 ? r0 : ri == 1 ? r1 : ri == 2 ? r2 : r3;
  const int HW = H * W;
  const long long b = q / HW;
  const int p = (int)(q - b * HW);
  const int y = p / W;
  const int x = p - y * W;
  const int sy = y - (tap / 3 - 1) * rate;
  const int sx = x - (tap % 3 - 1) * rate;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (sy >= 0 && sy < H && sx >= 0 && sx < W)
    v = *reinterpret_cast<const uint4*>(
        g + ((b * HW + (long long)sy * W + sx) * R + ri) * F + f);
  *reinterpret_cast<uint4*>(G + q * K + k) = v;
}

// --------------------------------------------------------------------------
// weight gradient
// --------------------------------------------------------------------------
constexpr int BM = 128;   // channels c per tile: an m64 per consumer warpgroup
constexpr int BN = 192;   // packed columns k per tile
constexpr int BP = 64;    // pixels per stage
constexpr int ATOM = 64;  // bf16 elements in a 128-byte box row
constexpr int STAGES = 5;
constexpr int CHUNK = 4352;  // pixels of one image per partial, at most
constexpr int CONSUMER_WGS = BM / 64;
constexpr int THREADS = 128 * (CONSUMER_WGS + 1);
constexpr int BOX_BYTES = BP * 128;                  // 8 KB
constexpr int A_BOXES = BM / ATOM;
constexpr int B_BOXES = BN / ATOM;
constexpr int A_BYTES = A_BOXES * BOX_BYTES;
constexpr int STAGE_BYTES = (A_BOXES + B_BOXES) * BOX_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
static_assert(BM % ATOM == 0 && BN % ATOM == 0 && BP % 16 == 0,
              "whole boxes and k16 slices");
static_assert(CHUNK % BP == 0, "a stage lies in one partial");
static_assert(SMEM_BYTES <= 232448, "one block's shared memory");

constexpr int MAX_ORDER = 64;   // k tiles ordered by their cost

struct Rates {
  int r[4];
};

// The launch order of the k tiles, longest row range first.
struct TileOrder {
  uint16_t kt[MAX_ORDER];
};

// Image rows [lo, hi) in which some column of the k tile at k0 can be
// nonzero: column (r, di, dj, f) of G holds g_r shifted by (di - 1) r rows,
// so it is zero outside rows max(0, (di - 1) r) .. H + min(0, (di - 1) r).
__host__ __device__ __forceinline__ int2 live_rows(int k0, int K, int F,
                                                   const Rates& rates, int H) {
  int lo = H, hi = 0;
  const int last = (K < k0 + BN ? K : k0 + BN) - 1;
  for (int tap = k0 / F; tap <= last / F; ++tap) {
    const int off = ((tap % 9) / 3 - 1) * rates.r[tap / 9];
    const int a = off > 0 ? off : 0, z = off < 0 ? H + off : H;
    lo = a < lo ? a : lo;
    hi = z > hi ? z : hi;
  }
  return lo < hi ? make_int2(lo, hi) : make_int2(0, 0);
}

__global__ void __launch_bounds__(THREADS, 1)
aspp_grad_weight_kernel(const __grid_constant__ CUtensorMap x_map,  // (B, HW, C)
                        const __grid_constant__ CUtensorMap g_map,  // (B, HW, K)
                        float* __restrict__ out,  // (parts, C, K)
                        int B, int H, int W, int C, int K, int F,
                        int splits, const __grid_constant__ Rates rates,
                        const __grid_constant__ TileOrder order) {
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

  // block -> (k tile in launch order, partial, c tile), c tile fastest:
  // the blocks running together share a G tile; the longest tiles start
  // first.  Partial `part` is split s of image b.
  const int c_tiles = (C + BM - 1) / BM;
  const int parts = B * splits;
  const int c0 = (blockIdx.x % c_tiles) * BM;
  const int part = (blockIdx.x / c_tiles) % parts;
  const int b = part / splits, s = part % splits;
  const int k0 = order.kt[blockIdx.x / (c_tiles * parts)] * BN;
  const int2 rows = live_rows(k0, K, F, rates, H);
  const int p0 = rows.x * W + s * CHUNK;
  const int p1 = min(rows.y * W, p0 + CHUNK);
  const int stages = p1 > p0 ? (p1 - p0 + BP - 1) / BP : 0;
  const int wg = threadIdx.x >> 7;

  if (wg == CONSUMER_WGS) {
    // ---------------- producer ----------------
    reg_dealloc<40>();
    if (threadIdx.x == CONSUMER_WGS * 128) {
      // boxes wholly past C or K are not loaded: they only feed masked
      // outputs
      int a_boxes = 0, b_boxes = 0;
      for (int i = 0; i < A_BOXES; ++i) a_boxes += c0 + i * ATOM < C;
      for (int i = 0; i < B_BOXES; ++i) b_boxes += k0 + i * ATOM < K;
      int stage = 0;
      uint32_t phase = 1;   // the ring starts empty: the first waits pass
      for (int j = 0; j < stages; ++j) {
        mbar_wait(empty + stage, phase);
        uint8_t* a = smem + stage * STAGE_BYTES;
        mbar_arrive_expect_tx(full + stage,
                              (a_boxes + b_boxes) * BOX_BYTES);
        const int p = p0 + j * BP;
        for (int i = 0; i < a_boxes; ++i)
          tma_load_3d(a + i * BOX_BYTES, &x_map, full + stage, c0 + i * ATOM,
                      p, b);
        for (int i = 0; i < b_boxes; ++i)
          tma_load_3d(a + A_BYTES + i * BOX_BYTES, &g_map, full + stage,
                      k0 + i * ATOM, p, b);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---------------- consumers ----------------
    reg_alloc<232>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    int stage = 0;
    uint32_t phase = 0;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int prev = -1;
    for (int j = 0; j < stages; ++j) {
      mbar_wait(full + stage, phase);
      const uint8_t* a = smem + stage * STAGE_BYTES;
      const uint64_t da = wgmma_desc_mn(a + wg * BOX_BYTES, BOX_BYTES);
      const uint64_t db = wgmma_desc_mn(a + A_BYTES, BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BP / 16; ++kk)
        wgmma_bf16_mn(acc, da + kk * (16 * 128 >> 4),
                      db + kk * (16 * 128 >> 4), 1);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();             // the previous stage's batch is done
        if (lane == 0) mbar_arrive(empty + prev);
      }
      prev = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);

    // epilogue: rows g and g + 8 of this warp's m16; lanes t and t ^ 1
    // swap halves of two n8 blocks so that each stores four columns
    float* dst = out + (size_t)part * C * K;
    const bool odd = t & 1;
#pragma unroll
    for (int i = 0; i < BN / 8; i += 2) {
      const int c = k0 + (odd ? 8 * (i + 1) + 2 * (t - 1) : 8 * i + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v00 = acc[4 * i + 2 * h], v01 = acc[4 * i + 2 * h + 1];
        const float v10 = acc[4 * (i + 1) + 2 * h];
        const float v11 = acc[4 * (i + 1) + 2 * h + 1];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v00 : v10, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v01 : v11, 1);
        const float4 o = odd ? make_float4(r0, r1, v10, v11)
                             : make_float4(v00, v01, r0, r1);
        const int row = c0 + wg * 64 + warp * 16 + g + 8 * h;
        if (row < C && c < K)
          *reinterpret_cast<float4*>(dst + (size_t)row * K + c) = o;
      }
    }
  }
}

// out[i] = sum_s part[s][i], s ascending: the fixed order makes the result
// independent of how the first pass was scheduled.
__global__ void split_sum_kernel(const float4* __restrict__ part,
                                 float4* __restrict__ out, int S,
                                 long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i];
  for (int s = 1; s < S; ++s) {
    const float4 b = part[(long long)s * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  out[i] = a;
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// g (B, H, W, R * F) bf16 -> G (B * H * W, R * 9 * F) bf16, both contiguous
// and 16-byte aligned.  Requires F % 8 == 0, 1 <= R <= 4.
extern "C" int aspp_grad_pack(const void* g, void* G, int B, int H, int W,
                              int F, int R, int r0, int r1, int r2, int r3,
                              void* stream) {
  if (F % 8 != 0 || R < 1 || R > 4 || B < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (long long)B * H * W * R * 9 * F / 8;
  const int threads = 256;
  const long long blocks = (chunks + threads - 1) / threads;
  aspp_grad_pack_kernel<<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(G), H,
      W, F, R, r0, r1, r2, r3, chunks);
  return static_cast<int>(cudaGetLastError());
}

// x (B * H * W, C) bf16, G (B * H * W, K) bf16 -> dW (C, K) fp32.  G is
// aspp_grad_pack's output for rates r0.. (R of them) and F channels per
// rate (K = R * 9 * F); the rows where a k tile's columns are zero are
// skipped.  With more than one partial (B * ceil(H * W / 4352)), work
// (partials, C, K) fp32 holds them.  All contiguous, 16-byte aligned;
// requires C % 8 == 0, K % 8 == 0 (TMA) and at most 64 k tiles of 192.
extern "C" int aspp_grad_weight(const void* x, const void* G, void* dW,
                                void* work, int B, int H, int W, int C,
                                int K, int F, int R, int r0, int r1, int r2,
                                int r3, void* stream) {
  const uint64_t hw = (uint64_t)H * W;
  const long long splits = (long long)((hw + CHUNK - 1) / CHUNK);
  const int k_tiles = (K + BN - 1) / BN;
  if (B < 1 || H < 1 || W < 1 || C < 8 || C % 8 != 0 || K % 8 != 0 ||
      R < 1 || R > 4 || F < 1 || K != R * 9 * F || k_tiles > MAX_ORDER ||
      (B * splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, g_map;
  const uint64_t x_dims[3] = {(uint64_t)C, hw, (uint64_t)B};
  const uint64_t g_dims[3] = {(uint64_t)K, hw, (uint64_t)B};
  const uint32_t box[3] = {ATOM, BP, 1};
  if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, x, x_dims,
                  box) ||
      !encode_map(&g_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, G, g_dims,
                  box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      aspp_grad_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long parts = B * splits;
  const long long blocks = parts * ((C + BM - 1) / BM) * k_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Rates rates = {{r0, r1, r2, r3}};
  // the k tiles by row count, longest first (stable), so that the short
  // ones fill the last wave: balanced waves are what the row skipping
  // gains through
  TileOrder order{};
  int rows[MAX_ORDER];
  for (int t = 0; t < k_tiles; ++t) {
    const int2 r = live_rows(t * BN, K, F, rates, H);
    int i = t;
    for (; i > 0 && rows[i - 1] < r.y - r.x; --i) {
      rows[i] = rows[i - 1];
      order.kt[i] = order.kt[i - 1];
    }
    rows[i] = r.y - r.x;
    order.kt[i] = static_cast<uint16_t>(t);
  }
  float* first =
      parts > 1 ? static_cast<float*>(work) : static_cast<float*>(dW);
  aspp_grad_weight_kernel<<<(int)blocks, THREADS, SMEM_BYTES, st>>>(
      x_map, g_map, first, B, H, W, C, K, F, (int)splits, rates, order);
  e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return static_cast<int>(e);
  const long long n4 = (long long)C * K / 4;
  const int threads = 256;
  split_sum_kernel<<<(unsigned)((n4 + threads - 1) / threads), threads, 0,
                     st>>>(static_cast<const float4*>(work),
                           static_cast<float4*>(dW), (int)parts, n4);
  return static_cast<int>(cudaGetLastError());
}
