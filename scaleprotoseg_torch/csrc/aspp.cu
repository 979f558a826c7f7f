// Concat-ASPP forward (K2): four dilated 3x3 convolutions over one NHWC
// bf16 feature map, fp32 accumulation, bias, bf16 output.
//
// Replaces scaleprotoseg_tpu/ops/pallas_aspp.py::fused_aspp.
//
// Bound: operations.  At the flagship shape (2 x 129 x 257 x 2048 -> 4 x 64)
// the work is ~0.63 TFLOP against ~0.3 GB of traffic, far above the card's
// ~295 flop/byte ridge, so the tensor cores are the limit.
//
// Design: an implicit GEMM per (rate, 64-channel output slice).  A block
// owns BM = 128 consecutive output pixels (flattened y * W + x) by BN = 64
// output channels, and walks K = (C / 64) channel chunks x 9 taps, channel
// chunk outermost so that the 9 shifted reads of one chunk hit L2 together.
// Each step stages a (128 x 64) bf16 input tile, gathered row by row at the
// tap's (dy, dx) shift with cp.async and zero-filled where the tap falls
// outside the image (no host-side padding of the input), and a (64 x 64)
// weight tile, in a 3-stage ring.  Eight warps each own a 32 x 32 piece of
// the output tile on nvcuda::wmma bf16 16x16x16 -> fp32 fragments.  The
// epilogue stages the fp32 tile in shared memory, adds the bias and writes
// bf16 into channels [rate * F + n0, rate * F + n0 + 64) of the NHWC output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;   // bf16 elements; 144-byte rows dodge bank conflicts
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // fp32 epilogue tile
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
static_assert(BM * LDC * 4 <= SMEM_BYTES, "epilogue tile must fit");
static_assert(THREADS == 256 && BM == 128 && BN == 64 && BK == 64,
              "thread mapping below assumes these");

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

__global__ void __launch_bounds__(THREADS)
aspp_kernel(const __nv_bfloat16* __restrict__ x,     // (B, H, W, C)
            const __nv_bfloat16* __restrict__ w,     // (R, 9, C, F)
            const float* __restrict__ bias,          // (R, F)
            __nv_bfloat16* __restrict__ out,         // (B, H, W, R * F)
            int H, int W, int C, int F, int R,
            int r0, int r1, int r2, int r3) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;

  const int n_tiles = F / BN;
  const int ri = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x - ri * n_tiles) * BN;
  const int rate = ri == 0 ? r0 : ri == 1 ? r1 : ri == 2 ? r2 : r3;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int HW = H * W;
  const int tid = threadIdx.x;

  // Loader mapping: thread -> 16-byte column `col` of rows tid/8 + 32 j.
  const int col = tid & 7;
  const int row = tid >> 3;
  int py[4], px[4];
  bool pv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int m = m0 + row + 32 * j;
    pv[j] = m < HW;
    py[j] = pv[j] ? m / W : 0;
    px[j] = pv[j] ? m - py[j] * W : 0;
  }
  const __nv_bfloat16* xb = x + (size_t)b * HW * C;
  const int KT = (C / BK) * 9;

  auto load_stage = [&](int stage, int it) {
    const int kc = it / 9;
    const int tap = it - kc * 9;
    const int dy = (tap / 3 - 1) * rate;
    const int dx = (tap % 3 - 1) * rate;
    const int c0 = kc * BK + col * 8;
    __nv_bfloat16* a = As + stage * A_STAGE;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sy = py[j] + dy;
      const int sx = px[j] + dx;
      const bool v = pv[j] && sy >= 0 && sy < H && sx >= 0 && sx < W;
      const __nv_bfloat16* src =
          v ? xb + ((size_t)sy * W + sx) * C + c0 : x;
      cp_async16(a + (row + 32 * j) * LDA + col * 8, src, v);
    }
    __nv_bfloat16* bt = Bs + stage * B_STAGE;
    const __nv_bfloat16* wt =
        w + ((size_t)(ri * 9 + tap) * C + kc * BK) * F + n0 + col * 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = row + 32 * j;
      cp_async16(bt + k * LDB + col * 8, wt + (size_t)k * F, true);
    }
  };

  const int warp = tid >> 5;
  const int wm = warp & 3;   // 4 warps along M, 32 rows each
  const int wn = warp >> 2;  // 2 warps along N, 32 columns each
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < KT; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < KT) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const __nv_bfloat16* a = As + (it % STAGES) * A_STAGE;
    const __nv_bfloat16* bt = Bs + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * LDA + kk * 16,
                               LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bt + kk * 16 * LDB + wn * 32 + j * 16,
                               LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  const float* bb = bias + ri * F + n0 + col * 8;
  float bv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bv[e] = bb[e];
  const int out_c = R * F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = row + 32 * j;
    const int m = m0 + r;
    if (m >= HW) continue;
    const float* c = Cs + r * LDC + col * 8;
    uint4 pack;
    uint32_t* words = reinterpret_cast<uint32_t*>(&pack);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 h2 = __floats2bfloat162_rn(c[2 * e] + bv[2 * e],
                                                c[2 * e + 1] + bv[2 * e + 1]);
      words[e] = *reinterpret_cast<uint32_t*>(&h2);
    }
    *reinterpret_cast<uint4*>(out + ((size_t)b * HW + m) * out_c + ri * F +
                              n0 + col * 8) = pack;
  }
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x (B, H, W, C) bf16, w (R, 9, C, F) bf16, bias (R, F) fp32,
// out (B, H, W, R * F) bf16; all contiguous and 16-byte aligned.
// Requires C % 64 == 0, F % 64 == 0, 1 <= R <= 4.
extern "C" int aspp_forward(const void* x, const void* w, const void* bias,
                            void* out, int B, int H, int W, int C, int F,
                            int R, int r0, int r1, int r2, int r3,
                            void* stream) {
  if (C % BK != 0 || F % BN != 0 || R < 1 || R > 4 || B < 1 || H < 1 ||
      W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      aspp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(R * (F / BN), (H * W + BM - 1) / BM, B);
  aspp_kernel<<<grid, THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, C, F, R, r0, r1, r2, r3);
  return static_cast<int>(cudaGetLastError());
}
