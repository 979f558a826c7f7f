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
// at the training shape (N = 8450, C = 2048, K = 2304).  A block owns a
// 128 (c) x 64 (k) output tile on nvcuda::wmma bf16 16x16x16 -> fp32
// fragments and walks its share of the pixels 64 at a time through a
// 3-stage cp.async ring; x is read as the column-major A operand, so
// neither operand is transposed in memory.  The pixel range is split into
// S contiguous chunks, one block row per chunk (grid z), each writing its
// partial tile to a workspace; a second pass adds the S partials in split
// order.  No atomics: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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
constexpr int BM = 128;  // channels c per tile
constexpr int BN = 64;   // packed columns k per tile
constexpr int BK = 64;   // pixels q per stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int LDA = BM + 8;  // bf16 elements; rows of x, channel-contiguous
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // fp32 epilogue tile
constexpr int A_STAGE = BK * LDA;
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
aspp_grad_weight_kernel(const __nv_bfloat16* __restrict__ x,  // (N, C)
                        const __nv_bfloat16* __restrict__ G,  // (N, K)
                        float* __restrict__ out,  // (S, C, K) or (C, K)
                        int N, int C, int K, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;

  const int k0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * BM;
  const int q_begin = blockIdx.z * chunk;
  const int q_end = min(q_begin + chunk, N);
  const int KT = (q_end - q_begin + BK - 1) / BK;
  const int tid = threadIdx.x;

  auto load_stage = [&](int stage, int it) {
    const int qb = q_begin + it * BK;
    __nv_bfloat16* a = As + stage * A_STAGE;
    // A: BK pixel rows x BM channels = 64 rows of 16 chunks
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + j * THREADS;
      const int r = idx >> 4;
      const int col = idx & 15;
      const int q = qb + r;
      const bool v = q < q_end;
      const __nv_bfloat16* src = v ? x + (size_t)q * C + c0 + col * 8 : x;
      cp_async16(a + r * LDA + col * 8, src, v);
    }
    // B: BK pixel rows x BN columns = 64 rows of 8 chunks
    __nv_bfloat16* bt = Bs + stage * B_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * THREADS;
      const int r = idx >> 3;
      const int col = idx & 7;
      const int q = qb + r;
      const bool v = q < q_end;
      const __nv_bfloat16* src = v ? G + (size_t)q * K + k0 + col * 8 : G;
      cp_async16(bt + r * LDB + col * 8, src, v);
    }
  };

  const int warp = tid >> 5;
  const int wm = warp & 3;   // 4 warps along c, 32 rows each
  const int wn = warp >> 2;  // 2 warps along k, 32 columns each
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
      // A(m = c, k = q) sits at a[q * LDA + c]: column-major with ld LDA
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + kk * 16 * LDA + wm * 32 + i * 16,
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

  float* dst = out + (size_t)blockIdx.z * C * K;
  // 128 rows x 16 float4 = 2048 float4, 8 per thread
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int idx = tid + j * THREADS;
    const int r = idx >> 4;
    const int col = idx & 15;
    const float* c = Cs + r * LDC + col * 4;
    *reinterpret_cast<float4*>(dst + (size_t)(c0 + r) * K + k0 + col * 4) =
        make_float4(c[0], c[1], c[2], c[3]);
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

// x (N, C) bf16, G (N, K) bf16 -> dW (C, K) fp32; with splits > 1, work
// (splits, C, K) fp32 holds the partials.  All contiguous, 16-byte aligned.
// Requires C % 128 == 0, K % 64 == 0, chunk % 64 == 0,
// splits == ceil(N / chunk).
extern "C" int aspp_grad_weight(const void* x, const void* G, void* dW,
                                void* work, int N, int C, int K, int chunk,
                                int splits, void* stream) {
  if (C % BM != 0 || K % BN != 0 || chunk % BK != 0 || N < 1 ||
      splits < 1 || (long long)(splits - 1) * chunk >= N ||
      (long long)splits * chunk < N || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      aspp_grad_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(K / BN, C / BM, splits);
  float* first = splits > 1 ? static_cast<float*>(work)
                            : static_cast<float*>(dW);
  aspp_grad_weight_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(G), first, N, C, K, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long n4 = (long long)C * K / 4;
  const int threads = 256;
  split_sum_kernel<<<(unsigned)((n4 + threads - 1) / threads), threads, 0,
                     st>>>(static_cast<const float4*>(work),
                           static_cast<float4*>(dW), splits, n4);
  return static_cast<int>(cudaGetLastError());
}
