// int8 tensor-core products of the quant8 serving path.
//
// Replaces benchmarks/bench_int8_mosaic.py::pallas_mm (K4, pallas_call :48):
// a tiled (M, K) @ (K, N) product, int8 x int8 -> int32 or bf16 x bf16 ->
// fp32, and, through the same tile, the int8 convolutions that XLA's s8
// conv lowering runs for scaleprotoseg_tpu/ops/quant.py
// (static_int8_conv / dynamic_int8_conv) on layer4/5 of the ResNet.
//
// Kernels (one tile body, mm_tile<T, TAPS>):
//   int8_gemm_kernel     A (M, K) int8 @ Bt (N, K)^T int8 -> int32, or the
//                        dequantized bf16(float(acc) * (sx * sw[n])) or fp32;
//   int8_conv3x3_kernel  the same tile over nine taps: the implicit-GEMM
//                        dilated 3x3 conv (int8_conv3x3);
//   bf16_gemm_kernel     A (M, K) bf16 @ Bt (N, K)^T bf16 -> fp32 (pallas_mm's
//                        other arm);
//   quantize_kernel    bf16/fp32 NHWC -> int8, static (x * (1 / max(s,
//                      1e-12))) or dynamic (x / s), rintf (half to even),
//                      clipped to +-127;
//   absmax_*_kernel    the dynamic scale max(max|x|, 1e-12) / 127 in two
//                      passes (per-block maxima, then one block), no atomics.
//
// Bound: the layer4/5 convs are operations-bound (~5.4 T int8 operations
// per 2 x 1024 x 2048 batch against a few GB of traffic); K4 at its own
// benchmark shape (8192 x 512 x 512) and the quantize passes are bytes-bound.
//
// Design: a block owns BM = 128 output rows (pixels) by BN = 128 output
// channels and walks K in 64-byte chunks (64 int8 or 32 bf16 values), tap
// innermost for the conv so the nine shifted reads of one chunk meet in L2.
// Each step stages a 128 x 64-byte A tile and a 128 x 64-byte B tile with
// cp.async in a 4-stage ring; A rows are gathered at the tap's (dy, dx)
// shift straight from the unpadded NHWC map and zero-filled outside the
// image or past M (src-size 0), so no padded copy exists.  Both operands
// are K-contiguous in shared memory (rows padded to 80 bytes: conflict-free
// ldmatrix), which is the row.col layout of mma.sync.  Eight warps each own
// a 64 x 32 piece: per 32-byte K slice 4 ldmatrix.x4 for A, 2 for B and 16
// mma.sync (m16n8k32 s8 -> s32, or m16n8k16 bf16 -> f32: the two have the
// same fragment layout in bytes).  The epilogue writes from the fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
struct Mma;

template <>
struct Mma<int8_t> {
  using Acc = int32_t;
  static __device__ __forceinline__ void run(int32_t (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Rows are pixels of a (B, H, W) grid flattened as m = (b * H + y) * W + x;
// a plain GEMM passes H = M, W = 1 and one tap.  Tap t of nine reads row
// (y + (t / 3 - 1) * dil, x + (t % 3 - 1) * dil); Bt is (TAPS, N, Kb).
template <typename T, int TAPS>
__device__ __forceinline__ void mm_tile(
    const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
    void* __restrict__ out, const float* __restrict__ sx,
    const float* __restrict__ sw, int M, int Kb, int N, int H, int W,
    int dil, int mode) {
  using Acc = typename Mma<T>::Acc;
  constexpr int taps = TAPS;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* As = smem;
  uint8_t* Bs = smem + STAGES * A_STAGE;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int HW = H * W;
  const int tid = threadIdx.x;

  // Loader mapping: 16-byte chunk `col` of rows `row` and `row + 64`.
  const int col = tid & 3;
  const int row = tid >> 2;
  int py[2], px[2];
  bool pv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + row + 64 * j;
    pv[j] = m < M;
    const int rem = pv[j] ? m % HW : 0;
    py[j] = rem / W;
    px[j] = rem - py[j] * W;
  }
  const int KT = (Kb / BKB) * taps;

  auto load_stage = [&](int stage, int it) {
    const int kc = it / taps;
    const int tap = it - kc * taps;
    const int dy = taps == 9 ? (tap / 3 - 1) * dil : 0;
    const int dx = taps == 9 ? (tap % 3 - 1) * dil : 0;  // taps is 1 or 9
    const int k0 = kc * BKB + col * 16;
    uint8_t* as = As + stage * A_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int sy = py[j] + dy;
      const int sx_ = px[j] + dx;
      const bool v = pv[j] && sy >= 0 && sy < H && sx_ >= 0 && sx_ < W;
      const int m = m0 + row + 64 * j;
      const uint8_t* src =
          v ? a + (size_t)(m + dy * W + dx) * Kb + k0 : a;
      cp_async16(as + (row + 64 * j) * LDS + col * 16, src, v);
    }
    uint8_t* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = row + 64 * j;
      cp_async16(bs + n * LDS + col * 16,
                 bt + ((size_t)tap * N + n0 + n) * Kb + k0, true);
    }
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // 2 warps along M, 64 rows each
  const int wn = warp >> 1;  // 4 warps along N, 32 columns each
  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
          Mma<T>::run(acc[i][j], fa[i], fb[j >> 1][(j & 1) * 2],
                      fb[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Fragment (i, j): rows g and g + 8 of the m16 tile, columns 2 * tig and
  // 2 * tig + 1 of the n8 tile.
  const int g = lane >> 2;
  const int tig = lane & 3;
  const float s_x = mode == RAW ? 0.0f : sx[0];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + tig * 2;
    float s0 = 0.0f, s1 = 0.0f;
    if (mode != RAW) {
      s0 = s_x * sw[n];      // the scale product first, as the reference
      s1 = s_x * sw[n + 1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + g + h * 8;
        if (m >= M) continue;
        const Acc c0 = acc[i][j][2 * h];
        const Acc c1 = acc[i][j][2 * h + 1];
        const size_t o = (size_t)m * N + n;
        if (mode == DEQUANT_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(static_cast<float>(c0) * s0,
                                    static_cast<float>(c1) * s1);
        } else if (mode == DEQUANT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(static_cast<float>(c0) * s0,
                          static_cast<float>(c1) * s1);
        } else {
          Acc* p = static_cast<Acc*>(out) + o;
          p[0] = c0;
          p[1] = c1;
        }
      }
    }
  }
}

#define MM_ARGS                                                              \
  const uint8_t *__restrict__ a, const uint8_t *__restrict__ bt,            \
      void *__restrict__ out, const float *__restrict__ sx,                 \
      const float *__restrict__ sw, int M, int Kb, int N, int H, int W,     \
      int dil, int mode

__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(MM_ARGS) {
  mm_tile<int8_t, 1>(a, bt, out, sx, sw, M, Kb, N, H, W, dil, mode);
}

__global__ void __launch_bounds__(THREADS) int8_conv3x3_kernel(MM_ARGS) {
  mm_tile<int8_t, 9>(a, bt, out, sx, sw, M, Kb, N, H, W, dil, mode);
}

__global__ void __launch_bounds__(THREADS) bf16_gemm_kernel(MM_ARGS) {
  mm_tile<__nv_bfloat16, 1>(a, bt, out, sx, sw, M, Kb, N, H, W, dil, mode);
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

using MmKernel = void (*)(const uint8_t*, const uint8_t*, void*, const float*,
                         const float*, int, int, int, int, int, int, int);

int launch_mm(MmKernel kernel, const void* a, const void* bt, void* out,
              const float* sx, const float* sw, int M, int Kb, int N, int H,
              int W, int dil, int mode, void* stream) {
  if (M < 1 || Kb % BKB != 0 || N % BN != 0 || mode < 0 || mode > 2 ||
      (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt), out,
      sx, sw, M, Kb, N, H, W, dil, mode);
  return static_cast<int>(cudaGetLastError());
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
// float(acc) * (sx[0] * sw[n]).  Requires K % 64 == 0, N % 128 == 0.
extern "C" int int8_mm(const void* a, const void* bt, void* out,
                       const float* sx, const float* sw, int M, int K, int N,
                       int mode, void* stream) {
  return launch_mm(int8_gemm_kernel, a, bt, out, sx, sw, M, K, N, M, 1, 0,
                   mode, stream);
}

// a (M, K) bf16, bt (N, K) bf16 -> out (M, N) fp32 = a @ bt^T.
// Requires K % 32 == 0, N % 128 == 0.
extern "C" int bf16_mm(const void* a, const void* bt, void* out, int M, int K,
                       int N, void* stream) {
  return launch_mm(bf16_gemm_kernel, a, bt, out, nullptr, nullptr, M, 2 * K,
                   N, M, 1, 0, RAW, stream);
}

// x (B, H, W, C) int8 NHWC, wt (9, N, C) int8 with tap t = 3 * ky + kx,
// zero padding = dil; out (B, H, W, N) as int8_mm's modes.
extern "C" int int8_conv3x3(const void* x, const void* wt, void* out,
                            const float* sx, const float* sw, int B, int H,
                            int W, int C, int N, int dil, int mode,
                            void* stream) {
  if (B < 1 || H < 1 || W < 1 || dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mm(int8_conv3x3_kernel, x, wt, out, sx, sw, B * H * W, C, N,
                   H, W, dil, mode, stream);
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
