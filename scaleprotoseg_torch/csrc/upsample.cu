// Bilinear upsample + argmax over classes (K3), writing labels directly.
//
// Replaces scaleprotoseg_tpu/ops/pallas_upsample.py::fused_upsample_argmax
// (_apply).
//
// Bound: at the flagship shape (2 x 129 x 257 x 19 fp32 -> 2 x 1024 x 2048
// uint8) the kernel reads 5.0 MB and writes 4.2 MB (2.8 us at 3.35 TB/s)
// and does ~0.35 GFLOP of fp32 work (5.2 us at 67 TFLOP/s): operations.
// In instructions it is more: per output pixel and class a multiply, a
// fused multiply-add and a compare that moves both a maximum and its
// index, ~5 instructions, ~0.4 G in all.
//
// Design: a block owns a band of BH output rows by `blockDim.x` output
// columns of one image (one column per thread).
//  - It stages the source rows the band's taps reach (3-4 at 8x), over the
//    source columns the span's taps reach, in shared memory: each staged
//    row is one contiguous run of the NHWC logits, copied with 16-byte
//    loads (scalar at the run's unaligned ends).
//  - Classes go CK at a time.  The band's output rows fall into runs that
//    read the same two source rows; per run and chunk a thread forms the W
//    interpolation t = a * wx0 + b * wx1 of those two rows once, in
//    registers, and every row of the run reuses it: v = wy0 * t0 + wy1 * t1
//    (the TPU kernel's order of association; the taps and weights come
//    from host-built tables holding the nonzeros of the JAX package's
//    _bilinear_matrix, so the weights are bit-equal).
//  - The chunk's first maximum comes from a tree of pairwise compares (a
//    later class wins only if strictly larger), then meets the pixel's
//    running maximum, kept in shared memory across chunks: the labels of a
//    sequential first maximum for finite logits.  A chunk whose classes
//    all exist runs without masking.
//  - Labels (uint8, or int32 above 255 classes) go through a shared-memory
//    tile and leave 16 bytes at a time; a row that starts unaligned is
//    staged at its byte offset so only its ends are written narrower.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BH = 16;    // output rows per band
constexpr int CK = 4;     // classes per register chunk
constexpr int THREADS_MAX = 256;
constexpr int MIN_BLOCKS = 3;     // blocks resident per SM (registers)

// Index of staged row k's first element in `src`: rows are `rs` floats
// apart, each shifted by its run's misalignment so that the run's aligned
// middle lands on 16-byte boundaries.
__device__ __forceinline__ int row_base(int k, int rs, long e0) {
  return k * rs + static_cast<int>(e0 & 3);
}

template <typename Out>
__global__ void __launch_bounds__(THREADS_MAX, MIN_BLOCKS)
upsample_argmax_kernel(const float* __restrict__ logits,
                       const int* __restrict__ y_idx,
                       const float* __restrict__ y_w,
                       const int* __restrict__ x_idx,
                       const float* __restrict__ x_w,
                       Out* __restrict__ out, int h, int w, int C, int H,
                       int W, int bands, int spans, int rs, int taps_at) {
  extern __shared__ float4 smem4[];
  float* src = reinterpret_cast<float*>(smem4);
  float4* taps = smem4 + taps_at;   // per band row: wy0, wy1, staged rows
  const int BW = blockDim.x;
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int span = blk % spans;
  blk /= spans;
  const int band = blk % bands;
  const int b = blk / bands;
  const int Y0 = band * BH, X0 = span * BW;
  const int bh = min(BH, H - Y0), bw = min(BW, W - X0);
  // taps are non-decreasing: the band reads rows y0(Y0) .. y1(last row)
  const int sy0 = __ldg(y_idx + 2 * Y0);
  const int sy1 = __ldg(y_idx + 2 * (Y0 + bh - 1) + 1);
  const int sx0 = __ldg(x_idx + 2 * X0);
  const int sx1 = __ldg(x_idx + 2 * (X0 + bw - 1) + 1);
  const int nrows = sy1 - sy0 + 1;
  const int len = (sx1 - sx0 + 1) * C;
  const size_t img = static_cast<size_t>(b) * h;

  // ---- stage the source window: one contiguous run per source row ----
  for (int k = 0; k < nrows; ++k) {
    const long e0 = ((long)(img + sy0 + k) * w + sx0) * C;
    const float* g = logits + e0;
    float* dst = src + row_base(k, rs, e0);
    const int pre = min(static_cast<int>((4 - (e0 & 3)) & 3), len);
    const int n4 = (len - pre) >> 2;
    for (int i = tid; i < pre; i += BW) dst[i] = __ldg(g + i);
    const float4* g4 = reinterpret_cast<const float4*>(g + pre);
    float4* d4 = reinterpret_cast<float4*>(dst + pre);
    for (int i = tid; i < n4; i += BW) d4[i] = __ldg(g4 + i);
    for (int i = pre + 4 * n4 + tid; i < len; i += BW) dst[i] = __ldg(g + i);
  }

  // ---- this thread's column taps and the band's row taps ----
  const bool live = tid < bw;
  const int X = X0 + (live ? tid : 0);
  const int c0off = (__ldg(x_idx + 2 * X) - sx0) * C;
  const int c1off = (__ldg(x_idx + 2 * X + 1) - sx0) * C;
  const float wx0 = __ldg(x_w + 2 * X), wx1 = __ldg(x_w + 2 * X + 1);
  // row taps, and where each row's run of rows with the same tap pair
  // ends; the running maxima start below every logit
  float* sbest = reinterpret_cast<float*>(taps + BH);   // [BH][BW]
  int* sarg = reinterpret_cast<int*>(sbest + BH * BW);   // [BH][BW]
  auto pair_of = [&](int Y) {
    return (__ldg(y_idx + 2 * Y) - sy0) |
           ((__ldg(y_idx + 2 * Y + 1) - sy0) << 16);
  };
  if (tid < bh) {
    const int kp = pair_of(Y0 + tid);
    int end = tid + 1;
    while (end < bh && pair_of(Y0 + end) == kp) ++end;
    taps[tid] = make_float4(__ldg(y_w + 2 * (Y0 + tid)),
                            __ldg(y_w + 2 * (Y0 + tid) + 1),
                            __int_as_float(kp), __int_as_float(end));
  }
  for (int r = 0; r < bh; ++r) {
    sbest[r * BW + tid] = -INFINITY;
    sarg[r * BW + tid] = 0;
  }
  __syncthreads();

  if (live) {
    // classes [c0, c0 + CK); FULL: all CK of them exist (no masking)
    auto chunk = [&](int c0, auto full) {
      constexpr bool FULL = decltype(full)::value;
      // the W interpolation of staged row k at this column, classes
      // [c0, c0 + CK) (zero past C)
      auto interp = [&](int k, float (&t)[CK]) {
        const int base =
            row_base(k, rs, ((long)(img + sy0 + k) * w + sx0) * C) + c0;
        const float* s0 = src + base + c0off;
        const float* s1 = src + base + c1off;
#pragma unroll
        for (int u = 0; u < CK; ++u)
          t[u] = FULL || c0 + u < C ? s0[u] * wx0 + s1[u] * wx1 : 0.f;
      };
      float ta[CK], tb[CK];
      int held = -1;     // the staged row tb holds
      for (int r = 0; r < bh;) {
        // a run of output rows reading the same two staged rows; the next
        // run's first row is usually this run's second
        const float4 head = taps[r];
        const int kp = __float_as_int(head.z);
        const int end = __float_as_int(head.w);
        if ((kp & 0xffff) == held) {
#pragma unroll
          for (int u = 0; u < CK; ++u) ta[u] = tb[u];
        } else {
          interp(kp & 0xffff, ta);
        }
        held = kp >> 16;
        if ((kp >> 16) == (kp & 0xffff)) {
#pragma unroll
          for (int u = 0; u < CK; ++u) tb[u] = ta[u];
        } else {
          interp(kp >> 16, tb);
        }
#pragma unroll 2
        for (; r < end; ++r) {
          const float4 tr = taps[r];
          // the chunk's first maximum by a tree of pairwise compares (the
          // right one wins only if strictly larger, so ties keep the
          // lower class), then against the running maximum: the labels
          // of a sequential first maximum, for finite logits, with a
          // short dependency chain
          float v[CK];
          int ix[CK];
#pragma unroll
          for (int u = 0; u < CK; ++u) {
            v[u] = FULL || c0 + u < C ? tr.x * ta[u] + tr.y * tb[u]
                                        : -INFINITY;
            ix[u] = c0 + u;
          }
#pragma unroll
          for (int step = 1; step < CK; step *= 2)
#pragma unroll
            for (int u = 0; u < CK; u += 2 * step)
              if (v[u + step] > v[u]) {
                v[u] = v[u + step];
                ix[u] = ix[u + step];
              }
          if (v[0] > sbest[r * BW + tid]) {
            sbest[r * BW + tid] = v[0];
            sarg[r * BW + tid] = ix[0];
          }
        }
      }
    };
    for (int c0 = 0; c0 < C; c0 += CK) {
      if (c0 + CK <= C)
        chunk(c0, std::true_type());
      else
        chunk(c0, std::false_type());
    }
  }

  // ---- labels: a shared tile, then 16-byte stores ----
  __syncthreads();   // the source window is no longer read
  constexpr int PAD = 16;
  const int row_bytes = BW * static_cast<int>(sizeof(Out)) + PAD;
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem4);
  auto dst_row = [&](int r) {
    return reinterpret_cast<uint8_t*>(
        out + ((size_t)b * H + Y0 + r) * W + X0);
  };
  if (live) {
    for (int r = 0; r < bh; ++r) {
      const int mis = static_cast<int>(
          reinterpret_cast<uintptr_t>(dst_row(r)) & 15);
      *reinterpret_cast<Out*>(tile + r * row_bytes + mis +
                              tid * sizeof(Out)) =
          static_cast<Out>(sarg[r * BW + tid]);
    }
  }
  __syncthreads();
  // every row's aligned middle in 16-byte stores, all rows at once, then
  // the unaligned ends (at most 15 bytes on each side) byte by byte
  const int nbytes = bw * static_cast<int>(sizeof(Out));
  const int per_row = (nbytes >> 4) + 1;
  auto row_span = [&](int r, uint8_t*& d, const uint8_t*& s, int& pre,
                      int& n16) {
    d = dst_row(r);
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(d) & 15);
    s = tile + r * row_bytes + mis;
    pre = min((16 - mis) & 15, nbytes);
    n16 = (nbytes - pre) >> 4;
  };
  for (int i = tid; i < bh * per_row; i += BW) {
    const int r = i / per_row, c = i - r * per_row;
    uint8_t* d;
    const uint8_t* s;
    int pre, n16;
    row_span(r, d, s, pre, n16);
    if (c < n16)
      reinterpret_cast<uint4*>(d + pre)[c] =
          reinterpret_cast<const uint4*>(s + pre)[c];
  }
  for (int i = tid; i < bh * 32; i += BW) {
    const int r = i >> 5, b = i & 31;
    uint8_t* d;
    const uint8_t* s;
    int pre, n16;
    row_span(r, d, s, pre, n16);
    const int at = b < 16 ? b : pre + 16 * n16 + b - 16;
    if (b < 16 ? b < pre : at < nbytes) d[at] = s[at];
  }
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// logits (B, h, w, C) fp32, 16-byte aligned; y_idx/y_w (Hout, 2); x_idx/x_w
// (Wout, 2); out (B, Hout, Wout) uint8 (out_int32 == 0) or int32.
// `threads` output columns per block (a multiple of 32, at most 256);
// `max_rows` / `max_cols`: the most source rows a band and source columns
// a span of that width reach (the host reads them off the tap tables).
// Shared memory: max_rows staged rows of round4(max_cols * C + 3) floats,
// or the label tile, whichever is larger, then the band's row taps.
extern "C" int upsample_argmax_forward(const void* logits, const void* y_idx,
                                       const void* y_w, const void* x_idx,
                                       const void* x_w, void* out,
                                       int out_int32, int B, int h, int w,
                                       int C, int Hout, int Wout, int threads,
                                       int max_rows, int max_cols,
                                       void* stream) {
  if (B < 1 || h < 1 || w < 1 || C < 1 || C > 0xffff || Hout < 1 ||
      Wout < 1 || threads < 32 || threads > THREADS_MAX || threads % 32 ||
      max_rows < 1 || max_rows > 0x7fff || max_cols < 1 ||
      (reinterpret_cast<uintptr_t>(logits) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const long rs = ((long)max_cols * C + 3 + 3) / 4 * 4;
  const long src_bytes = (long)max_rows * rs * 4;
  const long tile_bytes =
      (long)BH * (threads * (out_int32 ? 4 : 1) + 16);
  const long taps_at = ((src_bytes > tile_bytes ? src_bytes : tile_bytes) +
                        15) / 16;
  const long smem = taps_at * 16 + BH * 16 + (long)BH * threads * 8;
  if (smem > 232448 || rs > 0x7fffffffL / max_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bands = (Hout + BH - 1) / BH;
  const int spans = (Wout + threads - 1) / threads;
  const long blocks = (long)B * bands * spans;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const int* yi = static_cast<const int*>(y_idx);
  const float* yw = static_cast<const float*>(y_w);
  const int* xi = static_cast<const int*>(x_idx);
  const float* xw = static_cast<const float*>(x_w);
  cudaError_t e;
  if (out_int32) {
    auto k = upsample_argmax_kernel<int32_t>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<(unsigned)blocks, threads, smem, st>>>(
        lg, yi, yw, xi, xw, static_cast<int32_t*>(out), h, w, C, Hout, Wout,
        bands, spans, (int)rs, (int)taps_at);
  } else {
    auto k = upsample_argmax_kernel<uint8_t>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<(unsigned)blocks, threads, smem, st>>>(
        lg, yi, yw, xi, xw, static_cast<uint8_t*>(out), h, w, C, Hout, Wout,
        bands, spans, (int)rs, (int)taps_at);
  }
  return static_cast<int>(cudaGetLastError());
}
