// Bilinear upsample + argmax over classes (K3), writing labels directly.
//
// Replaces scaleprotoseg_tpu/ops/pallas_upsample.py::fused_upsample_argmax
// (_apply).
//
// Bound: at the flagship shape (2 x 129 x 257 x 19 fp32 -> 2 x 1024 x 2048
// uint8) the kernel moves ~9 MB and does ~0.35 GFLOP of fp32 work, both a
// few microseconds; what it must avoid is the ~318 MB of full-resolution
// fp32 logits that interpolate-then-argmax would write and read back.
//
// Design: one thread per output pixel.  The two row taps and two column
// taps with their weights come from small host-built tables holding the
// nonzeros of the JAX package's _bilinear_matrix, so the weights are
// bit-equal.  Per class the thread interpolates along W on both source
// rows, then along H, and keeps a running maximum with a strict '>' so the
// first maximal class wins.  Neighbouring output pixels share their source
// pixels (8x upsampling), so the reads are served by L1.  The label is
// written as uint8 (int32 when there are more than 255 classes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Out>
__global__ void upsample_argmax_kernel(const float* __restrict__ logits,
                                       const int* __restrict__ y_idx,
                                       const float* __restrict__ y_w,
                                       const int* __restrict__ x_idx,
                                       const float* __restrict__ x_w,
                                       Out* __restrict__ out, int B, int h,
                                       int w, int C, int Hout, int Wout) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)B * Hout * Wout;
  if (idx >= total) return;
  const int X = (int)(idx % Wout);
  const long t = idx / Wout;
  const int Y = (int)(t % Hout);
  const int b = (int)(t / Hout);

  const int y0 = __ldg(y_idx + 2 * Y), y1 = __ldg(y_idx + 2 * Y + 1);
  const float wy0 = __ldg(y_w + 2 * Y), wy1 = __ldg(y_w + 2 * Y + 1);
  const int x0 = __ldg(x_idx + 2 * X), x1 = __ldg(x_idx + 2 * X + 1);
  const float wx0 = __ldg(x_w + 2 * X), wx1 = __ldg(x_w + 2 * X + 1);

  const float* base = logits + (long)b * h * w * C;
  const float* p00 = base + ((long)y0 * w + x0) * C;
  const float* p01 = base + ((long)y0 * w + x1) * C;
  const float* p10 = base + ((long)y1 * w + x0) * C;
  const float* p11 = base + ((long)y1 * w + x1) * C;

  float best = 0.f;
  int arg = 0;
  for (int c = 0; c < C; ++c) {
    const float t0 = __ldg(p00 + c) * wx0 + __ldg(p01 + c) * wx1;
    const float t1 = __ldg(p10 + c) * wx0 + __ldg(p11 + c) * wx1;
    const float v = wy0 * t0 + wy1 * t1;
    if (c == 0 || v > best) {
      best = v;
      arg = c;
    }
  }
  out[idx] = static_cast<Out>(arg);
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// logits (B, h, w, C) fp32; y_idx/y_w (Hout, 2); x_idx/x_w (Wout, 2);
// out (B, Hout, Wout) uint8 (out_int32 == 0) or int32.
extern "C" int upsample_argmax_forward(const void* logits, const void* y_idx,
                                       const void* y_w, const void* x_idx,
                                       const void* x_w, void* out,
                                       int out_int32, int B, int h, int w,
                                       int C, int Hout, int Wout,
                                       void* stream) {
  if (B < 1 || h < 1 || w < 1 || C < 1 || Hout < 1 || Wout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long total = (long)B * Hout * Wout;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const int* yi = static_cast<const int*>(y_idx);
  const float* yw = static_cast<const float*>(y_w);
  const int* xi = static_cast<const int*>(x_idx);
  const float* xw = static_cast<const float*>(x_w);
  if (out_int32)
    upsample_argmax_kernel<int32_t><<<blocks, threads, 0, st>>>(
        lg, yi, yw, xi, xw, static_cast<int32_t*>(out), B, h, w, C, Hout,
        Wout);
  else
    upsample_argmax_kernel<uint8_t><<<blocks, threads, 0, st>>>(
        lg, yi, yw, xi, xw, static_cast<uint8_t*>(out), B, h, w, C, Hout,
        Wout);
  return static_cast<int>(cudaGetLastError());
}
