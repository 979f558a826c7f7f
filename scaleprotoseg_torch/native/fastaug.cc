// Fused training augmentation: one pass over output pixels doing
// scale-resize (bilinear image / PIL-convention nearest label), LUT label
// conversion, mean-padding, random crop, horizontal flip, and
// normalization.  The numpy pipeline (dataset.py) performs these as
// separate passes over the window; this computes each output
// pixel directly from the source image.
//
// Built with g++ at first use (scaleprotoseg_torch/native/__init__.py) and
// bound via ctypes; the numpy pipeline (resized_window) is the reference.
//
// Conventions (must match scaleprotoseg_torch/data/dataset.py):
//   image resize: half-pixel centers, bilinear, float (cv2 INTER_LINEAR
//     semantics up to its fixed-point rounding)
//   label resize: src = floor((dst + 0.5) * in/out)  (PIL NEAREST)
//   pad: bottom/right only; image pad value = per-channel mean (on the
//     [0,1] scale), label pad = 0
//   flip: horizontal, after crop
//   normalize: (x - mean) / std; skipped for push mode

#include <cstdint>
#include <cmath>
#include <algorithm>

extern "C" {

void fastaug(const uint8_t* img,        // (in_h, in_w, 3) RGB
             const uint8_t* label,      // (in_h, in_w)
             int in_h, int in_w,
             const uint8_t* lut,        // 256-entry label LUT (id conv)
             int rs_h, int rs_w,        // resized dims (computed host-side)
             const int32_t* row_idx,    // PIL-NEAREST row map, len rs_h
             const int32_t* col_idx,    // PIL-NEAREST col map, len rs_w
             int win_h, int win_w,
             int start_h, int start_w,  // crop offset in resized coords
             int flip,
             const float* mean, const float* stddev,
             int normalize,
             float* out_img,            // (win_h, win_w, 3)
             int32_t* out_label) {      // (win_h, win_w)
  const double sy = (double)in_h / (double)rs_h;
  const double sx = (double)in_w / (double)rs_w;

  for (int y = 0; y < win_h; ++y) {
    const int ry = start_h + y;  // row in resized image
    for (int x = 0; x < win_w; ++x) {
      const int ox = flip ? (win_w - 1 - x) : x;
      const int rx = start_w + x;
      float* po = out_img + ((size_t)y * win_w + ox) * 3;
      int32_t* lo = out_label + (size_t)y * win_w + ox;

      if (ry >= rs_h || rx >= rs_w) {  // bottom/right padding
        for (int c = 0; c < 3; ++c) {
          const float v = mean[c];
          po[c] = normalize ? (v - mean[c]) / stddev[c] : v;
        }
        *lo = 0;
        continue;
      }

      // ---- label: PIL NEAREST via host-provided (PIL-derived) maps ----
      *lo = (int32_t)lut[label[(size_t)row_idx[ry] * in_w + col_idx[rx]]];

      // ---- image: bilinear, half-pixel centers ----
      double fy = (ry + 0.5) * sy - 0.5;
      double fx = (rx + 0.5) * sx - 0.5;
      fy = std::min(std::max(fy, 0.0), (double)(in_h - 1));
      fx = std::min(std::max(fx, 0.0), (double)(in_w - 1));
      const int y0 = (int)fy;
      const int x0 = (int)fx;
      const int y1 = std::min(y0 + 1, in_h - 1);
      const int x1 = std::min(x0 + 1, in_w - 1);
      const float wy = (float)(fy - y0);
      const float wx = (float)(fx - x0);
      const uint8_t* p00 = img + ((size_t)y0 * in_w + x0) * 3;
      const uint8_t* p01 = img + ((size_t)y0 * in_w + x1) * 3;
      const uint8_t* p10 = img + ((size_t)y1 * in_w + x0) * 3;
      const uint8_t* p11 = img + ((size_t)y1 * in_w + x1) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v =
            ((1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
             wy * ((1 - wx) * p10[c] + wx * p11[c])) / 255.0f;
        po[c] = normalize ? (v - mean[c]) / stddev[c] : v;
      }
    }
  }
}

}  // extern "C"
