// Native image preprocessing for the data pipeline (the port's copy of
// vae_tagger_tpu/native/resize.cpp; the same code, so both packages give
// the same pixels).
//
// SmartResize semantics (aspect-preserving crop to the target ratio, then a
// separable Lanczos-3 resample) in C++, so a loader's thread pool scales
// past PIL.  Exposed through a plain C ABI (ctypes binding in __init__.py).
//
// Layout: row-major HWC uint8 RGB in and out.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr int kLanczosA = 3;

inline double lanczos3(double x) {
  if (x == 0.0) return 1.0;
  if (x <= -kLanczosA || x >= kLanczosA) return 0.0;
  const double px = kPi * x;
  return kLanczosA * std::sin(px) * std::sin(px / kLanczosA) / (px * px);
}

// Triangle filter, support 1 — PIL's BILINEAR convention (support scales by
// the downsampling ratio, i.e. antialiased).  Used for the reference's
// inference-time square resize (torchvision Resize default is BILINEAR,
// modules.py:136-140).
inline double triangle(double x) {
  x = x < 0 ? -x : x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// filter ids of the C ABI: 0 = Lanczos-3, 1 = bilinear
inline double filter_support(int filter) { return filter == 1 ? 1.0 : kLanczosA; }
inline double filter_eval(int filter, double x) {
  return filter == 1 ? triangle(x) : lanczos3(x);
}

// Precomputed sampling kernel for one output axis: for each output index,
// the input window [start, start+len) and normalized weights.
struct AxisKernel {
  std::vector<int> start;
  std::vector<int> len;
  std::vector<double> weights;  // flattened, stride = max_len
  int max_len = 0;
};

// Matches the convention of high-quality resamplers (and PIL): the filter
// support scales by the downsampling ratio; weights are renormalized over
// the clipped window.
AxisKernel build_kernel(int in_size, int out_size, int in_offset, int filter) {
  AxisKernel k;
  k.start.resize(out_size);
  k.len.resize(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  const double filter_scale = std::max(scale, 1.0);
  const double support = filter_support(filter) * filter_scale;
  k.max_len = static_cast<int>(std::ceil(support)) * 2 + 1;
  k.weights.assign(static_cast<size_t>(out_size) * k.max_len, 0.0);

  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support));
    int hi = static_cast<int>(std::ceil(center + support));
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    k.start[i] = lo + in_offset;
    k.len[i] = hi - lo;
    double sum = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double w = filter_eval(filter, (j + 0.5 - center) / filter_scale);
      k.weights[static_cast<size_t>(i) * k.max_len + (j - lo)] = w;
      sum += w;
    }
    if (sum != 0.0) {
      for (int j = 0; j < k.len[i]; ++j) {
        k.weights[static_cast<size_t>(i) * k.max_len + j] /= sum;
      }
    }
  }
  return k;
}

inline uint8_t clamp_u8(double v) {
  return static_cast<uint8_t>(std::min(255.0, std::max(0.0, v + 0.5)));
}

// Aspect-preserving crop-window selection shared by the RGB and planar
// resamplers (SmartResize math, modules.py:149-178; mode 3 = distort).
// Returns false on a degenerate window.
bool crop_window(int src_h, int src_w, int dst_h, int dst_w, int crop_mode,
                 int crop_x, int crop_y, int* win_w, int* win_h, int* off_x,
                 int* off_y) {
  const double target_ratio = static_cast<double>(dst_w) / dst_h;
  const double src_ratio = static_cast<double>(src_w) / src_h;
  *win_w = src_w;
  *win_h = src_h;
  *off_x = 0;
  *off_y = 0;
  if (crop_mode == 3) {
    // distort: no crop
  } else if (src_ratio > target_ratio) {
    *win_w = static_cast<int>(src_h * target_ratio);
    *win_h = src_h;
    if (crop_mode == 0) *off_x = (src_w - *win_w) / 2;
    else if (crop_mode == 2)
      *off_x = std::min(std::max(crop_x, 0), src_w - *win_w);
  } else if (src_ratio < target_ratio) {
    *win_w = src_w;
    *win_h = static_cast<int>(src_w / target_ratio);
    if (crop_mode == 0) *off_y = (src_h - *win_h) / 2;
    else if (crop_mode == 2)
      *off_y = std::min(std::max(crop_y, 0), src_h - *win_h);
  }
  return *win_w > 0 && *win_h > 0;
}

}  // namespace

extern "C" {

// crop_mode: 0 = center, 1 = top/left (matching SmartResize semantics;
// 'random' crops pick their offset in Python and pass it via crop_x/crop_y
// with crop_mode=2; 3 = no crop — distorting resize like torchvision's
// square Resize((r, r))).  filter: 0 = Lanczos-3 (SmartResize/training),
// 1 = bilinear (the reference's inference transform).
int vt_smart_resize_filter(const uint8_t* src, int src_h, int src_w,
                           uint8_t* dst, int dst_h, int dst_w,
                           int crop_mode, int crop_x, int crop_y,
                           int filter) {
  if (!src || !dst || src_h <= 0 || src_w <= 0 || dst_h <= 0 || dst_w <= 0) {
    return -1;
  }

  // aspect-preserving crop window (SmartResize, modules.py:149-178 math)
  int win_w, win_h, off_x, off_y;
  if (!crop_window(src_h, src_w, dst_h, dst_w, crop_mode, crop_x, crop_y,
                   &win_w, &win_h, &off_x, &off_y)) {
    return -2;
  }

  const AxisKernel kx = build_kernel(win_w, dst_w, off_x, filter);
  const AxisKernel ky = build_kernel(win_h, dst_h, off_y, filter);

  // horizontal pass: (win_h, dst_w, 3) float intermediate over the crop rows
  std::vector<float> tmp(static_cast<size_t>(win_h) * dst_w * 3);
  for (int y = 0; y < win_h; ++y) {
    const uint8_t* row = src + (static_cast<size_t>(y + off_y) * src_w) * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dst_w * 3;
    for (int x = 0; x < dst_w; ++x) {
      const double* w = kx.weights.data() + static_cast<size_t>(x) * kx.max_len;
      const int s = kx.start[x];
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int j = 0; j < kx.len[x]; ++j) {
        const uint8_t* px = row + (static_cast<size_t>(s + j)) * 3;
        acc0 += w[j] * px[0];
        acc1 += w[j] * px[1];
        acc2 += w[j] * px[2];
      }
      trow[x * 3 + 0] = static_cast<float>(acc0);
      trow[x * 3 + 1] = static_cast<float>(acc1);
      trow[x * 3 + 2] = static_cast<float>(acc2);
    }
  }

  // vertical pass -> uint8 out.  ky.start is offset by off_y into the
  // original image; tmp is indexed from the crop origin.
  for (int y = 0; y < dst_h; ++y) {
    const double* w = ky.weights.data() + static_cast<size_t>(y) * ky.max_len;
    const int s = ky.start[y] - off_y;
    uint8_t* drow = dst + static_cast<size_t>(y) * dst_w * 3;
    for (int x = 0; x < dst_w; ++x) {
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int j = 0; j < ky.len[y]; ++j) {
        const float* px = tmp.data()
            + (static_cast<size_t>(s + j) * dst_w + x) * 3;
        acc0 += w[j] * px[0];
        acc1 += w[j] * px[1];
        acc2 += w[j] * px[2];
      }
      drow[x * 3 + 0] = clamp_u8(acc0);
      drow[x * 3 + 1] = clamp_u8(acc1);
      drow[x * 3 + 2] = clamp_u8(acc2);
    }
  }
  return 0;
}

// Original entry point — Lanczos-3, kept as the stable ABI name.
int vt_smart_resize(const uint8_t* src, int src_h, int src_w,
                    uint8_t* dst, int dst_h, int dst_w,
                    int crop_mode, int crop_x, int crop_y) {
  return vt_smart_resize_filter(src, src_h, src_w, dst, dst_h, dst_w,
                                crop_mode, crop_x, crop_y, /*filter=*/0);
}

// Single-channel crop+resample over a strided (possibly interleaved) source:
// pixel (y, x) of the plane lives at src[(y*src_w + x)*stride + offset].
// Used by the planar YUV 4:2:0 output path (decode.cpp) — the crop-window
// math matches vt_smart_resize_filter exactly, so resampling the Y plane to
// (dst_h, dst_w) and the chroma planes to (dst_h/2, dst_w/2) with the SAME
// crop parameters selects the same source window for all three (the target
// aspect ratio, which drives the window, is identical).
int vt_resize_plane(const uint8_t* src, int src_h, int src_w, int stride,
                    int offset, uint8_t* dst, int dst_h, int dst_w,
                    int crop_mode, int crop_x, int crop_y, int filter) {
  if (!src || !dst || src_h <= 0 || src_w <= 0 || dst_h <= 0 || dst_w <= 0 ||
      stride <= 0 || offset < 0 || offset >= stride) {
    return -1;
  }
  int win_w, win_h, off_x, off_y;
  if (!crop_window(src_h, src_w, dst_h, dst_w, crop_mode, crop_x, crop_y,
                   &win_w, &win_h, &off_x, &off_y)) {
    return -2;
  }
  const AxisKernel kx = build_kernel(win_w, dst_w, off_x, filter);
  const AxisKernel ky = build_kernel(win_h, dst_h, off_y, filter);

  std::vector<float> tmp(static_cast<size_t>(win_h) * dst_w);
  for (int y = 0; y < win_h; ++y) {
    const uint8_t* row =
        src + (static_cast<size_t>(y + off_y) * src_w) * stride + offset;
    float* trow = tmp.data() + static_cast<size_t>(y) * dst_w;
    for (int x = 0; x < dst_w; ++x) {
      const double* w = kx.weights.data() + static_cast<size_t>(x) * kx.max_len;
      const int s = kx.start[x];
      double acc = 0;
      for (int j = 0; j < kx.len[x]; ++j) {
        acc += w[j] * row[static_cast<size_t>(s + j) * stride];
      }
      trow[x] = static_cast<float>(acc);
    }
  }
  for (int y = 0; y < dst_h; ++y) {
    const double* w = ky.weights.data() + static_cast<size_t>(y) * ky.max_len;
    const int s = ky.start[y] - off_y;
    uint8_t* drow = dst + static_cast<size_t>(y) * dst_w;
    for (int x = 0; x < dst_w; ++x) {
      double acc = 0;
      for (int j = 0; j < ky.len[y]; ++j) {
        acc += w[j] * tmp[static_cast<size_t>(s + j) * dst_w + x];
      }
      drow[x] = clamp_u8(acc);
    }
  }
  return 0;
}

// HWC uint8 RGB -> planar YUV 4:2:0 (BT.601 full-range forward matrix, the
// JFIF convention; chroma is a 2x2 box average).  h and w must be even.
// Serves the non-JPEG sources of the YUV transfer path: PNG/WebP decode to
// RGB, then one cheap pass converts to the wire format the device op
// (ops/image.py::yuv420_to_normalized_rgb) reconstitutes.
int vt_rgb_to_yuv420(const uint8_t* src, int h, int w, uint8_t* y_dst,
                     uint8_t* cb_dst, uint8_t* cr_dst) {
  if (!src || !y_dst || !cb_dst || !cr_dst || h <= 0 || w <= 0 ||
      (h % 2) != 0 || (w % 2) != 0) {
    return -1;
  }
  std::vector<float> cb_full(static_cast<size_t>(h) * w);
  std::vector<float> cr_full(static_cast<size_t>(h) * w);
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = src + static_cast<size_t>(yy) * w * 3;
    uint8_t* yrow = y_dst + static_cast<size_t>(yy) * w;
    float* cbrow = cb_full.data() + static_cast<size_t>(yy) * w;
    float* crrow = cr_full.data() + static_cast<size_t>(yy) * w;
    for (int x = 0; x < w; ++x) {
      const double r = row[x * 3 + 0];
      const double g = row[x * 3 + 1];
      const double b = row[x * 3 + 2];
      yrow[x] = clamp_u8(0.299 * r + 0.587 * g + 0.114 * b);
      cbrow[x] = static_cast<float>(-0.168736 * r - 0.331264 * g + 0.5 * b
                                    + 128.0);
      crrow[x] = static_cast<float>(0.5 * r - 0.418688 * g - 0.081312 * b
                                    + 128.0);
    }
  }
  const int ch = h / 2, cw = w / 2;
  for (int yy = 0; yy < ch; ++yy) {
    const float* r0b = cb_full.data() + static_cast<size_t>(2 * yy) * w;
    const float* r1b = r0b + w;
    const float* r0r = cr_full.data() + static_cast<size_t>(2 * yy) * w;
    const float* r1r = r0r + w;
    uint8_t* cbrow = cb_dst + static_cast<size_t>(yy) * cw;
    uint8_t* crrow = cr_dst + static_cast<size_t>(yy) * cw;
    for (int x = 0; x < cw; ++x) {
      cbrow[x] = clamp_u8(0.25 * (r0b[2 * x] + r0b[2 * x + 1]
                                  + r1b[2 * x] + r1b[2 * x + 1]));
      crrow[x] = clamp_u8(0.25 * (r0r[2 * x] + r0r[2 * x + 1]
                                  + r1r[2 * x] + r1r[2 * x + 1]));
    }
  }
  return 0;
}

}  // extern "C"
