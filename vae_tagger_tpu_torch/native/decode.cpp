// Native image decode fused with the crop + resize (the port's copy of
// vae_tagger_tpu/native/decode.cpp; the same code, so both packages give
// the same pixels for the same bytes).
//
// libjpeg(-turbo) decoding is paired with the Lanczos core in resize.cpp,
// with DCT-domain scaling: when the target is much smaller than the source,
// libjpeg decodes directly at 1/2..7/8 scale (IDCT shortcut), cutting both
// decode and resample cost while the final Lanczos still resamples from a
// >= quality_factor x target image.
//
// PNG (libpng simplified API) and WebP (libwebp) get the same fused
// decode+crop+resize when their libraries are present at build time
// (VT_HAVE_PNG / VT_HAVE_WEBP); no DCT shortcut exists for them, but the
// one-call path releases the GIL for its whole length.
//
// Plain C ABI (ctypes binding in __init__.py).  Unsupported formats and
// exotic color spaces return an error and the caller falls back to PIL.

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

#include <cstdio>  // jpeglib needs FILE
#include <jpeglib.h>

#ifdef VT_HAVE_PNG
#include <png.h>
#endif
#ifdef VT_HAVE_WEBP
#include <webp/decode.h>
#endif

extern "C" int vt_smart_resize_filter(const uint8_t* src, int src_h,
                                      int src_w, uint8_t* dst, int dst_h,
                                      int dst_w, int crop_mode, int crop_x,
                                      int crop_y, int filter);
extern "C" int vt_resize_plane(const uint8_t* src, int src_h, int src_w,
                               int stride, int offset, uint8_t* dst,
                               int dst_h, int dst_w, int crop_mode,
                               int crop_x, int crop_y, int filter);

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void silent_emit(j_common_ptr, int) {}

}  // namespace

extern "C" {

// Header-only parse: fills (h, w), returns 0 on success.
int vt_jpeg_info(const uint8_t* data, size_t len, int* h, int* w) {
  if (!data || len < 4 || !h || !w) return -1;
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = silent_emit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + SmartResize in one call.
//
// crop_mode / crop_x / crop_y follow vt_smart_resize, with offsets given in
// FULL-RESOLUTION coordinates (they are rescaled if DCT scaling engages).
// quality_factor q: decode at the smallest DCT scale that keeps the crop
// window >= q x the target on both axes (q=0 forces a full decode, exactly
// matching a PIL decode + native resize).  reject_full_scale != 0 makes the
// call return 1 WITHOUT decoding when only a full-scale decode is possible
// (callers that prefer PIL's marginally faster full decode use this instead
// of mirroring the scale-selection math); q=0 overrides it — an explicit
// full-decode request is never rejected.  Returns 0 ok, 1 rejected,
// <0 error.
int vt_jpeg_decode_resize(const uint8_t* data, size_t len,
                          uint8_t* dst, int dst_h, int dst_w,
                          int crop_mode, int crop_x, int crop_y,
                          int quality_factor, int reject_full_scale,
                          int filter) {
  if (!data || len < 4 || !dst || dst_h <= 0 || dst_w <= 0) return -1;

  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = silent_emit;
  std::vector<uint8_t> pixels;  // declared before setjmp use below
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);

  const int full_w = static_cast<int>(cinfo.image_width);
  const int full_h = static_cast<int>(cinfo.image_height);
  if (full_w <= 0 || full_h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }

  // Crop window in full resolution (same ratio math as vt_smart_resize).
  const double target_ratio = static_cast<double>(dst_w) / dst_h;
  const double src_ratio = static_cast<double>(full_w) / full_h;
  int win_w = full_w, win_h = full_h;
  if (crop_mode != 3) {
    if (src_ratio > target_ratio) {
      win_w = static_cast<int>(full_h * target_ratio);
    } else if (src_ratio < target_ratio) {
      win_h = static_cast<int>(full_w / target_ratio);
    }
  }
  if (win_w <= 0 || win_h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }

  // Smallest DCT scale m/8 (m in 1..8) with win*m/8 >= q*target both axes.
  int m = 8;
  if (quality_factor > 0) {
    for (int cand = 1; cand <= 8; ++cand) {
      if (static_cast<long>(win_w) * cand >= 8L * quality_factor * dst_w &&
          static_cast<long>(win_h) * cand >= 8L * quality_factor * dst_h) {
        m = cand;
        break;
      }
    }
  }
  if (m >= 8 && reject_full_scale && quality_factor > 0) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.scale_num = m;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;  // converts GRAYSCALE/YCbCr; CMYK errors
  cinfo.dct_method = JDCT_ISLOW;    // PIL's default: keeps parity at m=8

  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  const int dec_w = static_cast<int>(cinfo.output_width);
  const int dec_h = static_cast<int>(cinfo.output_height);
  pixels.resize(static_cast<size_t>(dec_w) * dec_h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() +
        static_cast<size_t>(cinfo.output_scanline) * dec_w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Rescale explicit crop offsets into decoded coordinates.
  int cx = crop_x, cy = crop_y;
  if (crop_mode == 2 && m != 8) {
    cx = static_cast<int>(static_cast<long>(crop_x) * dec_w / full_w);
    cy = static_cast<int>(static_cast<long>(crop_y) * dec_h / full_h);
  }
  return vt_smart_resize_filter(pixels.data(), dec_h, dec_w, dst, dst_h,
                                dst_w, crop_mode, cx, cy, filter);
}

// JPEG decode to planar YUV 4:2:0 + SmartResize, skipping libjpeg's
// YCbCr->RGB color conversion (the wire format of the YUV transfer path:
// 1.5 B/px to the device instead of RGB's 3, with the color conversion +
// chroma upsample fused into the device program,
// ops/image.py::yuv420_to_normalized_rgb).
//
// Output: y_dst (dst_h x dst_w), cb_dst/cr_dst (dst_h/2 x dst_w/2); dst
// dims must be even.  Decoding stays interleaved (out_color_space
// JCS_YCbCr = no color transform, chroma upsample only), and each plane is
// resampled separately — Y at full target, chroma straight to half target,
// so the chroma resample cost is 1/4 of the RGB path's per-channel cost.
// Grayscale JPEGs decode as luma with neutral (128) chroma.  DCT-domain
// scaling applies exactly as in vt_jpeg_decode_resize.
//
// Returns 0 ok, 2 = colorspace this path does not serve (CMYK/RGB JPEGs —
// caller falls back to the RGB decoder + vt_rgb_to_yuv420), <0 error.
int vt_jpeg_decode_resize_yuv420(const uint8_t* data, size_t len,
                                 uint8_t* y_dst, uint8_t* cb_dst,
                                 uint8_t* cr_dst, int dst_h, int dst_w,
                                 int crop_mode, int crop_x, int crop_y,
                                 int quality_factor, int filter) {
  if (!data || len < 4 || !y_dst || !cb_dst || !cr_dst || dst_h <= 0 ||
      dst_w <= 0 || (dst_h % 2) != 0 || (dst_w % 2) != 0) {
    return -1;
  }

  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = silent_emit;
  std::vector<uint8_t> pixels;  // declared before setjmp use below
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);

  const int full_w = static_cast<int>(cinfo.image_width);
  const int full_h = static_cast<int>(cinfo.image_height);
  if (full_w <= 0 || full_h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  const bool gray = cinfo.jpeg_color_space == JCS_GRAYSCALE;
  if (!gray && cinfo.jpeg_color_space != JCS_YCbCr) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;  // RGB/CMYK JPEG: not worth a separate path; use RGB decode
  }

  // crop window + DCT scale selection: same math as vt_jpeg_decode_resize
  const double target_ratio = static_cast<double>(dst_w) / dst_h;
  const double src_ratio = static_cast<double>(full_w) / full_h;
  int win_w = full_w, win_h = full_h;
  if (crop_mode != 3) {
    if (src_ratio > target_ratio) {
      win_w = static_cast<int>(full_h * target_ratio);
    } else if (src_ratio < target_ratio) {
      win_h = static_cast<int>(full_w / target_ratio);
    }
  }
  if (win_w <= 0 || win_h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  int m = 8;
  if (quality_factor > 0) {
    for (int cand = 1; cand <= 8; ++cand) {
      if (static_cast<long>(win_w) * cand >= 8L * quality_factor * dst_w &&
          static_cast<long>(win_h) * cand >= 8L * quality_factor * dst_h) {
        m = cand;
        break;
      }
    }
  }
  cinfo.scale_num = m;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_YCbCr;
  cinfo.dct_method = JDCT_ISLOW;

  jpeg_start_decompress(&cinfo);
  const int comps = cinfo.output_components;
  if (comps != (gray ? 1 : 3)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  const int dec_w = static_cast<int>(cinfo.output_width);
  const int dec_h = static_cast<int>(cinfo.output_height);
  pixels.resize(static_cast<size_t>(dec_w) * dec_h * comps);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() +
        static_cast<size_t>(cinfo.output_scanline) * dec_w * comps;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  int cx = crop_x, cy = crop_y;
  if (crop_mode == 2 && m != 8) {
    cx = static_cast<int>(static_cast<long>(crop_x) * dec_w / full_w);
    cy = static_cast<int>(static_cast<long>(crop_y) * dec_h / full_h);
  }
  int rc = vt_resize_plane(pixels.data(), dec_h, dec_w, comps, 0, y_dst,
                           dst_h, dst_w, crop_mode, cx, cy, filter);
  if (rc != 0) return rc;
  if (gray) {
    std::memset(cb_dst, 128, static_cast<size_t>(dst_h / 2) * (dst_w / 2));
    std::memset(cr_dst, 128, static_cast<size_t>(dst_h / 2) * (dst_w / 2));
    return 0;
  }
  rc = vt_resize_plane(pixels.data(), dec_h, dec_w, comps, 1, cb_dst,
                       dst_h / 2, dst_w / 2, crop_mode, cx, cy, filter);
  if (rc != 0) return rc;
  return vt_resize_plane(pixels.data(), dec_h, dec_w, comps, 2, cr_dst,
                         dst_h / 2, dst_w / 2, crop_mode, cx, cy, filter);
}

#ifdef VT_HAVE_PNG

// Header-only parse via the libpng simplified API.
int vt_png_info(const uint8_t* data, size_t len, int* h, int* w) {
  if (!data || len < 8 || !h || !w) return -1;
  png_image im;
  std::memset(&im, 0, sizeof(im));
  im.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&im, data, len)) return -2;
  *h = static_cast<int>(im.height);
  *w = static_cast<int>(im.width);
  png_image_free(&im);
  return 0;
}

// PNG decode + crop + resize in one call.  Alpha is DROPPED, not composited
// (PIL ``convert("RGB")`` semantics — the reference's loader,
// modules.py:690); palette/gray expand to RGB.  No equivalent of JPEG's
// DCT-domain scaling exists for PNG, so this always decodes at full size;
// the win over the PIL path is the fused GIL-free decode+resample.
int vt_png_decode_resize(const uint8_t* data, size_t len,
                         uint8_t* dst, int dst_h, int dst_w,
                         int crop_mode, int crop_x, int crop_y, int filter) {
  if (!data || len < 8 || !dst || dst_h <= 0 || dst_w <= 0) return -1;
  png_image im;
  std::memset(&im, 0, sizeof(im));
  im.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&im, data, len)) return -2;
  if ((im.format & PNG_FORMAT_FLAG_LINEAR) != 0) {
    // 16-bit PNG: requesting 8-bit sRGB here would apply libpng's
    // linear->sRGB gamma encoding, while the PIL path (convert("RGB"))
    // does a plain bit-depth reduction — the pixels would differ by a
    // ~2.2 gamma curve depending on which decoder ran.  Reject (rc=1)
    // so the caller falls back to PIL, keeping inputs identical on
    // hosts with and without the native library.
    png_image_free(&im);
    return 1;
  }
  const bool has_alpha = (im.format & PNG_FORMAT_FLAG_ALPHA) != 0;
  im.format = has_alpha ? PNG_FORMAT_RGBA : PNG_FORMAT_RGB;
  const int sw = static_cast<int>(im.width);
  const int sh = static_cast<int>(im.height);
  if (sw <= 0 || sh <= 0) {
    png_image_free(&im);
    return -3;
  }
  std::vector<uint8_t> pixels(PNG_IMAGE_SIZE(im));
  if (!png_image_finish_read(&im, nullptr, pixels.data(), 0, nullptr)) {
    png_image_free(&im);
    return -3;
  }
  if (has_alpha) {  // strip A in place: RGBA -> RGB
    const size_t n = static_cast<size_t>(sw) * sh;
    for (size_t i = 1; i < n; ++i) {
      std::memmove(pixels.data() + i * 3, pixels.data() + i * 4, 3);
    }
  }
  return vt_smart_resize_filter(pixels.data(), sh, sw, dst, dst_h, dst_w,
                                crop_mode, crop_x, crop_y, filter);
}

#endif  // VT_HAVE_PNG

#ifdef VT_HAVE_WEBP

int vt_webp_info(const uint8_t* data, size_t len, int* h, int* w) {
  if (!data || len < 12 || !h || !w) return -1;
  int ww = 0, hh = 0;
  if (!WebPGetInfo(data, len, &ww, &hh)) return -2;
  *h = hh;
  *w = ww;
  return 0;
}

// WebP decode + crop + resize in one call (alpha dropped, as above).
int vt_webp_decode_resize(const uint8_t* data, size_t len,
                          uint8_t* dst, int dst_h, int dst_w,
                          int crop_mode, int crop_x, int crop_y, int filter) {
  if (!data || len < 12 || !dst || dst_h <= 0 || dst_w <= 0) return -1;
  int sw = 0, sh = 0;
  if (!WebPGetInfo(data, len, &sw, &sh)) return -2;
  if (sw <= 0 || sh <= 0) return -3;
  std::vector<uint8_t> pixels(static_cast<size_t>(sw) * sh * 3);
  if (!WebPDecodeRGBInto(data, len, pixels.data(), pixels.size(), sw * 3)) {
    return -3;
  }
  return vt_smart_resize_filter(pixels.data(), sh, sw, dst, dst_h, dst_w,
                                crop_mode, crop_x, crop_y, filter);
}

// WebP decode straight to planar YUV 4:2:0 + SmartResize.
//
// Lossy WebP (VP8) is CODED as BT.601 limited-range YCbCr 4:2:0, so this
// path skips libwebp's fancy chroma upsample + YUV->RGB conversion entirely:
// the coded planes are resampled directly (Y to target, Cb/Cr to half
// target — 1.5 plane-pixels per source pixel instead of the RGB path's 3),
// then expanded from limited (16..235 / 16..240) to FULL range with
// 256-entry LUTs so the wire format matches the JPEG path's full-range
// planes (the device converter, ops/image.py::yuv420_to_normalized_rgb,
// assumes JPEG-style full range; 1.402*255/224 == the 1.596 of the
// standard limited-range matrix, so the composition is the same math as
// libwebp's own conversion up to rounding).
//
// Lossless WebP is RGB-coded — requesting YUV would only move an RGB->YUV
// conversion inside libwebp at full resolution — and animations need the
// demux API; both return 2 and the caller uses the RGB decoder +
// vt_rgb_to_yuv420.  Chroma crop windows are recomputed on the half-size
// planes (<=1 chroma-pixel alignment difference vs the Y window — below
// the tolerance chroma subsampling already implies).  Returns 0 ok,
// 2 = not served, <0 error.
int vt_webp_decode_resize_yuv420(const uint8_t* data, size_t len,
                                 uint8_t* y_dst, uint8_t* cb_dst,
                                 uint8_t* cr_dst, int dst_h, int dst_w,
                                 int crop_mode, int crop_x, int crop_y,
                                 int filter) {
  if (!data || len < 12 || !y_dst || !cb_dst || !cr_dst || dst_h <= 0 ||
      dst_w <= 0 || (dst_h % 2) != 0 || (dst_w % 2) != 0) {
    return -1;
  }
  WebPBitstreamFeatures feat;
  if (WebPGetFeatures(data, len, &feat) != VP8_STATUS_OK) return -2;
  // format: 0 undefined, 1 lossy (VP8: native YUV), 2 lossless (RGB-coded)
  if (feat.format != 1 || feat.has_animation) return 2;
  const int sw = feat.width, sh = feat.height;
  if (sw <= 0 || sh <= 0) return -3;
  const int cw = (sw + 1) / 2;
  const int ch = (sh + 1) / 2;
  std::vector<uint8_t> yb(static_cast<size_t>(sw) * sh);
  std::vector<uint8_t> ub(static_cast<size_t>(cw) * ch);
  std::vector<uint8_t> vb(static_cast<size_t>(cw) * ch);
  if (!WebPDecodeYUVInto(data, len, yb.data(), yb.size(), sw,
                         ub.data(), ub.size(), cw,
                         vb.data(), vb.size(), cw)) {
    return -3;
  }
  int rc = vt_resize_plane(yb.data(), sh, sw, 1, 0, y_dst, dst_h, dst_w,
                           crop_mode, crop_x, crop_y, filter);
  if (rc != 0) return rc;
  rc = vt_resize_plane(ub.data(), ch, cw, 1, 0, cb_dst, dst_h / 2, dst_w / 2,
                       crop_mode, crop_x / 2, crop_y / 2, filter);
  if (rc != 0) return rc;
  rc = vt_resize_plane(vb.data(), ch, cw, 1, 0, cr_dst, dst_h / 2, dst_w / 2,
                       crop_mode, crop_x / 2, crop_y / 2, filter);
  if (rc != 0) return rc;

  // limited -> full range, applied at TARGET size (a linear map commutes
  // with the linear resample up to uint8 rounding; target is the smaller)
  uint8_t ylut[256], clut[256];
  for (int i = 0; i < 256; ++i) {
    const double yf = (i - 16) * 255.0 / 219.0;
    const double cf = (i - 128) * 255.0 / 224.0 + 128.0;
    ylut[i] = static_cast<uint8_t>(
        yf < 0 ? 0 : yf > 255 ? 255 : static_cast<int>(yf + 0.5));
    clut[i] = static_cast<uint8_t>(
        cf < 0 ? 0 : cf > 255 ? 255 : static_cast<int>(cf + 0.5));
  }
  const size_t ny = static_cast<size_t>(dst_h) * dst_w;
  const size_t nc = static_cast<size_t>(dst_h / 2) * (dst_w / 2);
  for (size_t i = 0; i < ny; ++i) y_dst[i] = ylut[y_dst[i]];
  for (size_t i = 0; i < nc; ++i) cb_dst[i] = clut[cb_dst[i]];
  for (size_t i = 0; i < nc; ++i) cr_dst[i] = clut[cr_dst[i]];
  return 0;
}

#endif  // VT_HAVE_WEBP

}  // extern "C"
