// Native host data plane of the port's input pipeline: the port's copy of
// clip_finegrained_alignment_tpu/native/cfa_host.cc.
//
// One C call per batch: a std::thread pool decodes (libjpeg/libpng), pads
// to square or center-crops, and resizes every sample (PIL-compatible
// antialiased bicubic, or box) straight into the caller's [N, S, S, 3]
// uint8 buffer: no Python objects, no GIL (ctypes releases it around the
// call), no worker processes.
//
// Also exposes the synthetic generator's compositing primitive (alpha-over
// paste, an integer blend: byte-equal to the numpy path for 0/255 masks,
// within 1 for other alphas).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 cfa_host.cc -o libcfa_host.so
//        -ljpeg -lpng -lpthread      (see native/__init__.py)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG file into an RGB buffer. Returns 0 on success; fills
// *width/*height. Caller frees *out with cfa_free.
static int decode_jpeg(FILE* f, uint8_t** out, int* width, int* height) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  uint8_t* buf = static_cast<uint8_t*>(malloc(size_t(w) * h * 3));
  if (!buf) { jpeg_destroy_decompress(&cinfo); return 2; }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf; *width = w; *height = h;
  return 0;
}

static int decode_png(FILE* f, uint8_t** out, int* width, int* height) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return 1; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);                 // palette/gray/1-8bit -> 8bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  uint8_t* buf = static_cast<uint8_t*>(malloc(size_t(w) * h * 3));
  if (!buf) { png_destroy_read_struct(&png, &info, nullptr); return 2; }
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = buf + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *out = buf; *width = w; *height = h;
  return 0;
}

// Decode JPEG or PNG by magic bytes. Returns 0 on success.
int cfa_decode_image(const char* path, uint8_t** out, int* width,
                     int* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return 3;
  uint8_t magic[8] = {0};
  if (fread(magic, 1, 8, f) != 8) { fclose(f); return 4; }
  rewind(f);
  int rc;
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = decode_jpeg(f, out, width, height);
  } else if (magic[0] == 0x89 && magic[1] == 'P') {
    rc = decode_png(f, out, width, height);
  } else {
    rc = 5;  // unsupported format
  }
  fclose(f);
  return rc;
}

void cfa_free(uint8_t* p) { free(p); }

// ---------------------------------------------------------------------------
// Geometry
// ---------------------------------------------------------------------------

// Box-filter (area-average) resize, RGB u8. Equivalent quality to
// PIL.Image.BOX on downscale; for the training feed (synthetic square
// PNGs -> model resolution) this is the right filter at 2x+ downscale.
void cfa_resize_box_u8(const uint8_t* src, int sh, int sw,
                       uint8_t* dst, int dh, int dw) {
  for (int y = 0; y < dh; ++y) {
    const float fy0 = (float)y * sh / dh, fy1 = (float)(y + 1) * sh / dh;
    const int y0 = (int)fy0, y1 = std::min((int)(fy1 + 0.9999f), sh);
    for (int x = 0; x < dw; ++x) {
      const float fx0 = (float)x * sw / dw, fx1 = (float)(x + 1) * sw / dw;
      const int x0 = (int)fx0, x1 = std::min((int)(fx1 + 0.9999f), sw);
      int acc[3] = {0, 0, 0};
      int n = 0;
      for (int yy = y0; yy < y1; ++yy) {
        const uint8_t* row = src + (size_t(yy) * sw + x0) * 3;
        for (int xx = x0; xx < x1; ++xx, row += 3) {
          acc[0] += row[0]; acc[1] += row[1]; acc[2] += row[2];
          ++n;
        }
      }
      uint8_t* o = dst + (size_t(y) * dw + x) * 3;
      if (n > 0) {
        o[0] = uint8_t(acc[0] / n);
        o[1] = uint8_t(acc[1] / n);
        o[2] = uint8_t(acc[2] / n);
      }
    }
  }
}

// PIL-compatible antialiased bicubic (Catmull-Rom, a = -0.5) resize.
// Mirrors PIL's ImagingResample structure: per-axis kernel support scaled
// by the downscale factor (antialiasing), separable two-pass with the
// horizontal pass first and a rounded uint8 intermediate — so the output
// matches PIL.Image.BICUBIC to within coefficient-quantization noise
// (PIL quantizes weights to int16; we keep float64 — measured max |Δ| ≤ 1
// LSB on photographic inputs, pinned by tests/test_native.py).
static double bicubic_kernel(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precompute normalized filter weights for one axis (PIL's
// precompute_coeffs): returns per-output-pixel (xmin, count) bounds and a
// [out_size, ksize] weight table.
static void bicubic_coeffs(int in_size, int out_size,
                           std::vector<int>& bounds,
                           std::vector<double>& weights, int* ksize_out) {
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;  // bicubic support = 2
  const int ksize = int(std::ceil(support)) * 2 + 1;
  bounds.resize(size_t(out_size) * 2);
  weights.assign(size_t(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &weights[size_t(xx) * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = bicubic_kernel((x + xmin - center + 0.5)
                                      / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    }
    bounds[size_t(xx) * 2] = xmin;
    bounds[size_t(xx) * 2 + 1] = xmax;
  }
  *ksize_out = ksize;
}

static inline uint8_t clip_round_u8(double v) {
  const double r = v + 0.5;
  if (r <= 0.0) return 0;
  if (r >= 255.0) return 255;
  return uint8_t(r);
}

void cfa_resize_bicubic_u8(const uint8_t* src, int sh, int sw,
                           uint8_t* dst, int dh, int dw) {
  // Horizontal pass: [sh, sw] -> [sh, dw] (uint8 intermediate, like PIL).
  std::vector<int> hb;
  std::vector<double> hw;
  int hks;
  bicubic_coeffs(sw, dw, hb, hw, &hks);
  std::vector<uint8_t> tmp(size_t(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + size_t(y) * sw * 3;
    uint8_t* trow = tmp.data() + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int xmin = hb[size_t(x) * 2], xmax = hb[size_t(x) * 2 + 1];
      const double* k = &hw[size_t(x) * hks];
      double acc[3] = {0.0, 0.0, 0.0};
      const uint8_t* p = srow + size_t(xmin) * 3;
      for (int i = 0; i < xmax; ++i, p += 3) {
        acc[0] += k[i] * p[0];
        acc[1] += k[i] * p[1];
        acc[2] += k[i] * p[2];
      }
      uint8_t* o = trow + size_t(x) * 3;
      o[0] = clip_round_u8(acc[0]);
      o[1] = clip_round_u8(acc[1]);
      o[2] = clip_round_u8(acc[2]);
    }
  }
  // Vertical pass: [sh, dw] -> [dh, dw].
  std::vector<int> vb;
  std::vector<double> vw;
  int vks;
  bicubic_coeffs(sh, dh, vb, vw, &vks);
  for (int y = 0; y < dh; ++y) {
    const int ymin = vb[size_t(y) * 2], ymax = vb[size_t(y) * 2 + 1];
    const double* k = &vw[size_t(y) * vks];
    uint8_t* drow = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      double acc[3] = {0.0, 0.0, 0.0};
      for (int i = 0; i < ymax; ++i) {
        const uint8_t* p = tmp.data() + (size_t(ymin + i) * dw + x) * 3;
        acc[0] += k[i] * p[0];
        acc[1] += k[i] * p[1];
        acc[2] += k[i] * p[2];
      }
      uint8_t* o = drow + size_t(x) * 3;
      o[0] = clip_round_u8(acc[0]);
      o[1] = clip_round_u8(acc[1]);
      o[2] = clip_round_u8(acc[2]);
    }
  }
}

// Pad to square with a constant fill (the counterfactual loader's white
// pad, count_dataloader.py:12-24). dst must hold side*side*3 where
// side = max(h, w).
void cfa_pad_square_u8(const uint8_t* src, int h, int w, uint8_t* dst,
                       uint8_t fill) {
  const int side = std::max(h, w);
  memset(dst, fill, size_t(side) * side * 3);
  const int top = (side - h) / 2, left = (side - w) / 2;
  for (int y = 0; y < h; ++y) {
    memcpy(dst + (size_t(y + top) * side + left) * 3,
           src + size_t(y) * w * 3, size_t(w) * 3);
  }
}

// Alpha-over paste of an RGBA-ish object (separate alpha plane, 255 =
// opaque) into an RGB canvas at (x, y), clipping at borders — the
// synthetic-generator compositing op (gen_synthetic_data.py:249-267).
void cfa_alpha_paste(uint8_t* dst, int dh, int dw,
                     const uint8_t* obj_rgb, const uint8_t* obj_alpha,
                     int oh, int ow, int x, int y) {
  const int x0 = std::max(0, x), y0 = std::max(0, y);
  const int x1 = std::min(dw, x + ow), y1 = std::min(dh, y + oh);
  for (int yy = y0; yy < y1; ++yy) {
    const int oy = yy - y;
    uint8_t* drow = dst + (size_t(yy) * dw + x0) * 3;
    const uint8_t* srow = obj_rgb + (size_t(oy) * ow + (x0 - x)) * 3;
    const uint8_t* arow = obj_alpha
        ? obj_alpha + size_t(oy) * ow + (x0 - x) : nullptr;
    for (int xx = x0; xx < x1; ++xx, drow += 3, srow += 3) {
      if (!arow) {
        drow[0] = srow[0]; drow[1] = srow[1]; drow[2] = srow[2];
      } else {
        const int a = *arow++;
        drow[0] = uint8_t((a * srow[0] + (255 - a) * drow[0]) / 255);
        drow[1] = uint8_t((a * srow[1] + (255 - a) * drow[1]) / 255);
        drow[2] = uint8_t((a * srow[2] + (255 - a) * drow[2]) / 255);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Batch assembler (the data-loader hot path)
// ---------------------------------------------------------------------------

// Python-compatible round-half-to-even (the PIL-path geometry in
// data/preprocess.py::resize_center_crop uses python round()).
static int py_round(double x) {
  const double f = std::floor(x);
  const double diff = x - f;
  if (diff > 0.5) return int(f) + 1;
  if (diff < 0.5) return int(f);
  const int fi = int(f);
  return (fi % 2 == 0) ? fi : fi + 1;
}

// Geometry modes for the batch assembler.
//   0: direct resize to [size, size] (aspect squash; legacy)
//   1: pad to square (white) first, then resize — the counterfactual
//      loader's transform (count_dataloader.py:12-24)
//   2: resize shorter side to `size`, then center crop — the HF-processor
//      geometry (synthetic_dataloader.py:69-76); same crop window as
//      data/preprocess.py::resize_center_crop
// Filters:
//   0: box (area average) — fastest, legacy default
//   1: PIL-compatible antialiased bicubic — matches the PIL/HF reference
//      path to ≤1 LSB, the parity-safe default
// `failed`: optional [n] uint8 out-mask, 1 = decode failure (that row of
// `out` is zero-filled). Returns the failure count.
int cfa_assemble_batch_v3(const char** paths, int n, int size, int mode,
                          int filter, uint8_t* out, uint8_t* failed,
                          int num_threads) {
  std::atomic<int> next(0), failures(0);
  const size_t stride = size_t(size) * size * 3;
  if (failed) memset(failed, 0, size_t(n));
  auto resize = (filter == 1) ? cfa_resize_bicubic_u8 : cfa_resize_box_u8;
  auto worker = [&]() {
    std::vector<uint8_t> scratch;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* decoded = nullptr;
      int w = 0, h = 0;
      if (cfa_decode_image(paths[i], &decoded, &w, &h) != 0) {
        memset(out + size_t(i) * stride, 0, stride);
        if (failed) failed[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      uint8_t* src = decoded;
      int sh = h, sw = w;
      if (mode == 1 && h != w) {
        const int side = std::max(h, w);
        scratch.resize(size_t(side) * side * 3);
        cfa_pad_square_u8(decoded, h, w, scratch.data(), 255);
        src = scratch.data();
        sh = sw = side;
      }
      uint8_t* dst = out + size_t(i) * stride;
      if (sh == size && sw == size) {
        memcpy(dst, src, stride);
      } else if (mode == 2 && sh != sw) {
        // Shorter-side resize + center crop.
        const double scale = double(size) / std::min(sh, sw);
        const int nh = std::max(size, py_round(sh * scale));
        const int nw = std::max(size, py_round(sw * scale));
        std::vector<uint8_t> resized(size_t(nh) * nw * 3);
        resize(src, sh, sw, resized.data(), nh, nw);
        const int top = (nh - size) / 2, left = (nw - size) / 2;
        for (int y = 0; y < size; ++y) {
          memcpy(dst + size_t(y) * size * 3,
                 resized.data() + (size_t(y + top) * nw + left) * 3,
                 size_t(size) * 3);
        }
      } else {
        resize(src, sh, sw, dst, size, size);
      }
      free(decoded);
    }
  };
  const int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
