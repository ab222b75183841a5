// Native image codec of srgan_tpu_torch: threaded JPEG/PNG decode +
// antialiased bicubic resize to canonical HR clips, and PNG/JPEG encode,
// GIL-free. A copy of srgan_tpu/native/loader.cpp (the JAX package's), so
// that the port imports nothing of that package.
//
// Why native: the reference's data path is per-item Python PIL decode inside
// a DataLoader with num_workers=0 (``src/utils.py:34-47``,
// ``src/train.py:94-95``) — single-threaded host decode. At the card's
// training rates Python decode becomes the bottleneck, and serving spends
// most of its time in PIL's PNG encode; this codec decodes, resizes and
// encodes on a C++ thread pool (the GIL is released for the whole batch via
// ctypes), reading and writing the caller's numpy buffers directly.
//
// Resampling matches PIL semantics (``transformers.py:79-82``
// ``Resize(..., BICUBIC)``): separable Catmull-Rom (a = -0.5) with support
// scaled by the downscale ratio (antialias), per axis.
//
// Build: g++ -O3 -shared -fPIC, linking libjpeg + libpng, at first use into
// srgan_tpu_torch/_build/ (srgan_tpu_torch/native/__init__.py, which also
// binds it with ctypes).

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

namespace {

// ---------------------------------------------------------------- decode --

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC, 3 channels
  bool ok = false;
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

Image decode_jpeg(FILE* f) {
  Image img;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return img;  // corrupt file -> ok=false (loader-level skip, like
                 // the reference's IndexError path, utils.py:38-40)
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return img;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.w = cinfo.output_width;
  img.h = cinfo.output_height;
  img.rgb.resize(size_t(img.w) * img.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.rgb.data() + size_t(cinfo.output_scanline) * img.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  return img;
}

Image decode_png(FILE* f) {
  Image img;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize everything to 8-bit RGB. Alpha is stripped UNCONDITIONALLY:
  // png_set_palette_to_rgb implies PNG_EXPAND, which also expands a tRNS
  // chunk into a full alpha channel, so gating the strip on the ORIGINAL
  // color_type's alpha mask bit (as this code once did) let palette/gray+
  // tRNS files emit w*4-byte rows into the w*3 buffer — heap overflow.
  // Dropping the alpha (never compositing) matches PIL convert("RGB"),
  // the parity target.
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != size_t(w) * 3) {
    // belt-and-braces: any transform combination that does not land on
    // exactly RGB8 rows is rejected instead of overrunning the buffer
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }

  img.w = int(w);
  img.h = int(h);
  img.rgb.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = img.rgb.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  img.ok = true;
  return img;
}

Image decode_file(const char* path) {
  Image img;
  FILE* f = fopen(path, "rb");
  if (!f) return img;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    img = decode_jpeg(f);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    img = decode_png(f);
  }
  fclose(f);
  return img;
}

// ---------------------------------------------------------------- resize --

// Catmull-Rom cubic, a = -0.5 (PIL BICUBIC kernel).
inline double cubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Per-output-pixel contribution table for one axis (PIL-style antialias:
// kernel support scaled by the downscale ratio).
struct Contribs {
  std::vector<int> start;      // first source index per output pixel
  std::vector<int> count;      // number of taps
  std::vector<double> weight;  // taps, row-major [out, max_count]
  int max_count = 0;
};

Contribs build_contribs(int in_size, int out_size) {
  Contribs c;
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  c.max_count = int(std::ceil(support)) * 2 + 1;
  c.start.resize(out_size);
  c.count.resize(out_size);
  c.weight.assign(size_t(out_size) * c.max_count, 0.0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    int n = xmax - xmin;
    double* w = &c.weight[size_t(xx) * c.max_count];
    double total = 0.0;
    for (int i = 0; i < n; i++) {
      double wv = cubic((xmin + i - center + 0.5) / filterscale);
      w[i] = wv;
      total += wv;
    }
    if (total != 0.0)
      for (int i = 0; i < n; i++) w[i] /= total;
    c.start[xx] = xmin;
    c.count[xx] = n;
  }
  return c;
}

// uint8 HWC -> float32 HWC [0,1], separable bicubic to (out_h, out_w).
void resize_bicubic(const Image& img, int out_h, int out_w, float* out) {
  Contribs cx = build_contribs(img.w, out_w);
  Contribs cy = build_contribs(img.h, out_h);

  // PIL's 8-bit pipeline clamps AND rounds to uint8 after each separable
  // pass (cubic overshoot is clipped per-pass); emulate both for bit-level
  // parity with ``transformers.py:79-82``'s PIL resize + ToTensor.
  auto q8 = [](double v) -> double {
    double r = std::floor(v + 0.5);
    return r < 0.0 ? 0.0 : (r > 255.0 ? 255.0 : r);
  };

  // horizontal pass: (h, w, 3) u8 -> (h, out_w, 3) quantized float
  std::vector<float> tmp(size_t(img.h) * out_w * 3);
  for (int y = 0; y < img.h; y++) {
    const uint8_t* src = img.rgb.data() + size_t(y) * img.w * 3;
    float* dst = tmp.data() + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; x++) {
      const double* w = &cx.weight[size_t(x) * cx.max_count];
      int s0 = cx.start[x], n = cx.count[x];
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < n; i++) {
        const uint8_t* p = src + size_t(s0 + i) * 3;
        acc0 += w[i] * p[0];
        acc1 += w[i] * p[1];
        acc2 += w[i] * p[2];
      }
      dst[x * 3 + 0] = float(q8(acc0));
      dst[x * 3 + 1] = float(q8(acc1));
      dst[x * 3 + 2] = float(q8(acc2));
    }
  }
  // vertical pass: (h, out_w, 3) -> (out_h, out_w, 3) uint8 grid, /255
  for (int y = 0; y < out_h; y++) {
    const double* w = &cy.weight[size_t(y) * cy.max_count];
    int s0 = cy.start[y], n = cy.count[y];
    float* dst = out + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w * 3; x++) {
      double acc = 0;
      for (int i = 0; i < n; i++)
        acc += w[i] * tmp[size_t(s0 + i) * out_w * 3 + x];
      dst[x] = float(q8(acc) * (1.0 / 255.0));
    }
  }
}

// ---------------------------------------------------------------- encode --

// The serving counterpart of the threaded decoder: ``upscale-dir`` writes
// hundreds of SR frames/s off the TPU, and single-threaded PIL PNG encode
// becomes the host bottleneck the way PIL decode was on the input side.

bool encode_png_file(const char* path, int h, int w, const uint8_t* rgb) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                              nullptr);
  if (!png) {
    fclose(f);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(f);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  // Serving profile: compression 1 trades ~15% file size for ~5x encode
  // speed vs libpng's default 6 (SR outputs are high-entropy; zlib level
  // barely matters for them).
  png_set_compression_level(png, 1);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  for (int y = 0; y < h; y++)
    png_write_row(png, const_cast<png_bytep>(rgb + size_t(y) * w * 3));
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return true;
}

bool encode_jpeg_file(const char* path, int h, int w, const uint8_t* rgb,
                      int quality) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + size_t(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return true;
}

bool has_suffix(const char* path, const char* suf) {
  size_t lp = std::strlen(path), ls = std::strlen(suf);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; i++) {
    char a = path[lp - ls + i], b = suf[i];
    if (a >= 'A' && a <= 'Z') a += 'a' - 'A';
    if (a != b) return false;
  }
  return true;
}

}  // namespace

// ----------------------------------------------------------------- C API --

extern "C" {

// Decode one image and resize to (out_h, out_w); writes out_h*out_w*3
// float32 [0,1]. Returns 0 ok, -1 unreadable/corrupt.
int srgan_load_image(const char* path, int out_h, int out_w, float* out) {
  Image img = decode_file(path);
  if (!img.ok || img.w < 1 || img.h < 1) return -1;
  resize_bicubic(img, out_h, out_w, out);
  return 0;
}

// Decode a batch on `num_threads` C++ threads. `paths` is n C strings;
// out is (n, out_h, out_w, 3) float32. status[i]: 0 ok, -1 failed.
// Returns the number of successfully decoded images.
int srgan_load_batch(const char** paths, int n, int out_h, int out_w,
                     float* out, int* status, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0), ok_count(0);
  size_t stride = size_t(out_h) * out_w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = srgan_load_image(paths[i], out_h, out_w, out + stride * i);
      status[i] = rc;
      if (rc == 0) ok_count.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  int nt = num_threads < n ? num_threads : n;
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok_count.load();
}

// uint8 variants: same decode + PIL-parity resize, but the output stays on
// the uint8 grid (the resampler quantizes per pass anyway, so this is
// lossless vs the float path x255). Used to keep host->device transfers
// 4x smaller.
int srgan_load_image_u8(const char* path, int out_h, int out_w,
                        uint8_t* out) {
  Image img = decode_file(path);
  if (!img.ok || img.w < 1 || img.h < 1) return -1;
  size_t n = size_t(out_h) * out_w * 3;
  std::vector<float> tmp(n);
  resize_bicubic(img, out_h, out_w, tmp.data());
  for (size_t k = 0; k < n; k++)
    out[k] = uint8_t(tmp[k] * 255.0f + 0.5f);
  return 0;
}

int srgan_load_batch_u8(const char** paths, int n, int out_h, int out_w,
                        uint8_t* out, int* status, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0), ok_count(0);
  size_t stride = size_t(out_h) * out_w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = srgan_load_image_u8(paths[i], out_h, out_w, out + stride * i);
      status[i] = rc;
      if (rc == 0) ok_count.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  int nt = num_threads < n ? num_threads : n;
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok_count.load();
}

// Encode one HWC float32 [0,1] image to `path` (format by extension:
// .jpg/.jpeg -> JPEG quality 95, everything else PNG). The float->uint8
// conversion matches utils/image_io.array_to_image: clamp then
// floor(v*255 + 0.5). Returns 0 ok, -1 failed.
int srgan_save_image(const char* path, int h, int w, const float* img) {
  size_t n = size_t(h) * w * 3;
  std::vector<uint8_t> rgb(n);
  for (size_t k = 0; k < n; k++) {
    float v = img[k];
    v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    rgb[k] = uint8_t(v * 255.0f + 0.5f);
  }
  bool ok = (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
                ? encode_jpeg_file(path, h, w, rgb.data(), 95)
                : encode_png_file(path, h, w, rgb.data());
  return ok ? 0 : -1;
}

// Threaded batch encode: `imgs` is (n, h, w, 3) float32. status[i]: 0 ok.
// Returns the number successfully written.
int srgan_save_batch(const char** paths, int n, int h, int w,
                     const float* imgs, int* status, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0), ok_count(0);
  size_t stride = size_t(h) * w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = srgan_save_image(paths[i], h, w, imgs + stride * i);
      status[i] = rc;
      if (rc == 0) ok_count.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  int nt = num_threads < n ? num_threads : n;
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok_count.load();
}

// uint8 encode variants: the device already quantized (serving path
// fetches uint8 frames — 4x less host-link traffic); no conversion pass.
int srgan_save_image_u8(const char* path, int h, int w, const uint8_t* rgb) {
  bool ok = (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
                ? encode_jpeg_file(path, h, w, rgb, 95)
                : encode_png_file(path, h, w, rgb);
  return ok ? 0 : -1;
}

int srgan_save_batch_u8(const char** paths, int n, int h, int w,
                        const uint8_t* imgs, int* status, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0), ok_count(0);
  size_t stride = size_t(h) * w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = srgan_save_image_u8(paths[i], h, w, imgs + stride * i);
      status[i] = rc;
      if (rc == 0) ok_count.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  int nt = num_threads < n ? num_threads : n;
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok_count.load();
}

// Probe: returns the ABI version.
int srgan_loader_version() { return 4; }

}  // extern "C"
