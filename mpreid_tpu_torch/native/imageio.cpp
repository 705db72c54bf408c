// Native batch image loader: JPEG/PNG decode + PIL-exact bicubic resize.
//
// ref mpreid_tpu/native/imageio.cpp, copied. The reference's data path is
// PIL decode + torchvision Resize(bicubic) (ref
// datasets/make_dataloader.py:46-61, datasets/bases.py:10-23); the port's
// Python path is PIL via a thread pool (data/loader.py::decode_resize).
// This is the native equivalent: one C call decodes and resizes a whole
// batch with OpenMP, writing directly into the caller's (N, H, W, 3) uint8
// buffer — no Python in the per-image loop.
//
// The resize reimplements PIL's 8-bit resampling exactly (Pillow
// src/libImaging/Resample.c): per-axis convolution with the bicubic
// (Catmull-Rom, a = -0.5) kernel, support scaled by the downsampling
// factor (i.e. antialiasing, like PIL and unlike OpenCV), fixed-point
// coefficients with PRECISION_BITS = 22 and per-pass uint8 rounding,
// horizontal pass then vertical. Byte-identical output to
// Image.resize(..., BICUBIC) lets the native and Python paths be swapped
// freely (enforced at runtime by a self-check in imageio.py).
//
// Built at first use by native/build.py:
// g++ -O3 -march=native -fopenmp -shared -fPIC imageio.cpp -ljpeg -lpng

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cstdint>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// PIL-exact resampling (Pillow Resample.c, 8bpc path)
// ---------------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;  // 22

inline unsigned char clip8(int in) {
  if (in >= (1 << (PRECISION_BITS + 8))) return 255;
  if (in <= 0) return 0;
  return (unsigned char)(in >> PRECISION_BITS);
}

double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

constexpr double BICUBIC_SUPPORT = 2.0;

// Precompute convolution bounds + fixed-point coefficients for one axis.
// Returns ksize. bounds: (outSize, 2) [xmin, count]; kk: (outSize, ksize).
int precompute_coeffs(int inSize, int outSize, int** boundsp, int** kkp) {
  double scale = (double)inSize / outSize;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = BICUBIC_SUPPORT * filterscale;
  int ksize = (int)ceil(support) * 2 + 1;

  double* kk = (double*)malloc(sizeof(double) * outSize * ksize);
  int* bounds = (int*)malloc(sizeof(int) * outSize * 2);
  for (int xx = 0; xx < outSize; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > inSize) xmax = inSize;
    xmax -= xmin;
    double* k = &kk[(size_t)xx * ksize];
    int x = 0;
    for (; x < xmax; x++) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    for (; x < ksize; x++) k[x] = 0;
    bounds[xx * 2 + 0] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  // normalize_coeffs_8bpc: double → fixed point
  int* ki = (int*)malloc(sizeof(int) * outSize * ksize);
  for (size_t i = 0; i < (size_t)outSize * ksize; i++) {
    if (kk[i] < 0)
      ki[i] = (int)(-0.5 + kk[i] * (1 << PRECISION_BITS));
    else
      ki[i] = (int)(0.5 + kk[i] * (1 << PRECISION_BITS));
  }
  free(kk);
  *boundsp = bounds;
  *kkp = ki;
  return ksize;
}

// Horizontal pass: (h, inW, 3) → (h, outW, 3)
void resample_horizontal(const unsigned char* in, int h, int inW,
                         unsigned char* out, int outW, const int* bounds,
                         const int* kk, int ksize) {
  for (int yy = 0; yy < h; yy++) {
    const unsigned char* row = in + (size_t)yy * inW * 3;
    unsigned char* orow = out + (size_t)yy * outW * 3;
    for (int xx = 0; xx < outW; xx++) {
      int xmin = bounds[xx * 2 + 0];
      int xmax = bounds[xx * 2 + 1];
      const int* k = &kk[(size_t)xx * ksize];
      int ss0 = 1 << (PRECISION_BITS - 1);
      int ss1 = ss0, ss2 = ss0;
      for (int x = 0; x < xmax; x++) {
        const unsigned char* p = row + (size_t)(x + xmin) * 3;
        ss0 += p[0] * k[x];
        ss1 += p[1] * k[x];
        ss2 += p[2] * k[x];
      }
      orow[xx * 3 + 0] = clip8(ss0);
      orow[xx * 3 + 1] = clip8(ss1);
      orow[xx * 3 + 2] = clip8(ss2);
    }
  }
}

// Vertical pass: (inH, w, 3) → (outH, w, 3)
void resample_vertical(const unsigned char* in, int inH, int w,
                       unsigned char* out, int outH, const int* bounds,
                       const int* kk, int ksize) {
  for (int yy = 0; yy < outH; yy++) {
    int ymin = bounds[yy * 2 + 0];
    int ymax = bounds[yy * 2 + 1];
    const int* k = &kk[(size_t)yy * ksize];
    unsigned char* orow = out + (size_t)yy * w * 3;
    for (int xx = 0; xx < w * 3; xx++) {
      int ss = 1 << (PRECISION_BITS - 1);
      for (int y = 0; y < ymax; y++)
        ss += in[(size_t)(y + ymin) * w * 3 + xx] * k[y];
      orow[xx] = clip8(ss);
    }
  }
}

// Full PIL-style resize (horizontal then vertical, per-pass rounding).
// Returns 0 on success.
int pil_resize(const unsigned char* in, int inH, int inW, unsigned char* out,
               int outH, int outW) {
  if (inH == outH && inW == outW) {
    memcpy(out, in, (size_t)inH * inW * 3);
    return 0;
  }
  int *bx = nullptr, *kx = nullptr, *by = nullptr, *ky = nullptr;
  const unsigned char* src = in;
  unsigned char* tmp = nullptr;
  if (inW != outW) {
    int ksize = precompute_coeffs(inW, outW, &bx, &kx);
    tmp = (unsigned char*)malloc((size_t)inH * outW * 3);
    resample_horizontal(src, inH, inW, tmp, outW, bx, kx, ksize);
    free(bx);
    free(kx);
    src = tmp;
  }
  if (inH != outH) {
    int ksize = precompute_coeffs(inH, outH, &by, &ky);
    resample_vertical(src, inH, outW, out, outH, by, ky, ksize);
    free(by);
    free(ky);
  } else {
    memcpy(out, src, (size_t)outH * outW * 3);
  }
  free(tmp);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, RGB8 output)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = (JpegErr*)cinfo->err;
  longjmp(err->jb, 1);
}

unsigned char* decode_jpeg(const unsigned char* buf, size_t len, int* h,
                           int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // volatile: modified between setjmp and longjmp — a plain local would be
  // indeterminate in the longjmp branch (UB; free of a stale pointer)
  unsigned char* volatile out = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale → RGB handled by libjpeg
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  out = (unsigned char*)malloc((size_t)*h * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + (size_t)cinfo.output_scanline * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng, RGB8 output)
// ---------------------------------------------------------------------------

struct PngReadState {
  const unsigned char* data;
  size_t len;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* st = (PngReadState*)png_get_io_ptr(png);
  if (st->pos + n > st->len) {
    png_error(png, "read past end");
    return;
  }
  memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

unsigned char* decode_png(const unsigned char* buf, size_t len, int* h,
                          int* w) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return nullptr;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return nullptr;
  }
  // volatile: modified between setjmp and longjmp (see decode_jpeg)
  unsigned char* volatile out = nullptr;
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(out);
    free(rows);
    return nullptr;
  }
  PngReadState st = {buf, len, 0};
  png_set_read_fn(png, &st, png_mem_read);
  png_read_info(png, info);
  // 16-bit GRAYSCALE diverges from PIL (mode 'I' → convert('RGB') clamps at
  // 255, while strip_16 keeps the high byte) — report failure so the caller
  // PIL-fallbacks and the byte-parity contract holds for every file
  if (png_get_bit_depth(png, info) == 16) {
    png_byte ct = png_get_color_type(png, info);
    if (ct == PNG_COLOR_TYPE_GRAY || ct == PNG_COLOR_TYPE_GRAY_ALPHA) {
      png_destroy_read_struct(&png, &info, nullptr);
      return nullptr;
    }
  }
  // → 8-bit RGB, alpha dropped (PIL convert('RGB') semantics)
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  if (png_get_channels(png, info) != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  out = (unsigned char*)malloc((size_t)*h * *w * 3);
  rows = (png_bytep*)malloc(sizeof(png_bytep) * *h);
  for (int y = 0; y < *h; y++) rows[y] = out + (size_t)y * *w * 3;
  png_read_image(png, rows);
  png_destroy_read_struct(&png, &info, nullptr);
  free(rows);
  return out;
}

unsigned char* decode_any(const unsigned char* buf, size_t len, int* h,
                          int* w) {
  if (len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8)
    return decode_jpeg(buf, len, h, w);
  if (len >= 8 && !png_sig_cmp(buf, 0, 8)) return decode_png(buf, len, h, w);
  return nullptr;
}

int load_one(const char* path, int outH, int outW, unsigned char* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    fclose(f);
    return 2;
  }
  unsigned char* buf = (unsigned char*)malloc(len);
  size_t rd = fread(buf, 1, len, f);
  fclose(f);
  if ((long)rd != len) {
    free(buf);
    return 2;
  }
  int h = 0, w = 0;
  unsigned char* img = decode_any(buf, len, &h, &w);
  free(buf);
  if (!img) return 3;
  int rc = pil_resize(img, h, w, out, outH, outW);
  free(img);
  return rc ? 4 : 0;
}

}  // namespace

extern "C" {

// Decode + resize a batch of image files into out (n, outH, outW, 3) uint8.
// status[i]: 0 ok; nonzero → caller should fall back (out row is zeroed).
// Returns the number of failures.
int decode_resize_batch(const char** paths, int n, int outH, int outW,
                        unsigned char* out, int* status) {
  int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
  for (int i = 0; i < n; i++) {
    unsigned char* dst = out + (size_t)i * outH * outW * 3;
    int rc = load_one(paths[i], outH, outW, dst);
    status[i] = rc;
    if (rc) {
      memset(dst, 0, (size_t)outH * outW * 3);
      failures += 1;
    }
  }
  return failures;
}

// Resize one in-memory RGB8 image (PIL-exact) — exposed for the parity
// self-check and tests.
int pil_resize_rgb8(const unsigned char* in, int inH, int inW,
                    unsigned char* out, int outH, int outW) {
  return pil_resize(in, inH, inW, out, outH, outW);
}

}  // extern "C"
