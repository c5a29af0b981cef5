// Native host-side image pipeline: JPEG/PNG decode -> bilinear resize ->
// center-crop -> float32 NHWC normalize, with a pthread batch loader.
//
// The eval input recipe (Resize -> CenterCrop -> ToArray -> Normalize,
// data/transforms.test_transform) runs entirely in this library, so the
// Python loader thread only copies the finished batch. The same source, bit
// for bit in what it computes, as the JAX package's decoder, so both
// packages' loaders give the same batches.
//
// C ABI only (consumed via ctypes).
//
// Build: g++ -O3 -shared -fPIC image_pipeline.cpp -ljpeg -lpng -lpthread
//        (driven by peekvit_torch/native/__init__.py, into build/peekvit_torch/)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <csetjmp>
#include <pthread.h>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  uint8_t* data = nullptr;  // HWC, RGB
  int h = 0, w = 0;
};

// ------------------------------------------------------------- JPEG decode

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG, optionally at a DCT-domain reduced scale:
// when min_w/min_h > 0, pick the SMALLEST M/8 scale (libjpeg-turbo
// supports scale_num 1..8 with denom 8; e.g. 500x375 -> 5/8 = 313x235 for
// a 224 target) whose output still covers (min_w, min_h) — libjpeg then
// runs the reduced-size IDCT directly (its cost scales with the output
// pixel count), skipping most of the full-resolution decode AND shrinking
// the bilinear-resize input ~(8/M)^2-fold. The subsequent triangle-filter
// resize still runs (scaled dims >= the resize target, so it remains a
// proper antialiased downscale); parity with the PIL full-decode path is
// pinned in tests/test_torch_native.py (DCT-domain scaling discards the same
// high frequencies the resize filter would — natural images agree
// tightly; pure-noise fixtures are the worst case and carry a looser
// bound there).
bool decode_jpeg(const uint8_t* bytes, size_t len, Image* out,
                 int min_w = 0, int min_h = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(out->data);
    out->data = nullptr;
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(bytes), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (min_w > 0 && min_h > 0) {
    for (int num = 1; num < 8; ++num) {
      // jpeg output dims round UP: ceil(dim * num / 8)
      const long sw = ((long)cinfo.image_width * num + 7) / 8;
      const long sh = ((long)cinfo.image_height * num + 7) / 8;
      if (sw >= min_w && sh >= min_h) {
        cinfo.scale_num = num;
        cinfo.scale_denom = 8;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data = static_cast<uint8_t*>(malloc((size_t)out->w * out->h * 3));
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data + (size_t)cinfo.output_scanline * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// -------------------------------------------------------------- PNG decode

struct PngReadState {
  const uint8_t* bytes;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep dst, png_size_t n) {
  PngReadState* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "png: read past end");
  }
  memcpy(dst, st->bytes + st->pos, n);
  st->pos += n;
}

bool decode_png(const uint8_t* bytes, size_t len, Image* out) {
  if (len < 8 || png_sig_cmp(bytes, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(out->data);
    out->data = nullptr;
    return false;
  }
  PngReadState st{bytes, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  // normalize everything to 8-bit RGB
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->data = static_cast<uint8_t*>(malloc((size_t)out->w * out->h * 3));
  for (int y = 0; y < out->h; ++y) {
    png_read_row(png, out->data + (size_t)y * out->w * 3, nullptr);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_image(const uint8_t* bytes, size_t len, Image* out,
                  int min_w = 0, int min_h = 0) {
  if (len >= 2 && bytes[0] == 0xFF && bytes[1] == 0xD8) {
    return decode_jpeg(bytes, len, out, min_w, min_h);
  }
  return decode_png(bytes, len, out);  // png has no DCT-domain scaling
}

// ------------------------------------------- resize + crop + normalize

// PIL-compatible BILINEAR resampling: a separable triangle filter whose
// support scales with the downscale factor (antialiasing), exactly PIL's
// ImagingResample convention — plain 2-tap bilinear diverges badly on
// downscale and would break eval-accuracy parity with the PIL path.
struct FilterTaps {
  int* starts;   // per-dst first source index
  float* weights;  // per-dst normalized weights, ksize each
  int ksize;
};

FilterTaps build_triangle_taps(int src_size, int dst_size) {
  const double scale = (double)src_size / dst_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support
  const int ksize = (int)ceil(support) * 2 + 1;
  FilterTaps taps;
  taps.ksize = ksize;
  taps.starts = static_cast<int*>(malloc(sizeof(int) * dst_size));
  taps.weights = static_cast<float*>(malloc(sizeof(float) * dst_size * ksize));
  for (int i = 0; i < dst_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > src_size) xmax = src_size;
    taps.starts[i] = xmin;
    double total = 0.0;
    float* w = taps.weights + (size_t)i * ksize;
    for (int j = 0; j < xmax - xmin; ++j) {
      double x = (j + xmin - center + 0.5) / filterscale;
      double t = x < 0 ? -x : x;
      double val = t < 1.0 ? 1.0 - t : 0.0;
      w[j] = (float)val;
      total += val;
    }
    for (int j = 0; j < xmax - xmin; ++j) w[j] = (float)(w[j] / total);
    for (int j = xmax - xmin; j < ksize; ++j) w[j] = 0.0f;
  }
  return taps;
}

void resize_bilinear(const Image& src, int out_h, int out_w, float* dst) {
  FilterTaps hx = build_triangle_taps(src.w, out_w);
  FilterTaps vy = build_triangle_taps(src.h, out_h);
  // horizontal pass: (src.h, out_w)
  float* tmp = static_cast<float*>(
      malloc((size_t)src.h * out_w * 3 * sizeof(float)));
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* srow = src.data + (size_t)y * src.w * 3;
    float* drow = tmp + (size_t)y * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const float* w = hx.weights + (size_t)x * hx.ksize;
      const int x0 = hx.starts[x];
      float acc[3] = {0, 0, 0};
      for (int j = 0; j < hx.ksize; ++j) {
        const float wj = w[j];
        if (wj == 0.0f) continue;
        const uint8_t* p = srow + (size_t)(x0 + j) * 3;
        acc[0] += wj * p[0];
        acc[1] += wj * p[1];
        acc[2] += wj * p[2];
      }
      drow[x * 3 + 0] = acc[0];
      drow[x * 3 + 1] = acc[1];
      drow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass: (out_h, out_w)
  for (int y = 0; y < out_h; ++y) {
    const float* w = vy.weights + (size_t)y * vy.ksize;
    const int y0 = vy.starts[y];
    float* drow = dst + (size_t)y * out_w * 3;
    memset(drow, 0, sizeof(float) * out_w * 3);
    for (int j = 0; j < vy.ksize; ++j) {
      const float wj = w[j];
      if (wj == 0.0f) continue;
      const float* srow = tmp + (size_t)(y0 + j) * out_w * 3;
      for (int x = 0; x < out_w * 3; ++x) drow[x] += wj * srow[x];
    }
  }
  free(tmp);
  free(hx.starts);
  free(hx.weights);
  free(vy.starts);
  free(vy.weights);
}

// full eval transform into `out` (size*size*3 float32):
// resize to (resize, resize) -> center crop (size) -> /255 -> (x-mean)/std
bool process_one(const uint8_t* bytes, size_t len, int resize, int size,
                 const float* mean, const float* std, float* out) {
  // crop offset below is (resize - size) / 2: reject configs where the
  // crop would read outside the resized image instead of going OOB.
  if (size <= 0 || resize < size) return false;
  Image img;
  // scaled decode: the resized output is (resize, resize), so both axes
  // only need `resize` pixels of source resolution
  if (!decode_image(bytes, len, &img, resize, resize) || !img.data) {
    return false;
  }
  float* resized = static_cast<float*>(malloc((size_t)resize * resize * 3 * sizeof(float)));
  if (!resized) {
    free(img.data);
    return false;
  }
  resize_bilinear(img, resize, resize, resized);
  free(img.data);
  const int top = (resize - size) / 2;
  const int left = (resize - size) / 2;
  for (int y = 0; y < size; ++y) {
    const float* srow = resized + (((size_t)(y + top)) * resize + left) * 3;
    float* drow = out + (size_t)y * size * 3;
    for (int x = 0; x < size; ++x) {
      for (int c = 0; c < 3; ++c) {
        float v = srow[x * 3 + c] * (1.0f / 255.0f);
        drow[x * 3 + c] = (v - mean[c]) / std[c];
      }
    }
  }
  free(resized);
  return true;
}

bool process_file(const char* path, int resize, int size, const float* mean,
                  const float* std, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  if (len <= 0) {
    fclose(f);
    return false;
  }
  fseek(f, 0, SEEK_SET);
  uint8_t* buf = static_cast<uint8_t*>(malloc(len));
  if (!buf) {
    fclose(f);
    return false;
  }
  size_t got = fread(buf, 1, len, f);
  fclose(f);
  bool ok = (got == (size_t)len) &&
            process_one(buf, len, resize, size, mean, std, out);
  free(buf);
  return ok;
}

// ------------------------------------------------------- batch thread pool

struct BatchJob {
  const char** paths;
  int n;
  int resize;
  int size;
  const float* mean;
  const float* std;
  float* out;       // n * size * size * 3
  int* ok;          // n flags
  int next;         // work index
  pthread_mutex_t mu;
};

void* batch_worker(void* arg) {
  BatchJob* job = static_cast<BatchJob*>(arg);
  for (;;) {
    pthread_mutex_lock(&job->mu);
    int i = job->next++;
    pthread_mutex_unlock(&job->mu);
    if (i >= job->n) break;
    float* dst = job->out + (size_t)i * job->size * job->size * 3;
    job->ok[i] = process_file(job->paths[i], job->resize, job->size,
                              job->mean, job->std, dst)
                     ? 1
                     : 0;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Decode+transform one in-memory image. Returns 1 on success.
int pv_decode_transform(const uint8_t* bytes, long len, int resize, int size,
                        const float* mean, const float* std, float* out) {
  return process_one(bytes, (size_t)len, resize, size, mean, std, out) ? 1 : 0;
}

// Decode+transform a batch of files with `num_threads` workers.
// out: (n, size, size, 3) float32. ok: per-file success flags.
// Returns the number of successfully decoded images.
int pv_load_batch(const char** paths, int n, int resize, int size,
                  const float* mean, const float* std, float* out, int* ok,
                  int num_threads) {
  BatchJob job{paths, n, resize, size, mean, std, out, ok, 0,
               PTHREAD_MUTEX_INITIALIZER};
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  pthread_t threads[64];
  if (num_threads > 64) num_threads = 64;
  for (int t = 0; t < num_threads; ++t) {
    pthread_create(&threads[t], nullptr, batch_worker, &job);
  }
  int total = 0;
  for (int t = 0; t < num_threads; ++t) pthread_join(threads[t], nullptr);
  for (int i = 0; i < n; ++i) total += ok[i];
  return total;
}

// Raw decode to uint8 HWC RGB (caller frees with pv_free). Returns pointer,
// writes dims; nullptr on failure.
uint8_t* pv_decode(const uint8_t* bytes, long len, int* h, int* w) {
  Image img;
  if (!decode_image(bytes, (size_t)len, &img) || !img.data) return nullptr;
  *h = img.h;
  *w = img.w;
  return img.data;
}

void pv_free(void* p) { free(p); }

}  // extern "C"
