// Native batch JPEG decode + Lanczos3 resize for the host data pipeline of
// the PyTorch port: the port's own copy of baseboostdepth_tpu/native/
// bbd_loader.cpp, the same code, so that both packages decode the same bytes.
//
// The reference feeds its DataLoader workers with PIL (pillow-simd) decode +
// LANCZOS resize (mono_dataset.py:16-19, 70-74). Here the whole per-batch
// image set is decoded and resized by a C++ thread pool in one call
// (ctypes releases the GIL):
//   - libjpeg decode, optionally with DCT-space prescale (fast mode picks
//     the smallest scale >= target, cutting IDCT work ~2-4x),
//   - separable Lanczos3 resampling with PIL-compatible antialias support
//     widening on downscale.
//
// Built by loader.py at first use: g++ -O3 -shared -fPIC bbd_loader.cpp -ljpeg

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// ---------------------------------------------------------------- lanczos
inline double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  if (x == 0.0) return 1.0;
  double px = M_PI * x;
  return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
}

struct FilterBank {
  int taps;                      // taps per output element
  std::vector<int> start;        // first input index per output element
  std::vector<float> weights;    // [out_size, taps]
};

FilterBank build_filter(int in_size, int out_size) {
  FilterBank fb;
  double scale = static_cast<double>(in_size) / out_size;
  double support = 3.0 * std::max(scale, 1.0);  // antialias widening
  fb.taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  fb.start.resize(out_size);
  fb.weights.assign(static_cast<size_t>(out_size) * fb.taps, 0.0f);
  double inv = 1.0 / std::max(scale, 1.0);
  for (int o = 0; o < out_size; ++o) {
    double center = (o + 0.5) * scale - 0.5;
    int lo = static_cast<int>(std::floor(center - support));
    fb.start[o] = lo;
    double sum = 0.0;
    std::vector<double> w(fb.taps, 0.0);
    for (int t = 0; t < fb.taps; ++t) {
      double x = (center - (lo + t)) * inv;
      w[t] = lanczos3(x);
      sum += w[t];
    }
    for (int t = 0; t < fb.taps; ++t)
      fb.weights[static_cast<size_t>(o) * fb.taps + t] =
          static_cast<float>(sum != 0.0 ? w[t] / sum : 0.0);
  }
  return fb;
}

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// resize [in_h, in_w, 3] u8 -> [out_h, out_w, 3] u8
void resize_lanczos(const unsigned char* in, int in_w, int in_h,
                    unsigned char* out, int out_w, int out_h) {
  FilterBank fx = build_filter(in_w, out_w);
  FilterBank fy = build_filter(in_h, out_h);

  // horizontal pass -> float intermediate [in_h, out_w, 3]
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const unsigned char* row = in + static_cast<size_t>(y) * in_w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int o = 0; o < out_w; ++o) {
      const float* w = &fx.weights[static_cast<size_t>(o) * fx.taps];
      int lo = fx.start[o];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int t = 0; t < fx.taps; ++t) {
        int xi = clampi(lo + t, 0, in_w - 1);
        float ww = w[t];
        const unsigned char* p = row + xi * 3;
        acc0 += ww * p[0];
        acc1 += ww * p[1];
        acc2 += ww * p[2];
      }
      trow[o * 3 + 0] = acc0;
      trow[o * 3 + 1] = acc1;
      trow[o * 3 + 2] = acc2;
    }
  }

  // vertical pass
  for (int o = 0; o < out_h; ++o) {
    const float* w = &fy.weights[static_cast<size_t>(o) * fy.taps];
    int lo = fy.start[o];
    unsigned char* orow = out + static_cast<size_t>(o) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      float acc = 0;
      for (int t = 0; t < fy.taps; ++t) {
        int yi = clampi(lo + t, 0, in_h - 1);
        acc += w[t] * tmp[static_cast<size_t>(yi) * out_w * 3 + x];
      }
      int v = static_cast<int>(std::lround(acc));
      orow[x] = static_cast<unsigned char>(clampi(v, 0, 255));
    }
  }
}

// ------------------------------------------------------------------ jpeg
bool decode_jpeg(const char* path, std::vector<unsigned char>* pixels,
                 int* w, int* h, int target_w, int target_h, bool fast) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (fast && target_w > 0) {
    // smallest DCT scale N/8 with scaled dims still >= target
    for (int n = 1; n <= 8; ++n) {
      long sw = (static_cast<long>(cinfo.image_width) * n + 7) / 8;
      long sh = (static_cast<long>(cinfo.image_height) * n + 7) / 8;
      if (sw >= target_w && sh >= target_h) {
        cinfo.scale_num = n;
        cinfo.scale_denom = 8;
        break;
      }
    }
    cinfo.dct_method = JDCT_IFAST;
  }

  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  pixels->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

}  // namespace

extern "C" {

// Decode+resize n images into out [n, out_h, out_w, 3] u8.
// status[i] = 1 on success, 0 on failure. Returns number of failures.
int bbd_decode_resize_batch(const char** paths, int n, unsigned char* out,
                            int out_w, int out_h, int n_threads, int fast,
                            unsigned char* status) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  size_t stride = static_cast<size_t>(out_w) * out_h * 3;

  auto worker = [&]() {
    std::vector<unsigned char> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      bool ok = decode_jpeg(paths[i], &pixels, &w, &h, out_w, out_h, fast != 0);
      if (!ok) {
        status[i] = 0;
        failures.fetch_add(1);
        std::memset(out + stride * i, 0, stride);
        continue;
      }
      if (w == out_w && h == out_h) {
        std::memcpy(out + stride * i, pixels.data(), stride);
      } else {
        resize_lanczos(pixels.data(), w, h, out + stride * i, out_w, out_h);
      }
      status[i] = 1;
    }
  };

  int threads = std::max(1, n_threads);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
