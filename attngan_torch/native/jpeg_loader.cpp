// Native data loader: multithreaded JPEG decode + separable triangle-filter
// resize to a fixed square resolution, exposed to Python via ctypes.
//
// The reference's data layer decodes every image eagerly on the Python main
// thread through PIL (reference data/bedrooms.py:137-164) — the slowest part
// of dataset construction. This loader decodes a batch of files across a
// thread pool with libjpeg and resizes with the same triangle (bilinear)
// resampling family PIL uses (filter support scales with the reduction
// factor, so downscales average instead of point-sampling), writing straight
// into a caller-provided (N, res, res, 3) uint8 buffer that feeds the
// device-side pyramid (attngan_torch/data/dataset.py::preprocess_pyramid).
//
// Build: g++ -O3 -shared -fPIC -o libjpeg_loader.so jpeg_loader.cpp -ljpeg -lpthread
// (driven by attngan_torch/data/native_loader.py on first use).

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

struct Taps {
  int lo;
  int count;
  std::vector<float> w;  // normalized weights, length `count`
};

// Triangle-filter tap table for one axis (in_len -> out_len).
std::vector<Taps> make_taps(int in_len, int out_len) {
  std::vector<Taps> taps(out_len);
  const float scale = static_cast<float>(in_len) / out_len;
  const float support = scale > 1.0f ? scale : 1.0f;
  for (int o = 0; o < out_len; ++o) {
    const float center = (o + 0.5f) * scale;
    int lo = static_cast<int>(std::floor(center - support));
    int hi = static_cast<int>(std::ceil(center + support));
    if (lo < 0) lo = 0;
    if (hi > in_len) hi = in_len;
    Taps& t = taps[o];
    t.lo = lo;
    t.count = hi - lo;
    t.w.resize(t.count);
    float wsum = 0.0f;
    for (int k = 0; k < t.count; ++k) {
      const float x = ((lo + k) + 0.5f - center) / support;
      float w = 1.0f - std::fabs(x);
      if (w < 0.0f) w = 0.0f;
      t.w[k] = w;
      wsum += w;
    }
    if (wsum <= 0.0f) wsum = 1.0f;
    for (int k = 0; k < t.count; ++k) t.w[k] /= wsum;
  }
  return taps;
}

// (sh, sw, 3) u8 -> (dh, dw, 3) u8, separable triangle filter.
void resize_triangle(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  const std::vector<Taps> htaps = make_taps(sw, dw);
  const std::vector<Taps> vtaps = make_taps(sh, dh);

  // Horizontal pass: (sh, sw, 3) u8 -> (sh, dw, 3) f32
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int row = 0; row < sh; ++row) {
    const uint8_t* in_row = src + static_cast<size_t>(row) * sw * 3;
    float* out_row = tmp.data() + static_cast<size_t>(row) * dw * 3;
    for (int o = 0; o < dw; ++o) {
      const Taps& t = htaps[o];
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
      for (int k = 0; k < t.count; ++k) {
        const uint8_t* px = in_row + static_cast<size_t>(t.lo + k) * 3;
        acc0 += t.w[k] * px[0];
        acc1 += t.w[k] * px[1];
        acc2 += t.w[k] * px[2];
      }
      out_row[o * 3 + 0] = acc0;
      out_row[o * 3 + 1] = acc1;
      out_row[o * 3 + 2] = acc2;
    }
  }

  // Vertical pass: (sh, dw, 3) f32 -> (dh, dw, 3) u8
  for (int o = 0; o < dh; ++o) {
    const Taps& t = vtaps[o];
    uint8_t* out_row = dst + static_cast<size_t>(o) * dw * 3;
    for (int col = 0; col < dw * 3; ++col) {
      float acc = 0.0f;
      for (int k = 0; k < t.count; ++k) {
        acc += t.w[k] * tmp[static_cast<size_t>(t.lo + k) * dw * 3 + col];
      }
      if (acc < 0.0f) acc = 0.0f;
      if (acc > 255.0f) acc = 255.0f;
      out_row[col] = static_cast<uint8_t>(acc + 0.5f);
    }
  }
}

bool decode_one(const char* path, uint8_t* out, int res) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
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
  // libjpeg DCT scaling: cheap pre-shrink toward the target before the
  // filter pass (scale down to >= target; DCT-domain scaling is high quality and the
  // triangle pass cleans up the remainder).
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  while (cinfo.scale_denom < 8 &&
         (cinfo.image_width / (cinfo.scale_denom * 2) >= (unsigned)res) &&
         (cinfo.image_height / (cinfo.scale_denom * 2) >= (unsigned)res)) {
    cinfo.scale_denom *= 2;
  }
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {  // grayscale/CMYK: bail to PIL path
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  const int sw = cinfo.output_width;
  const int sh = cinfo.output_height;
  std::vector<uint8_t> raw(static_cast<size_t>(sw) * sh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = raw.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  resize_triangle(raw.data(), sw, sh, out, res, res);
  return true;
}

}  // namespace

extern "C" {

// Decode+resize one file into out[res*res*3]. Returns 1 on success.
int ag_decode_one(const char* path, uint8_t* out, int res) {
  return decode_one(path, out, res) ? 1 : 0;
}

// Decode+resize a batch across a thread pool. paths: array of C strings;
// out: (n, res, res, 3) uint8; ok: per-file success flags. Returns the
// number of successfully decoded files.
int ag_decode_batch(const char** paths, int n, uint8_t* out, int res,
                    uint8_t* ok, int num_threads) {
  if (num_threads <= 0) num_threads = std::thread::hardware_concurrency();
  if (num_threads <= 0) num_threads = 4;
  std::atomic<int> next(0);
  std::atomic<int> good(0);
  const size_t stride = static_cast<size_t>(res) * res * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      const bool success = decode_one(paths[i], out + stride * i, res);
      ok[i] = success ? 1 : 0;
      if (success) good.fetch_add(1);
      else std::memset(out + stride * i, 0, stride);
    }
  };

  std::vector<std::thread> threads;
  const int tcount = num_threads < n ? num_threads : n;
  threads.reserve(tcount);
  for (int t = 0; t < tcount; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return good.load();
}

}  // extern "C"
