// qtpu_torch host runtime: fused image preprocessing + int8 quantization
// (the port's own copy of native/preprocess.cpp, without its batch pack:
// the port's pack_batch copies in numpy).
//
// The serving ingest path: normalize((px/255 - mean)/std) fused with
// quantization onto the stem's calibrated affine grid on the HOST, so the
// engine ships int8 codes instead of f32 pixels to the card (4x less
// host->device transfer) and runs no ingest work on the device.
//
// Build (qtpu_torch/data/native.py does it at first use, into the
// git-ignored qtpu_torch/build/):
//   g++ -O3 -march=x86-64-v2 -ffp-contract=off -shared -fPIC -o lib.so preprocess.cpp -lpthread
// ABI: plain C, consumed via ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline int8_t quantize_one(float v, float scale, float zp_u) {
  // Matches qtpu_torch.ops.qops.quantize_act EXACTLY: division (not
  // reciprocal multiply) and separate add, rounded to-even via
  // std::nearbyint — built with -ffp-contract=off so no FMA contraction
  // changes the last ulp.
  float t = v / scale;
  float q = std::nearbyint(t + zp_u);
  q = std::min(std::max(q, 0.0f), 255.0f);
  return static_cast<int8_t>(static_cast<int>(q) - 128);
}

struct Job {
  const uint8_t* src;
  int8_t* dst;
  float* dstf;
  int64_t hwc;
  int channels;
  const float* mean;
  const float* std_dev;
  float scale;
  float zp_u;
};

void run_batch(const Job& job, int64_t n_images, int threads,
               void (*per_image)(const Job&, int64_t)) {
  if (threads <= 1 || n_images <= 1) {
    for (int64_t i = 0; i < n_images; ++i) per_image(job, i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  int t = std::min<int64_t>(threads, n_images);
  for (int k = 0; k < t; ++k) {
    pool.emplace_back([&] {
      int64_t i;
      while ((i = next.fetch_add(1)) < n_images) per_image(job, i);
    });
  }
  for (auto& th : pool) th.join();
}

void image_to_int8(const Job& job, int64_t i) {
  const uint8_t* s = job.src + i * job.hwc;
  int8_t* d = job.dst + i * job.hwc;
  const int C = job.channels;
  for (int64_t p = 0; p < job.hwc; ++p) {
    const int c = static_cast<int>(p % C);
    const float x = (s[p] / 255.0f - job.mean[c]) / job.std_dev[c];
    d[p] = quantize_one(x, job.scale, job.zp_u);
  }
}

void image_to_f32(const Job& job, int64_t i) {
  const uint8_t* s = job.src + i * job.hwc;
  float* d = job.dstf + i * job.hwc;
  const int C = job.channels;
  for (int64_t p = 0; p < job.hwc; ++p) {
    const int c = static_cast<int>(p % C);
    d[p] = (s[p] / 255.0f - job.mean[c]) / job.std_dev[c];
  }
}

}  // namespace

extern "C" {

// uint8 NHWC images -> int8 codes on the stem's affine grid (signed storage).
// zp_signed is the signed-grid zero point (freeze convention); scale > 0.
void qtpu_preprocess_quantize(const uint8_t* src, int64_t n, int64_t h,
                              int64_t w, int64_t c, const float* mean,
                              const float* std_dev, float scale,
                              int32_t zp_signed, int8_t* dst, int threads) {
  Job job{src, dst, nullptr, h * w * c, static_cast<int>(c), mean,
          std_dev, scale, static_cast<float>(zp_signed + 128)};
  run_batch(job, n, threads, image_to_int8);
}

// uint8 NHWC images -> normalized f32 (no quantization), for fp32 paths.
void qtpu_preprocess_f32(const uint8_t* src, int64_t n, int64_t h, int64_t w,
                         int64_t c, const float* mean, const float* std_dev,
                         float* dst, int threads) {
  Job job{src, nullptr, dst, h * w * c, static_cast<int>(c), mean,
          std_dev, 1.0f, 0.0f};
  run_batch(job, n, threads, image_to_f32);
}

int qtpu_native_version() { return 3; }

}  // extern "C"
