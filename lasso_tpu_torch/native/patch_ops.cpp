// Native data-pipeline kernels for lasso_tpu_torch.
//
// The host-side feeding path for dictionary learning: patch extraction and
// per-patch centering/normalization over large image batches. These run on
// CPU while the card executes solver steps, so they are multithreaded C++
// rather than Python. Built on demand by lasso_tpu_torch/native/__init__.py
// into a shared library and bound via ctypes (no pybind11 dependency).
//
// Layouts: images [n, h, w] row-major float32; patches [count, p*p].

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, seedable, statistically solid for position sampling.
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline uint32_t bounded(uint64_t& state, uint32_t bound) {
  return static_cast<uint32_t>(splitmix64(state) % bound);
}

void parallel_for(int64_t n, int threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  threads = std::min<int64_t>(threads, n);
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// All patches on a regular stride grid. Returns number written.
// out must hold n * n_y * n_x * p * p floats where
// n_y = (h - p) / stride + 1, n_x = (w - p) / stride + 1.
int64_t extract_patches_dense(const float* imgs, int64_t n, int64_t h,
                              int64_t w, int64_t p, int64_t stride,
                              float* out, int threads) {
  if (p > h || p > w || stride < 1) return -1;
  const int64_t n_y = (h - p) / stride + 1;
  const int64_t n_x = (w - p) / stride + 1;
  const int64_t per_img = n_y * n_x;
  const int64_t dim = p * p;

  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* img = imgs + i * h * w;
      float* dst = out + i * per_img * dim;
      for (int64_t yy = 0; yy < n_y; ++yy) {
        for (int64_t xx = 0; xx < n_x; ++xx) {
          const float* src = img + (yy * stride) * w + xx * stride;
          for (int64_t r = 0; r < p; ++r) {
            std::memcpy(dst + r * p, src + r * w, p * sizeof(float));
          }
          dst += dim;
        }
      }
    }
  });
  return n * per_img;
}

// per_image random patch positions per image (seeded, deterministic).
int64_t extract_patches_random(const float* imgs, int64_t n, int64_t h,
                               int64_t w, int64_t p, int64_t per_image,
                               uint64_t seed, float* out, int threads) {
  if (p > h || p > w || per_image < 1) return -1;
  const int64_t dim = p * p;
  const uint32_t ymax = static_cast<uint32_t>(h - p + 1);
  const uint32_t xmax = static_cast<uint32_t>(w - p + 1);

  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* img = imgs + i * h * w;
      float* dst = out + i * per_image * dim;
      uint64_t state = seed ^ (0x2545F4914F6CDD1DULL * (uint64_t)(i + 1));
      for (int64_t k = 0; k < per_image; ++k) {
        const int64_t y0 = bounded(state, ymax);
        const int64_t x0 = bounded(state, xmax);
        const float* src = img + y0 * w + x0;
        for (int64_t r = 0; r < p; ++r) {
          std::memcpy(dst + r * p, src + r * w, p * sizeof(float));
        }
        dst += dim;
      }
    }
  });
  return n * per_image;
}

// In-place per-row mean subtraction; optional unit-l2 normalization.
void center_patches(float* patches, int64_t count, int64_t dim,
                    int normalize, int threads) {
  parallel_for(count, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float* row = patches + i * dim;
      double mean = 0.0;
      for (int64_t j = 0; j < dim; ++j) mean += row[j];
      mean /= static_cast<double>(dim);
      for (int64_t j = 0; j < dim; ++j)
        row[j] -= static_cast<float>(mean);
      if (normalize) {
        double ss = 0.0;
        for (int64_t j = 0; j < dim; ++j) ss += (double)row[j] * row[j];
        const float inv = ss > 1e-12 ? 1.0f / std::sqrt((float)ss) : 0.0f;
        for (int64_t j = 0; j < dim; ++j) row[j] *= inv;
      }
    }
  });
}

}  // extern "C"
