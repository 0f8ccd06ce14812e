// Multithreaded dense->CSR packing of sparse code matrices.
//
// Encoded lasso codes z [N, K] are 80-96% zeros at typical alpha; dense
// storage wastes memory and downstream-transfer bandwidth in serving
// pipelines. This packs them to CSR (values, col indices, row pointers)
// with a two-pass parallel algorithm: per-thread row-range nnz counts,
// exclusive scan on the main thread, then parallel fill into the exact
// offsets. The reference framework has no serving/IO layer at all; this
// is part of the host-side native runtime (see lasso_tpu_torch/native).
//
// Exported C ABI (ctypes):
//   csr_count_nnz(z, N, K, eps, row_nnz_out, threads) -> total nnz
//   csr_pack(z, N, K, eps, row_ptr_in, values_out, cols_out, threads)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

int clamp_threads(int threads, int64_t work_items) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int t = threads > 0 ? threads : static_cast<int>(hw);
  if (static_cast<int64_t>(t) > work_items) t = static_cast<int>(work_items);
  return t < 1 ? 1 : t;
}

template <typename F>
void parallel_rows(int64_t n, int threads, F fn) {
  int t = clamp_threads(threads, n);
  if (t == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  int64_t chunk = (n + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// First pass: per-row nnz counts (|z| > eps). Returns total nnz.
int64_t csr_count_nnz(const float* z, int64_t n, int64_t k, float eps,
                      int64_t* row_nnz, int threads) {
  parallel_rows(n, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const float* row = z + r * k;
      int64_t c = 0;
      for (int64_t j = 0; j < k; ++j) c += std::fabs(row[j]) > eps;
      row_nnz[r] = c;
    }
  });
  int64_t total = 0;
  for (int64_t r = 0; r < n; ++r) total += row_nnz[r];
  return total;
}

// Second pass: fill values/cols given exclusive row offsets row_ptr[n+1].
void csr_pack(const float* z, int64_t n, int64_t k, float eps,
              const int64_t* row_ptr, float* values, int32_t* cols,
              int threads) {
  parallel_rows(n, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const float* row = z + r * k;
      int64_t o = row_ptr[r];
      for (int64_t j = 0; j < k; ++j) {
        if (std::fabs(row[j]) > eps) {
          values[o] = row[j];
          cols[o] = static_cast<int32_t>(j);
          ++o;
        }
      }
    }
  });
}

// CSR -> dense reconstruction (round-trip / decode side).
void csr_unpack(const float* values, const int32_t* cols,
                const int64_t* row_ptr, int64_t n, int64_t k, float* out,
                int threads) {
  parallel_rows(n, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      float* row = out + r * k;
      for (int64_t j = 0; j < k; ++j) row[j] = 0.0f;
      for (int64_t o = row_ptr[r]; o < row_ptr[r + 1]; ++o)
        row[cols[o]] = values[o];
    }
  });
}

}  // extern "C"
