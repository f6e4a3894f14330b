// Host geometry builder of the PyTorch port: pairwise squared distances and
// per-row quantile locality thresholds, multithreaded on the host CPU.
//
// The fixed-mesh setups (burgers, sod, darcy with its 421^2 zero-shot
// super-resolution grid, vorticity, cylinder) build their geometry here and
// upload it once (models/geometry.build_geometry_host). Rows are streamed
// across std::thread workers; each threshold is the exact linear
// interpolation quantile, found by O(n) nth_element selection as
// v1 + frac * (v2 - v1). This source is a copy of the JAX package's
// native/geometry.cpp, code unchanged, and is compiled with the same flags
// (data/native.py), so the kept sets d <= thr equal that package's to the
// bit: a threshold interpolated in another order can move a distance that
// lies within an ulp of it to the other side of the cut.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline float sq(float v) { return v * v; }

// metric: 0 = euclidean, 1 = periodic1d (first coord only),
//         2 = periodic2d (per-axis wrap). `period` is the torus length.
void dist_rows(const float* a, const float* b, float* out, int64_t row0,
               int64_t row1, int64_t lb, int dim, int metric, float period) {
  for (int64_t i = row0; i < row1; ++i) {
    const float* ai = a + i * dim;
    float* oi = out + i * lb;
    for (int64_t j = 0; j < lb; ++j) {
      const float* bj = b + j * dim;
      float acc = 0.f;
      if (metric == 0) {
        for (int k = 0; k < dim; ++k) acc += sq(ai[k] - bj[k]);
      } else if (metric == 1) {
        float d = std::fabs(ai[0] - bj[0]);
        d = std::min(d, period - d);
        acc = d * d;
      } else {
        for (int k = 0; k < dim; ++k) {
          float d = std::fabs(ai[k] - bj[k]);
          d = std::min(d, period - d);
          acc += d * d;
        }
      }
      oi[j] = acc;
    }
  }
}

void quantile_rows(const float* dist, float* thr, int64_t row0, int64_t row1,
                   int64_t cols, float q) {
  std::vector<float> scratch(cols);
  const double pos = static_cast<double>(q) * static_cast<double>(cols - 1);
  const int64_t k = static_cast<int64_t>(pos);
  const float frac = static_cast<float>(pos - static_cast<double>(k));
  for (int64_t i = row0; i < row1; ++i) {
    const float* row = dist + i * cols;
    std::copy(row, row + cols, scratch.begin());
    std::nth_element(scratch.begin(), scratch.begin() + k, scratch.end());
    float v1 = scratch[k];
    float out = v1;
    if (frac > 0.f && k + 1 < cols) {
      // elements after position k are all >= v1 after nth_element
      float v2 = *std::min_element(scratch.begin() + k + 1, scratch.end());
      out = v1 + frac * (v2 - v1);
    }
    thr[i] = out;
  }
}

template <typename F>
void parallel_rows(int64_t rows, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, rows));
  if (n_threads == 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  int64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t r0 = t * chunk;
    int64_t r1 = std::min(rows, r0 + chunk);
    if (r0 >= r1) break;
    workers.emplace_back([=, &fn] { fn(r0, r1); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

void pit_pairwise_sq_dist(const float* a, const float* b, float* out,
                          int64_t la, int64_t lb, int dim, int metric,
                          float period) {
  parallel_rows(la, [=](int64_t r0, int64_t r1) {
    dist_rows(a, b, out, r0, r1, lb, dim, metric, period);
  });
}

void pit_row_quantile(const float* dist, float* thr, int64_t rows,
                      int64_t cols, float q) {
  parallel_rows(rows, [=](int64_t r0, int64_t r1) {
    quantile_rows(dist, thr, r0, r1, cols, q);
  });
}

// fused: distances + thresholds in one pass over row blocks (the distance
// block stays hot in cache for the selection scan)
void pit_geometry(const float* a, const float* b, float* dist, float* thr,
                  int64_t la, int64_t lb, int dim, int metric, float period,
                  float q) {
  parallel_rows(la, [=](int64_t r0, int64_t r1) {
    dist_rows(a, b, dist, r0, r1, lb, dim, metric, period);
    if (q < 1.0f && q >= 0.0f)
      quantile_rows(dist, thr, r0, r1, lb, q);
  });
}

}  // extern "C"
