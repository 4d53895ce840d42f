// Native host-side clustering / nearest-neighbor kernels.
//
// C++ replacement for the reference's faiss-cpu dependency
// (psvi/inference/utils.py:556-612: faiss.Kmeans + IndexFlatL2.search):
// k-means++ seeded Lloyd iterations and exact L2 nearest-neighbor search,
// OpenMP-parallel over rows. Exposed through a C ABI consumed via ctypes
// (psvi_torch/native/__init__.py). The port keeps its own copy of the JAX
// package's source; the functions and their outputs are the same.
//
// The on-device torch implementation (psvi_torch/ops/kmeans.py) is the
// default backend; this native path serves host-resident selection
// pipelines where the data never needs to touch the accelerator.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Squared L2 distance between two d-vectors.
static inline float sqdist(const float* a, const float* b, int64_t d) {
  float acc = 0.f;
  for (int64_t i = 0; i < d; ++i) {
    const float diff = a[i] - b[i];
    acc += diff * diff;
  }
  return acc;
}

// Assign each of n points to its nearest of k centroids.
// X: n x d row-major; C: k x d; labels out: n; returns total inertia.
double assign_labels(const float* X, int64_t n, int64_t d, const float* C,
                     int64_t k, int32_t* labels) {
  double inertia = 0.0;
#pragma omp parallel for reduction(+ : inertia) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float best = std::numeric_limits<float>::max();
    int32_t best_j = 0;
    const float* xi = X + i * d;
    for (int64_t j = 0; j < k; ++j) {
      const float dist = sqdist(xi, C + j * d, d);
      if (dist < best) {
        best = dist;
        best_j = static_cast<int32_t>(j);
      }
    }
    labels[i] = best_j;
    inertia += best;
  }
  return inertia;
}

// k-means++ initialization.
static void kmeanspp_init(const float* X, int64_t n, int64_t d, int64_t k,
                          uint64_t seed, float* C) {
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int64_t> first(0, n - 1);
  std::vector<double> dmin(n, std::numeric_limits<double>::max());

  const int64_t c0 = first(rng);
  std::memcpy(C, X + c0 * d, d * sizeof(float));

  for (int64_t j = 1; j < k; ++j) {
    const float* cprev = C + (j - 1) * d;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const double dist = sqdist(X + i * d, cprev, d);
      if (dist < dmin[i]) dmin[i] = dist;
    }
    double total = 0.0;
    for (int64_t i = 0; i < n; ++i) total += dmin[i];
    std::uniform_real_distribution<double> u(0.0, total);
    double r = u(rng), acc = 0.0;
    int64_t pick = n - 1;
    for (int64_t i = 0; i < n; ++i) {
      acc += dmin[i];
      if (acc >= r) {
        pick = i;
        break;
      }
    }
    std::memcpy(C + j * d, X + pick * d, d * sizeof(float));
  }
}

// Full k-means fit: k-means++ init + `iters` Lloyd iterations.
// Outputs centroids (k x d), labels (n), returns final inertia.
double kmeans_fit(const float* X, int64_t n, int64_t d, int64_t k,
                  int32_t iters, uint64_t seed, float* C, int32_t* labels) {
  kmeanspp_init(X, n, d, k, seed, C);
  std::vector<double> sums(static_cast<size_t>(k) * d);
  std::vector<int64_t> counts(k);
  double inertia = 0.0;
  for (int32_t it = 0; it < iters; ++it) {
    inertia = assign_labels(X, n, d, C, k, labels);
    std::fill(sums.begin(), sums.end(), 0.0);
    std::fill(counts.begin(), counts.end(), 0);
    for (int64_t i = 0; i < n; ++i) {
      const int32_t j = labels[i];
      ++counts[j];
      const float* xi = X + i * d;
      double* sj = sums.data() + static_cast<size_t>(j) * d;
      for (int64_t t = 0; t < d; ++t) sj[t] += xi[t];
    }
    for (int64_t j = 0; j < k; ++j) {
      if (counts[j] == 0) continue;  // keep empty-cluster centroid
      float* cj = C + j * d;
      const double* sj = sums.data() + static_cast<size_t>(j) * d;
      const double inv = 1.0 / static_cast<double>(counts[j]);
      for (int64_t t = 0; t < d; ++t)
        cj[t] = static_cast<float>(sj[t] * inv);
    }
  }
  inertia = assign_labels(X, n, d, C, k, labels);
  return inertia;
}

// Exact nearest-datapoint search: for each of k query centroids, the index
// of the closest row of X (faiss IndexFlatL2.search(centroids, 1) analog).
void nearest_index(const float* X, int64_t n, int64_t d, const float* C,
                   int64_t k, int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < k; ++j) {
    float best = std::numeric_limits<float>::max();
    int64_t best_i = 0;
    const float* cj = C + j * d;
    for (int64_t i = 0; i < n; ++i) {
      const float dist = sqdist(X + i * d, cj, d);
      if (dist < best) {
        best = dist;
        best_i = i;
      }
    }
    out[j] = best_i;
  }
}

// Pairwise squared-L2 distance matrix (n x m) between X (n x d), Y (m x d).
void pairwise_sq_dists(const float* X, int64_t n, const float* Y, int64_t m,
                       int64_t d, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float* xi = X + i * d;
    float* oi = out + i * m;
    for (int64_t j = 0; j < m; ++j) oi[j] = sqdist(xi, Y + j * d, d);
  }
}

}  // extern "C"
