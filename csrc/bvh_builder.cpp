// Native BVH builder.
//
// The host-side counterpart of mrt/geometry/bvh.py::build — identical
// semantics (float64 math, deterministic widest-axis median split OR
// binned SAH, stable sort, depth-first layout with escape indices) so
// the two builders produce bit-identical node arrays; the Python one
// remains as the fallback and as the executable specification.
//
// The reference builds its BVH with recursive Vec sorting in Rust
// (reference: src/geom.rs:109-162); at Menger scale (3.2M instances,
// scenes/menger.rs) the Python builder takes minutes while this one
// takes ~1s.
//
// split_mode 1 = binned SAH (bvh.py::_sah_partition semantics, double
// math in the same operation order; mrt/geometry tests assert
// bit-equality against the Python spec).  SAH trees cut node visits on
// irregular geometry such as lucy's statue field, with bit-identical
// means; the per-scene default rule lives in mrt/geometry/bvh.py.
//
// Build: g++ -O3 -shared -fPIC -o libmrt_native.so bvh_builder.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr int kSahBins = 16;
constexpr double kInf = std::numeric_limits<double>::infinity();

// Surface area of an AABB; 0 for empty/non-finite boxes (matches
// bvh.py::_area).
double sah_area(const double lo[3], const double hi[3]) {
  double d[3];
  bool ok = true;
  for (int k = 0; k < 3; ++k) {
    d[k] = hi[k] - lo[k];
    if (!std::isfinite(d[k]) || d[k] < 0.0) ok = false;
  }
  if (!ok) return 0.0;
  return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
}

struct Builder {
  const double* cent;   // (n,3) centroids
  const double* bmin;   // (n,3)
  const double* bmax;   // (n,3)
  int leaf_size;
  int split_mode;       // 0 = widest-axis median, 1 = binned SAH
  int64_t* order;       // (n) permutation, in/out
  // Output node arrays (capacity 2n), SoA:
  double* node_bmin;
  double* node_bmax;
  int32_t* node_first;
  int32_t* node_count;
  int32_t* node_escape;
  int32_t n_nodes = 0;

  std::vector<int64_t> scratch;

  // Best binned-SAH split of order[start:end); returns mid (the split
  // point after a stable two-sided partition) or -1 when degenerate
  // (bvh.py::_sah_partition).
  int64_t sah_partition(int64_t start, int64_t end) {
    double cmin[3] = {kInf, kInf, kInf};
    double cmax[3] = {-kInf, -kInf, -kInf};
    for (int64_t i = start; i < end; ++i) {
      const int64_t p = order[i];
      for (int k = 0; k < 3; ++k) {
        cmin[k] = std::min(cmin[k], cent[p * 3 + k]);
        cmax[k] = std::max(cmax[k], cent[p * 3 + k]);
      }
    }
    double best_cost = kInf;
    int best_axis = -1, best_k = -1;
    double best_scale = 0.0, best_cmin = 0.0;
    for (int axis = 0; axis < 3; ++axis) {
      const double ext = cmax[axis] - cmin[axis];
      if (ext <= 0.0) continue;
      const double scale = kSahBins * (1.0 - 1e-12) / ext;
      double cnt[kSahBins] = {0};
      double bin_min[kSahBins][3], bin_max[kSahBins][3];
      for (int b = 0; b < kSahBins; ++b)
        for (int k = 0; k < 3; ++k) {
          bin_min[b][k] = kInf;
          bin_max[b][k] = -kInf;
        }
      for (int64_t i = start; i < end; ++i) {
        const int64_t p = order[i];
        const int b = static_cast<int>(
            (cent[p * 3 + axis] - cmin[axis]) * scale);
        cnt[b] += 1.0;
        for (int k = 0; k < 3; ++k) {
          bin_min[b][k] = std::min(bin_min[b][k], bmin[p * 3 + k]);
          bin_max[b][k] = std::max(bin_max[b][k], bmax[p * 3 + k]);
        }
      }
      // Prefix (left) / suffix (right) accumulations over bins.
      double lmin[kSahBins][3], lmax[kSahBins][3];
      double rmin[kSahBins][3], rmax[kSahBins][3];
      double lcnt[kSahBins];
      double total = 0.0;
      for (int b = 0; b < kSahBins; ++b) {
        for (int k = 0; k < 3; ++k) {
          lmin[b][k] = b ? std::min(lmin[b - 1][k], bin_min[b][k])
                         : bin_min[b][k];
          lmax[b][k] = b ? std::max(lmax[b - 1][k], bin_max[b][k])
                         : bin_max[b][k];
        }
        lcnt[b] = (b ? lcnt[b - 1] : 0.0) + cnt[b];
        total += cnt[b];
      }
      for (int b = kSahBins - 1; b >= 0; --b) {
        for (int k = 0; k < 3; ++k) {
          rmin[b][k] = b < kSahBins - 1
                           ? std::min(rmin[b + 1][k], bin_min[b][k])
                           : bin_min[b][k];
          rmax[b][k] = b < kSahBins - 1
                           ? std::max(rmax[b + 1][k], bin_max[b][k])
                           : bin_max[b][k];
        }
      }
      // Split k: left bins [0,k], right bins [k+1, BINS); first
      // minimum wins (np.argmin), earlier axis wins cost ties.
      int arg = -1;
      double arg_cost = kInf;
      for (int k = 0; k < kSahBins - 1; ++k) {
        const double lc = lcnt[k];
        const double rc = total - lcnt[k];
        if (!(lc > 0.0 && rc > 0.0)) continue;
        const double la = sah_area(lmin[k], lmax[k]);
        const double ra = sah_area(rmin[k + 1], rmax[k + 1]);
        const double cost = (lc > 0.0 ? lc * la : 0.0)
                            + (rc > 0.0 ? rc * ra : 0.0);
        if (cost < arg_cost) {
          arg_cost = cost;
          arg = k;
        }
      }
      if (arg >= 0 && arg_cost < best_cost) {
        best_cost = arg_cost;
        best_axis = axis;
        best_k = arg;
        best_scale = scale;
        best_cmin = cmin[axis];
      }
    }
    if (best_axis < 0) return -1;
    // Stable two-sided partition by bin <= k (concatenate keeps the
    // original relative order on both sides).
    scratch.clear();
    int64_t mid = start;
    for (int64_t i = start; i < end; ++i) {
      const int64_t p = order[i];
      const int b = static_cast<int>(
          (cent[p * 3 + best_axis] - best_cmin) * best_scale);
      if (b <= best_k)
        order[mid++] = p;
      else
        scratch.push_back(p);
    }
    std::copy(scratch.begin(), scratch.end(), order + mid);
    return mid;
  }

  int32_t build_range(int64_t start, int64_t end) {
    const int32_t idx = n_nodes++;
    double bb_min[3] = {1e300, 1e300, 1e300};
    double bb_max[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = start; i < end; ++i) {
      const int64_t p = order[i];
      for (int k = 0; k < 3; ++k) {
        bb_min[k] = std::min(bb_min[k], bmin[p * 3 + k]);
        bb_max[k] = std::max(bb_max[k], bmax[p * 3 + k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      node_bmin[idx * 3 + k] = bb_min[k];
      node_bmax[idx * 3 + k] = bb_max[k];
    }
    const int64_t n = end - start;
    if (n <= leaf_size) {
      node_first[idx] = static_cast<int32_t>(start);
      node_count[idx] = static_cast<int32_t>(n);
      node_escape[idx] = idx + 1;
      return idx;
    }
    int64_t mid = -1;
    if (split_mode == 1) mid = sah_partition(start, end);
    if (mid < 0) {  // median (also the SAH-degenerate fallback)
      // Widest axis; ties resolve to the lowest index like np.argmax.
      int axis = 0;
      double widest = bb_max[0] - bb_min[0];
      for (int k = 1; k < 3; ++k) {
        const double w = bb_max[k] - bb_min[k];
        if (w > widest) {
          widest = w;
          axis = k;
        }
      }
      // Stable sort on the centroid component == argsort(kind=stable).
      scratch.assign(order + start, order + end);
      std::stable_sort(scratch.begin(), scratch.end(),
                       [&](int64_t a, int64_t b) {
                         return cent[a * 3 + axis] < cent[b * 3 + axis];
                       });
      std::copy(scratch.begin(), scratch.end(), order + start);
      mid = start + n / 2;
    }

    node_first[idx] = 0;
    node_count[idx] = 0;
    build_range(start, mid);
    build_range(mid, end);
    node_escape[idx] = n_nodes;  // index after my subtree
    return idx;
  }
};

}  // namespace

extern "C" {

// Returns the node count (<= 2n); arrays must have capacity 2n.
// split_mode: 0 = widest-axis median, 1 = binned SAH.
int32_t mrt_bvh_build(const double* cent, const double* bmin,
                      const double* bmax, int64_t n, int32_t leaf_size,
                      int32_t split_mode,
                      double* node_bmin, double* node_bmax,
                      int32_t* node_first, int32_t* node_count,
                      int32_t* node_escape, int64_t* order) {
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  Builder b{cent, bmin, bmax, leaf_size, split_mode, order,
            node_bmin, node_bmax, node_first, node_count, node_escape};
  b.build_range(0, n);
  return b.n_nodes;
}

}  // extern "C"
