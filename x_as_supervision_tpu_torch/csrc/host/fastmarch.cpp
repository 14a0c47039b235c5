// Fast Marching Method for the geodesic weight maps of the input pipeline:
// the port's own copy of native/fastmarch.cpp (its fmm_distance, unchanged),
// built with the host compiler at first use by ops/_build.py:load_host and
// bound with ctypes by data/geodesic.py.
//
// Solves the Eikonal equation |grad T| = 1 on a 2-D grid with unit speed
// using the standard first-order upwind discretization and a binary heap,
// the scheme of scikit-fmm, which the reference's geodesic module uses
// (reference: human_utils/common/utility/geodesic.py:2,32,36).
//
// API (C ABI):
//   fmm_distance(h, w, seeds_mask, valid_mask, out)
//     seeds_mask: uint8[h*w], 1 where T = 0 (the zero level set)
//     valid_mask: uint8[h*w], 1 where the front may propagate (masked
//                 cells are never visited and keep out = 0)
//     out:        float64[h*w] distances (0 at seeds, 0 at invalid cells)
//   returns 0 on success, nonzero on bad input.

#include <cmath>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

namespace {

constexpr double kInf = 1e30;

struct HeapEntry {
  double t;
  int idx;
  bool operator>(const HeapEntry& o) const { return t > o.t; }
};

// Solve the quadratic upwind update from the smaller of each axis'
// neighbor values: (T - a)^2 + (T - b)^2 = 1 (or the 1-D fallback).
inline double solve_eikonal(double a, double b) {
  double lo = a < b ? a : b;
  double hi = a < b ? b : a;
  if (hi >= kInf || hi - lo >= 1.0) return lo + 1.0;
  double sum = a + b;
  double diff2 = (a - b) * (a - b);
  double disc = 2.0 - diff2;
  return 0.5 * (sum + std::sqrt(disc));
}

}  // namespace

extern "C" {

int fmm_distance(int h, int w, const uint8_t* seeds, const uint8_t* valid,
                 double* out) {
  if (h <= 0 || w <= 0 || !seeds || !valid || !out) return 1;
  const int n = h * w;
  std::vector<double> t(n, kInf);
  std::vector<uint8_t> frozen(n, 0);
  std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                      std::greater<HeapEntry>>
      heap;

  for (int i = 0; i < n; ++i) {
    if (seeds[i] && valid[i]) {
      t[i] = 0.0;
      heap.push({0.0, i});
    }
  }

  auto axis_min = [&](int y, int x, int dy, int dx) -> double {
    double best = kInf;
    int y1 = y + dy, x1 = x + dx;
    if (y1 >= 0 && y1 < h && x1 >= 0 && x1 < w) {
      int j = y1 * w + x1;
      if (frozen[j]) best = t[j];
    }
    int y2 = y - dy, x2 = x - dx;
    if (y2 >= 0 && y2 < h && x2 >= 0 && x2 < w) {
      int j = y2 * w + x2;
      if (frozen[j] && t[j] < best) best = t[j];
    }
    return best;
  };

  while (!heap.empty()) {
    HeapEntry e = heap.top();
    heap.pop();
    if (frozen[e.idx] || e.t > t[e.idx]) continue;
    frozen[e.idx] = 1;
    int y = e.idx / w, x = e.idx % w;

    static const int dy[4] = {-1, 1, 0, 0};
    static const int dx[4] = {0, 0, -1, 1};
    for (int k = 0; k < 4; ++k) {
      int ny = y + dy[k], nx = x + dx[k];
      if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
      int j = ny * w + nx;
      if (frozen[j] || !valid[j]) continue;
      double ty = axis_min(ny, nx, 1, 0);
      double tx = axis_min(ny, nx, 0, 1);
      double cand = solve_eikonal(ty, tx);
      if (cand < t[j]) {
        t[j] = cand;
        heap.push({cand, j});
      }
    }
  }

  for (int i = 0; i < n; ++i) {
    out[i] = (t[i] >= kInf || !valid[i]) ? 0.0 : t[i];
  }
  return 0;
}

}  // extern "C"
