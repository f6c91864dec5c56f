// fusionhost: native host-side runtime for the JAX fusion framework.
//
// C++ equivalents of the reference's host/CPU components (the engine's
// GPU-side work lives in XLA/Pallas; this library covers what the
// reference ran in C++ on the host):
//  - depth-pair packing            (storage layout of m_bufDepthPairs,
//                                   reference gpu_depthmap_fusion.cpp:1583)
//  - LSD radix sort u32 + grouping (reference radix_sort.h / radix_grouper.h,
//                                   OpenMP parallel count/scatter)
//  - counting-sort grouping        (reference uint_grouper.h)
//  - 8-connected component labeling per layer (reference labelVoxels's
//                                   cv::connectedComponentsWithStats role)
//  - Moore contour tracing with Jacob's criterion (cv::findContours role)
//  - point-sequence staging append (reference addPointSequence copy loop)
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// depth pair packing (two u16 per u32, little end first)
// ---------------------------------------------------------------------------
void fh_pack_depth_pairs(const uint16_t* in, uint32_t* out, int64_t n_pairs) {
#pragma omp parallel for
  for (int64_t i = 0; i < n_pairs; ++i) {
    out[i] = (uint32_t)in[2 * i] | ((uint32_t)in[2 * i + 1] << 16);
  }
}

void fh_unpack_depth_pairs(const uint32_t* in, uint16_t* out,
                           int64_t n_pairs) {
#pragma omp parallel for
  for (int64_t i = 0; i < n_pairs; ++i) {
    out[2 * i] = (uint16_t)(in[i] & 0xFFFFu);
    out[2 * i + 1] = (uint16_t)(in[i] >> 16);
  }
}

// ---------------------------------------------------------------------------
// LSD radix sort (4 passes of 8 bits) carrying original indices.
// Parallel per-thread counting + redistribution, mirroring the structure of
// the reference's radixWithRedistribution (radix_sort.h:108-239).
// ---------------------------------------------------------------------------
void fh_radix_sort_u32(const uint32_t* keys, uint32_t* out_keys,
                       uint32_t* out_idx, int64_t n) {
  std::vector<uint32_t> k(keys, keys + n);
  std::vector<uint32_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = (uint32_t)i;
  std::vector<uint32_t> k2(n), idx2(n);

  int nt = 1;
#ifdef _OPENMP
  nt = omp_get_max_threads();
#endif
  std::vector<int64_t> counts((size_t)nt * 256);

  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    std::fill(counts.begin(), counts.end(), 0);
#pragma omp parallel num_threads(nt)
    {
      int t = 0;
#ifdef _OPENMP
      t = omp_get_thread_num();
#endif
      int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
      int64_t* c = &counts[(size_t)t * 256];
      for (int64_t i = lo; i < hi; ++i) c[(k[i] >> shift) & 0xFF]++;
    }
    // skip-pass optimization: all keys share this digit
    {
      bool single = false;
      for (int d = 0; d < 256; ++d) {
        int64_t tot = 0;
        for (int t = 0; t < nt; ++t) tot += counts[(size_t)t * 256 + d];
        if (tot == n) { single = true; break; }
        if (tot > 0 && tot < n) break;
      }
      if (single) continue;
    }
    // exclusive prefix over (digit, thread)
    std::vector<int64_t> offs((size_t)nt * 256);
    int64_t run = 0;
    for (int d = 0; d < 256; ++d) {
      for (int t = 0; t < nt; ++t) {
        offs[(size_t)t * 256 + d] = run;
        run += counts[(size_t)t * 256 + d];
      }
    }
#pragma omp parallel num_threads(nt)
    {
      int t = 0;
#ifdef _OPENMP
      t = omp_get_thread_num();
#endif
      int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
      int64_t* o = &offs[(size_t)t * 256];
      for (int64_t i = lo; i < hi; ++i) {
        int d = (k[i] >> shift) & 0xFF;
        int64_t dst = o[d]++;
        k2[dst] = k[i];
        idx2[dst] = idx[i];
      }
    }
    k.swap(k2);
    idx.swap(idx2);
  }
  std::memcpy(out_keys, k.data(), (size_t)n * 4);
  std::memcpy(out_idx, idx.data(), (size_t)n * 4);
}

// run-length group equal sorted keys (radix_grouper.h:35-64 role)
int64_t fh_group_sorted_u32(const uint32_t* sorted_keys, int64_t n,
                            int64_t* starts, int64_t* sizes,
                            uint32_t* values, int64_t cap) {
  int64_t g = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || sorted_keys[i] != sorted_keys[i - 1]) {
      ++g;
      if (g >= cap) return cap;
      starts[g] = i;
      sizes[g] = 0;
      values[g] = sorted_keys[i];
    }
    sizes[g]++;
  }
  return g + 1;
}

// ---------------------------------------------------------------------------
// 8-connected component labeling (two-pass union-find), cv semantics:
// background 0, labels numbered in raster order of first pixel; returns
// numLabels including background. stats: [label][5] = x, y, w, h, area;
// centroids: [label][2].
// ---------------------------------------------------------------------------
static uint32_t fh_find(std::vector<uint32_t>& parent, uint32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

int32_t fh_cc_label_u8(const uint8_t* img, uint16_t* labels, int32_t h,
                       int32_t w, int32_t* stats, double* centroids,
                       int32_t max_labels) {
  std::vector<uint32_t> raw((size_t)h * w, 0);
  std::vector<uint32_t> parent(1, 0);
  // first pass
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      if (!img[(size_t)y * w + x]) continue;
      uint32_t neigh[4];
      int nn = 0;
      if (y > 0) {
        if (x > 0 && raw[(size_t)(y - 1) * w + x - 1])
          neigh[nn++] = raw[(size_t)(y - 1) * w + x - 1];
        if (raw[(size_t)(y - 1) * w + x])
          neigh[nn++] = raw[(size_t)(y - 1) * w + x];
        if (x + 1 < w && raw[(size_t)(y - 1) * w + x + 1])
          neigh[nn++] = raw[(size_t)(y - 1) * w + x + 1];
      }
      if (x > 0 && raw[(size_t)y * w + x - 1])
        neigh[nn++] = raw[(size_t)y * w + x - 1];
      if (nn == 0) {
        uint32_t nl = (uint32_t)parent.size();
        parent.push_back(nl);
        raw[(size_t)y * w + x] = nl;
      } else {
        uint32_t m = neigh[0];
        for (int i = 1; i < nn; ++i) m = std::min(m, neigh[i]);
        raw[(size_t)y * w + x] = m;
        for (int i = 0; i < nn; ++i) {
          uint32_t ra = fh_find(parent, m);
          uint32_t rb = fh_find(parent, neigh[i]);
          if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
        }
      }
    }
  }
  // resolve roots -> dense labels in raster order of first pixel
  std::vector<uint16_t> dense(parent.size(), 0);
  std::vector<uint8_t> seen(parent.size(), 0);
  uint16_t next = 1;
  for (int64_t i = 0; i < (int64_t)h * w; ++i) {
    if (!raw[i]) {
      labels[i] = 0;
      continue;
    }
    uint32_t root = fh_find(parent, raw[i]);
    if (!seen[root]) {
      seen[root] = 1;
      dense[root] = (next < max_labels) ? next++ : (uint16_t)(max_labels - 1);
    }
    labels[i] = dense[root];
  }
  int32_t num = next;  // includes background
  if (stats && centroids) {
    for (int32_t l = 0; l < num; ++l) {
      stats[l * 5 + 0] = w;  // min x
      stats[l * 5 + 1] = h;  // min y
      stats[l * 5 + 2] = -1; // max x (temp)
      stats[l * 5 + 3] = -1; // max y (temp)
      stats[l * 5 + 4] = 0;  // area
      centroids[l * 2] = 0;
      centroids[l * 2 + 1] = 0;
    }
    for (int32_t y = 0; y < h; ++y)
      for (int32_t x = 0; x < w; ++x) {
        uint16_t l = labels[(size_t)y * w + x];
        stats[l * 5 + 0] = std::min(stats[l * 5 + 0], x);
        stats[l * 5 + 1] = std::min(stats[l * 5 + 1], y);
        stats[l * 5 + 2] = std::max(stats[l * 5 + 2], x);
        stats[l * 5 + 3] = std::max(stats[l * 5 + 3], y);
        stats[l * 5 + 4]++;
        centroids[l * 2] += x;
        centroids[l * 2 + 1] += y;
      }
    for (int32_t l = 0; l < num; ++l) {
      int32_t area = stats[l * 5 + 4];
      if (area > 0) {
        centroids[l * 2] /= area;
        centroids[l * 2 + 1] /= area;
      }
      stats[l * 5 + 2] -= stats[l * 5 + 0] - 1;  // -> width
      stats[l * 5 + 3] -= stats[l * 5 + 1] - 1;  // -> height
    }
  }
  return num;
}

// ---------------------------------------------------------------------------
// Moore contour tracing (Jacob's stopping criterion), mask != 0 foreground.
// Returns number of contour points written as interleaved (x, y).
// ---------------------------------------------------------------------------
static const int MOORE_DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
static const int MOORE_DY[8] = {0, 1, 1, 1, 0, -1, -1, -1};

int64_t fh_trace_contour(const uint8_t* mask, int32_t h, int32_t w,
                         int32_t sy, int32_t sx, int32_t* out_xy,
                         int64_t max_pts) {
  auto at = [&](int32_t y, int32_t x) {
    return y >= 0 && y < h && x >= 0 && x < w && mask[(size_t)y * w + x];
  };
  int64_t n = 0;
  if (max_pts < 1) return 0;
  out_xy[0] = sx;
  out_xy[1] = sy;
  n = 1;
  int32_t cy = sy, cx = sx;
  int backtrack = 4;  // entered from the West
  int first_move = -1;
  while (true) {
    int found = -1;
    for (int k = 1; k <= 8; ++k) {
      int d = (backtrack + k) & 7;
      if (at(cy + MOORE_DY[d], cx + MOORE_DX[d])) {
        found = d;
        break;
      }
    }
    if (found < 0) return n;  // isolated pixel
    if (cy == sy && cx == sx) {
      if (first_move < 0)
        first_move = found;
      else if (found == first_move && n > 1)
        return n - 1;  // drop the duplicate start re-entry
    }
    cy += MOORE_DY[found];
    cx += MOORE_DX[found];
    if (n >= max_pts) return n;
    out_xy[2 * n] = cx;
    out_xy[2 * n + 1] = cy;
    ++n;
    backtrack = (found + 4) & 7;
    if (n > 4 * (int64_t)h * w) return n;  // safety backstop
  }
}

// ---------------------------------------------------------------------------
// Segmented-object assembly (the reference's createCCObjects tail,
// gpu_depthmap_fusion.cpp:2364-2550, plus the cv::minAreaRect /
// cv::minEnclosingCircle / findContours work it leans on): one call per
// frame turns the device segmentation outputs (per-layer labels + the
// (layer, local-label) -> merged-label lookup) into grouped per-object
// point sets, convex hulls, min-area rects, min enclosing circles,
// topviews and per-component Moore contours. Mirrors the semantics of the
// Python path in mapping/objects.py (the parity oracle).
// ---------------------------------------------------------------------------

namespace {

struct PD {
  double x, y;
};

static inline double cross3(const PD& o, const PD& a, const PD& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain over lex-(x, y)-sorted unique points -> CCW hull
// (identical pop rule to mapping/geometry.py convex_hull: cross <= 0).
static void hull_chain(const std::vector<PD>& pts, std::vector<PD>& out) {
  out.clear();
  size_t n = pts.size();
  if (n <= 2) {
    out = pts;
    return;
  }
  std::vector<PD> lower, upper;
  lower.reserve(n);
  upper.reserve(n);
  for (size_t i = 0; i < n; ++i) {
    while (lower.size() >= 2 &&
           cross3(lower[lower.size() - 2], lower.back(), pts[i]) <= 0)
      lower.pop_back();
    lower.push_back(pts[i]);
  }
  for (size_t ii = n; ii-- > 0;) {
    while (upper.size() >= 2 &&
           cross3(upper[upper.size() - 2], upper.back(), pts[ii]) <= 0)
      upper.pop_back();
    upper.push_back(pts[ii]);
  }
  out.assign(lower.begin(), lower.end() - 1);
  out.insert(out.end(), upper.begin(), upper.end() - 1);
}

// Min-area bounding rect by rotating calipers over hull edges; matches
// mapping/geometry.py min_area_rect incl. the [0, 90) angle normalization
// with size swap. out5 = cx, cy, w, h, angle_deg.
static void fit_rect(const std::vector<PD>& hull, double* out5) {
  size_t n = hull.size();
  out5[0] = out5[1] = out5[2] = out5[3] = out5[4] = 0.0;
  if (n == 0) return;
  if (n == 1) {
    out5[0] = hull[0].x;
    out5[1] = hull[0].y;
    return;
  }
  if (n == 2) {
    double dx = hull[1].x - hull[0].x, dy = hull[1].y - hull[0].y;
    out5[0] = (hull[0].x + hull[1].x) / 2;
    out5[1] = (hull[0].y + hull[1].y) / 2;
    out5[2] = std::hypot(dx, dy);
    out5[3] = 0.0;
    out5[4] = std::atan2(dy, dx) * 180.0 / M_PI;
    return;
  }
  double best_area = 1e300;
  double bux = 1, buy = 0, bxm = 0, bxM = 0, bym = 0, byM = 0;
  for (size_t i = 0; i < n; ++i) {
    const PD& a = hull[i];
    const PD& b = hull[(i + 1) % n];
    double ex = b.x - a.x, ey = b.y - a.y;
    double norm = std::hypot(ex, ey);
    if (norm <= 1e-12) continue;
    double ux = ex / norm, uy = ey / norm;
    // projections onto edge dir (ux, uy) and its normal (-uy, ux)
    double xm = 1e300, xM = -1e300, ym = 1e300, yM = -1e300;
    for (size_t j = 0; j < n; ++j) {
      double px = hull[j].x * ux + hull[j].y * uy;
      double py = hull[j].x * -uy + hull[j].y * ux;
      xm = std::min(xm, px);
      xM = std::max(xM, px);
      ym = std::min(ym, py);
      yM = std::max(yM, py);
    }
    double area = (xM - xm) * (yM - ym);
    if (area < best_area) {
      best_area = area;
      bux = ux;
      buy = uy;
      bxm = xm;
      bxM = xM;
      bym = ym;
      byM = yM;
    }
  }
  double w = bxM - bxm, h = byM - bym;
  double cx = (bxM + bxm) / 2 * bux + (byM + bym) / 2 * -buy;
  double cy = (bxM + bxm) / 2 * buy + (byM + bym) / 2 * bux;
  double angle = std::atan2(buy, bux) * 180.0 / M_PI;
  angle = std::fmod(angle, 180.0);
  if (angle < 0) angle += 180.0;
  if (angle >= 90.0) {
    angle -= 90.0;
    std::swap(w, h);
  }
  out5[0] = cx;
  out5[1] = cy;
  out5[2] = w;
  out5[3] = h;
  out5[4] = angle;
}

// Welzl min enclosing circle (iterative move-to-front form on a
// deterministically LCG-shuffled copy). out3 = cx, cy, r.
static void circle_two(const PD& a, const PD& b, double* c) {
  c[0] = (a.x + b.x) / 2;
  c[1] = (a.y + b.y) / 2;
  c[2] = std::hypot(a.x - c[0], a.y - c[1]);
}

static void circle_three(const PD& a, const PD& b, const PD& cc, double* c) {
  double d = 2 * (a.x * (b.y - cc.y) + b.x * (cc.y - a.y) +
                  cc.x * (a.y - b.y));
  if (std::fabs(d) < 1e-12) {
    double dab = std::hypot(a.x - b.x, a.y - b.y);
    double dac = std::hypot(a.x - cc.x, a.y - cc.y);
    double dbc = std::hypot(b.x - cc.x, b.y - cc.y);
    if (dab >= dac && dab >= dbc)
      circle_two(a, b, c);
    else if (dac >= dbc)
      circle_two(a, cc, c);
    else
      circle_two(b, cc, c);
    return;
  }
  double a2 = a.x * a.x + a.y * a.y;
  double b2 = b.x * b.x + b.y * b.y;
  double c2 = cc.x * cc.x + cc.y * cc.y;
  c[0] = (a2 * (b.y - cc.y) + b2 * (cc.y - a.y) + c2 * (a.y - b.y)) / d;
  c[1] = (a2 * (cc.x - b.x) + b2 * (a.x - cc.x) + c2 * (b.x - a.x)) / d;
  c[2] = std::hypot(a.x - c[0], a.y - c[1]);
}

static inline bool in_circle(const double* c, const PD& q) {
  return std::hypot(q.x - c[0], q.y - c[1]) <= c[2] + 1e-7;
}

static void fit_circle(const std::vector<PD>& hull, double* out3) {
  out3[0] = out3[1] = out3[2] = 0.0;
  size_t n = hull.size();
  if (n == 0) return;
  if (n == 1) {
    out3[0] = hull[0].x;
    out3[1] = hull[0].y;
    return;
  }
  std::vector<PD> p(hull);
  uint64_t s = 0x9E3779B97F4A7C15ull;
  for (size_t i = n - 1; i > 0; --i) {
    s = s * 6364136223846793005ull + 1442695040888963407ull;
    size_t j = (size_t)(s % (i + 1));
    std::swap(p[i], p[j]);
  }
  circle_two(p[0], p[1], out3);
  for (size_t i = 2; i < n; ++i) {
    if (in_circle(out3, p[i])) continue;
    circle_two(p[0], p[i], out3);
    for (size_t j = 1; j < i; ++j) {
      if (in_circle(out3, p[j])) continue;
      circle_two(p[i], p[j], out3);
      for (size_t k = 0; k < j; ++k) {
        if (in_circle(out3, p[k])) continue;
        circle_three(p[i], p[j], p[k], out3);
      }
    }
  }
}

// voxel (x, y) -> world (x, y): p * cell_size + lower (lower-corner
// convention, reference voxelCoordToWorldCoord, cpp:1720-1730)
static void map_world(const std::vector<PD>& v, double sx, double sy,
                      double ox, double oy, std::vector<PD>& w) {
  w.resize(v.size());
  for (size_t i = 0; i < v.size(); ++i)
    w[i] = PD{v[i].x * sx + ox, v[i].y * sy + oy};
}

// 16 doubles: voxel (rect5, circle3) then world (rect5, circle3)
static void fit_shapes16(const std::vector<PD>& hull_v, double sx, double sy,
                         double ox, double oy, double* out16) {
  fit_rect(hull_v, out16);
  fit_circle(hull_v, out16 + 5);
  std::vector<PD> hull_w;
  map_world(hull_v, sx, sy, ox, oy, hull_w);
  fit_rect(hull_w, out16 + 8);
  fit_circle(hull_w, out16 + 13);
}

// Moore contour trace (Jacob's criterion) of {labels == l} on one layer.
static void trace_label_contour(const uint16_t* lab, int32_t h, int32_t w,
                                uint16_t l, int32_t sy, int32_t sx,
                                std::vector<int32_t>& out_xy) {
  auto at = [&](int32_t y, int32_t x) {
    return y >= 0 && y < h && x >= 0 && x < w && lab[(size_t)y * w + x] == l;
  };
  out_xy.clear();
  out_xy.push_back(sx);
  out_xy.push_back(sy);
  int32_t cy = sy, cx = sx;
  int backtrack = 4;
  int first_move = -1;
  int64_t steps = 0, limit = 4 * (int64_t)h * w;
  while (true) {
    int found = -1;
    for (int k = 1; k <= 8; ++k) {
      int d = (backtrack + k) & 7;
      if (at(cy + MOORE_DY[d], cx + MOORE_DX[d])) {
        found = d;
        break;
      }
    }
    if (found < 0) return;  // isolated pixel
    if (cy == sy && cx == sx) {
      if (first_move < 0) {
        first_move = found;
      } else if (found == first_move && out_xy.size() > 2) {
        out_xy.pop_back();  // drop the duplicate start re-entry
        out_xy.pop_back();
        return;
      }
    }
    cy += MOORE_DY[found];
    cx += MOORE_DX[found];
    out_xy.push_back(cx);
    out_xy.push_back(cy);
    backtrack = (found + 4) & 7;
    if (++steps > limit) return;  // safety backstop
  }
}

}  // namespace

// Pass 1: sizes for caller allocation. out_sizes[0] = fg pixel count
// (merged label in [1, M)), out_sizes[1] = number of components
// (distinct (layer, local-label > 0) with merged > 0).
void fh_assemble_count(const uint16_t* labels, int32_t Z, int32_t H,
                       int32_t W, const int32_t* lut, int32_t L, int32_t M,
                       int64_t* out_sizes) {
  int64_t hw = (int64_t)H * W;
  int64_t fg = 0, ncomp = 0;
#pragma omp parallel for reduction(+ : fg, ncomp)
  for (int32_t z = 0; z < Z; ++z) {
    const uint16_t* lz = labels + (size_t)z * hw;
    const int32_t* lutz = lut + (size_t)z * L;
    std::vector<uint8_t> seen(L, 0);
    for (int64_t i = 0; i < hw; ++i) {
      uint16_t l = lz[i];
      if (l >= L) continue;
      int32_t m = lutz[l];
      if (m <= 0 || m >= M) continue;
      ++fg;
      if (l > 0 && !seen[l]) {
        seen[l] = 1;
        ++ncomp;
      }
    }
  }
  out_sizes[0] = fg;
  out_sizes[1] = ncomp;
}

// Pass 2: full assembly. Caller allocates per fh_assemble_count sizes:
//   group_start   int64[M*Z + 1]   pts_xy      int32[2*fg]
//   hull_start    int64[M*Z + 1]   hull_xy     int32[2*fg]
//   layer_shapes  double[M*Z*16]
//   tv_start      int64[M + 1]     tv_xy       int32[2*fg]
//   tv_hull_start int64[M + 1]     tv_hull_xy  int32[2*fg]
//   tv_shapes     double[M*16]
//   comp_zlm      int32[3*ncomp]   contour_start int64[ncomp + 1]
//   contour_xy    int32[2*contour_cap]          comp_shapes double[16*ncomp]
// Returns ncomp, or -1 if contour_cap was insufficient.
int32_t fh_assemble_objects(
    const uint16_t* labels, int32_t Z, int32_t H, int32_t W,
    const int32_t* lut, int32_t L, int32_t M, double sx, double sy,
    double ox, double oy, int64_t* group_start, int32_t* pts_xy,
    int64_t* hull_start, int32_t* hull_xy, double* layer_shapes,
    int64_t* tv_start, int32_t* tv_xy, int64_t* tv_hull_start,
    int32_t* tv_hull_xy, double* tv_shapes, int32_t* comp_zlm,
    int64_t* contour_start, int32_t* contour_xy, int64_t contour_cap,
    double* comp_shapes) {
  const int64_t hw = (int64_t)H * W;
  const int64_t ng = (int64_t)M * Z;

  // --- count pixels per (m, z) group + first pixel per (z, local) ---
  std::vector<int64_t> cnt(ng, 0);
  std::vector<int64_t> first_pix((size_t)Z * L, -1);
#pragma omp parallel for
  for (int32_t z = 0; z < Z; ++z) {
    const uint16_t* lz = labels + (size_t)z * hw;
    const int32_t* lutz = lut + (size_t)z * L;
    for (int64_t i = 0; i < hw; ++i) {
      uint16_t l = lz[i];
      if (l >= L) continue;
      int32_t m = lutz[l];
      if (m <= 0 || m >= M) continue;
      cnt[(size_t)m * Z + z]++;
      if (l > 0 && first_pix[(size_t)z * L + l] < 0)
        first_pix[(size_t)z * L + l] = i;
    }
  }
  group_start[0] = 0;
  for (int64_t g = 0; g < ng; ++g) group_start[g + 1] = group_start[g] + cnt[g];

  // --- scatter grouped (x, y) in raster order per group ---
  std::vector<int64_t> cur(group_start, group_start + ng);
#pragma omp parallel for
  for (int32_t z = 0; z < Z; ++z) {
    const uint16_t* lz = labels + (size_t)z * hw;
    const int32_t* lutz = lut + (size_t)z * L;
    for (int64_t i = 0; i < hw; ++i) {
      uint16_t l = lz[i];
      if (l >= L) continue;
      int32_t m = lutz[l];
      if (m <= 0 || m >= M) continue;
      int64_t dst = cur[(size_t)m * Z + z]++;
      pts_xy[2 * dst] = (int32_t)(i % W);
      pts_xy[2 * dst + 1] = (int32_t)(i / W);
    }
  }

  // --- per-(m, z) hull + shapes ---
  std::vector<std::vector<PD>> hulls(ng);
#pragma omp parallel for schedule(dynamic)
  for (int64_t g = 0; g < ng; ++g) {
    std::fill(layer_shapes + 16 * g, layer_shapes + 16 * (g + 1), 0.0);
    if (!cnt[g]) continue;
    std::vector<PD> p((size_t)cnt[g]);
    for (int64_t i = 0; i < cnt[g]; ++i)
      p[i] = PD{(double)pts_xy[2 * (group_start[g] + i)],
                (double)pts_xy[2 * (group_start[g] + i) + 1]};
    std::sort(p.begin(), p.end(), [](const PD& a, const PD& b) {
      return a.x != b.x ? a.x < b.x : a.y < b.y;
    });
    hull_chain(p, hulls[g]);
    fit_shapes16(hulls[g], sx, sy, ox, oy, layer_shapes + 16 * g);
  }
  hull_start[0] = 0;
  for (int64_t g = 0; g < ng; ++g)
    hull_start[g + 1] = hull_start[g] + (int64_t)hulls[g].size();
  for (int64_t g = 0; g < ng; ++g)
    for (size_t i = 0; i < hulls[g].size(); ++i) {
      hull_xy[2 * (hull_start[g] + i)] = (int32_t)hulls[g][i].x;
      hull_xy[2 * (hull_start[g] + i) + 1] = (int32_t)hulls[g][i].y;
    }

  // --- topview per m: unique (x, y) over all layers, lex-sorted ---
  std::vector<std::vector<PD>> tv(M), tv_hull(M);
#pragma omp parallel for schedule(dynamic)
  for (int32_t m = 1; m < M; ++m) {
    std::fill(tv_shapes + 16 * m, tv_shapes + 16 * (m + 1), 0.0);
    std::vector<PD> all;
    for (int32_t z = 0; z < Z; ++z) {
      int64_t g = (int64_t)m * Z + z;
      for (int64_t i = group_start[g]; i < group_start[g + 1]; ++i)
        all.push_back(PD{(double)pts_xy[2 * i], (double)pts_xy[2 * i + 1]});
    }
    if (all.empty()) continue;
    std::sort(all.begin(), all.end(), [](const PD& a, const PD& b) {
      return a.x != b.x ? a.x < b.x : a.y < b.y;
    });
    all.erase(std::unique(all.begin(), all.end(),
                          [](const PD& a, const PD& b) {
                            return a.x == b.x && a.y == b.y;
                          }),
              all.end());
    tv[m] = std::move(all);
    hull_chain(tv[m], tv_hull[m]);
    fit_shapes16(tv_hull[m], sx, sy, ox, oy, tv_shapes + 16 * m);
  }
  std::fill(tv_shapes, tv_shapes + 16, 0.0);  // background stub
  tv_start[0] = tv_hull_start[0] = 0;
  for (int32_t m = 0; m < M; ++m) {
    tv_start[m + 1] = tv_start[m] + (int64_t)tv[m].size();
    tv_hull_start[m + 1] = tv_hull_start[m] + (int64_t)tv_hull[m].size();
  }
  for (int32_t m = 0; m < M; ++m) {
    for (size_t i = 0; i < tv[m].size(); ++i) {
      tv_xy[2 * (tv_start[m] + i)] = (int32_t)tv[m][i].x;
      tv_xy[2 * (tv_start[m] + i) + 1] = (int32_t)tv[m][i].y;
    }
    for (size_t i = 0; i < tv_hull[m].size(); ++i) {
      tv_hull_xy[2 * (tv_hull_start[m] + i)] = (int32_t)tv_hull[m][i].x;
      tv_hull_xy[2 * (tv_hull_start[m] + i) + 1] = (int32_t)tv_hull[m][i].y;
    }
  }

  // --- components: (z, local) ascending; Moore contour + shapes ---
  std::vector<int32_t> comp_z, comp_l, comp_m;
  for (int32_t z = 0; z < Z; ++z)
    for (int32_t l = 1; l < L; ++l) {
      int64_t fp = first_pix[(size_t)z * L + l];
      if (fp < 0) continue;
      comp_z.push_back(z);
      comp_l.push_back(l);
      comp_m.push_back(lut[(size_t)z * L + l]);
    }
  int32_t nc = (int32_t)comp_z.size();
  std::vector<std::vector<int32_t>> contours(nc);
#pragma omp parallel for schedule(dynamic)
  for (int32_t c = 0; c < nc; ++c) {
    int32_t z = comp_z[c], l = comp_l[c];
    int64_t fp = first_pix[(size_t)z * L + l];
    trace_label_contour(labels + (size_t)z * hw, H, W, (uint16_t)l,
                        (int32_t)(fp / W), (int32_t)(fp % W), contours[c]);
    std::vector<PD> cp(contours[c].size() / 2);
    for (size_t i = 0; i < cp.size(); ++i)
      cp[i] = PD{(double)contours[c][2 * i], (double)contours[c][2 * i + 1]};
    std::sort(cp.begin(), cp.end(), [](const PD& a, const PD& b) {
      return a.x != b.x ? a.x < b.x : a.y < b.y;
    });
    cp.erase(std::unique(cp.begin(), cp.end(),
                         [](const PD& a, const PD& b) {
                           return a.x == b.x && a.y == b.y;
                         }),
             cp.end());
    std::vector<PD> ch;
    hull_chain(cp, ch);
    fit_shapes16(ch, sx, sy, ox, oy, comp_shapes + 16 * c);
  }
  contour_start[0] = 0;
  for (int32_t c = 0; c < nc; ++c) {
    contour_start[c + 1] = contour_start[c] + (int64_t)contours[c].size() / 2;
    comp_zlm[3 * c] = comp_z[c];
    comp_zlm[3 * c + 1] = comp_l[c];
    comp_zlm[3 * c + 2] = comp_m[c];
  }
  if (contour_start[nc] > contour_cap) return -1;
  for (int32_t c = 0; c < nc; ++c)
    std::memcpy(contour_xy + 2 * contour_start[c], contours[c].data(),
                contours[c].size() * sizeof(int32_t));
  return nc;
}

// ---------------------------------------------------------------------------
// Host segmentation backend: the reference's production path runs per-layer
// connected components on the CPU (OpenCV, gpu_depthmap_fusion.cpp:1872-2011)
// and merges labels across layers on the CPU (cpp:2243-2361). This is that
// path, self-contained: per-layer 8-connected CC (raster-order label
// numbering, OMP across layers), cross-layer union-find restricted to
// both-background / both-foreground column pairs (cpp:2303,2332 semantics,
// run to full fixpoint like mapping/segmentation.py), dense renumbering in
// ascending order of the smallest global label, and per-object voxel stats.
// Bit-exact with the device program (tested), ~10 ms at deployment scale.
// ---------------------------------------------------------------------------
int32_t fh_segment_grid(const uint8_t* occ, int32_t Z, int32_t H, int32_t W,
                        int32_t max_labels, int32_t max_objects,
                        uint16_t* labels, int32_t* num_labels,
                        int32_t* merged_of_label, int64_t* voxel_count,
                        double* centroid, int32_t* vmin, int32_t* vmax) {
  const int64_t hw = (int64_t)H * W;
  const int32_t L = max_labels;
// per-layer CC (reuses fh_cc_label_u8; stats not needed here)
#pragma omp parallel for schedule(dynamic)
  for (int32_t z = 0; z < Z; ++z) {
    num_labels[z] = fh_cc_label_u8(occ + (size_t)z * hw,
                                   labels + (size_t)z * hw, H, W, nullptr,
                                   nullptr, max_labels);
  }
  // cross-layer union-find over global label ids z*L + l
  const int64_t t = (int64_t)Z * L;
  std::vector<int32_t> parent(t);
  for (int64_t i = 0; i < t; ++i) parent[i] = (int32_t)i;
  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  auto unite = [&](int32_t a, int32_t b) {
    int32_t ra = find(a), rb = find(b);
    if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
  };
  for (int32_t z = 0; z + 1 < Z; ++z) {
    const uint16_t* la = labels + (size_t)z * hw;
    const uint16_t* lb = labels + (size_t)(z + 1) * hw;
    int32_t last_a = -1, last_b = -1;
    for (int64_t i = 0; i < hw; ++i) {
      int32_t a = la[i], b = lb[i];
      if ((a == 0) != (b == 0)) continue;  // bg only merges with bg
      if (a == last_a && b == last_b) continue;  // run-skip
      last_a = a;
      last_b = b;
      unite(z * L + a, (z + 1) * L + b);
    }
  }
  // dense renumber: valid labels are l < num_labels[z]; merged ids in
  // ascending order of each partition's smallest global label
  std::vector<int32_t> dense(t, -1);
  int32_t num_merged = 0;
  for (int32_t z = 0; z < Z; ++z)
    for (int32_t l = 0; l < num_labels[z]; ++l) {
      int32_t g = z * L + l;
      if (find(g) == g) dense[g] = num_merged++;
    }
  for (int32_t z = 0; z < Z; ++z) {
    for (int32_t l = 0; l < L; ++l) {
      int32_t g = z * L + l;
      merged_of_label[g] = (l < num_labels[z]) ? dense[find(g)] : 0;
    }
  }
  // per-object voxel stats over occupied voxels (device semantics:
  // ids clamped to max_objects-1; empty objects get vmax=-1)
  const int32_t M = max_objects;
  for (int32_t m = 0; m < M; ++m) {
    voxel_count[m] = 0;
    centroid[3 * m] = centroid[3 * m + 1] = centroid[3 * m + 2] = 0;
    vmin[3 * m] = vmin[3 * m + 1] = vmin[3 * m + 2] = 0;
    vmax[3 * m] = vmax[3 * m + 1] = vmax[3 * m + 2] = -1;
  }
  std::vector<double> sums((size_t)M * 3, 0.0);
  std::vector<int32_t> mn((size_t)M * 3, INT32_MAX), mx((size_t)M * 3,
                                                        INT32_MIN);
  for (int32_t z = 0; z < Z; ++z) {
    const uint16_t* lz = labels + (size_t)z * hw;
    const uint8_t* oz = occ + (size_t)z * hw;
    const int32_t* mz = merged_of_label + (size_t)z * L;
    for (int64_t i = 0; i < hw; ++i) {
      if (!oz[i]) continue;
      int32_t m = mz[lz[i]];
      if (m >= M) m = M - 1;
      int32_t x = (int32_t)(i % W), y = (int32_t)(i / W);
      voxel_count[m]++;
      sums[3 * m] += x;
      sums[3 * m + 1] += y;
      sums[3 * m + 2] += z;
      mn[3 * m] = std::min(mn[3 * m], x);
      mn[3 * m + 1] = std::min(mn[3 * m + 1], y);
      mn[3 * m + 2] = std::min(mn[3 * m + 2], z);
      mx[3 * m] = std::max(mx[3 * m], x);
      mx[3 * m + 1] = std::max(mx[3 * m + 1], y);
      mx[3 * m + 2] = std::max(mx[3 * m + 2], z);
    }
  }
  for (int32_t m = 0; m < M; ++m) {
    if (voxel_count[m] > 0) {
      for (int k = 0; k < 3; ++k) {
        centroid[3 * m + k] = sums[3 * m + k] / (double)voxel_count[m];
        vmin[3 * m + k] = mn[3 * m + k];
        vmax[3 * m + k] = mx[3 * m + k];
      }
    }
  }
  return num_merged;
}

// ---------------------------------------------------------------------------
// Depth-link codec (encoder half; the decoder is a vectorized XLA program,
// ops/depth_codec.py). Lossless escape-zero row-DPCM for u16 depth maps:
//
//  - each pixel is a B-bit code; codes 0..2^B-2 are zigzag(d - previous
//    valid pixel in the row); the top code ESC = 2^B-1 marks a hole
//    (depth == 0, contributes delta 0) — no separate mask plane;
//  - each row's first VALID pixel is stored raw (row_first) and gets
//    code 0 (delta 0), so DPCM never pays a full-magnitude recovery delta;
//  - zigzag values >= ESC are encoded as 0 in the stream and their true
//    value goes to an (index, value) exception list the decoder scatters
//    back before the row prefix-sum;
//  - B is frame-constant: the smallest allowed width whose overflow count
//    fits the exception budget (the decoder compiles one jit variant per
//    allowed width). B=17 never overflows (max zigzag(+-65535) = 2^17-2).
//
// Rationale: smooth depth compresses to ~3-5 bits/px, shrinking the
// host->device upload, and the decoder is pure vectorized bit math + one
// row cumsum (static shapes per B).
// ---------------------------------------------------------------------------

static inline uint32_t fh_zigzag(int32_t d) {
  return ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
}

static inline int fh_bits_needed(uint32_t v) {
#if defined(__GNUC__) || defined(__clang__)
  return v ? 32 - __builtin_clz(v) : 0;
#else
  int b = 0;
  while (v) {
    ++b;
    v >>= 1;
  }
  return b;
#endif
}

static const uint32_t FH_HOLE = 0xFFFFFFFFu;  // zz_tmp sentinel for depth==0

// Streaming bit packer for one row: shift B-bit codes into a 64-bit
// accumulator, flush 32-bit words as they fill (write-only, no RMW).
struct FhRowPacker {
  uint32_t* out;
  uint64_t acc = 0;
  int32_t nbits = 0;
  explicit FhRowPacker(uint32_t* o) : out(o) {}
  inline void push(uint32_t code, int32_t B) {
    acc |= (uint64_t)code << nbits;
    nbits += B;
    if (nbits >= 32) {
      *out++ = (uint32_t)acc;
      acc >>= 32;
      nbits -= 32;
    }
  }
  inline void flush() {
    if (nbits > 0) *out++ = (uint32_t)acc;
  }
};

// Pack one row of zigzag codes at width B; exceptions (zz >= ESC) are
// encoded as 0 and appended to `exc` as (flat_index << 32 | zz).
static inline void fh_pack_row(const uint32_t* zrow, int64_t r, int32_t W,
                               int32_t B, int32_t wpr, uint32_t* words,
                               std::vector<uint64_t>& exc) {
  const uint32_t esc = (1u << B) - 1;
  FhRowPacker pk(words + r * wpr);
  for (int32_t x = 0; x < W; ++x) {
    uint32_t z = zrow[x];
    if (z == FH_HOLE) {
      z = esc;
    } else if (z >= esc) {
      exc.push_back(((uint64_t)(r * W + x) << 32) | z);
      z = 0;
    }
    pk.push(z, B);
  }
  pk.flush();
}

// Returns chosen bit width B (1..17) or -1 when the overflow count exceeds
// max_exc at every allowed width. Caller allocates: zz_tmp u32[C*H*W]
// scratch, words u32[C*H*ceil(W*B/32)] at the largest allowed B (rows use
// stride ceil(W*B/32) of the CHOSEN B), row_first u16[C*H],
// exc_idx/exc_zz u32[max_exc]. out_meta[0] = exception count,
// out_meta[1] = words-per-row at the chosen B.
//
// guess_B: the expected width (e.g. last frame's — depth streams are
// temporally stable). When in the allowed list, rows are packed at
// guess_B during the DPCM pass; if the histogram then confirms guess_B,
// the packing pass is skipped entirely.
//
// quant_shift: optional bounded-loss quantization — nonzero depths are
// rounded to multiples of 2^quant_shift BEFORE the DPCM (error at most
// 2^(quant_shift-1) depth units, i.e. <= 2 mm at shift 2 with mm depth
// — below RealSense-class sensor noise at range and 2-3 orders below
// the deployment voxel sizes). Deltas shrink by the same factor, so the
// histogram typically picks a width ~quant_shift bits narrower. 0 =
// lossless (default path, bit-exact round trip). The decoder multiplies
// the reconstructed series back by 2^quant_shift.
int32_t fh_depth_encode2(const uint16_t* depth, int32_t C, int32_t H,
                         int32_t W, int64_t max_exc,
                         const int32_t* allowed_bits, int32_t n_allowed,
                         int32_t guess_B, int32_t quant_shift,
                         uint32_t* zz_tmp, uint32_t* words,
                         uint16_t* row_first,
                         uint32_t* exc_idx, uint32_t* exc_zz,
                         int64_t* out_meta) {
  const int64_t rows = (int64_t)C * H;
  const int32_t qsh = quant_shift;
  const int32_t qround = qsh > 0 ? (1 << (qsh - 1)) : 0;
  const int32_t qmax = 65535 >> qsh;  // so series << qsh stays u16
  bool guess_allowed = false;
  for (int32_t i = 0; i < n_allowed; ++i)
    if (allowed_bits[i] == guess_B) guess_allowed = true;
  const int32_t gwpr =
      guess_allowed ? (int32_t)(((int64_t)W * guess_B + 31) / 32) : 0;
  // pass 1: per-row DPCM -> zigzag deltas (holes -> sentinel) + histogram
  // of bits_needed(zz + 1)  (zz >= 2^B - 1  <=>  bits_needed(zz+1) > B),
  // speculatively packing at guess_B as we go
  int64_t hist[20] = {0};
  std::vector<std::vector<uint64_t>> exc_parts;
#pragma omp parallel
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
    const int nth = omp_get_num_threads();
#else
    const int tid = 0, nth = 1;
#endif
#pragma omp single
    exc_parts.assign(nth, {});
    std::vector<uint64_t>& mine = exc_parts[tid];
    int64_t lhist[20] = {0};
#pragma omp for nowait
    for (int64_t r = 0; r < rows; ++r) {
      const uint16_t* row = depth + r * W;
      uint32_t* zrow = zz_tmp + r * W;
      int32_t prev = -1;
      uint16_t first = 0;
      const uint32_t gesc = guess_allowed ? (1u << guess_B) - 1 : 0;
      FhRowPacker pk(words + r * gwpr);
      for (int32_t x = 0; x < W; ++x) {
        uint16_t d = row[x];
        if (d != 0 && qsh > 0)
          d = (uint16_t)std::min(qmax,
                                 std::max(1, ((int32_t)d + qround) >> qsh));
        uint32_t z, code;
        if (d == 0) {
          z = FH_HOLE;
          code = gesc;
        } else {
          z = 0;
          if (prev < 0)
            first = d;  // delta 0 by construction
          else
            z = fh_zigzag((int32_t)d - prev);
          prev = d;
          lhist[fh_bits_needed(z + 1)]++;
          code = z;
          if (guess_allowed && z >= gesc) {
            mine.push_back(((uint64_t)(r * W + x) << 32) | z);
            code = 0;
          }
        }
        zrow[x] = z;
        if (guess_allowed) pk.push(code, guess_B);
      }
      if (guess_allowed) pk.flush();
      row_first[r] = first;
    }
#pragma omp critical
    for (int i = 0; i < 20; ++i) hist[i] += lhist[i];
  }
  // smallest allowed B whose overflow fits the exception budget
  int64_t tail[20];  // tail[b] = # valid px with zz >= 2^b - 1
  tail[19] = 0;
  for (int b = 18; b >= 1; --b) tail[b] = tail[b + 1] + hist[b + 1];
  int32_t B = -1;
  for (int32_t i = 0; i < n_allowed; ++i) {
    const int32_t b = allowed_bits[i];  // ascending
    if (b >= 1 && b <= 17 && tail[b] <= max_exc) {
      B = b;
      break;
    }
  }
  if (B < 0) return -1;
  const int32_t wpr = (int32_t)(((int64_t)W * B + 31) / 32);
  if (!(guess_allowed && B == guess_B)) {
    // guess missed: repack from the zigzag scratch at the chosen width
    exc_parts.clear();
#pragma omp parallel
    {
#ifdef _OPENMP
      const int tid = omp_get_thread_num();
      const int nth = omp_get_num_threads();
#else
      const int tid = 0, nth = 1;
#endif
#pragma omp single
      exc_parts.assign(nth, {});
      std::vector<uint64_t>& mine = exc_parts[tid];
#pragma omp for
      for (int64_t r = 0; r < rows; ++r)
        fh_pack_row(zz_tmp + r * W, r, W, B, wpr, words, mine);
    }
  }
  std::vector<uint64_t> exc;
  for (auto& p : exc_parts) exc.insert(exc.end(), p.begin(), p.end());
  std::sort(exc.begin(), exc.end());
  if ((int64_t)exc.size() > max_exc) return -1;
  for (size_t i = 0; i < exc.size(); ++i) {
    exc_idx[i] = (uint32_t)(exc[i] >> 32);
    exc_zz[i] = (uint32_t)exc[i];
  }
  out_meta[0] = (int64_t)exc.size();
  out_meta[1] = wpr;
  return B;
}

// Temporal (P-frame) encoder: predict each pixel from the PREVIOUS
// frame's quantized series prev_q (holes = 0) instead of the row-left
// neighbor — zz = zigzag(curr_q - prev_q). No row bases; the decoder is
// pointwise (prev_q + delta), no cumsum. Pixels whose previous value was
// a hole carry full magnitude and ride the exception list, so scenes
// with heavy hole churn exceed the budget and the caller falls back to
// an I-frame (fh_depth_encode2). Writes curr_q (the next frame's
// prediction state) alongside. Same allocation contract as
// fh_depth_encode2 minus row_first. Returns B or -1.
int32_t fh_depth_encode_temporal(
    const uint16_t* depth, const uint16_t* prev_q, int32_t C, int32_t H,
    int32_t W, int64_t max_exc, const int32_t* allowed_bits,
    int32_t n_allowed, int32_t guess_B, int32_t quant_shift,
    uint32_t* zz_tmp, uint32_t* words, uint16_t* curr_q,
    uint32_t* exc_idx, uint32_t* exc_zz, int64_t* out_meta) {
  const int64_t rows = (int64_t)C * H;
  const int32_t qsh = quant_shift;
  const int32_t qround = qsh > 0 ? (1 << (qsh - 1)) : 0;
  const int32_t qmax = 65535 >> qsh;
  bool guess_allowed = false;
  for (int32_t i = 0; i < n_allowed; ++i)
    if (allowed_bits[i] == guess_B) guess_allowed = true;
  const int32_t gwpr =
      guess_allowed ? (int32_t)(((int64_t)W * guess_B + 31) / 32) : 0;
  int64_t hist[20] = {0};
  std::vector<std::vector<uint64_t>> exc_parts;
#pragma omp parallel
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
    const int nth = omp_get_num_threads();
#else
    const int tid = 0, nth = 1;
#endif
#pragma omp single
    exc_parts.assign(nth, {});
    std::vector<uint64_t>& mine = exc_parts[tid];
    int64_t lhist[20] = {0};
#pragma omp for nowait
    for (int64_t r = 0; r < rows; ++r) {
      const uint16_t* row = depth + r * W;
      const uint16_t* prow = prev_q + r * W;
      uint16_t* qrow = curr_q + r * W;
      uint32_t* zrow = zz_tmp + r * W;
      const uint32_t gesc = guess_allowed ? (1u << guess_B) - 1 : 0;
      FhRowPacker pk(words + r * gwpr);
      for (int32_t x = 0; x < W; ++x) {
        uint16_t d = row[x];
        if (d != 0 && qsh > 0)
          d = (uint16_t)std::min(qmax,
                                 std::max(1, ((int32_t)d + qround) >> qsh));
        uint32_t z, code;
        if (d == 0) {
          z = FH_HOLE;
          code = gesc;
          qrow[x] = 0;
        } else {
          z = fh_zigzag((int32_t)d - (int32_t)prow[x]);
          qrow[x] = d;
          lhist[fh_bits_needed(z + 1)]++;
          code = z;
          if (guess_allowed && z >= gesc) {
            mine.push_back(((uint64_t)(r * W + x) << 32) | z);
            code = 0;
          }
        }
        zrow[x] = z;
        if (guess_allowed) pk.push(code, guess_B);
      }
      if (guess_allowed) pk.flush();
    }
#pragma omp critical
    for (int i = 0; i < 20; ++i) hist[i] += lhist[i];
  }
  int64_t tail[20];
  tail[19] = 0;
  for (int b = 18; b >= 1; --b) tail[b] = tail[b + 1] + hist[b + 1];
  int32_t B = -1;
  for (int32_t i = 0; i < n_allowed; ++i) {
    const int32_t b = allowed_bits[i];  // ascending
    if (b >= 1 && b <= 17 && tail[b] <= max_exc) {
      B = b;
      break;
    }
  }
  if (B < 0) return -1;
  const int32_t wpr = (int32_t)(((int64_t)W * B + 31) / 32);
  if (!(guess_allowed && B == guess_B)) {
    exc_parts.clear();
#pragma omp parallel
    {
#ifdef _OPENMP
      const int tid = omp_get_thread_num();
      const int nth = omp_get_num_threads();
#else
      const int tid = 0, nth = 1;
#endif
#pragma omp single
      exc_parts.assign(nth, {});
      std::vector<uint64_t>& mine = exc_parts[tid];
#pragma omp for
      for (int64_t r = 0; r < rows; ++r)
        fh_pack_row(zz_tmp + r * W, r, W, B, wpr, words, mine);
    }
  }
  std::vector<uint64_t> exc;
  for (auto& p : exc_parts) exc.insert(exc.end(), p.begin(), p.end());
  std::sort(exc.begin(), exc.end());
  if ((int64_t)exc.size() > max_exc) return -1;
  for (size_t i = 0; i < exc.size(); ++i) {
    exc_idx[i] = (uint32_t)(exc[i] >> 32);
    exc_zz[i] = (uint32_t)exc[i];
  }
  out_meta[0] = (int64_t)exc.size();
  out_meta[1] = wpr;
  return B;
}

// p4 temporal encoder: 4-pixel-group flags + per-row byte-budgeted
// literal stream with HYSTERESIS quantization (see ops/depth_codec.py
// module comment for the format and the gather-free decode).
//
//   quant/hysteresis: a valid pixel KEEPS its previous bin while
//     |raw - (prev_q << shift)| <= 2^(shift-1) + hyst (raw units);
//     error bound q/2 + hyst held, q/2 after a flip.
//   codes (4 bits): 0..14 = zigzag(delta) for delta in [-7, +7]
//     (0 = delta 0), 15 = new hole. |delta| > 7 and hole->value
//     revivals code 0 and ride the exception list (value->hole in a
//     SPILLED group rides it as zigzag(-prev): prev + delta == 0 is the
//     hole encoding).
//   flags: u32[rows * fw], bit g set iff group g got a literal slot
//     (groups past budget/2 are NOT flagged; their non-zero pixels all
//     go to exceptions).
//   lits: u8[rows * budget] row-local 16-bit group literals, 2 bytes
//     each little-endian (capacity budget/2 groups per row).
//
// Returns 0, or -1 when exceptions exceed max_exc (caller sends an
// I-frame). out_meta: [0] exc count, [1] total literal bytes,
// [2] spilled groups (diagnostics).
int32_t fh_depth_encode_p4(
    const uint16_t* depth, const uint16_t* prev_q, int32_t C, int32_t H,
    int32_t W, int32_t quant_shift, int32_t hysteresis, int32_t budget,
    int64_t max_exc, uint32_t* flags, uint8_t* lits, uint16_t* curr_q,
    uint32_t* exc_idx, uint32_t* exc_zz, int64_t* out_meta) {
  const int64_t rows = (int64_t)C * H;
  const int32_t qsh = quant_shift;
  const int32_t qround = qsh > 0 ? (1 << (qsh - 1)) : 0;
  const int32_t qmax = 65535 >> qsh;
  const int32_t band = (qsh > 0 ? (1 << (qsh - 1)) : 0) + hysteresis;
  const int32_t gw = (W + 3) / 4;
  const int32_t fw = (gw + 31) / 32;
  int64_t lit_total = 0, spilled_total = 0;
  std::vector<std::vector<uint64_t>> exc_parts;
#pragma omp parallel reduction(+ : lit_total, spilled_total)
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
    const int nth = omp_get_num_threads();
#else
    const int tid = 0, nth = 1;
#endif
#pragma omp single
    exc_parts.assign(nth, {});
    std::vector<uint64_t>& mine = exc_parts[tid];
    // per-group scratch: codes + pending exceptions of the group
    uint32_t gexc_idx[4];
    uint32_t gexc_zz[4];
#pragma omp for nowait
    for (int64_t r = 0; r < rows; ++r) {
      const uint16_t* drow = depth + r * W;
      const uint16_t* prow = prev_q + r * W;
      uint16_t* qrow = curr_q + r * W;
      uint32_t* frow = flags + r * fw;
      uint8_t* lrow = lits + (int64_t)r * budget;
      std::memset(frow, 0, (size_t)fw * 4);
      std::memset(lrow, 0, (size_t)budget);
      const int32_t gcap = budget / 2;  // 2 bytes per group literal
      int32_t nlit = 0;                 // groups kept this row
      for (int32_t g = 0; g < gw; ++g) {
        uint32_t gword = 0;
        int32_t gex = 0;
        const int32_t x0 = g * 4;
        const int32_t xe = std::min(W, x0 + 4);
        for (int32_t x = x0; x < xe; ++x) {
          const int32_t p = prow[x];
          int32_t d = drow[x];
          int32_t q;
          if (d == 0) {
            q = 0;
          } else if (p != 0 && std::abs(d - (p << qsh)) <= band) {
            q = p;  // hysteresis hold
          } else if (qsh > 0) {
            q = std::min(qmax, std::max(1, (d + qround) >> qsh));
          } else {
            q = d;
          }
          qrow[x] = (uint16_t)q;
          const int32_t delta = q - p;
          uint32_t code = 0;
          if (q == 0) {
            if (p != 0) code = 15;  // new hole (persistent holes code 0)
          } else if (p != 0 && delta >= -7 && delta <= 7) {
            code = fh_zigzag(delta);  // 0..14 in-stream
          } else {
            // |delta| > 7 (content motion) or hole->value revival
            const uint32_t zz = fh_zigzag(delta);
            gexc_idx[gex] = (uint32_t)(r * W + x);
            gexc_zz[gex] = zz;
            ++gex;
          }
          gword |= code << (4 * (x - x0));
        }
        if (gword != 0) {
          if (nlit < gcap) {
            lrow[2 * nlit] = (uint8_t)(gword & 0xFF);
            lrow[2 * nlit + 1] = (uint8_t)(gword >> 8);
            ++nlit;
            frow[g >> 5] |= 1u << (g & 31);
            for (int32_t e = 0; e < gex; ++e)
              mine.push_back(((uint64_t)gexc_idx[e] << 32) | gexc_zz[e]);
          } else {
            // SPILL: group unflagged; every non-zero-code pixel rides
            // the exception list (holes as zigzag(-prev))
            ++spilled_total;
            for (int32_t x = x0; x < xe; ++x) {
              const int32_t delta = (int32_t)qrow[x] - (int32_t)prow[x];
              if (delta == 0) continue;
              mine.push_back(((uint64_t)(r * W + x) << 32)
                             | fh_zigzag(delta));
            }
          }
        } else {
          // zero byte: exception-only pixels of an unflagged group
          for (int32_t e = 0; e < gex; ++e)
            mine.push_back(((uint64_t)gexc_idx[e] << 32) | gexc_zz[e]);
        }
      }
      lit_total += 2 * nlit;  // bytes
    }
  }
  std::vector<uint64_t> exc;
  for (auto& p : exc_parts) exc.insert(exc.end(), p.begin(), p.end());
  if ((int64_t)exc.size() > max_exc) return -1;
  std::sort(exc.begin(), exc.end());
  for (size_t i = 0; i < exc.size(); ++i) {
    exc_idx[i] = (uint32_t)(exc[i] >> 32);
    exc_zz[i] = (uint32_t)exc[i];
  }
  out_meta[0] = (int64_t)exc.size();
  out_meta[1] = lit_total;
  out_meta[2] = spilled_total;
  return 0;
}

// ---------------------------------------------------------------------------
// point-sequence staging append (reference addPointSequence copy loop,
// gpu_depthmap_fusion.cpp:747-796): copy xyz (stride float) with w = 1.
// ---------------------------------------------------------------------------
int64_t fh_stage_points_xyz(const float* xyz, int64_t n, int64_t stride_floats,
                            float* out_xyzw, int64_t cap) {
  int64_t m = std::min(n, cap);
#pragma omp parallel for
  for (int64_t i = 0; i < m; ++i) {
    out_xyzw[4 * i + 0] = xyz[stride_floats * i + 0];
    out_xyzw[4 * i + 1] = xyz[stride_floats * i + 1];
    out_xyzw[4 * i + 2] = xyz[stride_floats * i + 2];
    out_xyzw[4 * i + 3] = 1.0f;
  }
  return m;
}

}  // extern "C"
