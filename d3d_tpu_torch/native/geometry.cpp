// Host-side rotated-box geometry: exact Sutherland-Hodgman clipping in
// double precision, plus greedy NMS and point-in-box tests.
//
// This is the native CPU fallback / oracle of d3d_tpu_torch, a copy of
// d3d_tpu's (the role the reference's libtorch box_impl extension plays for
// its no-GPU build, d3d/box/{iou,nms,utils}.cpp — reimplemented from the
// algorithm, not the code). The CUDA path in d3d_tpu_torch.ops is the
// production kernel; this library exists to (a) validate it against an
// independent implementation and (b) serve pure-host deployments. Exposed
// through a C ABI for ctypes.
//
// Build: d3d_tpu_torch/native/__init__.py compiles it with voxel.cpp into
// build/d3d_tpu_torch/ on first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

// corners of an (x, y, w, h, r) box, counter-clockwise
static void box_corners(const double* b, Pt out[4]) {
  const double c = std::cos(b[4]), s = std::sin(b[4]);
  const double dx = b[2] * 0.5, dy = b[3] * 0.5;
  const double lx[4] = {-dx, dx, dx, -dx};
  const double ly[4] = {-dy, -dy, dy, dy};
  for (int i = 0; i < 4; ++i) {
    out[i].x = c * lx[i] - s * ly[i] + b[0];
    out[i].y = s * lx[i] + c * ly[i] + b[1];
  }
}

static inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// area of the intersection of two convex polygons via Sutherland-Hodgman
static double intersect_area(const Pt* subj, int ns, const Pt* clip, int nc) {
  // clip `subj` successively against each directed edge of `clip`
  std::vector<Pt> cur(subj, subj + ns), next;
  next.reserve(16);
  for (int e = 0; e < nc && !cur.empty(); ++e) {
    const Pt& a = clip[e];
    const Pt& b = clip[(e + 1) % nc];
    next.clear();
    const int n = static_cast<int>(cur.size());
    for (int i = 0; i < n; ++i) {
      const Pt& p = cur[i];
      const Pt& q = cur[(i + 1) % n];
      const double sp = cross(a, b, p);
      const double sq = cross(a, b, q);
      if (sp >= 0) next.push_back(p);
      if ((sp < 0) != (sq < 0)) {
        const double t = sp / (sp - sq);
        next.push_back({p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)});
      }
    }
    cur.swap(next);
  }
  if (cur.size() < 3) return 0.0;
  double area = 0.0;
  const int n = static_cast<int>(cur.size());
  for (int i = 0; i < n; ++i) {
    const Pt& p = cur[i];
    const Pt& q = cur[(i + 1) % n];
    area += p.x * q.y - p.y * q.x;
  }
  return std::fabs(area) * 0.5;
}

static double rbox_iou_one(const double* b1, const double* b2) {
  Pt p1[4], p2[4];
  box_corners(b1, p1);
  box_corners(b2, p2);
  const double inter = intersect_area(p1, 4, p2, 4);
  const double uni = b1[2] * b1[3] + b2[2] * b2[3] - inter;
  return uni > 1e-12 ? inter / uni : 0.0;
}

static double aabox_iou_one(const double* b1, const double* b2) {
  Pt p1[4], p2[4];
  box_corners(b1, p1);
  box_corners(b2, p2);
  double lo1x = p1[0].x, hi1x = p1[0].x, lo1y = p1[0].y, hi1y = p1[0].y;
  double lo2x = p2[0].x, hi2x = p2[0].x, lo2y = p2[0].y, hi2y = p2[0].y;
  for (int i = 1; i < 4; ++i) {
    lo1x = std::min(lo1x, p1[i].x); hi1x = std::max(hi1x, p1[i].x);
    lo1y = std::min(lo1y, p1[i].y); hi1y = std::max(hi1y, p1[i].y);
    lo2x = std::min(lo2x, p2[i].x); hi2x = std::max(hi2x, p2[i].x);
    lo2y = std::min(lo2y, p2[i].y); hi2y = std::max(hi2y, p2[i].y);
  }
  const double iw = std::max(0.0, std::min(hi1x, hi2x) - std::max(lo1x, lo2x));
  const double ih = std::max(0.0, std::min(hi1y, hi2y) - std::max(lo1y, lo2y));
  const double inter = iw * ih;
  const double uni =
      (hi1x - lo1x) * (hi1y - lo1y) + (hi2x - lo2x) * (hi2y - lo2y) - inter;
  return uni > 1e-12 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

// (n, 5) x (m, 5) -> (n, m) rotated IoU matrix
void d3d_rbox_iou_matrix(const double* boxes1, int64_t n, const double* boxes2,
                         int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < m; ++j)
      out[i * m + j] = rbox_iou_one(boxes1 + 5 * i, boxes2 + 5 * j);
}

void d3d_aabox_iou_matrix(const double* boxes1, int64_t n,
                          const double* boxes2, int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < m; ++j)
      out[i * m + j] = aabox_iou_one(boxes1 + 5 * i, boxes2 + 5 * j);
}

// greedy hard NMS in descending score order; writes the suppressed mask.
// semantics match d3d_tpu_torch.ops.nms (and the reference nms.cpp): boxes with
// score <= score_threshold are pre-suppressed except the top-scoring one.
void d3d_nms2d(const double* boxes, const double* scores, int64_t n,
               int rotated, double iou_threshold, double score_threshold,
               uint8_t* suppressed) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });
  std::fill(suppressed, suppressed + n, 0);
  for (int64_t k = 1; k < n; ++k)
    if (scores[order[k]] <= score_threshold) suppressed[order[k]] = 1;

  for (int64_t a = 0; a < n; ++a) {
    const int64_t i = order[a];
    if (suppressed[i]) continue;
    for (int64_t b = a + 1; b < n; ++b) {
      const int64_t j = order[b];
      if (suppressed[j]) continue;
      const double iou = rotated ? rbox_iou_one(boxes + 5 * i, boxes + 5 * j)
                                 : aabox_iou_one(boxes + 5 * i, boxes + 5 * j);
      if (iou > iou_threshold) suppressed[j] = 1;
    }
  }
}

// (m, 5) boxes x (n, 2) points -> (m, n) containment mask
void d3d_box2dr_contains(const double* boxes, int64_t m, const double* points,
                         int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < m; ++i) {
    Pt poly[4];
    box_corners(boxes + 5 * i, poly);
    for (int64_t j = 0; j < n; ++j) {
      const Pt p{points[2 * j], points[2 * j + 1]};
      bool inside = true;
      for (int e = 0; e < 4 && inside; ++e)
        inside = cross(poly[e], poly[(e + 1) % 4], p) >= 0;
      out[i * n + j] = inside ? 1 : 0;
    }
  }
}

}  // extern "C"
