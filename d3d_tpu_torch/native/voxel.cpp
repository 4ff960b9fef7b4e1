// Native host voxelizer oracle.
//
// Replicates the reference's single-threaded hash-map voxelization
// (d3d/voxel/voxelize.cpp: dense :46-199, sparse :288-335) as an
// INDEPENDENT implementation used to cross-validate the torch sort+segment
// formulation in d3d_tpu_torch/ops/voxel.py — the same role
// geometry.cpp plays for the polygon-clipping kernels.
//
// Semantics pinned to the reference:
//  * cell index is a C trunc cast of (p - bmin) / vsize (voxelize.cpp:102),
//    so scaled values in (-1, 0] land in cell 0; the bounds check runs on
//    the *integer* cell. Cell arithmetic is done in float (f32) to mirror
//    the device path bit-for-bit at cell boundaries.
//  * voxel ids are assigned in first-encounter (hash-insertion) order;
//    once max_voxels cells are registered, points of NEW cells are
//    dropped but points of registered cells still accumulate.
//  * the voxels tensor keeps only the first max_points points per cell in
//    point order; npoints counts ALL in-range points of the cell
//    (voxelize.cpp:128-135); aggregates reduce over ALL points too, with
//    the mean finalized by npoints (:161-164).

#include <array>
#include <cmath>
#include <cstdint>
#include <map>
#include <unordered_map>

extern "C" {

// reduction: 0 = none, 1 = mean, 2 = max, 3 = min.
// voxels/pmask/npoints/aggregates must be zero-initialized by the caller.
void d3d_voxelize_dense(const double* points, int64_t n, int64_t f,
                        const double* bounds, const int64_t* shape,
                        int64_t max_points, int64_t max_voxels,
                        int reduction, double* voxels, int64_t* coords,
                        uint8_t* pmask, int64_t* npoints,
                        double* aggregates, int64_t* nvoxels) {
  float bmin[3], vsize[3];
  for (int d = 0; d < 3; ++d) {
    bmin[d] = (float)bounds[2 * d];
    vsize[d] =
        ((float)bounds[2 * d + 1] - (float)bounds[2 * d]) / (float)shape[d];
  }
  std::unordered_map<int64_t, int64_t> vid;
  vid.reserve((size_t)max_voxels * 2);
  int64_t nv = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double* p = points + i * f;
    int64_t c[3];
    bool ok = true;
    for (int d = 0; d < 3; ++d) {
      float s = ((float)p[d] - bmin[d]) / vsize[d];
      if (!(s > -2e9f && s < 2e9f)) {  // guard the float->int cast (UB)
        ok = false;
        break;
      }
      int64_t ci = (int64_t)s;  // trunc toward zero, like the reference
      if (ci < 0 || ci >= shape[d]) {
        ok = false;
        break;
      }
      c[d] = ci;
    }
    if (!ok) continue;
    int64_t key = (c[0] * shape[1] + c[1]) * shape[2] + c[2];
    auto it = vid.find(key);
    int64_t v;
    if (it == vid.end()) {
      if (nv >= max_voxels) continue;  // cap reached: drop new cells
      v = nv++;
      vid.emplace(key, v);
      for (int d = 0; d < 3; ++d) coords[v * 3 + d] = c[d];
    } else {
      v = it->second;
    }
    int64_t seen = npoints[v];
    if (seen < max_points) {
      double* slot = voxels + (v * max_points + seen) * f;
      for (int64_t j = 0; j < f; ++j) slot[j] = p[j];
      pmask[v * max_points + seen] = 1;
    }
    npoints[v] = seen + 1;
    if (reduction != 0) {
      double* agg = aggregates + v * f;
      for (int64_t j = 0; j < f; ++j) {
        if (reduction == 1)
          agg[j] += p[j];
        else if (seen == 0)
          agg[j] = p[j];
        else if (reduction == 2)
          agg[j] = agg[j] > p[j] ? agg[j] : p[j];
        else
          agg[j] = agg[j] < p[j] ? agg[j] : p[j];
      }
    }
  }
  if (reduction == 1)
    for (int64_t v = 0; v < nv; ++v)
      for (int64_t j = 0; j < f; ++j) aggregates[v * f + j] /= (double)npoints[v];
  *nvoxels = nv;
}

// Sparse (unbounded-grid) voxelization: cells are floor(xyz / voxel_size),
// every point is mapped, voxel ids in first-encounter order
// (voxelize.cpp:288-335). coords/npoints are sized (n, 3)/(n,) by the
// caller (worst case: every point its own voxel). Like the dense path,
// the division+floor run in f32 to mirror the device arithmetic at cell
// boundaries (f64 floors differ ~3/million points at non-dyadic sizes).
void d3d_voxelize_sparse(const double* points, int64_t n, int64_t f,
                         const double* voxel_size, int64_t* points_mapping,
                         int64_t* coords, int64_t* npoints,
                         int64_t* nvoxels) {
  std::map<std::array<int64_t, 3>, int64_t> vid;
  int64_t nv = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double* p = points + i * f;
    std::array<int64_t, 3> c;
    for (int d = 0; d < 3; ++d)
      c[d] = (int64_t)std::floor((float)p[d] / (float)voxel_size[d]);
    auto it = vid.find(c);
    int64_t v;
    if (it == vid.end()) {
      v = nv++;
      vid.emplace(c, v);
      for (int d = 0; d < 3; ++d) coords[v * 3 + d] = c[d];
      npoints[v] = 0;
    } else {
      v = it->second;
    }
    points_mapping[i] = v;
    npoints[v] += 1;
  }
  *nvoxels = nv;
}

}  // extern "C"
