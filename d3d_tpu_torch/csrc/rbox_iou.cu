// K1: rotated-box IoU matrix on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_iou_tile_kernel` of
// d3d_tpu/ops/geometry_pallas.py (launched by `rbox_iou_matrix`, the
// pallas_call at geometry_pallas.py:177). The plain PyTorch version is
// d3d_tpu_torch/ops/geometry_soa.py `_rbox_iou_matrix_plain`; the Python
// wrapper is d3d_tpu_torch/ops/geometry_cuda.py `rbox_iou_matrix`.
//
// What it computes: out[r, c] = IoU of rotated boxes r and c, from box
// descriptors (K, 10) = [x0..x3, y0..y3, area, max |corner|] that the
// wrapper computes with torch (so the trigonometry is the plain version's).
// Per pair: 16 edge crossings + 8 corner-in-box tests -> 24 candidate
// vertices, diamond-angle keys around their centroid, the 132-comparator
// pruned Batcher network, shoelace, inter / max(union, 1e-12). The math is
// `_iou_tile_kernel`'s, line by line: the same candidates, the relative
// parallel cutoff |denom| > 1e-4 |r||s|, the containment tolerance
// (max scale + 1) 1e-5, _BIGKEY / _KEYCUT, and its shoelace order.
//
// What bounds it on this card: operations. Each pair costs ~2,300 f32
// operations (counted per block in chip_smoke.py, K1_OPS_PER_PAIR) against
// 8 bytes of output-and-input traffic, so the f32 ALU rate bounds it, by
// about two orders of magnitude over the memory rate.
//
// What the design does about it: one thread per output pair runs the whole
// chain in registers; nothing pair-shaped touches memory except the one
// output float. A 16x16 block stages its 16 row and 16 column descriptors
// in shared memory (one coalesced load per box, reused by 16 threads). The
// sort network is unrolled from compile-time index pairs (pairs24.cuh,
// generated at build time from geometry_soa._PAIRS24), so the 24-slot
// key/x/y arrays stay in registers instead of spilling to local memory.
//
// Rounding: built with -fmad=false (ops/_build.py) and without
// --use_fast_math, so every multiply, add, division and square root rounds
// exactly as the plain version's separate f32 tensor ops do. What differs
// from the plain version is the summation order of the shoelace (the Pallas
// kernel's, last edge first) and the trigonometry of the descriptors on the
// card; both stay within a few f32 ulps of IoU values in [0, 1], far inside
// the stated atol of 2e-5.

#include <cuda_runtime.h>

#include "pairs24.cuh"

namespace {

constexpr int kTileRows = 16;  // blockDim.y: row boxes per block
constexpr int kTileCols = 16;  // blockDim.x: column boxes per block
constexpr int kDesc = 10;      // floats per box descriptor
constexpr int kCand = 24;
constexpr float kBigKey = 5.0f;  // geometry_soa._BIGKEY
constexpr float kKeyCut = 4.0f;  // geometry_soa._KEYCUT

// monotone surrogate of atan2(dy, dx) on (-pi, pi] -> (-2, 2]
__device__ __forceinline__ float diamond_angle(float dx, float dy) {
  const float s = fabsf(dx) + fabsf(dy);
  const float t = dy / (s > 0.f ? s : 1.f);
  return dx >= 0.f ? t : (dy >= 0.f ? 2.f - t : -2.f - t);
}

// point (px, py) inside the CCW quad (qx, qy), with tolerance ceps
__device__ __forceinline__ bool inside(const float* qx, const float* qy,
                                       float px, float py, float ceps) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + 1) & 3;
    const float ex = qx[j] - qx[i], ey = qy[j] - qy[i];
    const float side = ex * (py - qy[i]) - ey * (px - qx[i]);
    ok &= side >= -ceps;
  }
  return ok;
}

__device__ float pair_iou(const float* a, const float* b) {
  float ax[4], ay[4], bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] = a[k];
    ay[k] = a[4 + k];
    bx[k] = b[k];
    by[k] = b[4 + k];
  }
  const float ceps = (fmaxf(a[9], b[9]) + 1.f) * 1e-5f;

  float px[kCand], py[kCand];
  bool valid[kCand];

  // 16 edge-edge crossings
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int i2 = (i + 1) & 3;
    const float rx = ax[i2] - ax[i], ry = ay[i2] - ay[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int j2 = (j + 1) & 3;
      const float sx = bx[j2] - bx[j], sy = by[j2] - by[j];
      const float denom = rx * sy - ry * sx;
      const float rs =
          sqrtf(fmaxf((rx * rx + ry * ry) * (sx * sx + sy * sy), 1e-30f));
      const bool ok = fabsf(denom) > 1e-4f * rs;
      const float dsafe = ok ? denom : 1.f;
      const float acx = bx[j] - ax[i], acy = by[j] - ay[i];
      const float t = ok ? (acx * sy - acy * sx) / dsafe : -1.f;
      const float u = ok ? (acx * ry - acy * rx) / dsafe : -1.f;
      const bool hit =
          ok && t >= 0.f && t <= 1.f && u >= 0.f && u <= 1.f;
      const int c = i * 4 + j;
      px[c] = hit ? ax[i] + t * rx : 0.f;
      py[c] = hit ? ay[i] + t * ry : 0.f;
      valid[c] = hit;
    }
  }

  // corners of each box inside the other
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ins = inside(bx, by, ax[i], ay[i], ceps);
    px[16 + i] = ins ? ax[i] : 0.f;
    py[16 + i] = ins ? ay[i] : 0.f;
    valid[16 + i] = ins;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ins = inside(ax, ay, bx[j], by[j], ceps);
    px[20 + j] = ins ? bx[j] : 0.f;
    py[20 + j] = ins ? by[j] : 0.f;
    valid[20 + j] = ins;
  }

  // centroid of the valid candidates (invalid ones hold exactly 0, so the
  // plain version's sum of x * valid is this sum of x, in the same order)
  float cnt = 0.f, sumx = 0.f, sumy = 0.f;
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    cnt = cnt + (valid[k] ? 1.f : 0.f);
    sumx = sumx + px[k];
    sumy = sumy + py[k];
  }
  const float cnt_safe = fmaxf(cnt, 1.f);
  const float cx = sumx / cnt_safe, cy = sumy / cnt_safe;

  float key[kCand];
#pragma unroll
  for (int k = 0; k < kCand; ++k)
    key[k] = valid[k] ? diamond_angle(px[k] - cx, py[k] - cy) : kBigKey;

  // the pruned Batcher network, every index a compile-time constant
#define D3D_CE(i, j)                                  \
  {                                                   \
    const bool sw = key[i] > key[j];                  \
    const float klo = fminf(key[i], key[j]);          \
    const float khi = fmaxf(key[i], key[j]);          \
    key[i] = klo;                                     \
    key[j] = khi;                                     \
    const float xi = px[i], xj = px[j];               \
    px[i] = sw ? xj : xi;                             \
    px[j] = sw ? xi : xj;                             \
    const float yi = py[i], yj = py[j];               \
    py[i] = sw ? yj : yi;                             \
    py[j] = sw ? yi : yj;                             \
  }
  D3D_PAIRS24(D3D_CE)
#undef D3D_CE

  // invalid slots collapse onto the first vertex (zero-length edges)
  const float fx = px[0], fy = py[0];
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    const bool ok = key[k] < kKeyCut;
    px[k] = (ok ? px[k] : fx) - cx;
    py[k] = (ok ? py[k] : fy) - cy;
  }

  // shoelace in the Pallas kernel's order: the closing edge first
  float area2 = px[kCand - 1] * py[0] - py[kCand - 1] * px[0];
#pragma unroll
  for (int k = 0; k < kCand - 1; ++k)
    area2 = area2 + (px[k] * py[k + 1] - py[k] * px[k + 1]);
  const float inter = fmaxf(0.5f * area2, 0.f);
  const float uni = fmaxf(a[8] + b[8] - inter, 1e-12f);
  return inter / uni;
}

__global__ void __launch_bounds__(kTileRows * kTileCols)
    rbox_iou_tile_kernel(const float* __restrict__ da,
                         const float* __restrict__ db,
                         float* __restrict__ out, int n, int m) {
  __shared__ float sa[kTileRows][kDesc];
  __shared__ float sb[kTileCols][kDesc];
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  // the tile's descriptors are contiguous runs of the (K, 10) inputs
  for (int e = tid; e < kTileRows * kDesc; e += kTileRows * kTileCols) {
    const int r = row0 + e / kDesc;
    sa[e / kDesc][e % kDesc] = r < n ? da[row0 * kDesc + e] : 0.f;
  }
  for (int e = tid; e < kTileCols * kDesc; e += kTileRows * kTileCols) {
    const int c = col0 + e / kDesc;
    sb[e / kDesc][e % kDesc] = c < m ? db[col0 * kDesc + e] : 0.f;
  }
  __syncthreads();
  const int r = row0 + threadIdx.y, c = col0 + threadIdx.x;
  if (r < n && c < m)
    out[static_cast<size_t>(r) * m + c] =
        pair_iou(sa[threadIdx.y], sb[threadIdx.x]);
}

}  // namespace

// da (n, 10) and db (m, 10) f32 descriptors, out (n, m) f32, all contiguous
// on the current device; stream is a cudaStream_t. Returns the launch's
// cudaGetLastError().
extern "C" int d3d_rbox_iou_matrix(const float* da, const float* db,
                                   float* out, int n, int m, void* stream) {
  const dim3 block(kTileCols, kTileRows);
  const dim3 grid((m + kTileCols - 1) / kTileCols,
                  (n + kTileRows - 1) / kTileRows);
  rbox_iou_tile_kernel<<<grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(da, db, out, n,
                                                              m);
  return static_cast<int>(cudaGetLastError());
}
