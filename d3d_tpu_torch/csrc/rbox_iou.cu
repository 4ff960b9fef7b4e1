// K1: rotated-box IoU matrix on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_iou_tile_kernel` of
// d3d_tpu/ops/geometry_pallas.py (launched by `rbox_iou_matrix`, the
// pallas_call at geometry_pallas.py:177). The plain PyTorch version is
// d3d_tpu_torch/ops/geometry_soa.py `_rbox_iou_matrix_plain`; the Python
// wrapper is d3d_tpu_torch/ops/geometry_cuda.py `rbox_iou_matrix`, and the
// plain version of the reject test below is `_reject_plain` there.
//
// What it computes: out[r, c] = IoU of rotated boxes r and c, given as
// (K, 5) xywhr. Each block first turns its boxes into descriptors
// [x0..x3, y0..y3, area, max |corner|] with the operations, in the order,
// of `geometry_cuda.box_descriptors` (cosf/sinf, separate multiplies and
// adds, a NaN-propagating max), so they equal torch's on the card bit for
// bit. Per pair, `pair_iou`: 16 edge crossings + 8 corner-in-box tests ->
// 24 candidate vertices, diamond-angle keys around their centroid, the
// 132-comparator pruned Batcher network, shoelace, inter / max(union,
// 1e-12) -- `_iou_tile_kernel`'s math line by line: the same candidates,
// the relative parallel cutoff |denom| > 1e-4 |r||s|, the containment
// tolerance (max scale + 1) 1e-5, _BIGKEY / _KEYCUT, its shoelace order.
//
// What bounds it on this card: operations, but only for pairs that can
// overlap. The chain costs ~2,400 f32 operations a pair (chip_smoke.py
// K1_OPS_PER_PAIR); on a detector's boxes only 1-2% of pairs have extents
// that meet, and for every other pair the chain ends in exactly +0.0 (no
// candidate is valid, every vertex collapses to 0, 0 / union = +0.0). So
// the least work is the chain for the pairs that meet, a ~20-operation
// test for every pair, and the (N, M) f32 output written once.
//
// What the design does about it: a block takes a T x T tile of pairs
// (T from the shape, so that even a 100 x 100 matrix spreads over the
// SMs). Phase 1: every thread tests its pairs with the reject test below,
// writes +0.0 for a rejected pair (coalesced along the row) and queues a
// surviving (row, column) in shared memory (a warp ballot, a __popc
// prefix, one atomicAdd a warp on the block's counter). Phase 2: all
// threads drain the queue through `pair_iou`, so no lane idles on a
// rejected pair. Every in-range entry of the output is written exactly
// once: by phase 1 if rejected, by phase 2 if queued.
//
// The reject test is conservative: it rejects a pair only where no
// candidate vertex can be valid, so the chain would give +0.0 too. With
// each box's axis-aligned extent [xlo, xhi] x [ylo, yhi] taken from its
// four corners (exact: min and max round nothing), the gap between two
// boxes' extents is g = max(xlo_b - xhi_a, xlo_a - xhi_b, ylo_b - yhi_a,
// ylo_a - yhi_b). The margin covers both kinds of candidate:
//   - a crossing is valid when the computed t and u both lie in [0, 1].
//     Past the cutoff |denom| > 1e-4 |r||s| the f32 rounding of t's
//     numerator and denominator moves t by at most 6 eps 1e4 (|ac| / |r| +
//     |t|) ~ 3.6e-3 (|ac| / |r| + |t|) (eps = 2^-24; u alike), so a valid
//     crossing needs g <= 7.3e-3 |ac| + 3.7e-3 (|r| + |s|) with |ac| <=
//     2 g + E (E = the two extents' widths plus heights): g <= ~0.012 E;
//   - a corner is inside the other box when every edge's cross product
//     is >= -ceps, which lets it lie up to ceps / |e| outside an edge of
//     length |e| (plus ~6 eps |p - q| of rounding), so up to sqrt(2) ceps /
//     e_min from the box at a rectangle's corner.
// So a pair is rejected when g - 0.02 E > 0 and (g - 0.02 E) e_min > 2
// ceps, with ceps the pair's containment tolerance and e_min the shorter of
// the two boxes' shortest edges (0 for a degenerate box: never rejected).
// The factor 0.02 leaves almost 2x over the bound. A pair is never rejected
// unless every corner of both boxes is below 1e9 in magnitude (no NaN, no
// inf: a NaN gap fails the comparison by itself, an inf one would not) and
// both areas are finite, and then no product of the chain overflows.
//
// Occupancy: `pair_iou` keeps 24-slot arrays in registers; the launch
// bounds cap a thread at 128 registers (two 256-thread blocks an SM).
//
// Rounding: built with -fmad=false (ops/_build.py) and without
// --use_fast_math, so every multiply, add, division and square root rounds
// exactly as the plain version's separate f32 tensor ops do. What differs
// from the plain version is the summation order of the shoelace (the Pallas
// kernel's, last edge first); it stays within a few f32 ulps of IoU values
// in [0, 1], far inside the stated atol of 2e-5.

#include <cuda_runtime.h>
#include <math.h>

#include "pairs24.cuh"

namespace {

constexpr int kDesc = 10;      // floats per box descriptor
constexpr int kCand = 24;
constexpr float kBigKey = 5.0f;  // geometry_soa._BIGKEY
constexpr float kKeyCut = 4.0f;  // geometry_soa._KEYCUT
// the reject test (see above; geometry_cuda.py holds the same constants)
constexpr float kRejectRel = 0.02f;     // margin per metre of the extents
constexpr float kRejectMaxScale = 1e9f;  // larger corners never reject
// blocks that fill the card's 132 SMs once: the tile is the largest whose
// grid has at least this many blocks
constexpr int kFillBlocks = 132;

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

// torch.maximum: NaN if either is NaN (fmaxf would drop the NaN)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// geometry_cuda.box_descriptors, operation for operation
__device__ __forceinline__ void box_descriptor(const float* __restrict__ box,
                                               float* d) {
  const float x = box[0], y = box[1], w = box[2], h = box[3], r = box[4];
  const float dx = w * 0.5f, dy = h * 0.5f;
  const float c = cosf(r), s = sinf(r);
  const float lx[4] = {-dx, dx, dx, -dx};
  const float ly[4] = {-dy, -dy, dy, dy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k] = c * lx[k] - s * ly[k] + x;
    d[4 + k] = s * lx[k] + c * ly[k] + y;
  }
  float scale = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) scale = nan_max(scale, fabsf(d[k]));
  d[8] = w * h;
  d[9] = scale;
}

// one side of a tile: T boxes' descriptors and what the reject test reads
template <int T>
struct Side {
  float desc[T][kDesc];
  float xlo[T], xhi[T], ylo[T], yhi[T];
  float ext[T];   // extent width + height
  float emin[T];  // shortest edge
  bool ok[T];     // every corner finite and below kRejectMaxScale
};

template <int T>
__device__ __forceinline__ void stage_box(Side<T>& s, int k,
                                          const float* __restrict__ box) {
  float* d = s.desc[k];
  if (box == nullptr) {  // past the matrix's edge: never tested
#pragma unroll
    for (int e = 0; e < kDesc; ++e) d[e] = 0.f;
    s.ok[k] = false;
    return;
  }
  box_descriptor(box, d);
  float xlo = d[0], xhi = d[0], ylo = d[4], yhi = d[4], emin = INFINITY;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    xlo = fminf(xlo, d[i]);
    xhi = fmaxf(xhi, d[i]);
    ylo = fminf(ylo, d[4 + i]);
    yhi = fmaxf(yhi, d[4 + i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + 1) & 3;
    const float ex = d[j] - d[i], ey = d[4 + j] - d[4 + i];
    emin = fminf(emin, sqrtf(ex * ex + ey * ey));
  }
  s.xlo[k] = xlo;
  s.xhi[k] = xhi;
  s.ylo[k] = ylo;
  s.yhi[k] = yhi;
  s.ext[k] = (xhi - xlo) + (yhi - ylo);
  s.emin[k] = emin;
  s.ok[k] = d[9] <= kRejectMaxScale && isfinite(d[8]);
}

// true where the pair cannot overlap (see the note at the top)
template <int TA, int TB>
__device__ __forceinline__ bool rejects(const Side<TA>& a, int i,
                                        const Side<TB>& b, int j) {
  const float gap = fmaxf(fmaxf(b.xlo[j] - a.xhi[i], a.xlo[i] - b.xhi[j]),
                          fmaxf(b.ylo[j] - a.yhi[i], a.ylo[i] - b.yhi[j]));
  const float slack = gap - kRejectRel * (a.ext[i] + b.ext[j]);
  const float ceps = (fmaxf(a.desc[i][9], b.desc[j][9]) + 1.f) * 1e-5f;
  return a.ok[i] && b.ok[j] && slack > 0.f &&
         slack * fminf(a.emin[i], b.emin[j]) > 2.f * ceps;
}

// a tile's threads (one pair each up to 256) and the launch bounds' blocks
// an SM: 512 threads an SM leave a thread 128 registers
template <int T>
struct Tile {
  static constexpr int kThreads = T * T < 256 ? T * T : 256;
  static constexpr int kMinBlocks = 512 / kThreads;
};

template <int T>
__global__ void __launch_bounds__(Tile<T>::kThreads, Tile<T>::kMinBlocks)
    rbox_iou_kernel(const float* __restrict__ ba,
                    const float* __restrict__ bb, float* __restrict__ out,
                    int n, int m, int* __restrict__ chains) {
  constexpr int kThreads = Tile<T>::kThreads;
  __shared__ Side<T> sa, sb;
  __shared__ unsigned short queue[T * T];  // (row << 8) | column
  __shared__ int count;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = blockIdx.y * T, col0 = blockIdx.x * T;
  if (tid == 0) count = 0;
  // the tile's 2T boxes, one a thread
  for (int e = tid; e < 2 * T; e += kThreads) {
    if (e < T)
      stage_box(sa, e, row0 + e < n ? ba + 5 * (row0 + e) : nullptr);
    else
      stage_box(sb, e - T, col0 + e - T < m ? bb + 5 * (col0 + e - T)
                                            : nullptr);
  }
  __syncthreads();

  // phase 1: zeros for rejected pairs, the rest into the queue
#pragma unroll 1
  for (int p = tid; p < T * T; p += kThreads) {
    const int r = p / T, c = p % T;
    const bool in = row0 + r < n && col0 + c < m;
    const bool rej = in && rejects(sa, r, sb, c);
    if (rej) out[static_cast<size_t>(row0 + r) * m + col0 + c] = 0.f;
    const bool keep = in && !rej;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (ballot) {  // the same on every lane
      int base = 0;
      if (lane == 0) base = atomicAdd(&count, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (keep)
        queue[base + __popc(ballot & ((1u << lane) - 1u))] =
            static_cast<unsigned short>((r << 8) | c);
    }
  }
  __syncthreads();

  // phase 2: every thread takes queued pairs through the chain
  const int total = count;
  if (chains != nullptr && tid == 0 && total > 0) atomicAdd(chains, total);
  for (int q = tid; q < total; q += kThreads) {
    const int r = queue[q] >> 8, c = queue[q] & 0xff;
    out[static_cast<size_t>(row0 + r) * m + col0 + c] =
        pair_iou(sa.desc[r], sb.desc[c]);
  }
}

// ---------------------------------------------------------------------------
// The bit-row form, nms2d's private route (`d3d_rbox_overlap_bits`): for
// the square case of the boxes in score order it writes the (n,
// ceil(n/64)) 64-bit rows the NMS scan reads (csrc/nms_scan.cu) instead
// of the f32 matrix. Bit (i, j) is j > i and iou(i, j) > threshold: the
// chain runs with the higher-ranked box i first, as the f32 form's (i, j)
// entry does (the chain is not exactly symmetric in f32); a rejected pair's
// IoU is +0.0, so its bit is 0.0f > threshold (set for a negative
// threshold); a NaN IoU sets no bit. The descriptors, the reject test, the
// queue and `pair_iou` are the f32 form's.
//
// A block takes R rows and one 64-column word, on or above the diagonal
// (the scan never reads j <= i, so those tiles do not run: half the
// pairs). Phase 1 gives each warp 32 columns of one row, so a rejected
// pair's bit goes into the tile's word by a ballot, and queues the rest;
// phase 2 ORs the chain's bits into the word in shared memory; the block
// then writes each row's word once. The block of a row tile's own word
// also zeroes its rows' words left of it (never read; written so that
// every word of the output is written exactly once, as the output is
// torch.empty).

constexpr int kBitThreads = 256;

// the tiles on or above the diagonal of an n x n bit matrix with R-row
// tiles: row tile rt lies in word band rt / q (q = 64 / R row tiles a
// band) and takes the words from its band's on
struct BitTiles {
  int words, q, row_tiles;
  __host__ __device__ BitTiles(int n, int rows)
      : words((n + 63) / 64), q(64 / rows), row_tiles((n + rows - 1) / rows) {}
  // tiles before band b
  __host__ __device__ long long start(int b) const {
    return static_cast<long long>(q) *
           (static_cast<long long>(b) * words -
            static_cast<long long>(b) * (b - 1) / 2);
  }
  __host__ __device__ long long total() const {
    const int last = (row_tiles - 1) / q;
    return start(last) +
           static_cast<long long>(row_tiles - last * q) * (words - last);
  }
};

template <int R>
__global__ void __launch_bounds__(kBitThreads, 2)
    rbox_bits_kernel(const float* __restrict__ boxes,
                     unsigned long long* __restrict__ bits, int n, float thr,
                     int* __restrict__ chains) {
  __shared__ Side<R> sa;
  __shared__ Side<64> sb;
  __shared__ unsigned short queue[R * 64];  // (row << 8) | column
  __shared__ unsigned half[R][2];           // the tile's word, 32 bits a warp
  __shared__ int count;
  const int tid = threadIdx.x, lane = tid & 31;
  const BitTiles tiles(n, R);
  const int words = tiles.words;

  // this block's tile: its band by bisection, then row tile and word
  const long long blk = blockIdx.x;
  int lo = 0, hi = (tiles.row_tiles - 1) / tiles.q;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tiles.start(mid) <= blk) lo = mid; else hi = mid - 1;
  }
  const int per = words - lo;
  const long long idx = blk - tiles.start(lo);
  const int row0 = (lo * tiles.q + static_cast<int>(idx / per)) * R;
  const int w = lo + static_cast<int>(idx % per);
  const int col0 = w * 64;

  if (tid == 0) count = 0;
  for (int e = tid; e < R + 64; e += kBitThreads) {
    if (e < R)
      stage_box(sa, e, row0 + e < n ? boxes + 5 * (row0 + e) : nullptr);
    else
      stage_box(sb, e - R, col0 + e - R < n ? boxes + 5 * (col0 + e - R)
                                            : nullptr);
  }
  if (w == lo) {  // the rows' own word: zero the words left of it
    for (int e = tid; e < R * w; e += kBitThreads) {
      const int r = e / w;
      if (row0 + r < n)
        bits[static_cast<size_t>(row0 + r) * words + e % w] = 0ull;
    }
  }
  __syncthreads();

  // phase 1: a rejected pair's bit by ballot, the rest into the queue
  const bool zero_bit = 0.f > thr;
#pragma unroll 1
  for (int p = tid; p < R * 64; p += kBitThreads) {
    const int r = p >> 6, c = p & 63;
    const bool in = col0 + c > row0 + r && col0 + c < n;
    const bool rej = in && rejects(sa, r, sb, c);
    const unsigned set = __ballot_sync(0xffffffffu, rej && zero_bit);
    if (lane == 0) half[r][c >> 5] = set;
    const bool keep = in && !rej;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (ballot) {  // the same on every lane
      int base = 0;
      if (lane == 0) base = atomicAdd(&count, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (keep)
        queue[base + __popc(ballot & ((1u << lane) - 1u))] =
            static_cast<unsigned short>((r << 8) | c);
    }
  }
  __syncthreads();

  // phase 2: the chain for the queued pairs, box i (the row) first
  const int total = count;
  if (chains != nullptr && tid == 0 && total > 0) atomicAdd(chains, total);
  for (int q = tid; q < total; q += kBitThreads) {
    const int r = queue[q] >> 8, c = queue[q] & 0xff;
    if (pair_iou(sa.desc[r], sb.desc[c]) > thr)
      atomicOr(&half[r][c >> 5], 1u << (c & 31));
  }
  __syncthreads();
  for (int r = tid; r < R; r += kBitThreads)
    if (row0 + r < n)
      bits[static_cast<size_t>(row0 + r) * words + w] =
          (static_cast<unsigned long long>(half[r][1]) << 32) | half[r][0];
}

template <int R>
int launch_bits(const float* boxes, unsigned long long* bits, int n,
                float thr, int* chains, cudaStream_t s) {
  const long long grid = BitTiles(n, R).total();
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rbox_bits_kernel<R><<<static_cast<unsigned>(grid), kBitThreads, 0, s>>>(
      boxes, bits, n, thr, chains);
  return static_cast<int>(cudaGetLastError());
}

__global__ void rbox_descriptor_kernel(const float* __restrict__ boxes,
                                       float* __restrict__ desc, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k) {
    float d[kDesc];
    box_descriptor(boxes + 5 * i, d);
#pragma unroll
    for (int e = 0; e < kDesc; ++e) desc[kDesc * i + e] = d[e];
  }
}

template <int T>
int blocks(int n, int m) {
  return ((n + T - 1) / T) * ((m + T - 1) / T);
}

template <int T>
void launch(const float* ba, const float* bb, float* out, int n, int m,
            int* chains, cudaStream_t s) {
  const dim3 grid((m + T - 1) / T, (n + T - 1) / T);
  rbox_iou_kernel<T><<<grid, Tile<T>::kThreads, 0, s>>>(ba, bb, out, n, m,
                                                          chains);
}

}  // namespace

// boxes_a (n, 5) and boxes_b (m, 5) f32 xywhr, out (n, m) f32, all
// contiguous on the current device; chains, if not null, is an int on the
// device to which the launch adds the number of pairs that ran the chain.
// stream is a cudaStream_t. Returns the launch's cudaGetLastError().
extern "C" int d3d_rbox_iou_matrix(const float* boxes_a, const float* boxes_b,
                                   float* out, int n, int m, int* chains,
                                   void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks<64>(n, m) >= kFillBlocks)
    launch<64>(boxes_a, boxes_b, out, n, m, chains, s);
  else if (blocks<32>(n, m) >= kFillBlocks)
    launch<32>(boxes_a, boxes_b, out, n, m, chains, s);
  else if (blocks<16>(n, m) >= kFillBlocks)
    launch<16>(boxes_a, boxes_b, out, n, m, chains, s);
  else
    launch<8>(boxes_a, boxes_b, out, n, m, chains, s);
  return static_cast<int>(cudaGetLastError());
}

// boxes (n, 5) f32 xywhr in score order -> bits (n, ceil(n/64)) 64-bit
// rows, bit (i, j) = j > i and iou(i, j) > iou_threshold, every word
// written; chains as in d3d_rbox_iou_matrix (pairs j > i only). The tile
// is the largest whose grid fills the card's SMs once. Returns the
// launch's cudaGetLastError().
extern "C" int d3d_rbox_overlap_bits(const float* boxes, void* bits, int n,
                                     float iou_threshold, int* chains,
                                     void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<unsigned long long*>(bits);
  if (BitTiles(n, 64).total() >= kFillBlocks)
    return launch_bits<64>(boxes, out, n, iou_threshold, chains, s);
  if (BitTiles(n, 32).total() >= kFillBlocks)
    return launch_bits<32>(boxes, out, n, iou_threshold, chains, s);
  if (BitTiles(n, 16).total() >= kFillBlocks)
    return launch_bits<16>(boxes, out, n, iou_threshold, chains, s);
  return launch_bits<8>(boxes, out, n, iou_threshold, chains, s);
}

// boxes (k, 5) f32 xywhr -> desc (k, 10) f32: the descriptors K1's blocks
// compute, for holding them to geometry_cuda.box_descriptors on the card.
extern "C" int d3d_rbox_descriptors(const float* boxes, float* desc, int k,
                                    void* stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rbox_descriptor_kernel<<<(k + 127) / 128, 128, 0,
                           static_cast<cudaStream_t>(stream)>>>(boxes, desc,
                                                                k);
  return static_cast<int>(cudaGetLastError());
}
