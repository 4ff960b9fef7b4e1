// K6: the weight gradient of the sparse-conv gather-GEMM on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dw_kernel` of
// d3d_tpu/ops/sparse_conv_pallas.py (launched by `_dw_call`, the pallas_call
// at :139), the d/dweights half of `subm_conv_fused`'s backward. The plain
// PyTorch version is d3d_tpu_torch/ops/sparse_conv_cuda.py
// `_subm_conv_dw_plain`; the Python wrapper is `subm_conv_dw` there.
//
// What it computes: dW[k, c, d] = sum_{n < Nq} feat[nbr[n, k], c] * g[n, d],
// absent neighbours (nbr < 0) contributing 0, in f32. feat is (N, C) f32 or
// bf16 (converted in registers), g the (Nq, Cout) f32 cotangent already
// masked by the output sites' validity; dW is (K, C, Cout) f32. It walks
// the map's rule book (ops/rulebook.py `RuleBook.pairs`): for each offset k
// the `counts[k]` query rows that have it, in ascending order; each one's
// input row is read from the map.
//
// What bounds it on this card: 2 * C * Cout operations per pair that exists
// and the bytes of feat, g and the lists read once; microseconds by the
// card's rates. The cotangent is f32 in the JAX package, so the products
// stay in f32 FFMA: a bf16 tensor-core product would round it.
//
// Design:
//   pass 1, one block of 256 threads per (slab of `slab` entries of offset
//   k's list, k, 64 x 64 tile of dW[k]). Slabs past the end of a list exit
//   at once: only pairs that exist are multiplied. The block loads its
//   slab's pairs into shared memory, then streams chunks of the gathered
//   feature rows and cotangent rows through a 4-stage ring filled by
//   cp.async (16, 8 or 4 bytes a copy), so three chunks' gathers are in
//   flight while it multiplies the fourth. A staged row is as wide as the
//   tile's columns (4 floats at C = 4, not 64), and a chunk holds as many
//   rows as fit a fixed 17 KB (32 rows at 64 x 64, 152 at 4 x 16), so a
//   narrow layer takes few, full steps. Each thread keeps a 4 x 4 register
//   tile of dW[k] (4 channels by 4 output columns: two shared loads feed 16
//   FMAs). Where the tile has fewer than 256 such pieces (C x Cout < 4096)
//   the threads split into row groups that take every groups-th pair of a
//   chunk, and the groups' tiles are summed in shared memory in group
//   order. The block writes its partial sum to a workspace (K, slabs, C,
//   Cout).
//   pass 2 sums each dW entry's partials over the slabs its list has, in
//   slab order.
// The partition into slabs is fixed by the map alone, and no float atomic
// is used: two runs on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // c and d extent of one block's tile of dW[k]
constexpr int kMicro = 4;   // a thread's register tile is kMicro x kMicro
constexpr int kStages = 4;
constexpr int kStageBytes = 32 * (68 + 68) * 4;  // 32 rows of a 64 x 64 tile
constexpr int kMaxRows = 256;                    // rows of one chunk
constexpr int kMaxDevices = 64;

using bf16 = __nv_bfloat16;

// the staging layout of one launch: row strides (elements) of the feature
// and cotangent tiles, as wide as the widest tile's columns plus a pad that
// keeps rows 16-byte aligned and shifts the banks, and the rows a chunk
struct Layout {
  int ldx, ldg, rows;
};

template <typename T>
Layout layout(int c, int cout) {
  const int tc = c < kTile ? c : kTile, td = cout < kTile ? cout : kTile;
  Layout l;
  l.ldx = sizeof(T) == 4 ? (tc + 3) / 4 * 4 + 4 : (tc + 7) / 8 * 8 + 8;
  l.ldg = (td + 3) / 4 * 4 + 4;
  const int row = l.ldx * static_cast<int>(sizeof(T)) + l.ldg * 4;
  l.rows = kStageBytes / row / 8 * 8;
  l.rows = l.rows > kMaxRows ? kMaxRows : l.rows;
  return l;
}

template <typename T>
size_t smem_bytes(const Layout& l, int slab) {
  return static_cast<size_t>(kStages) * l.rows
             * (sizeof(T) * l.ldx + sizeof(float) * l.ldg)
         + 2 * sizeof(int) * static_cast<size_t>(slab);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(fill ? BYTES : 0));
}

__device__ __forceinline__ void copy_unit(void* dst, const void* src,
                                          int vec, bool fill) {
  if (vec == 16)
    cp_async<16>(dst, src, fill);
  else if (vec == 8)
    cp_async<8>(dst, src, fill);
  else
    cp_async<4>(dst, src, fill);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    subm_conv_dw_partial(const T* __restrict__ feat,
                         const int* __restrict__ nbr,
                         const int* __restrict__ pair_out,
                         const int64_t* __restrict__ counts,
                         const float* __restrict__ g,
                         float* __restrict__ part, int n, int nq,
                         int k_off, int c, int cout, int slab, int d_tiles,
                         int vec_x, int vec_g, Layout lay) {
  const int ldx = lay.ldx, ldg = lay.ldg, chunk_rows = lay.rows;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);          // kStages x rows x ldx
  float* gs = reinterpret_cast<float*>(xs + kStages * chunk_rows * ldx);
  int* in_s = reinterpret_cast<int*>(gs + kStages * chunk_rows * ldg);
  int* out_s = in_s + slab;

  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int kk = blockIdx.y;
  const int j0 = s * slab;
  const int count = static_cast<int>(counts[kk]);
  if (j0 >= count) return;  // past the end of this offset's list
  const int rows = min(slab, count - j0);
  const int c0 = (blockIdx.z / d_tiles) * kTile;
  const int d0 = (blockIdx.z % d_tiles) * kTile;
  const int tc = min(kTile, c - c0);
  const int td = min(kTile, cout - d0);
  const int mc = (tc + kMicro - 1) / kMicro;
  const int md = (td + kMicro - 1) / kMicro;
  const int nmicro = mc * md;          // <= 256
  const int groups = kThreads / nmicro;
  const int micro = tid % nmicro;
  const int grp = tid / nmicro;        // grp >= groups: loads only
  const int ci = (micro / md) * kMicro;
  const int dj = (micro % md) * kMicro;

  // row k of the list starts k * (nq + 1) entries in (ops/rulebook.py)
  const size_t base = static_cast<size_t>(kk) * (nq + 1) + j0;
  for (int i = tid; i < rows; i += kThreads) {
    const int q = pair_out[base + i];
    const int v = nbr[static_cast<size_t>(q) * k_off + kk];
    in_s[i] = v < n ? v : -1;
    out_s[i] = q;
  }
  __syncthreads();

  const int chunks = (rows + chunk_rows - 1) / chunk_rows;
  // copies a staged row: the tile's columns rounded up to 4 (the register
  // tiles read 4 at a time; the columns past tc / td stage as zeros)
  const int epx = vec_x / static_cast<int>(sizeof(T));
  const int upx = ((tc + 3) / 4 * 4 + epx - 1) / epx;
  const int epg = vec_g / static_cast<int>(sizeof(float));
  const int upg = (td + 3) / 4 * 4 / epg;
  // stage chunk `ch`'s feature rows (columns c0..) and cotangent rows
  // (columns d0..); pairs past the slab stage as zeros and are not
  // multiplied
  // a thread's copies advance by kThreads copies at a time: whole rows
  // (kThreads / upx) plus a column remainder, walked without a division
  const int qx = kThreads / upx, rx = kThreads - qx * upx;
  const int qg = kThreads / upg, rg = kThreads - qg * upg;
  auto issue = [&](int ch) {
    const int st = ch % kStages;
    const int r0 = ch * chunk_rows;
    T* xd = xs + st * chunk_rows * ldx;
    for (int r = tid / upx, cu = tid - (tid / upx) * upx; r < chunk_rows;) {
      const int col = cu * epx;
      const int src = r0 + r < rows ? in_s[r0 + r] : -1;
      const bool fill = src >= 0 && col < tc;
      copy_unit(xd + r * ldx + col,
                fill ? feat + static_cast<size_t>(src) * c + c0 + col : feat,
                vec_x, fill);
      r += qx;
      cu += rx;
      if (cu >= upx) cu -= upx, ++r;
    }
    float* gd = gs + st * chunk_rows * ldg;
    for (int r = tid / upg, cu = tid - (tid / upg) * upg; r < chunk_rows;) {
      const int col = cu * epg;
      const bool fill = r0 + r < rows && col < td;
      copy_unit(gd + r * ldg + col,
                fill ? g + static_cast<size_t>(out_s[r0 + r]) * cout + d0
                           + col
                     : g,
                vec_g, fill);
      r += qg;
      cu += rg;
      if (cu >= upg) cu -= upg, ++r;
    }
  };

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < chunks) issue(q);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1 is consumed
    if (ch + kStages - 1 < chunks) issue(ch + kStages - 1);
    cp_async_commit();
    if (grp < groups) {
      const int st = ch % kStages;
      const T* xa = xs + st * chunk_rows * ldx + ci;
      const float* gb = gs + st * chunk_rows * ldg + dj;
      const int nr = min(chunk_rows, rows - ch * chunk_rows);
      for (int r = grp; r < nr; r += groups) {
        const float4 a = load4(xa + r * ldx);
        const float4 b = load4(gb + r * ldg);
        const float av[kMicro] = {a.x, a.y, a.z, a.w};
        const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
  }
  cp_async_wait<0>();

  // sum the row groups' tiles in group order, through shared memory (the
  // staging ring is free now: it holds >= 256 threads * 16 floats)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (grp < groups) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        red[(grp * nmicro + micro) * kMicro * kMicro + i * kMicro + j] =
            acc[i][j];
  }
  __syncthreads();
  float* out = part + ((static_cast<size_t>(kk) * gridDim.x + s) * c) * cout;
  for (int e = tid; e < nmicro * kMicro * kMicro; e += kThreads) {
    const int m = e / (kMicro * kMicro), ij = e - m * kMicro * kMicro;
    const int cc = (m / md) * kMicro + ij / kMicro;
    const int dd = (m % md) * kMicro + ij % kMicro;
    if (cc >= tc || dd >= td) continue;
    float sum = 0.f;
    for (int q = 0; q < groups; ++q) sum += red[(q * nmicro) * kMicro * kMicro
                                                + e];
    out[static_cast<size_t>(c0 + cc) * cout + d0 + dd] = sum;
  }
}

// dw[k, c, d] = sum, in slab order, of part[k, s, c, d] over the slabs that
// offset k's list fills (none: 0)
__global__ void __launch_bounds__(kThreads)
    subm_conv_dw_reduce(const float* __restrict__ part,
                        const int64_t* __restrict__ counts,
                        float* __restrict__ dw, int k_off, int slabs,
                        int slab, int cd) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(k_off) * cd) return;
  const size_t kk = i / cd, e = i - kk * cd;
  const int filled = static_cast<int>((counts[kk] + slab - 1) / slab);
  const float* p = part + kk * slabs * cd + e;
  float sum = 0.f;
  for (int s = 0; s < filled; ++s) sum += p[static_cast<size_t>(s) * cd];
  dw[i] = sum;
}

template <typename T>
int launch(const void* feat, const int* nbr, const int* pair_out,
           const int64_t* counts, const float* g, float* part, float* dw,
           int n, int nq, int k_off, int c, int cout, int slab, int vec_x,
           int vec_g, cudaStream_t stream) {
  const Layout lay = layout<T>(c, cout);
  // cudaFuncSetAttribute costs host time on every launch it runs in: ask
  // once a device for the most shared memory this kernel has needed there
  static std::atomic<int> granted[kMaxDevices];
  const int smem = static_cast<int>(smem_bytes<T>(lay, slab));
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || granted[dev].load() < smem) {
      err = cudaFuncSetAttribute(subm_conv_dw_partial<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) granted[dev].store(smem);
    }
  }
  const int slabs = (nq + slab - 1) / slab;
  const int c_tiles = (c + kTile - 1) / kTile;
  const int d_tiles = (cout + kTile - 1) / kTile;
  const dim3 grid(slabs, k_off, c_tiles * d_tiles);
  subm_conv_dw_partial<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), nbr, pair_out, counts, g, part, n, nq,
      k_off, c, cout, slab, d_tiles, vec_x, vec_g, lay);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(k_off) * c * cout;
  subm_conv_dw_reduce<<<static_cast<unsigned>((total + kThreads - 1)
                                              / kThreads),
                        kThreads, 0, stream>>>(part, counts, dw, k_off, slabs,
                                               slab, c * cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nbr: the (nq, k_off) int32 map; pair_out: (k_off, nq) int32 lists with
// rows nq + 1 apart, row k's first counts[k] entries the query rows that
// have offset k; counts: (k_off,) int64 on the device. feat_dtype: 0 = float32, 1 = bfloat16; g, the
// workspace part (k_off, slabs, C, Cout) with slabs = ceil(nq / slab), and
// dw are float32. vec_x / vec_g: the bytes of one asynchronous copy (16, 8
// or 4) dividing a row of feat / of g and their start addresses.
extern "C" int d3d_subm_conv_dw(const void* feat, const int* nbr,
                                const int* pair_out, const int64_t* counts,
                                const float* g, float* part, float* dw, int n,
                                int nq, int k_off, int c, int cout, int slab,
                                int feat_dtype, int vec_x, int vec_g,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = feat_dtype == 0 ? 4 : 2;
  const bool vec_ok = (vec_x == 4 || vec_x == 8 || vec_x == 16)
                      && (vec_g == 4 || vec_g == 8 || vec_g == 16)
                      && (c * elem) % vec_x == 0 && (cout * 4) % vec_g == 0;
  if (n <= 0 || nq <= 0 || c <= 0 || cout <= 0 || k_off <= 0 || slab <= 0
      || !vec_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  if (feat_dtype == 0)
    return launch<float>(feat, nbr, pair_out, counts, g, part, dw, n, nq,
                         k_off, c, cout, slab, vec_x, vec_g, s);
  if (feat_dtype == 1)
    return launch<bf16>(feat, nbr, pair_out, counts, g, part, dw, n, nq,
                        k_off, c, cout, slab, vec_x, vec_g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
