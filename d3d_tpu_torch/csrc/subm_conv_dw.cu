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
// masked by the output sites' validity, nbr (Nq, K) int32; dW is (K, C, Cout)
// f32. Submanifold maps have Nq == N, strided maps Nq < N.
//
// Design (a simple one, right first, and the same bits on every run):
//   pass 1, one block of 256 threads per (slab of `slab` query rows, offset
//   k, 64 x 64 tile of dW[k]): the block walks its slab in chunks of 64
//   rows, staging each chunk's gathered feature rows and cotangent rows in
//   shared memory as f32; each thread keeps a 4 x 4 register tile of dW[k]
//   (4 channels by 4 output columns: 4 + 4 shared loads feed 16 FMAs). Where
//   the tile has fewer than 256 such 4 x 4 pieces (C x Cout < 4096) the
//   threads split into row groups that take every groups-th row of a chunk,
//   and the groups' tiles are summed in shared memory in group order. The
//   block writes its partial sum to a workspace (K, slabs, C, Cout).
//   pass 2 sums the slabs' partials of each dW entry in slab order.
// No float atomics anywhere: every sum runs in an order fixed by the shapes,
// so two runs on the same inputs give the same bits.
//
// What bounds it on this card: the FMAs (2 * C * Cout per present
// neighbour) are few and the bytes (feat, g and nbr read once, dW written)
// fewer; at SECOND's shapes the bound is microseconds. This design is bound
// by latency instead: each chunk is a dependent gather of scattered rows
// followed by two barriers, and it multiplies the zero rows of absent
// neighbours (about 90% of them at SECOND's first stage) like present ones.
// A rule book of present pairs and tensor cores are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // c and d extent of one block's tile of dW[k]
constexpr int kMicro = 4;   // a thread's register tile is kMicro x kMicro
constexpr int kRows = 64;   // query rows staged per chunk
constexpr int kPad = 4;     // keeps float4 rows aligned, offsets the banks
constexpr int kStride = kTile + kPad;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    subm_conv_dw_partial(const T* __restrict__ feat,
                         const int* __restrict__ nbr,
                         const float* __restrict__ g,
                         float* __restrict__ part, int n, int nq, int k_off,
                         int c, int cout, int slab, int d_tiles) {
  __shared__ __align__(16) float x_s[kRows * kStride];
  __shared__ __align__(16) float g_s[kRows * kStride];
  __shared__ int src_s[kRows];

  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int kk = blockIdx.y;
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

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  const int row_begin = s * slab;
  const int row_end = min(nq, row_begin + slab);
  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    const int rows = min(kRows, row_end - r0);
    __syncthreads();  // the previous chunk's reads are done
    for (int r = tid; r < kRows; r += kThreads) {
      const int v = r < rows ? nbr[static_cast<size_t>(r0 + r) * k_off + kk]
                             : -1;
      src_s[r] = v < n ? v : -1;
    }
    __syncthreads();
    // rows past the chunk and columns past the tile stage as 0, so the
    // register tiles need no bounds checks
    for (int i = tid; i < kRows * kTile; i += kThreads) {
      const int r = i / kTile, ch = i - r * kTile;
      const int src = src_s[r];
      x_s[r * kStride + ch] =
          (src >= 0 && ch < tc)
              ? to_f32(feat[static_cast<size_t>(src) * c + c0 + ch]) : 0.f;
      g_s[r * kStride + ch] =
          (r < rows && ch < td)
              ? g[static_cast<size_t>(r0 + r) * cout + d0 + ch] : 0.f;
    }
    __syncthreads();
    if (grp < groups) {
      for (int r = grp; r < rows; r += groups) {
        const float4 a = *reinterpret_cast<const float4*>(
            &x_s[r * kStride + ci]);
        const float4 b = *reinterpret_cast<const float4*>(
            &g_s[r * kStride + dj]);
        const float av[kMicro] = {a.x, a.y, a.z, a.w};
        const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
  }

  // sum the row groups' tiles in group order, through shared memory (the
  // staging buffer x_s is free now: 64 * 68 floats >= 256 threads * 16)
  __syncthreads();
  float* red = x_s;
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

// dw[k, c, d] = sum over slabs, in slab order, of part[k, s, c, d]
__global__ void __launch_bounds__(kThreads)
    subm_conv_dw_reduce(const float* __restrict__ part,
                        float* __restrict__ dw, int k_off, int slabs,
                        int cd) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(k_off) * cd) return;
  const size_t kk = i / cd, e = i - kk * cd;
  const float* p = part + kk * slabs * cd + e;
  float sum = 0.f;
  for (int s = 0; s < slabs; ++s) sum += p[static_cast<size_t>(s) * cd];
  dw[i] = sum;
}

template <typename T>
int launch(const void* feat, const int* nbr, const float* g, float* part,
           float* dw, int n, int nq, int k_off, int c, int cout, int slab,
           cudaStream_t stream) {
  const int slabs = (nq + slab - 1) / slab;
  const int c_tiles = (c + kTile - 1) / kTile;
  const int d_tiles = (cout + kTile - 1) / kTile;
  const dim3 grid(slabs, k_off, c_tiles * d_tiles);
  subm_conv_dw_partial<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), nbr, g, part, n, nq, k_off, c, cout,
      slab, d_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(k_off) * c * cout;
  subm_conv_dw_reduce<<<static_cast<unsigned>((total + kThreads - 1)
                                              / kThreads),
                        kThreads, 0, stream>>>(part, dw, k_off, slabs,
                                               c * cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat_dtype: 0 = float32, 1 = bfloat16; g, the workspace part (K, slabs,
// C, Cout) with slabs = ceil(nq / slab), and dw are float32
extern "C" int d3d_subm_conv_dw(const void* feat, const int* nbr,
                                const float* g, float* part, float* dw, int n,
                                int nq, int k_off, int c, int cout, int slab,
                                int feat_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || slab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (feat_dtype == 0)
    return launch<float>(feat, nbr, g, part, dw, n, nq, k_off, c, cout, slab,
                         s);
  if (feat_dtype == 1)
    return launch<__nv_bfloat16>(feat, nbr, g, part, dw, n, nq, k_off, c,
                                 cout, slab, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
