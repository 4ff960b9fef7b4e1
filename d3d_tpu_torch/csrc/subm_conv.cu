// K5: the sparse-conv gather-GEMM on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// d3d_tpu/ops/sparse_conv_pallas.py (launched by `_fwd_call`, the
// pallas_call at :118), the forward of `subm_conv_fused`. The plain PyTorch
// version is d3d_tpu_torch/ops/sparse_conv_cuda.py `_subm_conv_plain`; the
// Python wrapper is `subm_conv` there.
//
// What it computes: out[n, d] = valid[n] * sum_k sum_c feat[nbr[n, k], c] *
// W[k, c, d] for n < Nq, with absent neighbours (nbr < 0) contributing 0,
// accumulated in f32 and stored in the features' type (f32 or bf16; W has
// the same type). The Pallas kernel needs Nq == N (its lane gather takes
// indices shaped like the operand); this one takes the strided maps'
// Nq < N directly.
//
// Design (a simple one, to be right first): one block of 256 threads owns
// a tile of output rows and up to 64 output columns (16, 32 or 64, the
// least that covers Cout). It loads the tile's (rows, K) neighbour rows once
// into shared memory, then for every offset k and every chunk of 32 input
// channels stages the gathered feature rows and the W[k] chunk in shared
// memory as f32 (bf16 is converted on the way in, in registers; no f32
// copy of the features exists in device memory) and accumulates 4 rows x 1
// column per thread in registers. Each W value read from shared memory
// feeds 4 FMAs; each feature value is a broadcast within a warp.
//
// What bounds it on this card: the FMAs are few (3.6 GFLOP per SECOND
// request at every offset, far less for the neighbours that exist) and the
// bytes fewer, so by the card's rates it would take microseconds. What
// bounds this design is latency: every (offset, chunk) step is a dependent
// gather of scattered rows from L2 followed by two barriers, 27 steps per
// tile, with about one block per SM at the SECOND shapes. It also multiplies
// the zeros of absent neighbours (at SECOND's density about 90% of the
// offsets are absent). Tensor cores, cp.async/TMA and a rule book of present
// pairs are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kChunk = 32;  // input channels staged per step
constexpr int kPad = kChunk + 1;  // row stride of the staged features

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    subm_conv_kernel(const T* __restrict__ feat, const int* __restrict__ nbr,
                     const T* __restrict__ w,
                     const uint8_t* __restrict__ valid, T* __restrict__ out,
                     int n, int nq, int k_off, int c, int cout, int tn) {
  extern __shared__ float smem[];
  const int tm = (kThreads / tn) * kRowsPerThread;
  int* nbr_s = reinterpret_cast<int*>(smem);  // (tm, k_off)
  float* x_s = smem + tm * k_off;             // (tm, kPad)
  float* w_s = x_s + tm * kPad;               // (kChunk, tn)

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * tm;
  const int col0 = blockIdx.y * tn;
  const int col = tid % tn;
  const int r0 = (tid / tn) * kRowsPerThread;

  // the tile's neighbour rows: one contiguous, coalesced run of nbr; rows
  // past Nq and out-of-range entries read as absent
  for (int i = tid; i < tm * k_off; i += kThreads) {
    const int v = row0 + i / k_off < nq
                      ? nbr[static_cast<size_t>(row0) * k_off + i] : -1;
    nbr_s[i] = v < n ? v : -1;
  }

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;

  for (int kk = 0; kk < k_off; ++kk) {
    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int cc = min(kChunk, c - c0);
      __syncthreads();  // the previous step's reads are done
      for (int i = tid; i < tm * cc; i += kThreads) {
        const int r = i / cc, ch = i - r * cc;
        const int src = nbr_s[r * k_off + kk];
        x_s[r * kPad + ch] =
            src >= 0 ? to_f32(feat[static_cast<size_t>(src) * c + c0 + ch])
                     : 0.f;
      }
      const T* wk = w + (static_cast<size_t>(kk) * c + c0) * cout + col0;
      for (int i = tid; i < cc * tn; i += kThreads) {
        const int ch = i / tn, j = i - ch * tn;
        w_s[i] = col0 + j < cout ? to_f32(wk[static_cast<size_t>(ch) * cout
                                             + j])
                                 : 0.f;
      }
      __syncthreads();
      for (int ch = 0; ch < cc; ++ch) {
        const float wv = w_s[ch * tn + col];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r] += x_s[(r0 + r) * kPad + ch] * wv;
      }
    }
  }

  if (col0 + col >= cout) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + r0 + r;
    if (row < nq)
      store(out + static_cast<size_t>(row) * cout + col0 + col,
            acc[r] * static_cast<float>(valid[row]));
  }
}

template <typename T>
int launch(const void* feat, const int* nbr, const void* w,
           const uint8_t* valid, void* out, int n, int nq, int k_off, int c,
           int cout, cudaStream_t stream) {
  const int tn = cout <= 16 ? 16 : cout <= 32 ? 32 : 64;
  const int tm = (kThreads / tn) * kRowsPerThread;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(tm) * (k_off + kPad)
                       + static_cast<size_t>(kChunk) * tn);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((nq + tm - 1) / tm, (cout + tn - 1) / tn);
  subm_conv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), nbr, static_cast<const T*>(w), valid,
      static_cast<T*>(out), n, nq, k_off, c, cout, tn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features, weights and output alike)
extern "C" int d3d_subm_conv(const void* feat, const int* nbr, const void* w,
                             const uint8_t* valid, void* out, int n, int nq,
                             int k_off, int c, int cout, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feat, nbr, w, valid, out, n, nq, k_off, c, cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, nbr, w, valid, out, n, nq, k_off, c,
                                 cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
