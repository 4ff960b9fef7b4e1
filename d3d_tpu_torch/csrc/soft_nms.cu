// K4: the soft-NMS pick/decay cascade on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_soft_nms_kernel(method)` of
// d3d_tpu/ops/nms_pallas.py (launched by `soft_nms_scan`, the pallas_call
// at :222). The plain PyTorch version is d3d_tpu_torch/ops/nms_cuda.py
// `_soft_nms_scan_plain`; the Python wrapper is `soft_nms_scan` there.
//
// What it computes (Bodla et al. 2017; semantics of nms_pallas.py:158-210):
// scores start at scores0 (pre-suppressed boxes at -inf), nothing frozen,
// suppressed = pre. Each of n steps
//   - picks the first argmax of the scores of boxes neither frozen nor
//     suppressed (every other box counts as -inf, so with no box available
//     the pick is box 0 and `any_avail` gates every update below);
//   - for every unfrozen j != pick with iou[pick, j] > iou_threshold, decays
//     the score: linear s * (1 - exp(p log max(iou, 1e-38))) with p = 0
//     giving 1 - 1, gaussian s * exp(-iou^2 / p);
//   - suppresses such a j if its decayed score is below score_threshold;
//   - freezes the pick.
// Once no box is available nothing changes any more, so the kernel stops
// there; the result is that of all n steps.
//
// Design: one block runs the serial steps. Thread t owns boxes t, t + T,
// ..., (ITEMS of them) and keeps their score, frozen and suppressed state in
// registers. A step is a (max score, min index) reduction: in registers,
// then across the warp with shuffles, then across warps through a
// double-buffered slot per warp in shared memory, so one barrier a step
// suffices (every warp finishes the reduction itself). Then every thread
// reads its boxes of row `pick` (coalesced: neighbouring threads, neighbouring
// columns) and updates its own state.
//
// What bounds it on this card: latency, not bytes or operations. Step s+1
// needs the pick of step s; each step costs one block-wide barrier, a
// shuffle reduction and one dependent read of a row from L2 (the matrix,
// n^2 f32, is read at most once per row).
//
// Rounding: built with -fmad=false (ops/_build.py) and without
// --use_fast_math; the operation order is the Pallas body's, and expf/logf
// and the IEEE division are those of PyTorch's CUDA kernels, so on the card
// the masks equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxItems = 8;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    better(v, i, ov, oi);
  }
}

template <int ITEMS, bool GAUSSIAN>
__global__ void __launch_bounds__(kMaxThreads)
    soft_nms_kernel(const float* __restrict__ iou,
                    const float* __restrict__ scores0,
                    const uint8_t* __restrict__ pre,
                    uint8_t* __restrict__ suppressed, int n, float iou_t,
                    float score_t, float param) {
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  float sc[ITEMS];
  bool fr[ITEMS], su[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int j = tid + it * nt;
    sc[it] = j < n ? scores0[j] : -INFINITY;
    su[it] = j >= n || pre[j];  // padding is never available
    fr[it] = false;
  }

  for (int step = 0; step < n; ++step) {
    float bv = -INFINITY;
    int bi = n;
    bool any = false;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int j = tid + it * nt;
      if (j < n) {
        const bool avail = !fr[it] && !su[it];
        any |= avail;
        better(bv, bi, avail ? sc[it] : -INFINITY, j);
      }
    }
    warp_best(bv, bi);
    const int par = step & 1;
    if (lane == 0) {
      red_v[par][warp] = bv;
      red_i[par][warp] = bi;
    }
    if (!__syncthreads_or(any)) break;  // nothing available: nothing changes
    bv = lane < nwarps ? red_v[par][lane] : -INFINITY;
    bi = lane < nwarps ? red_i[par][lane] : n;
    warp_best(bv, bi);
    const int pick = min(bi, n - 1);

    const float* row = iou + static_cast<size_t>(pick) * n;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int j = tid + it * nt;
      if (j < n) {
        const float r = row[j];
        const bool m = r > iou_t && !fr[it] && j != pick;
        float decay;
        if (GAUSSIAN) {
          decay = expf(-(r * r) / param);
        } else {
          const float pw =
              param == 0.f ? 1.f : expf(param * logf(fmaxf(r, 1e-38f)));
          decay = 1.f - pw;
        }
        const float nsc = m ? sc[it] * decay : sc[it];
        su[it] = su[it] || (m && nsc < score_t);
        fr[it] = fr[it] || j == pick;
        sc[it] = nsc;
      }
    }
  }

#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int j = tid + it * nt;
    if (j < n) suppressed[j] = su[it];
  }
}

template <bool GAUSSIAN>
int launch(const float* iou, const float* scores0, const uint8_t* pre,
           uint8_t* suppressed, int n, float iou_t, float score_t,
           float param, cudaStream_t s) {
  const int threads = n < kMaxThreads ? (n + 31) / 32 * 32 : kMaxThreads;
  const int need = (n + threads - 1) / threads;
  const int items = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
#define D3D_SOFT_NMS(I)                                                   \
  soft_nms_kernel<I, GAUSSIAN><<<1, threads, 0, s>>>(                    \
      iou, scores0, pre, suppressed, n, iou_t, score_t, param)
  if (items == 1) D3D_SOFT_NMS(1);
  else if (items == 2) D3D_SOFT_NMS(2);
  else if (items == 4) D3D_SOFT_NMS(4);
  else D3D_SOFT_NMS(8);
#undef D3D_SOFT_NMS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// method: 0 = linear, 1 = gaussian. n is at most kMaxThreads * kMaxItems
// (8192; nms_cuda.py `_SOFT_MAX_N`).
extern "C" int d3d_soft_nms_scan(const float* iou, const float* scores0,
                                 const uint8_t* pre, uint8_t* suppressed,
                                 int n, float iou_t, float score_t,
                                 float param, int method, void* stream) {
  if (n <= 0 || n > kMaxThreads * kMaxItems || (method != 0 && method != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return method ? launch<true>(iou, scores0, pre, suppressed, n, iou_t,
                               score_t, param, s)
                : launch<false>(iou, scores0, pre, suppressed, n, iou_t,
                                score_t, param, s);
}
