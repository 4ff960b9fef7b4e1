// The BEV layers' epilogue on Hopper (sm_90a): inference BatchNorm and the
// ReLU in one pass, out = relu((x - mean[c]) * mul[c] + beta[c]), over an
// NCHW map (in place or into a channel slice of a larger map) or over
// channels-last rows.
//
// Replaces no TPU kernel: the JAX package leaves each convolution,
// BatchNorm and ReLU to XLA, which fuses them. It was added so that the
// port's inference route (d3d_tpu_torch/models/pointpillars.py: `_PFN`,
// `_ConvBlock`, `_Upsample`) runs one pass over a layer's output where
// PyTorch ran a BatchNorm pass and a ReLU pass (and, around cuDNN's f32
// convolutions on channels-last maps, two layout transposes), and writes
// an upsampling's output straight into its slice of the heads' input, where
// a `torch.cat` copied it. The per-channel mean, mul = rsqrt(var + eps) *
// scale and beta come from the running statistics, computed once a layer
// by the wrapper's caller. The wrapper is d3d_tpu_torch/ops/epilogue.py
// `bn_relu`, whose plain PyTorch version `_bn_relu_plain` runs on CPU
// tensors.
//
// The arithmetic is flax's BatchNorm as the port's training route writes it
// (`_bn_train`): a subtraction, a multiplication and an addition, each
// rounded in the compute type (float for float32 and bfloat16 maps, double
// for float64; no fused multiply-add), then the ReLU
// (`r < 0 ? 0 : r`, which keeps a NaN, as torch.relu does) and one rounding
// to the map's dtype. So it equals the plain version bit for bit, and the
// convolution's weights stay as they are: folding the statistics into them
// would round every product differently.
//
// What bounds it on this card: bytes. It reads the map once and writes it
// once, three operations an element: 2 x map bytes at 3.35 TB/s (PointPillars'
// 64 x 432 x 496 float32 map: 109.7 MB, 32.8 us; an upsampling's 128 x 432 x
// 496 slice: 65.5 us). What the design does about it:
//   - each thread moves 16-byte vectors (4 float32, 8 bfloat16, 2
//     float64), four of them in flight (every load issued before the
//     first store), so a warp's access is 512 contiguous bytes;
//   - NCHW: a block covers a chunk of one (batch, channel) plane, the
//     channel is blockIdx.y and the batch blockIdx.z, so the statistics are
//     three scalar loads a block and no element divides its index by the
//     plane size. The H x W plane is dense and the channel and batch strides
//     are free, which lets an output be a channel slice of a larger map;
//   - rows (a (rows, C) channels-last map, the pillar net's): a thread owns
//     one vector of channels of every row it visits, its statistics held in
//     registers, and the block's threads tile 256 / (C / vector) rows at a
//     time, striding over the rest;
//   - where a plane, a row, a stride or a pointer does not allow 16-byte
//     vectors, the same work goes element by element (rows: the channel
//     taken as a remainder).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;
constexpr int kRowBlocks = 132 * 8;  // rows kernel: a grid that fills the SMs

template <typename T>
struct Arith {  // float32: computed in float
  using C = float;
  static __device__ __forceinline__ C in(T v) { return v; }
  static __device__ __forceinline__ T out(C v) { return v; }
};

template <>
struct Arith<double> {
  using C = double;
  static __device__ __forceinline__ C in(double v) { return v; }
  static __device__ __forceinline__ double out(C v) { return v; }
};

template <>
struct Arith<__nv_bfloat16> {
  using C = float;
  static __device__ __forceinline__ C in(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(C v) {
    return __float2bfloat16_rn(v);
  }
};

// ((v - mean) * mul) + beta, each operation rounded on its own
__device__ __forceinline__ float affine(float v, float m, float k, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, m), k), b);
}
__device__ __forceinline__ double affine(double v, double m, double k,
                                         double b) {
  return __dadd_rn(__dmul_rn(__dsub_rn(v, m), k), b);
}

template <typename T>
struct Stats {  // one channel's statistics in the compute type
  using C = typename Arith<T>::C;
  C mean, mul, beta;
  __device__ __forceinline__ T apply(T v) const {
    const C r = affine(Arith<T>::in(v), mean, mul, beta);
    return Arith<T>::out(r < C(0) ? C(0) : r);
  }
};

template <typename T>
__device__ __forceinline__ Stats<T> load_stats(
    const typename Arith<T>::C* mean, const typename Arith<T>::C* mul,
    const typename Arith<T>::C* beta, long long c) {
  return Stats<T>{mean[c], mul[c], beta[c]};
}

// Elements of T a 16-byte vector holds, and a plane block's chunk.
template <typename T>
constexpr int kPerVec = 16 / sizeof(T);
template <typename T>
constexpr int kChunk = kThreads * kVecsPerThread * kPerVec<T>;

// x and out may be the same map (in place): no __restrict__, and each
// element is read and written by the same thread.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    bn_relu_planes_kernel(const T* x, T* out,
                          const typename Arith<T>::C* mean,
                          const typename Arith<T>::C* mul,
                          const typename Arith<T>::C* beta, long long plane,
                          long long x_batch, long long x_channel,
                          long long out_batch, long long out_channel) {
  const long long c = blockIdx.y, b = blockIdx.z;
  const T* src = x + b * x_batch + c * x_channel;
  T* dst = out + b * out_batch + c * out_channel;
  const Stats<T> st = load_stats<T>(mean, mul, beta, c);
  const long long first = static_cast<long long>(blockIdx.x) * kChunk<T>;
  if (kVec) {
    const uint4* s = reinterpret_cast<const uint4*>(src + first);
    uint4* d = reinterpret_cast<uint4*>(dst + first);
    const long long nvec = (plane - first) / kPerVec<T>;
    uint4 v[kVecsPerThread];
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const long long i = threadIdx.x + k * kThreads;
      if (i < nvec) v[k] = s[i];
    }
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const long long i = threadIdx.x + k * kThreads;
      if (i < nvec) {
        T* e = reinterpret_cast<T*>(&v[k]);
#pragma unroll
        for (int j = 0; j < kPerVec<T>; ++j) e[j] = st.apply(e[j]);
        d[i] = v[k];
      }
    }
  } else {
    const long long end = min(plane, first + kChunk<T>);
    for (long long i = first + threadIdx.x; i < end; i += kThreads)
      dst[i] = st.apply(src[i]);
  }
}

// (rows, channels) contiguous, vectors: thread t owns channel vector
// t % lanes of rows t / lanes + k * (256 / lanes); lanes = channels / kPerVec
// divides nothing in the loop.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_rows_kernel(const T* x, T* out,
                        const typename Arith<T>::C* mean,
                        const typename Arith<T>::C* mul,
                        const typename Arith<T>::C* beta, long long rows,
                        int lanes) {
  const int lane = threadIdx.x % lanes;
  const int tile = kThreads / lanes;
  const int row0 = threadIdx.x / lanes;
  if (row0 >= tile) return;
  Stats<T> st[kPerVec<T>];
#pragma unroll
  for (int j = 0; j < kPerVec<T>; ++j)
    st[j] = load_stats<T>(mean, mul, beta, lane * kPerVec<T> + j);
  const uint4* s = reinterpret_cast<const uint4*>(x);
  uint4* d = reinterpret_cast<uint4*>(out);
  const long long step = static_cast<long long>(gridDim.x) * tile;
  for (long long r = static_cast<long long>(blockIdx.x) * tile + row0;
       r < rows; r += step) {
    const long long i = r * lanes + lane;
    uint4 v = s[i];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < kPerVec<T>; ++j) e[j] = st[j].apply(e[j]);
    d[i] = v;
  }
}

// (rows, channels) contiguous, element by element: the channel is the
// index's remainder.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_rows_scalar_kernel(const T* x, T* out,
                               const typename Arith<T>::C* mean,
                               const typename Arith<T>::C* mul,
                               const typename Arith<T>::C* beta,
                               long long n, int channels) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += step)
    out[i] = load_stats<T>(mean, mul, beta, i % channels).apply(x[i]);
}

template <typename T>
int launch(const void* x, void* out, const void* mean, const void* mul,
           const void* beta, int rows_layout, int vec, long long batch,
           int channels, long long plane, long long x_batch,
           long long x_channel, long long out_batch, long long out_channel,
           cudaStream_t stream) {
  using C = typename Arith<T>::C;
  const T* xs = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const C* m = static_cast<const C*>(mean);
  const C* k = static_cast<const C*>(mul);
  const C* b = static_cast<const C*>(beta);
  if (rows_layout) {  // batch = rows
    if (vec) {
      const int lanes = channels / kPerVec<T>;
      const long long tile = kThreads / lanes;
      const long long blocks = (batch + tile - 1) / tile;
      bn_relu_rows_kernel<T><<<static_cast<unsigned>(
                                   blocks < kRowBlocks ? blocks : kRowBlocks),
                               kThreads, 0, stream>>>(xs, o, m, k, b, batch,
                                                      lanes);
    } else {
      const long long n = batch * channels;
      const long long blocks = (n + kThreads - 1) / kThreads;
      bn_relu_rows_scalar_kernel<T><<<static_cast<unsigned>(
                                          blocks < kRowBlocks ? blocks
                                                              : kRowBlocks),
                                      kThreads, 0, stream>>>(xs, o, m, k, b,
                                                             n, channels);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>((plane + kChunk<T> - 1) / kChunk<T>),
                  channels, static_cast<unsigned>(batch));
  if (vec)
    bn_relu_planes_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xs, o, m, k, b, plane, x_batch, x_channel, out_batch, out_channel);
  else
    bn_relu_planes_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xs, o, m, k, b, plane, x_batch, x_channel, out_batch, out_channel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Planes (rows_layout 0): out[b, c] = epilogue(x[b, c]) for each of the
// batch x channels dense planes of `plane` elements, element strides
// between batches and channels of x and out given apart; out may be x.
// Rows (rows_layout 1): x and out (batch rows, channels) contiguous, the
// strides and plane unused. mean, mul, beta: (channels,) in the compute
// type (float, double for float64). dtype: 0 float32, 1 float64,
// 2 bfloat16. vec: every pointer, stride and the plane (rows:
// the channels) allow 16-byte vectors, and rows have at most 256 of them
// (the wrapper checks).
extern "C" int d3d_bn_relu(const void* x, void* out, const void* mean,
                           const void* mul, const void* beta, int dtype,
                           int rows_layout, int vec, long long batch,
                           int channels, long long plane, long long x_batch,
                           long long x_channel, long long out_batch,
                           long long out_channel, void* stream) {
  if (batch <= 0 || channels <= 0 || plane <= 0 ||
      (!rows_layout && (batch > 65535 || channels > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, out, mean, mul, beta, rows_layout, vec, batch,
                           channels, plane, x_batch, x_channel, out_batch,
                           out_channel, s);
    case 1:
      return launch<double>(x, out, mean, mul, beta, rows_layout, vec, batch,
                            channels, plane, x_batch, x_channel, out_batch,
                            out_channel, s);
    case 2:
      return launch<__nv_bfloat16>(x, out, mean, mul, beta, rows_layout, vec,
                                   batch, channels, plane, x_batch, x_channel,
                                   out_batch, out_channel, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
