// K2 + K3: the greedy NMS suppression scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of d3d_tpu/ops/nms_pallas.py:
//   K2 `_nms_scan_kernel`    (launched by `nms_scan`, pallas_call at :67),
//   K3 `_nms_blocked_kernel` (launched by `nms_scan_blocked`, at :137).
// Both compute the same mask, so both wrappers in
// d3d_tpu_torch/ops/nms_cuda.py launch this one pair of kernels (each
// wrapper keeps its own launch count). The plain PyTorch version is
// nms_cuda.py `_nms_scan_plain`.
//
// What it computes: given the (N, N) overlap matrix in score order and the
// (N,) pre-suppression mask, walk i = 0..N-1; an unsuppressed i suppresses
// every later j > i with overlap[i, j]. Output: the (N,) suppressed mask.
//
// Design: the reference's own GPU decomposition (d3d/box/nms_cuda.cu:16-106,
// cited by the JAX module): 64-bit bitmask rows and a serial collect.
//   pass 1 (pack_overlap_kernel), parallel over rows: one warp per row packs
//     overlap[i, j] for j > i into (N, ceil(N/64)) uint64 words with two
//     __ballot_sync per word, reading the bool row coalesced;
//   pass 2 (scan_kernel), one block: the suppression words live in shared
//     memory. Rows go in chunks of 64 (one word). Thread 0 resolves the
//     chunk's 64-step chain in registers on the diagonal word (row r's
//     bits j > r inside the chunk), then the other threads OR the alive
//     rows' words into every later word in parallel. Like the Pallas
//     blocked kernel, the full-width step runs N/64 times, and every
//     thread issues its chunk's 64 loads before the chain, so a chunk
//     costs about one memory latency plus two barriers.
//
// What bounds it on this card: neither bytes (N^2 bytes read once, 0.3 MB
// at N = 512) nor operations, but the serial dependence: step i needs the
// outcome of every step before it. The chain here is N register steps plus
// N/64 block-wide barriers; pass 1 and the per-chunk OR are parallel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackWarps = 8;      // rows per block in pass 1
constexpr int kScanThreads = 256;  // threads of the single pass-2 block

typedef unsigned long long u64;

__global__ void __launch_bounds__(kPackWarps * 32)
    pack_overlap_kernel(const uint8_t* __restrict__ overlap,
                        u64* __restrict__ mask, int n, int words) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp: the row is per warp
  const uint8_t* orow = overlap + static_cast<size_t>(row) * n;
  // words before the row's own word only hold columns j < row, which a
  // row never suppresses; pass 2 never reads them
  for (int w = row >> 6; w < words; ++w) {
    const int j0 = w * 64 + lane, j1 = j0 + 32;
    const bool b0 = j0 < n && j0 > row && orow[j0];
    const bool b1 = j1 < n && j1 > row && orow[j1];
    const unsigned lo = __ballot_sync(0xffffffffu, b0);
    const unsigned hi = __ballot_sync(0xffffffffu, b1);
    if (lane == 0)
      mask[static_cast<size_t>(row) * words + w] =
          (static_cast<u64>(hi) << 32) | lo;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ pre,
                uint8_t* __restrict__ suppressed, int n, int words) {
  extern __shared__ u64 sup[];  // (words,) running suppression bits
  __shared__ u64 alive_bits;    // rows of the current chunk that survived
  const int lane = threadIdx.x & 31;

  // pre-suppression packed by warp ballots; padding bits (j >= n) start
  // suppressed, so they never become alive and their (nonexistent) mask
  // rows are never read
  for (int w = threadIdx.x >> 5; w < words; w += kScanThreads / 32) {
    const int j0 = w * 64 + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, j0 >= n || pre[j0]);
    const unsigned hi = __ballot_sync(0xffffffffu, j1 >= n || pre[j1]);
    if (lane == 0) sup[w] = (static_cast<u64>(hi) << 32) | lo;
  }
  __syncthreads();

  for (int c = 0; c < words; ++c) {
    const int r0 = c * 64;
    const int rows = min(64, n - r0);
    // thread t owns word c + t of the chunk's 64 rows: thread 0 the
    // diagonal word, the others later words. All 64 loads are issued
    // before the chain needs them, so one memory latency per chunk
    // overlaps thread 0's chain instead of 64 in a row.
    const int w = c + threadIdx.x;
    u64 v[64];
#pragma unroll
    for (int r = 0; r < 64; ++r)
      v[r] = (w < words && r < rows)
                 ? mask[static_cast<size_t>(r0 + r) * words + w]
                 : 0ull;
    if (threadIdx.x == 0) {
      u64 s = sup[c], alive = 0;
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const bool a = !((s >> r) & 1ull);
        alive |= static_cast<u64>(a) << r;
        s |= a ? v[r] : 0ull;
      }
      sup[c] = s;
      alive_bits = alive;
    }
    __syncthreads();
    const u64 alive = alive_bits;
    if (threadIdx.x > 0 && w < words) {
      u64 acc = 0;
#pragma unroll
      for (int r = 0; r < 64; ++r) acc |= ((alive >> r) & 1ull) ? v[r] : 0ull;
      sup[w] |= acc;
    }
    // words beyond the block's reach (more than 16k boxes)
    for (int w2 = w + kScanThreads; w2 < words; w2 += kScanThreads) {
      u64 acc = 0;
      for (int r = 0; r < rows; ++r)
        if ((alive >> r) & 1ull)
          acc |= mask[static_cast<size_t>(r0 + r) * words + w2];
      sup[w2] |= acc;
    }
    // the next chunk's chain reads sup[c + 1], written above
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    suppressed[j] = static_cast<uint8_t>((sup[j >> 6] >> (j & 63)) & 1ull);
}

}  // namespace

// overlap (n, n) bool, pre (n,) bool, mask (n, ceil(n/64)) 64-bit scratch,
// suppressed (n,) bool, all contiguous on the current device; stream is a
// cudaStream_t. Returns the launches' cudaGetLastError().
extern "C" int d3d_nms_scan(const uint8_t* overlap, const uint8_t* pre,
                            void* mask, uint8_t* suppressed, int n,
                            void* stream) {
  const int words = (n + 63) / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_overlap_kernel<<<(n + kPackWarps - 1) / kPackWarps, kPackWarps * 32,
                        0, s>>>(overlap, static_cast<u64*>(mask), n, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, words * sizeof(u64), s>>>(
      static_cast<const u64*>(mask), pre, suppressed, n, words);
  return static_cast<int>(cudaGetLastError());
}
