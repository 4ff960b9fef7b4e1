// K2 + K3: the greedy NMS suppression scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of d3d_tpu/ops/nms_pallas.py:
//   K2 `_nms_scan_kernel`    (launched by `nms_scan`, pallas_call at :67),
//   K3 `_nms_blocked_kernel` (launched by `nms_scan_blocked`, at :137).
// Both compute the same mask, so one scan serves both; the wrappers in
// d3d_tpu_torch/ops/nms_cuda.py count its launches under K2 up to 1024
// boxes and K3 above. The plain PyTorch versions are nms_cuda.py
// `_nms_scan_plain` (bool rows) and `_nms_scan_sorted_plain` (bit rows,
// pre-suppression from the sorted scores, the mask in input order).
//
// What it computes: given the boxes' overlaps in score order as bit rows
// (row i's word w holds bit j % 64 for every j > i in [64 w, 64 w + 64)
// that box i suppresses; the words left of row i's own word i / 64 are
// never read) and the pre-suppression mask, walk i = 0..N-1; an
// unsuppressed i suppresses every later j with bit (i, j). Output: the
// (N,) suppressed mask, in score order or, given nms2d's `order`, written
// back to input order (suppressed[order[i]]). The pre-suppression comes
// either as a bool mask or, for nms2d, from the negated scores in score
// order (torch.sort(-scores)'s values): score <= score_threshold, rank 0
// exempt, a NaN score never pre-suppressed -- `nms2d`'s rule.
//
// Where the bit rows come from: nms2d's K1 writes them directly
// (csrc/rbox_iou.cu, `d3d_rbox_overlap_bits`); the public bool-matrix
// route (`nms_scan(overlap, pre)`) packs them first (`pack_overlap_kernel`,
// one warp a row, two ballots a word).
//
// What bounds it on this card: neither bytes (N^2 / 16 bytes of the upper
// triangle read once, 32 KB at N = 512) nor operations, but the serial
// dependence: step i needs the outcome of every step before it. So the
// design removes everything from the chain that is not a dependent step:
//   - up to 2048 boxes (32 words), `scan_warp_kernel`: ONE warp, lane l
//     keeping suppression word l in a register. Rows go in chunks of 64.
//     The chunk's alive rows are its diagonal words' greedy outcome; the
//     whole warp finds it as the fixed point of alive = ~(entry word | OR
//     of the alive rows' diagonal words), two redux.sync a round, which a
//     detector's sparse overlaps reach in a few rounds (each round settles
//     one more link of the longest chain of suppressions); after 8 rounds
//     the owner lane c runs the 64-step chain itself, in two 32-bit
//     halves. Then the later words OR in the alive rows' words, 1, 2 or 4
//     lanes a word, so that lanes past the last word help. No block
//     barrier at all. The chunk's rows (its diagonal word and the later
//     ones) are staged in shared memory by cp.async one chunk ahead, so
//     their latency hides behind the previous chunk; nms2d's scores come
//     with the first chunk, its order into the buffer the last chunk
//     leaves free, and the mask goes out through shared memory, a lane a
//     box. A clock64 probe (scripts/probe_nms_scan.py) splits a chunk's
//     cycles into the staging, the resolution and the ORs: all three are
//     chains of dependent or throttled instructions on one warp, and
//     cp.async is cheaper to issue from one warp than a bulk (TMA) copy a
//     row, and predicated ORs over all 64 rows cheaper than a walk over a
//     list of the alive rows: both were tried.
//   - above, `scan_block_kernel`: one block, the words in shared memory,
//     thread 0 resolving the chain and the block ORing the later words,
//     with two barriers a chunk (the same chain; only the checks and very
//     large inputs go this way).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackWarps = 8;        // rows per block in the pack kernel
// one warp, a lane a word: N <= 2048 (ops/nms_cuda.py _WARP_MAX_N)
constexpr int kWarpWords = 32;
constexpr int kBlockThreads = 256;   // the block route's threads
constexpr int kMaxWords = 6144;     // the block route's words: 48 KB
constexpr unsigned kAll = 0xffffffffu;

typedef unsigned long long u64;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// count elements from global to shared memory, a warp's lanes in turn, in
// 16-byte pieces where the source allows
template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int count,
                                        int lane) {
  constexpr int kPer = 16 / sizeof(T);
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    i0 = count / kPer * kPer;
    for (int i = lane * kPer; i < i0; i += 32 * kPer)
      cp_async<16>(dst + i, src + i);
  }
  for (int i = i0 + lane; i < count; i += 32)
    cp_async<sizeof(T)>(dst + i, src + i);
}

// box j starts suppressed: padding past n (so it is never alive and its row
// never read), else the given mask, else nms2d's score rule
__device__ __forceinline__ bool presuppressed(int j, int n,
                                              const uint8_t* pre,
                                              const float* neg, float thr) {
  if (j >= n) return true;
  if (pre != nullptr) return pre[j] != 0;
  return j > 0 && -neg[j] <= thr;
}

__global__ void __launch_bounds__(kPackWarps * 32)
    pack_overlap_kernel(const uint8_t* __restrict__ overlap,
                        u64* __restrict__ mask, int n, int words) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp: the row is per warp
  const uint8_t* orow = overlap + static_cast<size_t>(row) * n;
  // words before the row's own word only hold columns j < row, which a
  // row never suppresses; the scan never reads them
  for (int w = row >> 6; w < words; ++w) {
    const int j0 = w * 64 + lane, j1 = j0 + 32;
    const bool b0 = j0 < n && j0 > row && orow[j0];
    const bool b1 = j1 < n && j1 > row && orow[j1];
    const unsigned lo = __ballot_sync(kAll, b0);
    const unsigned hi = __ballot_sync(kAll, b1);
    if (lane == 0)
      mask[static_cast<size_t>(row) * words + w] =
          (static_cast<u64>(hi) << 32) | lo;
  }
}

// chunk c's rows, words c..words-1, into `rows`: with an even row stride
// 16-byte copies of word pairs (a lane a pair, rows of one parity), else a
// lane a word
__device__ __forceinline__ void stage_chunk(u64 (*rows)[kWarpWords],
                                            const u64* __restrict__ bits,
                                            int c, int n, int words,
                                            int lane) {
  const int nrows = min(64, n - 64 * c);
  if ((words & 1) == 0) {
    const int w = 2 * ((c >> 1) + (lane & 15));
    if (w >= words) return;
    const int r0 = lane >> 4;
    const u64* src = bits + static_cast<size_t>(64 * c + r0) * words + w;
#pragma unroll 8
    for (int r = r0; r < nrows; r += 2, src += 2 * words)
      cp_async<16>(&rows[r][w], src);
  } else {
    const int w = c + lane;
    if (w >= words) return;
    const u64* src = bits + static_cast<size_t>(64 * c) * words + w;
#pragma unroll 8
    for (int r = 0; r < nrows; ++r, src += words) cp_async<8>(&rows[r][w], src);
  }
}

// the owner lane's chain over the chunk's 64 rows on its diagonal word;
// updates the lane's suppression word and returns the chunk's alive rows.
// A diagonal word holds only bits j > r, so a row's bit is final once its
// step has passed: the alive rows are the bits still clear at the end, and
// a step is a bit test and a predicated OR. Rows 32..63 have no bits in the
// low half, and the high half of rows 0..31 does not feed their own
// decisions: two 32-step chains on 32-bit words with an OR between them.
__device__ __forceinline__ u64 resolve_chunk(u64& s,
                                             const u64 (*rows)[kWarpWords],
                                             int c) {
  const unsigned* half = reinterpret_cast<const unsigned*>(&rows[0][c]);
  constexpr int kRow = 2 * kWarpWords;  // 32-bit words a row of `rows`
  unsigned d[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) d[r] = half[r * kRow];
  unsigned lo = static_cast<unsigned>(s), hi = static_cast<unsigned>(s >> 32);
#pragma unroll
  for (int r = 0; r < 32; ++r)
    if (!(lo & (1u << r))) lo |= d[r];
  unsigned acc0 = 0u, acc1 = 0u;  // two independent ORs, not one chain
#pragma unroll
  for (int r = 0; r < 32; r += 2) {
    if (!(lo & (1u << r))) acc0 |= half[r * kRow + 1];
    if (!(lo & (2u << r))) acc1 |= half[(r + 1) * kRow + 1];
  }
  hi |= acc0 | acc1;
#pragma unroll
  for (int r = 0; r < 32; ++r) d[r] = half[(32 + r) * kRow + 1];
#pragma unroll
  for (int r = 0; r < 32; ++r)
    if (!(hi & (1u << r))) hi |= d[r];
  s = (static_cast<u64>(hi) << 32) | lo;
  return ~s;
}

// the chunk's alive rows resolved by the whole warp: lane l holds the
// diagonal words of rows l and l + 32. Starting from the rows not
// suppressed on entry (word `sc`), a round sets alive = ~(sc | the OR of
// the alive rows' diagonal words), two redux.sync ORs. The greedy outcome
// is the one fixed point (a row depends on earlier rows only), and a round
// fixes at least every row whose longest chain of earlier suppressors is
// one step shorter than before: a detector's overlaps settle in a few
// rounds. False if kRounds rounds did not settle; else `alive` holds them.
constexpr int kRounds = 8;

__device__ __forceinline__ bool resolve_chunk_warp(
    u64 sc, const u64 (*rows)[kWarpWords], int c, int lane, u64& alive) {
  const unsigned* half = reinterpret_cast<const unsigned*>(&rows[0][c]);
  constexpr int kRow = 2 * kWarpWords;  // 32-bit words a row of `rows`
  const unsigned d0lo = half[lane * kRow], d0hi = half[lane * kRow + 1];
  const unsigned d1hi = half[(lane + 32) * kRow + 1];  // no low bits
  const unsigned slo = static_cast<unsigned>(sc);
  const unsigned shi = static_cast<unsigned>(sc >> 32);
  const unsigned me = 1u << lane;
  unsigned alo = ~slo, ahi = ~shi;
#pragma unroll 1
  for (int round = 0; round < kRounds; ++round) {
    const bool a0 = alo & me, a1 = ahi & me;
    const unsigned lo = __reduce_or_sync(kAll, a0 ? d0lo : 0u);
    const unsigned hi =
        __reduce_or_sync(kAll, (a0 ? d0hi : 0u) | (a1 ? d1hi : 0u));
    const unsigned nlo = ~(slo | lo), nhi = ~(shi | hi);
    if (nlo == alo && nhi == ahi) {
      alive = (static_cast<u64>(ahi) << 32) | alo;
      return true;
    }
    alo = nlo;
    ahi = nhi;
  }
  return false;
}

// the OR of the alive rows' words into the words after chunk c, G lanes a
// word (16 rows each with G = 4): returns, on every lane of a group, its
// word's OR
template <int G>
__device__ __forceinline__ u64 or_alive(const u64 (*rows)[kWarpWords],
                                        u64 alive, int c, int words,
                                        int lane) {
  constexpr int kRows = 64 / G;
  const int w = c + 1 + lane / G;
  const int r0 = (lane % G) * kRows;
  u64 part[4] = {0ull, 0ull, 0ull, 0ull};  // four independent OR chains
  if (w < words) {
    const u64 a = alive >> r0;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if ((a >> r) & 1ull) part[r & 3] |= rows[r0 + r][w];
  }
  u64 acc = (part[0] | part[1]) | (part[2] | part[3]);
#pragma unroll
  for (int o = 1; o < G; o <<= 1) acc |= __shfl_xor_sync(kAll, acc, o);
  return acc;
}

__global__ void __launch_bounds__(32)
    scan_warp_kernel(const u64* __restrict__ bits,
                     const uint8_t* __restrict__ pre,
                     const float* __restrict__ neg, float thr,
                     const int64_t* __restrict__ order,
                     uint8_t* __restrict__ suppressed, int n, int words) {
  // two chunks' rows (32 KB); the second holds the scores until chunk 1 is
  // staged, and the one the last chunk leaves free takes nms2d's order
  __shared__ __align__(16) u64 rows[2][64][kWarpWords];
  __shared__ u64 sup[kWarpWords];  // the suppression words, at the end
  const int lane = threadIdx.x;
  float* sneg = reinterpret_cast<float*>(rows[1]);
  int64_t* perm = reinterpret_cast<int64_t*>(rows[words & 1]);

  // the scores and chunk 0's rows: one memory latency for both
  if (pre == nullptr) copy_in(sneg, neg, n, lane);
  stage_chunk(rows[0], bits, 0, n, words, lane);
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();

  // lane l's suppression word: word l of the pre-suppression, by ballots
  // (padding past n suppressed, so it is never alive; rank 0 exempt from
  // the score rule, a NaN score never pre-suppressed)
  u64 s = 0ull;
#pragma unroll 8
  for (int w = 0; w < words; ++w) {
    unsigned half[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 64 * w + 32 * h + lane;
      const int jc = min(j, n - 1);
      const bool by_rule =
          pre != nullptr ? pre[jc] != 0 : (j > 0) & (-sneg[jc] <= thr);
      half[h] = __ballot_sync(kAll, (j >= n) | by_rule);
    }
    if (lane == w) s = (static_cast<u64>(half[1]) << 32) | half[0];
  }
  __syncwarp();  // the scores are read before chunk 1 overwrites them

  for (int c = 0; c < words; ++c) {
    if (c > 0) {
      cp_async_wait_all();  // chunk c's rows
      __syncwarp();
    }
    if (c + 1 < words)
      stage_chunk(rows[(c + 1) & 1], bits, c + 1, n, words, lane);
    else if (order != nullptr)  // the last chunk leaves the other buffer free
      copy_in(perm, order, n, lane);
    cp_async_commit();
    const u64(*cur)[kWarpWords] = rows[c & 1];
    u64 alive = 0ull;
    if (!resolve_chunk_warp(__shfl_sync(kAll, s, c), cur, c, lane, alive)) {
      // a long chain of suppressions: the owner lane's 64 steps
      if (lane == c) alive = resolve_chunk(s, cur, c);
      alive = __shfl_sync(kAll, alive, c);
    }
    if (lane == c) s = ~alive;
    const int later = words - c - 1;  // warp-uniform
    if (later > 0) {
      int g;
      u64 acc;
      if (later <= 8) {
        g = 4;
        acc = or_alive<4>(cur, alive, c, words, lane);
      } else if (later <= 16) {
        g = 2;
        acc = or_alive<2>(cur, alive, c, words, lane);
      } else {
        g = 1;
        acc = or_alive<1>(cur, alive, c, words, lane);
      }
      // lane c + 1 + q takes word q's OR from its group's first lane
      acc = __shfl_sync(kAll, acc, ((lane - c - 1) * g) & 31);
      if (lane > c && lane < words) s |= acc;
    }
    __syncwarp();  // every lane is done with rows[c & 1] before c + 2
  }

  // the mask: the words through shared memory, then a lane a box
  sup[lane] = s;
  cp_async_wait_all();  // the order
  __syncwarp();
  if (order != nullptr) {
#pragma unroll 4
    for (int j = lane; j < n; j += 32)
      suppressed[perm[j]] =
          static_cast<uint8_t>((sup[j >> 6] >> (j & 63)) & 1ull);
  } else {
#pragma unroll 4
    for (int j = lane; j < n; j += 32)
      suppressed[j] = static_cast<uint8_t>((sup[j >> 6] >> (j & 63)) & 1ull);
  }
}

__global__ void __launch_bounds__(kBlockThreads)
    scan_block_kernel(const u64* __restrict__ mask,
                      const uint8_t* __restrict__ pre,
                      const float* __restrict__ neg, float thr,
                      const int64_t* __restrict__ order,
                      uint8_t* __restrict__ suppressed, int n, int words) {
  extern __shared__ u64 sup[];  // (words,) running suppression bits, then
                                // the chunk's alive rows at sup[words]
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < words; w += kBlockThreads / 32) {
    const int j = w * 64 + lane;
    const unsigned lo = __ballot_sync(kAll, presuppressed(j, n, pre, neg, thr));
    const unsigned hi =
        __ballot_sync(kAll, presuppressed(j + 32, n, pre, neg, thr));
    if (lane == 0) sup[w] = (static_cast<u64>(hi) << 32) | lo;
  }
  __syncthreads();

  for (int c = 0; c < words; ++c) {
    const int r0 = c * 64;
    const int nrows = min(64, n - r0);
    // thread t owns word c + t: thread 0 the diagonal word. All 64 loads
    // are issued before the chain needs them.
    const int w = c + threadIdx.x;
    u64 v[64];
#pragma unroll
    for (int r = 0; r < 64; ++r)
      v[r] = (w < words && r < nrows)
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
      sup[words] = alive;
    }
    __syncthreads();
    const u64 alive = sup[words];
    if (threadIdx.x > 0 && w < words) {
      u64 acc = 0;
#pragma unroll
      for (int r = 0; r < 64; ++r) acc |= ((alive >> r) & 1ull) ? v[r] : 0ull;
      sup[w] |= acc;
    }
    // words beyond the block's reach (more than 16k boxes)
    for (int w2 = w + kBlockThreads; w2 < words; w2 += kBlockThreads) {
      u64 acc = 0;
      for (int r = 0; r < nrows; ++r)
        if ((alive >> r) & 1ull)
          acc |= mask[static_cast<size_t>(r0 + r) * words + w2];
      sup[w2] |= acc;
    }
    // the next chunk's chain reads sup[c + 1] and writes sup[words]
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    suppressed[order != nullptr ? order[j] : j] =
        static_cast<uint8_t>((sup[j >> 6] >> (j & 63)) & 1ull);
}

}  // namespace

// overlap (n, n) bool -> bits (n, ceil(n/64)) 64-bit rows, the words from
// each row's own word on; all contiguous on the current device. Returns the
// launch's cudaGetLastError().
extern "C" int d3d_nms_pack(const uint8_t* overlap, void* bits, int n,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pack_overlap_kernel<<<(n + kPackWarps - 1) / kPackWarps, kPackWarps * 32,
                        0, static_cast<cudaStream_t>(stream)>>>(
      overlap, static_cast<u64*>(bits), n, (n + 63) / 64);
  return static_cast<int>(cudaGetLastError());
}

// bits (n, ceil(n/64)) 64-bit rows in score order; the pre-suppression from
// pre (n,) bool if it is not null, else from neg (n,) f32, the negated
// scores in score order, and score_threshold; order (n,) int64, if not
// null, takes row i's outcome to suppressed[order[i]]; suppressed (n,)
// bool. All contiguous on the current device; stream is a cudaStream_t.
// Returns the launch's cudaGetLastError().
extern "C" int d3d_nms_scan(const void* bits, const uint8_t* pre,
                            const float* neg, float score_threshold,
                            const int64_t* order, uint8_t* suppressed, int n,
                            void* stream) {
  const int words = (n + 63) / 64;
  if (n <= 0 || words > kMaxWords || (pre == nullptr && neg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const u64* b = static_cast<const u64*>(bits);
  if (words <= kWarpWords) {
    scan_warp_kernel<<<1, 32, 0, s>>>(b, pre, neg, score_threshold, order,
                                      suppressed, n, words);
  } else {
    const size_t smem = (words + 1) * sizeof(u64);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          scan_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    scan_block_kernel<<<1, kBlockThreads, smem, s>>>(
        b, pre, neg, score_threshold, order, suppressed, n, words);
  }
  return static_cast<int>(cudaGetLastError());
}
