// K4: the soft-NMS pick/decay cascade on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_soft_nms_kernel(method)` of
// d3d_tpu/ops/nms_pallas.py (launched by `soft_nms_scan`, the pallas_call
// at :222). The plain PyTorch version is d3d_tpu_torch/ops/nms_cuda.py
// `_soft_nms_scan_plain`; the Python wrapper is `soft_nms_scan` there.
// tests/test_torch_nms_kernels.py emulates this kernel's schedule on the
// CPU against the plain version and the Pallas kernel.
//
// What it computes (Bodla et al. 2017; semantics of nms_pallas.py:158-210):
// scores start at scores0 (pre-suppressed boxes at -inf), nothing frozen,
// suppressed = pre. Each of n steps
//   - picks the first argmax of the scores of boxes neither frozen nor
//     suppressed (every other box counts as -inf, so with no box available
//     the pick is n - 1 and `any_avail` gates every update below; while a
//     NaN score is available the max is NaN and the pick n - 1 as well);
//   - for every unfrozen j != pick with iou[pick, j] > iou_threshold, decays
//     the score: linear s * (1 - exp(p log max(iou, 1e-38))) with p = 0
//     giving 1 - 1, gaussian s * exp(-iou^2 / p);
//   - suppresses such a j if its decayed score is below score_threshold;
//   - freezes the pick.
// Once no box is available nothing changes any more, so the kernel stops
// there; the result is that of all n steps. A suppressed box is never
// available again, so its score no longer matters: only available boxes
// are decayed, and the masks are the same.
//
// What bounds it on this card: latency. Step s + 1 needs the pick of step
// s, and at a detector's thresholds a pick overlaps few boxes: the work a
// step depends on is the argmax and those few boxes, not the row of n.
//
// What the design does about it. The decay factor depends only on
// iou[pick, j] and the parameter, so it leaves the serial steps:
//   - pass 1, one warp a row, parallel over the rows: a ballot a 32-column
//     word marks the j != i with iou[i, j] > iou_threshold (the marks: n
//     ceil(n / 32) words, n^2 / 8 bytes), counts the marks before each
//     word (a byte a word, saturated at 255) and keeps the decay factors of
//     the row's first kListLen marks, computed there by the same expression;
//   - pass 2, one block: lane g of NW warps owns the C boxes gC .. gC + C -
//     1 (C <= 32: one warp up to 1024 boxes, 2 to 32 warps above; above
//     32 768 boxes 32 warps of C = 64, 128 or 256 boxes a lane), with
//     their availability and suppression bits in registers (C / 32 words
//     a lane above 32 boxes), their scores and score keys in shared
//     memory, the best key of each group of 4 of its boxes and its best
//     (key, index). A step is a warp reduction
//     (`redux.sync`: the largest key, then the least index holding it)
//     and, for NW > 1, one double-buffered slot a warp, one barrier and the
//     same reduction over the slots. Then every lane reads its word of the
//     pick's marks: a marked available box of rank r in the row takes decay
//     factor r from the list (r < kListLen) or computes it from its IoU.
//     A lane of C > 32 boxes reads one word of marks for each 32 of them.
//     A lane that decayed or froze a box rescans that box's group (4 keys)
//     and its C / 4 group bests, not its C boxes. Past the loop over a
//     lane's hits the step has no branch: in one warp the lanes' paths run
//     one after another, so every lane takes the same path.
//   - three routes: up to kStagedMaxN boxes the rows (marks, counts,
//     decays: n = 512: 56 KB; 1024: 192 KB) are copied into shared memory
//     first; above it, each step reads the pick's words from L2. Above
//     kSharedStateMaxN boxes (8 warps of 32 boxes a lane) the block grows
//     to 16 or 32 warps (1024 threads), and the scores and keys, 128 KB at
//     16 384 boxes in f32 and 256 KB in f64, leave shared memory for a
//     slice of the scratch in global memory: each lane reads and writes
//     only its own boxes' entries there (coalesced across the warp), so
//     they stay in L2 from step to step. Above 32 768 boxes the 1024 lanes
//     own 64, 128 or 256 boxes each (kMaxN = 262 144 boxes: a float32
//     matrix of more is 275 GB, which no card holds, so the allocator
//     refuses the input before the kernel is called).
//
// Rounding: built with -fmad=false (ops/_build.py) and without
// --use_fast_math; the decay is the Pallas body's expression, with
// expf/logf and the IEEE division of PyTorch's CUDA kernels, so on the card
// the masks equal the plain version's bit for bit.
//
// Float64 (d3d_soft_nms_scan_f64): the same two passes on double IoU and
// scores, with the decay in double (exp/log, the plain version's
// operation order and 1e-38 floor). The score key is 64 bits wide and
// `redux.sync` has none, so a warp's pick is three reductions: the largest
// high word, the largest low word among the lanes holding it, then the
// least index holding both; the warp stays converged. Doubles take twice
// the bytes, so the rows are staged in shared memory up to kStagedMaxNF64
// boxes (nms_cuda.py `_SOFT_STAGED_MAX_N_F64`); from there to 1024 boxes
// one warp reads them from L2.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

// the widest layout: 32 warps of 256 boxes a lane (see the header)
constexpr int kMaxN = 262144;
// up to this many boxes a lane owns at most 32 (one word of bits); above,
// 32 warps of 64, 128 or 256 boxes a lane (nms_cuda.py `_SOFT_WORD_MAX_N`)
constexpr int kWordMaxN = 32768;
// the most boxes whose scores and keys pass 2 keeps in shared memory (8
// warps; nms_cuda.py `_SOFT_SHARED_STATE_MAX_N`); above, in global memory
constexpr int kSharedStateMaxN = 8192;
// the most boxes whose rows pass 2 stages in shared memory (nms_cuda.py
// `_SOFT_STAGED_MAX_N`): one warp, up to 32 boxes a lane
constexpr int kStagedMaxN = 1024;
// the same for float64 (nms_cuda.py `_SOFT_STAGED_MAX_N_F64`): at 1024
// boxes the double decay factors and scores would not fit in 227 KB
constexpr int kStagedMaxNF64 = 512;
constexpr int kListLen = 8;         // decay factors kept a row
constexpr int kRowThreads = 256;    // pass 1: 8 rows a block
constexpr int kBlockThreads = 256;  // pass 2: all stage, NW warps cascade
constexpr int kMaxDevices = 64;

// the scratch, in int32 words (nms_cuda.py `_soft_scratch_words`): the
// decay factors (n, kListLen) of T, the marks (n, words) u32, then the
// marks before each word (n, words) u8
template <typename T>
__host__ __device__ constexpr size_t decs_words(int n) {
  return static_cast<size_t>(n) * kListLen * (sizeof(T) / 4);
}
__host__ __device__ constexpr size_t marks_words(int n) {
  return static_cast<size_t>(n) * ((n + 31) / 32);
}
template <typename T>
__host__ __device__ constexpr size_t rows_words(int n) {
  return decs_words<T>(n) + marks_words(n) + (marks_words(n) + 3) / 4;
}
// above kSharedStateMaxN boxes: the cascade's warps (16 up to 16 384
// boxes, else 32), the boxes a lane (32 up to kWordMaxN, then the least of
// 64, 128, 256 that covers n), and its scores and keys (T and a key as
// wide a box) after the rows, from a 16-byte boundary
__host__ __device__ constexpr int wide_warps(int n) {
  return n <= 2 * kSharedStateMaxN ? 16 : 32;
}
__host__ __device__ constexpr int wide_boxes(int n) {
  return n <= kWordMaxN ? 32 : n <= 2 * kWordMaxN ? 64
                             : n <= 4 * kWordMaxN ? 128 : 256;
}
template <typename T>
__host__ __device__ constexpr size_t state_offset_of(int n) {
  return (rows_words<T>(n) + 3) / 4 * 4;
}
template <typename T>
__host__ __device__ constexpr size_t scratch_words(int n) {
  return n <= kSharedStateMaxN
             ? rows_words<T>(n)
             : state_offset_of<T>(n) + static_cast<size_t>(wide_warps(n)) *
                                           32 * wide_boxes(n) * 2 *
                                           (sizeof(T) / 4);
}

template <typename T>
struct Rows {
  const T* decs;
  const uint32_t* marks;
  const uint8_t* before;
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_at(const uint32_t* base, int n) {
  return {reinterpret_cast<const T*>(base), base + decs_words<T>(n),
          reinterpret_cast<const uint8_t*>(base + decs_words<T>(n) +
                                           marks_words(n))};
}

template <bool GAUSSIAN>
__device__ __forceinline__ float decay_of(float r, float param) {
  if (GAUSSIAN) return expf(-(r * r) / param);
  const float pw =
      param == 0.f ? 1.f : expf(param * logf(fmaxf(r, 1e-38f)));
  return 1.f - pw;
}

template <bool GAUSSIAN>
__device__ __forceinline__ double decay_of(double r, double param) {
  if (GAUSSIAN) return exp(-(r * r) / param);
  const double pw = param == 0.0 ? 1.0 : exp(param * log(fmax(r, 1e-38)));
  return 1.0 - pw;
}

template <typename T, bool GAUSSIAN>
__global__ void __launch_bounds__(kRowThreads)
    soft_nms_rows_kernel(const T* __restrict__ iou,
                         uint32_t* __restrict__ scratch, int n, int words,
                         T iou_t, T param) {
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // the whole warp
  T* decs = reinterpret_cast<T*>(scratch);
  uint32_t* marks = scratch + decs_words<T>(n);
  uint8_t* before = reinterpret_cast<uint8_t*>(scratch + decs_words<T>(n) +
                                               marks_words(n));
  const T* r = iou + static_cast<size_t>(row) * n;
  const size_t w0 = static_cast<size_t>(row) * words;
  int cnt = 0;
#pragma unroll 4
  for (int w = 0; w < words; ++w) {
    const int j = w * 32 + lane;
    const T v = j < n ? r[j] : T(0);
    const bool mark = j < n && j != row && v > iou_t;
    const unsigned bits = __ballot_sync(0xffffffffu, mark);
    if (lane == 0) {
      marks[w0 + w] = bits;
      before[w0 + w] = static_cast<uint8_t>(min(cnt, 255));
    }
    const int rank = cnt + __popc(bits & ((1u << lane) - 1u));
    if (mark && rank < kListLen)
      decs[static_cast<size_t>(row) * kListLen + rank] =
          decay_of<GAUSSIAN>(v, param);
    cnt += __popc(bits);
  }
}

// a score's order key: an unsigned integer as wide as the score. 0 is no
// box; a NaN score's key, all ones, lies above every other, because the
// Pallas body's max over the available scores is NaN as soon as one of
// them is, and then its `==` matches no box and the pick is n - 1
template <typename T>
struct KeyOf;
template <>
struct KeyOf<float> {
  using type = unsigned;
};
template <>
struct KeyOf<double> {
  using type = unsigned long long;
};

// an order-preserving key of a score, above 0 (no box) and below the NaN
// key; -0 and +0 tie, as they compare equal
__device__ __forceinline__ unsigned score_key(float v) {
  if (v != v) return 0xffffffffu;
  if (v == 0.f) v = 0.f;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long score_key(double v) {
  constexpr unsigned long long kSign = 1ull << 63;
  if (v != v) return ~0ull;
  if (v == 0.0) v = 0.0;
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(v));
  return (u & kSign) ? ~u : (u | kSign);
}

// the warp's largest key and the least index holding it: a key of 32 bits
// is one `redux.sync` a step
__device__ __forceinline__ void warp_pick(unsigned k, int i, unsigned& key,
                                          int& idx) {
  key = __reduce_max_sync(0xffffffffu, k);
  idx = __reduce_min_sync(0xffffffffu, k == key ? i : INT_MAX);
}

// a key of 64 bits, which `redux.sync` has no form for: the largest high
// word, then the largest low word among the lanes that hold it (the other
// lanes give 0, below or equal to any of theirs), then the least index
__device__ __forceinline__ void warp_pick(unsigned long long k, int i,
                                          unsigned long long& key, int& idx) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned top = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, hi == top ? static_cast<unsigned>(k) : 0u);
  key = (static_cast<unsigned long long>(top) << 32) | lo;
  idx = __reduce_min_sync(0xffffffffu, k == key ? i : INT_MAX);
}

// a lane's C boxes in groups of kGroup keys: the best of each group is
// kept, so a step that touches a box scans its group only. Its bits are
// kWords words (box k: bit k % 32 of word k / 32); a group lies in one
// word, and `Dirty` holds a bit a group
template <int C>
struct Groups {
  static constexpr int kGroup = C < 4 ? C : 4;
  static constexpr int kCount = C / kGroup;
  static constexpr int kWords = (C + 31) / 32;
  using Dirty = std::conditional_t<(kCount > 32), unsigned long long,
                                   unsigned>;
};

// word `w` of a lane's bits, `w` not known at compile time: a select a
// word, so the words stay in registers
template <int W>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&bits)[W],
                                            int w) {
  uint32_t out = bits[0];
#pragma unroll
  for (int i = 1; i < W; ++i) out = i == w ? bits[i] : out;
  return out;
}

__device__ __forceinline__ int first_bit(unsigned v) { return __ffs(v) - 1; }
__device__ __forceinline__ int first_bit(unsigned long long v) {
  return __ffsll(static_cast<long long>(v)) - 1;
}

// the best (key, slot) of each group in `dirty` anew (usually one group:
// kGroup loads and selects, no branch), then of the lane: the largest key,
// and of equal keys the lowest slot (the least index)
template <int C, int LANES, typename K>
__device__ __forceinline__ void best_of(
    const uint32_t (&avail)[Groups<C>::kWords], const K* s_kk, int g, int j0,
    typename Groups<C>::Dirty dirty, K* gk, int* gs, K& bk, int& bi) {
  constexpr int kGroup = Groups<C>::kGroup, kGroups = Groups<C>::kCount;
  while (dirty) {
    const int q = first_bit(dirty);
    dirty &= dirty - 1u;
    const uint32_t aw = word_at(avail, (q * kGroup) >> 5);
    K best = 0u;
    int slot = 0;
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      const int k = q * kGroup + e;
      const K key = ((aw >> (k & 31)) & 1u) ? s_kk[k * LANES + g] : K(0);
      const bool better = key > best;
      best = better ? key : best;
      slot = better ? k : slot;
    }
#pragma unroll
    for (int r = 0; r < kGroups; ++r) {
      gk[r] = r == q ? best : gk[r];
      gs[r] = r == q ? slot : gs[r];
    }
  }
  bk = gk[0];
  bi = j0 + gs[0];
#pragma unroll
  for (int r = 1; r < kGroups; ++r) {
    const bool better = gk[r] > bk;
    bk = better ? gk[r] : bk;
    bi = better ? j0 + gs[r] : bi;
  }
  if (bk == 0u) bi = INT_MAX;
}

// the words pass 2 stages in shared memory ahead of its state, rounded up
// to 16 bytes (the state's doubles stay aligned)
template <typename T, bool STAGED>
__host__ __device__ constexpr size_t staged_words(int n) {
  return STAGED ? (rows_words<T>(n) + 3) / 4 * 4 : 0;
}

// the block of NW warps: at least kBlockThreads to stage, all lanes above;
// above 8 warps (kSharedStateMaxN boxes) the scores and keys live in the
// scratch's state slice
template <int NW>
struct Block {
  static constexpr int kThreads =
      32 * NW > kBlockThreads ? 32 * NW : kBlockThreads;
  static constexpr bool kGlobalState = NW > 8;
};

__device__ __forceinline__ void cascade_barrier(int threads) {
  // barrier 1 (0 is __syncthreads), counted in threads; not .aligned,
  // so lanes that skipped a step's update may arrive apart
  asm volatile("barrier.sync 1, %0;" ::"r"(threads) : "memory");
}

template <typename T, int C, int NW, bool STAGED, bool GAUSSIAN>
__global__ void __launch_bounds__(Block<NW>::kThreads)
    soft_nms_cascade_kernel(const T* __restrict__ iou,
                            const T* __restrict__ scores0,
                            const uint8_t* __restrict__ pre,
                            const uint32_t* __restrict__ scratch,
                            uint32_t* state,
                            uint8_t* __restrict__ suppressed, int n,
                            int words, T score_t, T param) {
  using K = typename KeyOf<T>::type;
  constexpr K kNanKey = ~K(0);
  constexpr int kLanes = 32 * NW;
  constexpr int kThreads = Block<NW>::kThreads;
  constexpr int kGroup = Groups<C>::kGroup, kGroups = Groups<C>::kCount;
  extern __shared__ __align__(16) uint32_t smem[];
  const size_t staged = staged_words<T, STAGED>(n);
  // the scores and their keys, [C][kLanes] each: in shared memory, or in
  // the scratch's state slice
  T* s_sc =
      reinterpret_cast<T*>(Block<NW>::kGlobalState ? state : smem + staged);
  K* s_kk = reinterpret_cast<K*>(s_sc + C * kLanes);
  __shared__ K s_key[2][NW];
  __shared__ int s_idx[2][NW];
  const int tid = threadIdx.x;
  for (int e = tid; e < C * kLanes; e += kThreads) {
    const int j = (e % kLanes) * C + e / kLanes;
    s_sc[e] = j < n ? scores0[j] : T(0);
    s_kk[e] = score_key(s_sc[e]);
  }
  Rows<T> rows = rows_at<T>(scratch, n);
  if constexpr (STAGED) {  // 16 bytes a load, then the odd words
    const size_t words_in = rows_words<T>(n);
    const size_t quads = words_in / 4;
    const uint4* src = reinterpret_cast<const uint4*>(scratch);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (size_t e = tid; e < quads; e += kThreads) dst[e] = src[e];
    for (size_t e = quads * 4 + tid; e < words_in; e += kThreads)
      smem[e] = scratch[e];
    rows = rows_at<T>(smem, n);
  }
  __syncthreads();
  if (tid >= kLanes) return;

  const int g = tid, lane = tid & 31, warp = tid >> 5;
  const int j0 = g * C;
  using Dirty = typename Groups<C>::Dirty;
  constexpr int kWords = Groups<C>::kWords;
  uint32_t avail[kWords] = {}, supp[kWords] = {};
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if (j0 + k < n) {
      if (pre[j0 + k])
        supp[k >> 5] |= 1u << (k & 31);
      else
        avail[k >> 5] |= 1u << (k & 31);
    }
  }
  // the best (key, slot) of each group of kGroup boxes, and the lane's
  K gk[kGroups] = {};
  int gs[kGroups] = {};
  K bk;
  int bi;
  best_of<C, kLanes>(avail, s_kk, g, j0, ~Dirty(0) >> (8 * sizeof(Dirty) -
                                                       kGroups),
                     gk, gs, bk, bi);

  for (int step = 0; step < n; ++step) {
    K key;
    int idx;
    warp_pick(bk, bi, key, idx);
    if (NW > 1) {
      const int par = step & 1;
      if (lane == 0) {
        s_key[par][warp] = key;
        s_idx[par][warp] = idx;
      }
      cascade_barrier(kLanes);
      const K wk = lane < NW ? s_key[par][lane] : K(0);
      const int wi = lane < NW ? s_idx[par][lane] : INT_MAX;
      warp_pick(wk, wi, key, idx);
    }
    if (key == 0u) break;  // nothing available: nothing changes
    // a NaN score available: the Pallas body's pick, n - 1
    const int pick = key == kNanKey ? n - 1 : idx;

    // every lane, without a branch until its hits: a lane past n reads the
    // row's last word and owns no available box
    Dirty dirty = 0u;  // the groups whose best must be found anew
#pragma unroll
    for (int wd = 0; wd < kWords; ++wd) {
      // this lane's boxes in the pick's marks: C bits of one word (C < 32)
      // or word wd of its C / 32
      const size_t at = static_cast<size_t>(pick) * words +
                        min((j0 >> 5) + wd, words - 1);
      const uint32_t w = rows.marks[at];
      const int before = rows.before[at];
      const int bit0 = j0 & 31;
      uint32_t hit =
          (C >= 32 ? w : (w >> bit0) & ((1u << (C & 31)) - 1u)) & avail[wd];
      if (hit) {
        do {
          const int kw = __ffs(hit) - 1;
          hit &= hit - 1u;
          const int k = wd * 32 + kw;
          const int rank = before + __popc(w & ((1u << (bit0 + kw)) - 1u));
          const T dec =
              rank < kListLen
                  ? rows.decs[static_cast<size_t>(pick) * kListLen + rank]
                  : decay_of<GAUSSIAN>(
                        iou[static_cast<size_t>(pick) * n + j0 + k], param);
          const T nsc = s_sc[k * kLanes + g] * dec;
          const K nk = score_key(nsc);
          s_sc[k * kLanes + g] = nsc;
          s_kk[k * kLanes + g] = nk;
          if (nsc < score_t) {
            avail[wd] &= ~(1u << kw);
            supp[wd] |= 1u << kw;
          }
          dirty |= Dirty(1) << (k / kGroup);
        } while (hit);
      }
    }
    if (pick >= j0 && pick < j0 + C) {  // freeze the pick
      const int k = pick - j0;
#pragma unroll
      for (int wd = 0; wd < kWords; ++wd)
        avail[wd] &= (k >> 5) == wd ? ~(1u << (k & 31)) : ~0u;
      dirty |= Dirty(1) << (k / kGroup);
    }
    best_of<C, kLanes>(avail, s_kk, g, j0, dirty, gk, gs, bk, bi);
  }

#pragma unroll
  for (int k = 0; k < C; ++k)
    if (j0 + k < n) suppressed[j0 + k] = (supp[k >> 5] >> (k & 31)) & 1u;
}

// cudaFuncSetAttribute costs host time on every launch it runs in: ask
// once a device for the most dynamic shared memory `kernel` has needed
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem,
                       std::atomic<int>* granted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int bytes = static_cast<int>(smem);
  if (dev < kMaxDevices && granted[dev].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev].store(bytes);
  return err;
}

template <typename T, int C, int NW, bool STAGED, bool GAUSSIAN>
cudaError_t cascade(const T* iou, const T* scores0, const uint8_t* pre,
                    uint32_t* scratch, uint8_t* suppressed, int n, int words,
                    T score_t, T param, cudaStream_t s) {
  static std::atomic<int> granted[kMaxDevices];
  constexpr bool kGlobalState = Block<NW>::kGlobalState;
  auto* kernel = soft_nms_cascade_kernel<T, C, NW, STAGED, GAUSSIAN>;
  const size_t smem =
      sizeof(uint32_t) * staged_words<T, STAGED>(n) +
      (kGlobalState ? 0
                    : (sizeof(T) + sizeof(typename KeyOf<T>::type)) * C *
                          32 * NW);
  const cudaError_t err = allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  uint32_t* state = kGlobalState ? scratch + state_offset_of<T>(n) : nullptr;
  kernel<<<1, Block<NW>::kThreads, smem, s>>>(
      iou, scores0, pre, scratch, state, suppressed, n, words, score_t,
      param);
  return cudaGetLastError();
}

template <typename T, bool GAUSSIAN>
int launch(const T* iou, const T* scores0, const uint8_t* pre,
           uint8_t* suppressed, uint32_t* scratch, int n, T iou_t, T score_t,
           T param, cudaStream_t s) {
  const int words = (n + 31) / 32;
  constexpr int kRows = kRowThreads / 32;
  soft_nms_rows_kernel<T, GAUSSIAN><<<(n + kRows - 1) / kRows, kRowThreads,
                                      0, s>>>(iou, scratch, n, words, iou_t,
                                              param);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one warp stages the rows up to kStaged boxes; float64 reads those past
  // kStagedMaxNF64 from L2 with the same warp
  constexpr int kStaged =
      sizeof(T) == sizeof(float) ? kStagedMaxN : kStagedMaxNF64;
#define D3D_CASCADE(C, NW, STAGED)                                        \
  err = cascade<T, C, NW, STAGED, GAUSSIAN>(iou, scores0, pre, scratch,   \
                                            suppressed, n, words, score_t, \
                                            param, s)
  if (n <= 32) D3D_CASCADE(1, 1, true);
  else if (n <= 64) D3D_CASCADE(2, 1, true);
  else if (n <= 128) D3D_CASCADE(4, 1, true);
  else if (n <= 256) D3D_CASCADE(8, 1, true);
  else if (n <= 512) D3D_CASCADE(16, 1, true);
  else if (n <= kStaged) D3D_CASCADE(32, 1, true);
  else if (n <= kStagedMaxN) D3D_CASCADE(32, 1, false);
  else if (n <= 2048) D3D_CASCADE(32, 2, false);
  else if (n <= 4096) D3D_CASCADE(32, 4, false);
  else if (n <= kSharedStateMaxN) D3D_CASCADE(32, 8, false);
  else if (wide_warps(n) == 16) D3D_CASCADE(32, 16, false);
  else if (wide_boxes(n) == 32) D3D_CASCADE(32, 32, false);
  else if (wide_boxes(n) == 64) D3D_CASCADE(64, 32, false);
  else if (wide_boxes(n) == 128) D3D_CASCADE(128, 32, false);
  else D3D_CASCADE(256, 32, false);
#undef D3D_CASCADE
  return static_cast<int>(err);
}

template <typename T>
int scan(const T* iou, const T* scores0, const uint8_t* pre,
         uint8_t* suppressed, uint32_t* scratch,
         long long scratch_words_given, int n, T iou_t, T score_t, T param,
         int method, void* stream) {
  // n past kMaxN has no layout, but its matrix exists on no card (header)
  if (n <= 0 || n > kMaxN || (method != 0 && method != 1) ||
      static_cast<size_t>(scratch_words_given) < scratch_words<T>(n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return method ? launch<T, true>(iou, scores0, pre, suppressed, scratch, n,
                                  iou_t, score_t, param, s)
                : launch<T, false>(iou, scores0, pre, suppressed, scratch, n,
                                   iou_t, score_t, param, s);
}

}  // namespace

// iou (n, n) f32, scores0 (n,) f32, pre (n,) bool, suppressed (n,) bool
// out, scratch of scratch_words_given int32 (at least nms_cuda.py
// `_soft_scratch_words(n)`: above kSharedStateMaxN boxes it holds the
// cascade's scores and keys too), all contiguous on the current device;
// 1 <= n <= kMaxN. method: 0 = linear,
// 1 = gaussian. Returns the first launch error.
extern "C" int d3d_soft_nms_scan(const float* iou, const float* scores0,
                                 const uint8_t* pre, uint8_t* suppressed,
                                 uint32_t* scratch,
                                 long long scratch_words_given, int n,
                                 float iou_t, float score_t,
                                 float param, int method, void* stream) {
  return scan<float>(iou, scores0, pre, suppressed, scratch,
                     scratch_words_given, n, iou_t, score_t, param, method,
                     stream);
}

// the same for float64 iou and scores0, the thresholds and parameter in
// double; scratch of at least `_soft_scratch_words(n, 8)` int32
extern "C" int d3d_soft_nms_scan_f64(const double* iou, const double* scores0,
                                     const uint8_t* pre, uint8_t* suppressed,
                                     uint32_t* scratch,
                                     long long scratch_words_given, int n,
                                     double iou_t, double score_t,
                                     double param, int method, void* stream) {
  return scan<double>(iou, scores0, pre, suppressed, scratch,
                      scratch_words_given, n, iou_t, score_t, param, method,
                      stream);
}
