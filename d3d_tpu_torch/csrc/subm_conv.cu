// K5: the sparse-conv gather-GEMM on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// d3d_tpu/ops/sparse_conv_pallas.py (launched by `_fwd_call`, the
// pallas_call at :118), the forward of `subm_conv_fused`, and serves its
// backward too: the features' gradient of a submanifold layer is this
// kernel on the cotangent with mirrored weights. The plain PyTorch version
// is d3d_tpu_torch/ops/sparse_conv_cuda.py `_subm_conv_plain`; the Python
// wrapper is `subm_conv` there.
//
// What it computes: out[n, d] = valid[n] * sum_k sum_c feat[nbr[n, k], c] *
// W[k, c, d] for n < Nq, absent neighbours (nbr < 0) contributing 0,
// accumulated in f32 and stored in the features' type (f32 or bf16; W has
// the same type). Strided maps (Nq < N) are taken directly.
//
// What bounds it on this card: very little arithmetic (2 * C * Cout per
// neighbour that exists, 1.4 GFLOP for a SECOND request) on rows gathered
// from all over an L2-resident feature table. By the card's rates that is
// tens of microseconds; what costs time is latency (a gather, then the
// products, with nothing overlapping them) and work on absent neighbours,
// 41-92% of all (row, offset) pairs at SECOND's layers.
//
// Design:
//  - Output-stationary. A block owns a tile of 2048 outputs: TN = 16, 32
//    or 64 columns (the least that covers Cout) by TM = 2048 / TN rows.
//    Its 256 threads form two groups that each hold the whole tile (4 x 4
//    outputs a thread in f32, m16n8 fragments in bf16) and split every
//    step's (offset, channel) pairs in halves; at the end the second
//    group's sums are added to the first's. So each output's sum runs in
//    one block, over the offsets in ascending order within each half, and
//    the two halves join in a fixed order: no atomics, the same bits on
//    every run. (At SECOND's sizes one group alone would leave one warp
//    per scheduler, and the tile is bound by latency, not arithmetic.)
//  - The rows come in the rule book's order (ops/rulebook.py: rows stably
//    sorted by their 27-bit presence mask), so the rows of a tile share
//    their offsets. The block ORs its rows' presence into ceil(K / 32)
//    mask words and walks only the offsets that some row of the tile has;
//    a tile of rows without neighbours (padding, invalid sites) does no
//    work and writes zeros. Every output row is written. Any K: a map of
//    more than 31 offsets (kernel_size 4: 64, 5: 125) sorts its rows by a
//    31-bit fold of their masks (offset k on bit k mod 31), which still
//    groups rows of like offsets; the order only groups rows, the sums
//    run over each tile's present offsets ascending all the same. The
//    tile's neighbour rows are staged in shared memory while they fit
//    (up to ~200 offsets at 2048 outputs a tile); past that, each step
//    reads its rows' entries from the map in L2.
//  - The tile's work is one axis of (offset, channel) pairs: its present
//    offsets ascending, each one's C channels ascending. A step stages 64
//    of them, so where C < 64 one step carries several offsets (C = 4: 16
//    of them) instead of a mostly idle step per offset.
//  - Gathers are asynchronous: each step stages the tile's gathered rows
//    and the matching rows of W in a 3-stage shared-memory ring filled by
//    cp.async (L2-only for 16-byte copies), so two steps' gathers are in
//    flight while the block multiplies the third. Each thread's copies in
//    a step share one column, so a step costs a thread one integer
//    division, not one a copy. Absent rows and the pairs past the tile's
//    last offset are zero-filled by the copy itself (src-size 0). Copies
//    are 16, 8 or 4 bytes, the widest that divides a row (C = 4 in f32 is
//    one 16-byte copy a row; in bf16 one 8-byte copy).
//  - f32 multiplies in full-precision FFMA (TF32 would miss the f32
//    contract), 4 x 4 outputs a thread from float4 shared loads: 8 loads
//    feed 64 FMAs.
//  - bf16 multiplies on the tensor cores with f32 accumulators, with
//    mma.sync m16n8k16 rather than wgmma: the operand tiles are rebuilt
//    from gathered rows every step and are small (64 pairs, at most 64
//    columns); wgmma wants 64-row warpgroup tiles in its own swizzled
//    shared-memory layout, and at these sizes the tensor cores are far
//    from the limit. C = 4 needs no padding: the step axis packs 16
//    offsets' channels.
//  - TMA is not used: it cannot gather arbitrary rows, and W[k]'s chunk is
//    a few KB that the same cp.async ring carries.
//
// The rule book's build for all of a request's maps, two more kernels
// (`rulebook_masks_kernel`, `rulebook_pass_kernel`), is at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 128;       // threads that hold one copy of the tile
constexpr int kTileElems = 2048;  // outputs per block
constexpr int kStages = 3;        // depth of the cp.async ring
// the rule book's presence mask: one bit a row per offset, 31 of them;
// a map of more offsets folds offset k onto bit k mod 31
constexpr int kMaxOffsets = 31;
// the most dynamic shared memory a block may take on this card
constexpr size_t kMaxSmem = 227 * 1024;
// (offset, channel) pairs staged a step, each of the two thread groups
// taking half (f32: 32 channels; bf16: two k16 fragments)
constexpr int kStep = 64;
static_assert((kStep & (kStep - 1)) == 0, "a row's copies are counted by "
              "shifts: the pairs of a step are a power of two");

using bf16 = __nv_bfloat16;

// the tile's columns for `cout` output channels: the least of 16, 32, 64
// that covers them (wider layers take several column tiles)
__host__ __device__ constexpr int tile_cols(int cout) {
  return cout <= 16 ? 16 : cout <= 32 ? 32 : 64;
}

// f32: rows of KC + 4 floats keep float4 loads aligned and shift the banks;
// bf16: rows of KC + 8 (and TN + 8) values keep the fragments' 32-bit
// loads on distinct banks
template <typename T, int TN>
struct Tile {
  static constexpr int KC = kStep;
  static constexpr int TM = kTileElems / TN;
  static constexpr int LDX = KC + (std::is_same<T, float>::value ? 4 : 8);
  static constexpr int LDW = TN + (std::is_same<T, float>::value ? 0 : 8);
  // the ring, the tile's rows, their neighbour rows where staged, the
  // tile's present offsets (k_off) and its mask words
  static size_t smem_bytes(int k_off, bool stage_nbr) {
    return sizeof(T) * kStages * (static_cast<size_t>(TM) * LDX + KC * LDW)
           + sizeof(int) * (TM + (stage_nbr ? static_cast<size_t>(TM) * k_off
                                            : 0)
                            + k_off + (k_off + 31) / 32);
  }
};

// cudaFuncSetAttribute costs host time on every launch it runs in: ask
// once a device for the most dynamic shared memory `kernel` has needed
// there (`granted`, one per kernel, counts bytes by device)
constexpr int kMaxDevices = 64;

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

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(fill ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(fill ? BYTES : 0));
}

// one copy of `vec` bytes, or `vec` zero bytes where !fill
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32: thread (ty, tx) of a group owns rows 4ty..4ty+3 and columns
// 4tx..4tx+3 of the tile; acc[4 i + j]. Group grp adds the step's pairs
// [grp KC/2, (grp + 1) KC/2) one at a time, in order.
template <int TN>
__device__ __forceinline__ void step_f32(const float* xs, const float* ws,
                                         float* acc, int tid, int grp) {
  using C = Tile<float, TN>;
  constexpr int kHalf = C::KC / 2;
  const int tx = tid % (TN / 4), ty = tid / (TN / 4);
  const float* xa = xs + ty * 4 * C::LDX + grp * kHalf;
  const float* wb = ws + tx * 4 + grp * kHalf * C::LDW;
#pragma unroll
  for (int cc = 0; cc < kHalf; cc += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(xa + i * C::LDX + cc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(wb + (cc + j) * C::LDW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[4 * i + 0] += av[q] * b[q].x;
        acc[4 * i + 1] += av[q] * b[q].y;
        acc[4 * i + 2] += av[q] * b[q].z;
        acc[4 * i + 3] += av[q] * b[q].w;
      }
    }
  }
}

// bf16: warps split the tile into WARPS_M x WARPS_N warp tiles of WM x WN
// outputs, MT x NT fragments of m16n8; acc[4 (mi NT + ni) + e]
template <int TN>
struct WarpLayout {
  static constexpr int WN = TN >= 32 ? 32 : 16;
  static constexpr int WARPS_N = TN / WN;
  static constexpr int WARPS_M = (kGroup / 32) / WARPS_N;
  static constexpr int WM = (kTileElems / TN) / WARPS_M;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static_assert(MT * NT * 4 == 16, "16 accumulators a thread");
};

template <int TN>
__device__ __forceinline__ void step_bf16(const bf16* xs, const bf16* ws,
                                          float* acc, int tid, int grp) {
  using C = Tile<bf16, TN>;
  constexpr int kHalf = C::KC / 2;
  using L = WarpLayout<TN>;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / L::WARPS_N) * L::WM;
  const int wn0 = (warp % L::WARPS_N) * L::WN;
#pragma unroll
  for (int k16 = 0; k16 < kHalf; k16 += 16) {
    const int kk = grp * kHalf + k16;
    uint32_t a[L::MT][4];
#pragma unroll
    for (int mi = 0; mi < L::MT; ++mi) {
      const bf16* p = xs + (wm0 + mi * 16 + g) * C::LDX + kk + 2 * t4;
      a[mi][0] = ld32(p);
      a[mi][1] = ld32(p + 8 * C::LDX);
      a[mi][2] = ld32(p + 8);
      a[mi][3] = ld32(p + 8 * C::LDX + 8);
    }
#pragma unroll
    for (int ni = 0; ni < L::NT; ++ni) {
      const bf16* q = ws + (kk + 2 * t4) * C::LDW + wn0 + ni * 8 + g;
      const uint32_t b0 = pack(q[0], q[C::LDW]);
      const uint32_t b1 = pack(q[8 * C::LDW], q[9 * C::LDW]);
#pragma unroll
      for (int mi = 0; mi < L::MT; ++mi)
        mma_bf16(acc + 4 * (mi * L::NT + ni), a[mi], b0, b1);
    }
  }
}

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
    subm_conv_kernel(const T* __restrict__ feat, const int* __restrict__ nbr,
                     const int64_t* __restrict__ order,
                     const T* __restrict__ w,
                     const uint8_t* __restrict__ valid, T* __restrict__ out,
                     int n, int nq, int k_off, int c, int cout, int vec_x,
                     int vec_w, int stage_nbr) {
  using C = Tile<T, TN>;
  constexpr int TM = C::TM, KC = C::KC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);              // kStages x TM x LDX
  T* ws = xs + kStages * TM * C::LDX;              // kStages x KC x LDW
  int* rows_s = reinterpret_cast<int*>(ws + kStages * KC * C::LDW);
  int* nbr_s = rows_s + TM;              // TM x k_off where staged
  int* koff_s = nbr_s + (stage_nbr ? TM * k_off : 0);  // present offsets
  unsigned* mask_s = reinterpret_cast<unsigned*>(koff_s + k_off);
  const int mask_words = (k_off + 31) >> 5;

  const int tid = threadIdx.x;
  const int grp = tid / kGroup, gtid = tid % kGroup;
  const int t0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;

  // the tile's output rows in rule-book order, their neighbour rows
  // (out-of-range entries read as absent) and the union of their offsets
  for (int i = tid; i < mask_words; i += kThreads) mask_s[i] = 0u;
  for (int i = tid; i < TM; i += kThreads)
    rows_s[i] = t0 + i < nq ? static_cast<int>(order[t0 + i]) : -1;
  __syncthreads();
  // an entry of the map: out-of-range rows read as absent
  auto entry = [&](int r, int kk) {
    const int row = rows_s[r];
    const int v = row >= 0 ? nbr[static_cast<size_t>(row) * k_off + kk] : -1;
    return v < n ? v : -1;
  };
  if (k_off <= 32) {
    // one mask word: a thread ORs its entries' bits, a warp its threads'
    // (unrolled, so a thread's loads are in flight together rather than
    // one L2 round trip each)
    unsigned bits = 0u;
#pragma unroll 8
    for (int i = tid; i < TM * k_off; i += kThreads) {
      const int r = i / k_off, kk = i - r * k_off;
      const int v = entry(r, kk);
      if (stage_nbr) nbr_s[i] = v;
      if (v >= 0) bits |= 1u << kk;
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if ((tid & 31) == 0 && bits) atomicOr(mask_s, bits);
  } else {
    // several words: an entry sets its offset's bit unless it is set
#pragma unroll 8
    for (int i = tid; i < TM * k_off; i += kThreads) {
      const int r = i / k_off, kk = i - r * k_off;
      const int v = entry(r, kk);
      if (stage_nbr) nbr_s[i] = v;
      const unsigned bit = 1u << (kk & 31);
      if (v >= 0 && !(mask_s[kk >> 5] & bit)) atomicOr(&mask_s[kk >> 5], bit);
    }
  }
  __syncthreads();
  // the present offsets ascending: offset k goes after the present ones
  // of the words before its own and below it in its word
  for (int k = tid; k < k_off; k += kThreads) {
    const unsigned word = mask_s[k >> 5];
    if ((word >> (k & 31)) & 1u) {
      int at = __popc(word & ((1u << (k & 31)) - 1u));
      for (int q = 0; q < (k >> 5); ++q) at += __popc(mask_s[q]);
      koff_s[at] = k;
    }
  }
  int nk = 0;
  for (int q = 0; q < mask_words; ++q) nk += __popc(mask_s[q]);
  __syncthreads();

  // the tile's work runs along one axis of (offset, channel) pairs, the
  // present offsets ascending and each one's channels ascending; a step
  // stages KC of them, so a step can span several offsets where C < KC
  const int steps = (nk * c + KC - 1) / KC;
  const int epu = vec_x / static_cast<int>(sizeof(T));
  const int upr_log = __ffs(KC / epu) - 1;           // copies a row
  const int epw = vec_w / static_cast<int>(sizeof(T));
  const int upw_log = __ffs(TN / epw) - 1;           // copies a W row

  // stage `step` into the ring: the gathered rows (zero where absent or
  // past the last offset) and the matching rows of W. The threads cover
  // whole rows of copies, so a thread's copies of the gathered rows all
  // take the same columns of the step (one offset, one channel), and its
  // rows of W advance by a fixed number of (offset, channel) pairs: one
  // division a step, not one a copy.
  auto issue = [&](int step) {
    const int st = step % kStages;
    const int v0 = step * KC;
    T* xd = xs + st * TM * C::LDX;
    {
      const int u = (tid & ((1 << upr_log) - 1)) * epu;
      const int oi = (v0 + u) / c, ch = v0 + u - oi * c;
      const int kk = oi < nk ? koff_s[oi] : -1;
      for (int r = tid >> upr_log; r < TM; r += kThreads >> upr_log) {
        const int src =
            kk < 0 ? -1 : stage_nbr ? nbr_s[r * k_off + kk] : entry(r, kk);
        copy_unit(xd + r * C::LDX + u,
                  src >= 0 ? feat + static_cast<size_t>(src) * c + ch : feat,
                  vec_x, src >= 0);
      }
    }
    T* wd = ws + st * KC * C::LDW;
    {
      const int j = (tid & ((1 << upw_log) - 1)) * epw;
      const int dv = kThreads >> upw_log;
      int vr = tid >> upw_log;
      int oi = (v0 + vr) / c, ch = v0 + vr - oi * c;
      for (; vr < KC; vr += dv) {
        const bool fill = oi < nk && col0 + j < cout;
        const int kk = fill ? koff_s[oi] : 0;
        copy_unit(wd + vr * C::LDW + j,
                  fill ? w + (static_cast<size_t>(kk) * c + ch) * cout + col0
                             + j
                       : w,
                  vec_w, fill);
        for (ch += dv; ch >= c; ch -= c) ++oi;
      }
    }
  };

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is consumed
    if (s + kStages - 1 < steps) issue(s + kStages - 1);
    cp_async_commit();
    const int st = s % kStages;
    if constexpr (std::is_same<T, float>::value)
      step_f32<TN>(xs + st * TM * C::LDX, ws + st * KC * C::LDW, acc, gtid,
                   grp);
    else
      step_bf16<TN>(xs + st * TM * C::LDX, ws + st * KC * C::LDW, acc, gtid,
                    grp);
  }
  cp_async_wait<0>();

  // the second group's sums join the first's, in that order, through the
  // ring (free now: 2048 floats fit every stage's tiles)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (grp == 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) red[i * kGroup + gtid] = acc[i];
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += red[i * kGroup + gtid];

  // every row of the tile is written: zeros where no neighbour exists,
  // times valid as the plain version does
  if constexpr (std::is_same<T, float>::value) {
    const int tx = gtid % (TN / 4), ty = gtid / (TN / 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows_s[ty * 4 + i];
      if (row < 0) continue;
      const float v = static_cast<float>(valid[row]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx * 4 + j;
        if (col < cout)
          out[static_cast<size_t>(row) * cout + col] = acc[4 * i + j] * v;
      }
    }
  } else {
    using L = WarpLayout<TN>;
    const int warp = gtid >> 5, lane = gtid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int wm0 = (warp / L::WARPS_N) * L::WM;
    const int wn0 = (warp % L::WARPS_N) * L::WN;
#pragma unroll
    for (int mi = 0; mi < L::MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < L::NT; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rows_s[wm0 + mi * 16 + g + 8 * h];
          if (row < 0) continue;
          const float v = static_cast<float>(valid[row]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + wn0 + ni * 8 + 2 * t4 + e;
            if (col < cout)
              out[static_cast<size_t>(row) * cout + col] = __float2bfloat16_rn(
                  acc[4 * (mi * L::NT + ni) + 2 * h + e] * v);
          }
        }
  }
}

template <typename T, int TN>
int launch(const void* feat, const int* nbr, const int64_t* order,
           const void* w, const uint8_t* valid, void* out, int n, int nq,
           int k_off, int c, int cout, int vec_x, int vec_w,
           cudaStream_t stream) {
  using C = Tile<T, TN>;
  static std::atomic<int> granted[kMaxDevices];
  // the neighbour rows staged while they fit; the rest needs k_off ints
  const bool stage_nbr = C::smem_bytes(k_off, true) <= kMaxSmem;
  const size_t smem = C::smem_bytes(k_off, stage_nbr);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(subm_conv_kernel<T, TN>, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + C::TM - 1) / C::TM, (cout + TN - 1) / TN);
  subm_conv_kernel<T, TN><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), nbr, order, static_cast<const T*>(w),
      valid, static_cast<T*>(out), n, nq, k_off, c, cout, vec_x, vec_w,
      stage_nbr ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tn(const void* feat, const int* nbr, const int64_t* order,
              const void* w, const uint8_t* valid, void* out, int n, int nq,
              int k_off, int c, int cout, int vec_x, int vec_w,
              cudaStream_t s) {
  switch (tile_cols(cout)) {
    case 16:
      return launch<T, 16>(feat, nbr, order, w, valid, out, n, nq, k_off, c,
                           cout, vec_x, vec_w, s);
    case 32:
      return launch<T, 32>(feat, nbr, order, w, valid, out, n, nq, k_off, c,
                           cout, vec_x, vec_w, s);
    default:
      return launch<T, 64>(feat, nbr, order, w, valid, out, n, nq, k_off, c,
                           cout, vec_x, vec_w, s);
  }
}

// ---------------------------------------------------------------------------
// The rule book's build (ops/rulebook.py `subm_conv_rulebook`; its plain
// version is `_subm_conv_rulebook_plain` there): for each of up to
// kMaxMaps neighbour maps, every row's presence mask (bit k set where
// nbr[n, k] >= 0) and the rows stably sorted by mask, the order K5 walks.
// One call for all of a request's maps, with no host synchronisation.
//
// What bounds it: the bytes are a few hundred KB (each map read once, masks
// and order written once), so at a request's ~40 000 rows the work is
// latency: the serial passes of an LSD radix sort, and on the host the
// launches. A block a map (the first design) left 4-5 of the 132 SMs sorting,
// 7 passes of 4 bits each, in rounds with block barriers. Here every map's
// keys (mask << 32 | row) are cut into chunks of kChunk keys, a block a
// chunk of all the maps at once, with 8-bit digits: 4 passes for 27
// offsets.
//  - the masks phase: each row's mask and key, and the chunk's digit counts
//    of every pass, added into its map's histograms (one global atomic a
//    digit and block); it also clears the chunk's look-back slots.
//  - a pass (Merrill and Garland's single-pass scan with decoupled
//    look-back, as in Onesweep): the block ranks its keys stably (a warp
//    ranks 256 keys in index order with __match_any_sync and a counter a
//    digit), publishes its digit counts, and adds up the counts of the
//    map's earlier chunks from their published slots (8 slots a load
//    round), stopping at the first inclusive one; then each key goes to
//    its digit's base in the map (an exclusive scan of the map's
//    histogram), plus the earlier chunks' count of that digit, plus its
//    rank in the chunk. Every pass is stable and the keys start in row
//    order, so rows with equal masks keep it: the result equals
//    torch.sort(masks, stable=True). The last pass writes the order.
// When every chunk's block fits on the card at once (a request's ~20-50
// chunks do), the whole build is ONE cooperative launch (`rulebook_kernel`)
// whose phases are separated by grid barriers, so the host launches one
// kernel a call. Larger inputs take one launch a phase (a memset, the
// masks kernel, a kernel a pass whose blocks take their chunks by ticket,
// so every chunk they look back on has started).
// The maps hold up to 2^29 rows in all; SECOND's largest has 32 000.

constexpr int kMaxMaps = 16;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kKeysPerThread = 8;
constexpr int kChunk = 2048;  // keys a block (ops/rulebook.py _SORT_CHUNK)
static_assert(kChunk == kSortThreads * kKeysPerThread, "whole chunks");
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
// the passes of 31 offsets' masks (ops/rulebook.py _SORT_MAX_PASSES)
constexpr int kMaxPasses = 4;
static_assert(kMaxPasses * kRadixBits >= kMaxOffsets, "every mask bit");
static_assert(kRadix == kSortThreads, "a thread a digit");
// a look-back slot: the flag in the top two bits, the count below
constexpr unsigned kAggregate = 1u << 30;   // this chunk's count
constexpr unsigned kInclusive = 2u << 30;   // the map's count up to it
constexpr unsigned kCountMask = (1u << 30) - 1u;
constexpr int kLookBack = 8;                // slots a load round

struct MapSet {
  const int* nbr[kMaxMaps];
  int nq[kMaxMaps];
  int start[kMaxMaps];            // the map's first row in masks / order
  int chunk_start[kMaxMaps + 1];  // the map's first chunk; the last: all
  int piece_start[kMaxMaps + 1];  // the same in the masks phase's pieces
};

// the build's global scratch, carved out of the wrapper's buffer
struct SortScratch {
  unsigned long long* keys;  // two buffers of keys a map
  unsigned* status;          // [pass][chunk][digit] look-back slots
  int* hist;                 // [map][pass][digit] digit counts
  int* tickets;              // [pass] (the per-phase launches)
};

union SortSmem {
  struct {
    int rows[kSortThreads * kMaxOffsets];  // a piece's map rows
    int h[kMaxPasses][kRadix];             // the piece's digit counts
  } masks;
  struct {
    int wcnt[kSortWarps][kRadix];  // per warp and digit
    int base[kRadix];
    int warp_sums[kSortWarps];
  } pass;
};

__device__ __forceinline__ int map_of(const MapSet& maps, int n_maps,
                                      int chunk) {
  int m = 0;
  while (m + 1 < n_maps && chunk >= maps.chunk_start[m + 1]) ++m;
  return m;
}

__device__ __forceinline__ int map_of_piece(const MapSet& maps, int n_maps,
                                            int piece) {
  int m = 0;
  while (m + 1 < n_maps && piece >= maps.piece_start[m + 1]) ++m;
  return m;
}

// the look-back slots start empty: the blocks of a launch clear them in turn
__device__ __forceinline__ void clear_slots(unsigned* status, size_t count) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * kSortThreads +
                  threadIdx.x;
       e < count; e += static_cast<size_t>(gridDim.x) * kSortThreads)
    status[e] = 0u;
}

// one piece of kSortThreads rows of a map: its rows copied into shared
// memory in one coalesced burst (a thread a row reading its own k_off
// entries from global memory would touch a line an entry), then a thread a
// row: the mask, the key, and the piece's digit counts of every pass added
// into its map's histograms
__device__ void masks_phase(const MapSet& maps, int n_maps, int k_off,
                            int passes, int piece, int* __restrict__ masks,
                            const SortScratch& sc, SortSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int m = map_of_piece(maps, n_maps, piece);
  const int nq = maps.nq[m], start = maps.start[m];
  const int r0 = (piece - maps.piece_start[m]) * kSortThreads;
  const int nrows = min(kSortThreads, nq - r0);
  const int* src = maps.nbr[m] + static_cast<size_t>(r0) * k_off;
  // a map of more than kMaxOffsets offsets is read from L2, a thread a row
  const bool staged = k_off <= kMaxOffsets;
  const int count = staged ? nrows * k_off : 0;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    e0 = count / 4 * 4;
    for (int e = 4 * tid; e < e0; e += 4 * kSortThreads)
      cp_async<16>(&sm.masks.rows[e], src + e, true);
  }
  for (int e = e0 + tid; e < count; e += kSortThreads)
    cp_async<4>(&sm.masks.rows[e], src + e, true);
  cp_async_commit();
  for (int p = 0; p < kMaxPasses; ++p) sm.masks.h[p][tid] = 0;
  cp_async_wait<0>();
  __syncthreads();

  const bool in = tid < nrows;
  unsigned bits = 0u;
  if (in && staged) {
    const int* row = sm.masks.rows + tid * k_off;  // odd k_off: no conflicts
#pragma unroll
    for (int k = 0; k < kMaxOffsets; ++k)
      if (k < k_off) bits |= static_cast<unsigned>(row[k] >= 0) << k;
  } else if (in) {  // offset k onto bit k mod kMaxOffsets
    const int* row = src + static_cast<size_t>(tid) * k_off;
    for (int k = 0, b = 0; k < k_off; ++k, b = b + 1 < kMaxOffsets ? b + 1 : 0)
      bits |= static_cast<unsigned>(row[k] >= 0) << b;
  }
  if (in) {
    masks[start + r0 + tid] = static_cast<int>(bits);
    // map m's keys take scratch [2 start, 2 start + nq), the rest its
    // second buffer
    sc.keys[2 * static_cast<size_t>(start) + r0 + tid] =
        (static_cast<unsigned long long>(bits) << 32) |
        static_cast<unsigned>(r0 + tid);
  }
  for (int p = 0; p < passes; ++p) {
    const int d = in ? static_cast<int>(bits >> (p * kRadixBits)) &
                           (kRadix - 1)
                     : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (in && (peers & ((1u << lane) - 1u)) == 0)
      atomicAdd(&sm.masks.h[p][d], __popc(peers));
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p)
    if (sm.masks.h[p][tid] != 0)
      atomicAdd(&sc.hist[(m * kMaxPasses + p) * kRadix + tid],
                sm.masks.h[p][tid]);
  __syncthreads();  // the shared memory is reused by the next piece
}

// another block's look-back slot, read past the caches that could hold an
// old value
__device__ __forceinline__ unsigned read_slot(const unsigned* slots,
                                              int chunk, int d) {
  return *reinterpret_cast<const volatile unsigned*>(
      slots + static_cast<size_t>(chunk) * kRadix + d);
}

__device__ void pass_phase(const MapSet& maps, int n_maps, int pass,
                           bool last, int chunk, const SortScratch& sc,
                           int64_t* __restrict__ order, SortSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int chunks = maps.chunk_start[n_maps];
  const int m = map_of(maps, n_maps, chunk);
  const int nq = maps.nq[m], start = maps.start[m];
  const int first = maps.chunk_start[m];
  const int r0 = (chunk - first) * kChunk;
  unsigned long long* buf = sc.keys + 2 * static_cast<size_t>(start);
  const unsigned long long* src = buf + ((pass & 1) ? nq : 0);
  unsigned long long* dst = buf + ((pass & 1) ? 0 : nq);
  const int shift = 32 + pass * kRadixBits;
  const int d = tid;
  const int hc = sc.hist[(m * kMaxPasses + pass) * kRadix + d];
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) sm.pass.wcnt[w][tid] = 0;

  // a warp takes 256 consecutive keys, 32 a round: index order is (warp,
  // round, lane), and a key's rank among the warp's keys of its digit is
  // the warp's count of that digit so far plus its rank in the round
  unsigned long long v[kKeysPerThread];
  int dg[kKeysPerThread], rank[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = r0 + warp * (kChunk / kSortWarps) + j * 32 + lane;
    v[j] = i < nq ? src[i] : 0ull;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = r0 + warp * (kChunk / kSortWarps) + j * 32 + lane;
    dg[j] = i < nq ? static_cast<int>(v[j] >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, dg[j]);
    const int before = dg[j] < kRadix ? sm.pass.wcnt[warp][dg[j]] : 0;
    __syncwarp();
    if (dg[j] < kRadix && (peers & below) == 0)
      sm.pass.wcnt[warp][dg[j]] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & below);
  }
  __syncthreads();

  // thread d: digit d's count before each warp, and the chunk's
  int count = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int c = sm.pass.wcnt[w][d];
    sm.pass.wcnt[w][d] = count;
    count += c;
  }
  unsigned* slots = sc.status + static_cast<size_t>(pass) * chunks * kRadix;
  const bool head = chunk == first;
  atomicExch(slots + static_cast<size_t>(chunk) * kRadix + d,
             (head ? static_cast<unsigned>(kInclusive)
                   : static_cast<unsigned>(kAggregate)) |
                 static_cast<unsigned>(count));

  // the digit's base in the map: an exclusive scan of the map's histogram
  int incl = hc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) sm.pass.warp_sums[warp] = incl;

  // the map's earlier chunks' count of the digit: look back, kLookBack
  // slots a round of loads, to the first inclusive one
  int prior = 0;
  if (!head) {
    bool done = false;
    for (int k = chunk - 1; !done; k -= kLookBack) {
      unsigned sv[kLookBack];
#pragma unroll
      for (int i = 0; i < kLookBack; ++i)  // before the map: nothing
        sv[i] = k - i >= first ? read_slot(slots, k - i, d)
                               : static_cast<unsigned>(kInclusive);
#pragma unroll
      for (int i = 0; i < kLookBack; ++i) {
        if (!done) {
          while (sv[i] == 0u)  // not published yet
            sv[i] = read_slot(slots, k - i, d);
          prior += static_cast<int>(sv[i] & kCountMask);
          done = (sv[i] & kInclusive) != 0u;
        }
      }
    }
    atomicExch(slots + static_cast<size_t>(chunk) * kRadix + d,
               kInclusive | static_cast<unsigned>(prior + count));
  }
  __syncthreads();
  int before_warp = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w)
    before_warp += w < warp ? sm.pass.warp_sums[w] : 0;
  sm.pass.base[d] = before_warp + incl - hc + prior;
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    if (dg[j] < kRadix) {
      const int pos =
          sm.pass.base[dg[j]] + sm.pass.wcnt[warp][dg[j]] + rank[j];
      if (last)
        order[start + pos] = static_cast<int64_t>(v[j] & 0xffffffffull);
      else
        dst[pos] = v[j];
    }
  }
  __syncthreads();  // the shared memory is reused by the next phase
}

// the one-launch build's grid barrier: every block of the cooperative
// launch is resident, so all arrive; the last one resets the count and
// moves the generation on. Per device, one build at a time (a stream).
__device__ unsigned g_sort_arrived = 0u;
__device__ unsigned g_sort_generation = 0u;

__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = &g_sort_generation;
    const unsigned g = *gen;
    __threadfence();  // the read above comes before the arrival
    if (atomicAdd(&g_sort_arrived, 1u) == gridDim.x - 1) {
      atomicExch(&g_sort_arrived, 0u);
      __threadfence();
      atomicAdd(&g_sort_generation, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// the one-launch build: the grid holds every chunk's block (and as many
// more as the masks phase's pieces can use, up to what the card holds)
__global__ void __launch_bounds__(kSortThreads)
    rulebook_kernel(MapSet maps, int n_maps, int k_off, int passes,
                    int* __restrict__ masks, int64_t* __restrict__ order,
                    SortScratch sc) {
  __shared__ SortSmem sm;
  const int chunks = maps.chunk_start[n_maps];
  const int pieces = maps.piece_start[n_maps];
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e < n_maps * kMaxPasses * kRadix;
         e += kSortThreads)
      sc.hist[e] = 0;
  clear_slots(sc.status, static_cast<size_t>(chunks) * kMaxPasses * kRadix);
  grid_barrier();
  for (int piece = blockIdx.x; piece < pieces; piece += gridDim.x)
    masks_phase(maps, n_maps, k_off, passes, piece, masks, sc, sm);
  for (int p = 0; p < passes; ++p) {
    grid_barrier();
    if (static_cast<int>(blockIdx.x) < chunks)
      pass_phase(maps, n_maps, p, p == passes - 1, blockIdx.x, sc, order,
                 sm);
  }
}

// the per-phase build's first launch: a block a piece
__global__ void __launch_bounds__(kSortThreads)
    rulebook_masks_kernel(MapSet maps, int n_maps, int k_off, int passes,
                          int* __restrict__ masks, SortScratch sc) {
  __shared__ SortSmem sm;
  clear_slots(sc.status, static_cast<size_t>(maps.chunk_start[n_maps]) *
                             kMaxPasses * kRadix);
  masks_phase(maps, n_maps, k_off, passes, blockIdx.x, masks, sc, sm);
}

__global__ void __launch_bounds__(kSortThreads)
    rulebook_pass_kernel(MapSet maps, int n_maps, int pass, int last,
                         SortScratch sc, int64_t* __restrict__ order) {
  __shared__ SortSmem sm;
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(&sc.tickets[pass], 1);
  __syncthreads();
  pass_phase(maps, n_maps, pass, last != 0, ticket, sc, order, sm);
}

// the blocks of rulebook_kernel the current device holds at once
int resident_sort_blocks() {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && known[dev].load() > 0) return known[dev].load();
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rulebook_kernel, kSortThreads, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
          cudaSuccess)
    return 0;
  const int blocks = coop ? per_sm * sms : 0;
  if (dev < kMaxDevices) known[dev].store(blocks);
  return blocks;
}

}  // namespace

// the output rows of one tile for `cout` output channels: the schedule's
// row groups, which ops/rulebook.py `RuleBook.k5_schedule` counts
extern "C" int d3d_subm_conv_tile_rows(int cout) {
  return kTileElems / tile_cols(cout);
}

// dtype: 0 = float32, 1 = bfloat16 (features, weights and output alike);
// order: the rule book's row order, int64 (a permutation of 0..nq-1); vec_x /
// vec_w: the bytes of one asynchronous copy (16, 8 or 4) dividing a row of
// the features / of W and their start addresses
extern "C" int d3d_subm_conv(const void* feat, const int* nbr,
                             const int64_t* order, const void* w,
                             const uint8_t* valid, void* out, int n, int nq,
                             int k_off, int c, int cout, int dtype, int vec_x,
                             int vec_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec_ok = (vec_x == 4 || vec_x == 8 || vec_x == 16)
                      && (vec_w == 4 || vec_w == 8 || vec_w == 16)
                      && (c * elem) % vec_x == 0 && (cout * elem) % vec_w == 0;
  if (n <= 0 || nq <= 0 || c <= 0 || cout <= 0 || k_off <= 0 || !vec_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_tn<float>(feat, nbr, order, w, valid, out, n, nq, k_off, c,
                            cout, vec_x, vec_w, s);
  if (dtype == 1)
    return launch_tn<bf16>(feat, nbr, order, w, valid, out, n, nq, k_off, c,
                           cout, vec_x, vec_w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the chunks up to which the rule-book build is one cooperative launch on
// the current device (ops/rulebook.py counts the builds by route)
extern "C" int d3d_subm_conv_rulebook_resident() {
  return resident_sort_blocks();
}

// the rule books of n_maps <= 16 maps of k_off offsets (above 31, the masks
// fold offset k onto bit k mod 31): nbrs[i] an (nqs[i], k_off) int32 map
// on the card (nbrs and nqs are host arrays);
// masks (int32) and order (int64, each map's rows 0..nqs[i]-1) take the
// maps' rows end to end; scratch, scratch_words 64-bit words, holds two
// keys a row, kMaxPasses look-back slots of kRadix 32-bit words a chunk,
// kMaxPasses histograms of kRadix ints a map and kMaxPasses tickets
// (ops/rulebook.py _sort_scratch_words). Returns cudaGetLastError().
extern "C" int d3d_subm_conv_rulebook(const void* const* nbrs, const int* nqs,
                                      int n_maps, int k_off, int* masks,
                                      int64_t* order, void* scratch,
                                      int scratch_words, void* stream) {
  if (n_maps <= 0 || n_maps > kMaxMaps || k_off <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MapSet set{};
  int64_t total = 0, chunks = 0, pieces = 0;
  for (int i = 0; i < n_maps; ++i) {
    if (nqs[i] < 0 || nqs[i] > (1 << 29))
      return static_cast<int>(cudaErrorInvalidValue);
    set.nbr[i] = static_cast<const int*>(nbrs[i]);
    set.nq[i] = nqs[i];
    set.start[i] = static_cast<int>(total);
    set.chunk_start[i] = static_cast<int>(chunks);
    set.piece_start[i] = static_cast<int>(pieces);
    total += nqs[i];
    chunks += (nqs[i] + kChunk - 1) / kChunk;
    pieces += (nqs[i] + kSortThreads - 1) / kSortThreads;
  }
  set.chunk_start[n_maps] = static_cast<int>(chunks);
  set.piece_start[n_maps] = static_cast<int>(pieces);
  const int64_t need = 2 * total + chunks * kMaxPasses * kRadix / 2 +
                       n_maps * kMaxPasses * kRadix / 2 + kMaxPasses / 2;
  if (total <= 0 || total > (1 << 29) || need > scratch_words)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SortScratch sc;
  sc.keys = static_cast<unsigned long long*>(scratch);
  sc.status = reinterpret_cast<unsigned*>(sc.keys + 2 * total);
  sc.hist = reinterpret_cast<int*>(sc.status + chunks * kMaxPasses * kRadix);
  sc.tickets = sc.hist + n_maps * kMaxPasses * kRadix;
  int passes = (std::min(k_off, kMaxOffsets) + kRadixBits - 1) / kRadixBits;
  const int64_t resident = resident_sort_blocks();
  if (chunks <= resident) {
    const unsigned grid =
        static_cast<unsigned>(std::min(resident, std::max(chunks, pieces)));
    void* args[] = {&set, &n_maps, &k_off, &passes, &masks, &order, &sc};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(rulebook_kernel), dim3(grid),
        dim3(kSortThreads), args, 0, s));
  }
  cudaError_t err = cudaMemsetAsync(
      sc.hist, 0, (n_maps * kMaxPasses * kRadix + kMaxPasses) * sizeof(int),
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  rulebook_masks_kernel<<<static_cast<unsigned>(pieces), kSortThreads, 0,
                          s>>>(set, n_maps, k_off, passes, masks, sc);
  for (int p = 0; p < passes; ++p)
    rulebook_pass_kernel<<<static_cast<unsigned>(chunks), kSortThreads, 0,
                           s>>>(set, n_maps, p, p == passes - 1, sc, order);
  return static_cast<int>(cudaGetLastError());
}
