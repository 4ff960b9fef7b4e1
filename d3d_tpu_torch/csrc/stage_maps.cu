// M1: every neighbour map of a sparse middle's stages, for a batch of
// frames, built on the card (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds its maps with XLA ops
// (d3d_tpu/ops/sparse_conv.py: a dense canvas or a tagged sort join a
// lookup, a sort-unique a strided layer). The plain PyTorch version is
// d3d_tpu_torch/ops/stage_maps.py `_build_stage_maps_plain` (those torch
// ops a frame, the frames' maps moved to their rows and joined); the Python
// wrapper is `build_stage_maps` there.
//
// What it computes, for B frames of R_0 sites each ((B, R_0, 3) int32
// coords, (B, R_0) valid) and a plan of stages: for each stage s with R_s
// sites a frame on the extent g_s,
//  - the submanifold map (B * R_s, 27): row b * R_s + n holds, for each
//    offset of the centred 3x3x3 kernel in raster order, the row
//    b * R_s + m of the frame's site at that offset, or -1 (absent, out of
//    the extent, or n invalid);
//  - where a strided layer follows, its output sites: the unique output
//    cells in ascending key order, the first R_{s+1} of them ((B, R_{s+1},
//    3) coords, (B, R_{s+1}) valid; rows past a frame's last site are
//    invalid with coords 0), by one of two rules: `coords // s` on the
//    ceil-divided extent, or spconv's (an output is active when its window
//    [s*o - p, s*o - p + k - 1] holds an active input on every axis);
//  - and the strided map (B * R_{s+1}, T): for each output site and each
//    tap j of the window in raster order, the input row at s * o + j - p
//    (the first rule reads the centred 3x3x3 window), or -1.
// A frame's duplicate valid coords keep their last row. The maps, coords
// and valid equal the plain version's bit for bit on every row.
//
// What bounds it: bytes, and few of them. A SECOND request reads 40 000
// coords (0.5 MB) and writes ~27 MB of maps; the rest is a few MB of
// tables in L2. At 3.35 TB/s that is ~10 us; what costs time is latency
// and, in the plain version, ~550 launches of small torch ops a frame and
// the sorts behind them.
//
// Design, the launches of one call (4-stage SECOND: 22):
//  - one memset clears the whole scratch (every table's "empty" is 0);
//  - stage 0's sites go into an open-addressing hash table a frame (the
//    least power of two of at least 2 R_0 and 1024 slots; a slot holds the
//    key + 1 and the row + 1, claimed by atomicCAS with linear probing,
//    the row by atomicMax: the last of duplicates). One route for every
//    extent: no dense canvas, no sort join, whatever the extent's cells;
//  - each stage, one thread a (row, offset) writes its entry of the
//    submanifold map straight into the joined map;
//  - a strided layer: one thread an (input, tap) pair sets, with atomicOr,
//    the bit of the output cell whose window puts that input at that tap,
//    in a bitmap a frame over the output extent (704 x 800 x 21 bits =
//    1.48 MB for SECOND's first); then two launches rank the bitmap: each
//    block of 2048 words counts its bits, and then each block adds the
//    counts of its frame's earlier blocks (at most a few hundred), scans
//    its own words, writes each word's rank and decodes the coords of each
//    set bit of rank below the cap. That is "unique keys ascending, the
//    first R" with no sort; a frame's count of sites comes out of its last
//    block. Last, one thread an (output, tap) looks the input up;
//  - the next stage's sites are those bits, in key order: its lookups read
//    the bitmap and the words' ranks (a site is present when its bit is set
//    and its rank is below the cap), so stages after the first need no
//    hash table.
// No host synchronisation: every size comes from the plan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanInts = 18;      // ops/stage_maps.py _PLAN_INTS
constexpr int kMaxStages = 16;
constexpr int kSubmOffsets = 27;   // the centred 3x3x3 kernel
constexpr int kWordsPerThread = 8;
constexpr int kBlockWords = kThreads * kWordsPerThread;  // _BLOCK_WORDS
constexpr int kMinHashSlots = 1024;                      // _MIN_HASH_SLOTS

struct Stage {
  int rows;   // sites a frame
  int g[3];   // extent
  int kind;   // 0: no strided layer after; 1: coords // s; 2: spconv's
  int k[3], s[3], p[3];  // the strided map's window: kernel, stride, pad
  int out_rows;          // output sites a frame
  int og[3];             // output extent
};

// a stage's sites: (B, rows, 3) coords, (B, rows) valid
struct Sites {
  const int* coords;
  const uint8_t* valid;
  int rows;
};

// where a stage looks its sites up: a hash table a frame (stage 0), or the
// bitmap and words' ranks of the strided layer that made them
struct Table {
  int* slots;  // hash: 2 ints a slot, key + 1 and row + 1, 0 when empty
  int log2slots;
  const unsigned* bits;  // bitmap: words a frame (a multiple of kBlockWords)
  const int* rank;       // the rank of each word's first bit
  long long words;
  int rows;  // ranks from here on were cut by the cap
};

__device__ __forceinline__ int key3(int x, int y, int z, const int* g) {
  return x * (g[1] * g[2]) + y * g[2] + z;
}

__device__ __forceinline__ bool inside(int x, int y, int z, const int* g) {
  return x >= 0 && y >= 0 && z >= 0 && x < g[0] && y < g[1] && z < g[2];
}

__device__ __forceinline__ unsigned slot_of(int key, int log2slots) {
  return (static_cast<unsigned>(key) * 2654435761u) >> (32 - log2slots);
}

// frame b's row of the site at `key`, or -1
__device__ __forceinline__ int find(const Table& t, int b, int key) {
  if (t.bits == nullptr) {
    const int* slots = t.slots + (static_cast<size_t>(b) << (t.log2slots + 1));
    const unsigned mask = (1u << t.log2slots) - 1u;
    for (unsigned h = slot_of(key, t.log2slots);; h = (h + 1u) & mask) {
      const int k = slots[2 * h];
      if (k == key + 1) return slots[2 * h + 1] - 1;
      if (k == 0) return -1;
    }
  }
  const size_t w = static_cast<size_t>(b) * t.words + (key >> 5);
  const unsigned word = t.bits[w], bit = 1u << (key & 31);
  if ((word & bit) == 0u) return -1;
  const int r = t.rank[w] + __popc(word & (bit - 1u));
  return r < t.rows ? r : -1;
}

__device__ __forceinline__ int floor_div(int a, int s) {
  return a >= 0 ? a / s : -((-a + s - 1) / s);
}

__global__ void __launch_bounds__(kThreads)
    insert_kernel(Sites in, Stage st, Table t, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n || !in.valid[i]) return;
  const int b = static_cast<int>(i / in.rows);
  const int row = static_cast<int>(i - static_cast<long long>(b) * in.rows);
  const int* c = in.coords + 3 * i;
  if (!inside(c[0], c[1], c[2], st.g)) return;
  const int key = key3(c[0], c[1], c[2], st.g);
  int* slots = t.slots + (static_cast<size_t>(b) << (t.log2slots + 1));
  const unsigned mask = (1u << t.log2slots) - 1u;
  for (unsigned h = slot_of(key, t.log2slots);; h = (h + 1u) & mask) {
    const int prev = atomicCAS(&slots[2 * h], 0, key + 1);
    if (prev == 0 || prev == key + 1) {
      atomicMax(&slots[2 * h + 1], row + 1);
      return;
    }
  }
}

// a thread a (row, offset) of the stage's submanifold map
__global__ void __launch_bounds__(kThreads)
    subm_kernel(Sites in, Stage st, Table t, long long n,
                int* __restrict__ nbr) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const long long site = i / kSubmOffsets;
  const int k = static_cast<int>(i - site * kSubmOffsets);
  int out = -1;
  if (in.valid[site]) {
    const int* c = in.coords + 3 * site;
    const int x = c[0] + k / 9 - 1, y = c[1] + (k / 3) % 3 - 1,
              z = c[2] + k % 3 - 1;
    if (inside(x, y, z, st.g)) {
      const int b = static_cast<int>(site / in.rows);
      const int r = find(t, b, key3(x, y, z, st.g));
      if (r >= 0) out = r + b * in.rows;
    }
  }
  nbr[i] = out;
}

// tap j of a window in raster order, per axis
__device__ __forceinline__ void tap3(int t, const int* k, int* j) {
  j[2] = t % k[2];
  j[1] = (t / k[2]) % k[1];
  j[0] = t / (k[1] * k[2]);
}

// a thread an (input, tap): the bit of the output cell it names
__global__ void __launch_bounds__(kThreads)
    candidates_kernel(Sites in, Stage st, int taps, long long n,
                      unsigned* __restrict__ bits, long long words) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const long long site = i / taps;
  if (!in.valid[site]) return;
  const int* c = in.coords + 3 * site;
  int o[3];
  if (st.kind == 1) {
    for (int a = 0; a < 3; ++a) o[a] = floor_div(c[a], st.s[a]);
  } else {
    int j[3];
    tap3(static_cast<int>(i - site * taps), st.k, j);
    for (int a = 0; a < 3; ++a) {
      const int num = c[a] - (j[a] - st.p[a]);
      if (num % st.s[a] != 0) return;
      o[a] = num / st.s[a];
    }
  }
  if (!inside(o[0], o[1], o[2], st.og)) return;
  const int key = key3(o[0], o[1], o[2], st.og);
  const int b = static_cast<int>(site / in.rows);
  atomicOr(&bits[static_cast<size_t>(b) * words + (key >> 5)],
           1u << (key & 31));
}

__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  __syncthreads();  // warp_sums is reused
  return total;
}

__device__ __forceinline__ void load_words(const unsigned* p, unsigned* v) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 c = reinterpret_cast<const uint4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

// grid (blocks a frame, B): each block's count of set bits
__global__ void __launch_bounds__(kThreads)
    count_kernel(const unsigned* __restrict__ bits, long long words,
                 int* __restrict__ block_counts) {
  __shared__ int warp_sums[kThreads / 32];
  const int b = blockIdx.y, blk = blockIdx.x;
  unsigned v[kWordsPerThread];
  load_words(bits + static_cast<size_t>(b) * words +
                 static_cast<size_t>(blk) * kBlockWords +
                 threadIdx.x * kWordsPerThread,
             v);
  int c = 0;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) c += __popc(v[j]);
  c = block_sum(c, warp_sums);
  if (threadIdx.x == 0) block_counts[b * gridDim.x + blk] = c;
}

// grid (blocks a frame, B): each word's rank, the coords of each set bit
// of rank below the cap, and (the frame's last block) the frame's sites
__global__ void __launch_bounds__(kThreads)
    emit_kernel(const unsigned* __restrict__ bits, long long words,
                const int* __restrict__ block_counts, Stage st,
                int* __restrict__ rank, int* __restrict__ out_coords,
                int* __restrict__ counts) {
  __shared__ int warp_sums[kThreads / 32];
  const int b = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int before = 0;
  for (int i = tid; i < blk; i += kThreads)
    before += block_counts[b * gridDim.x + i];
  const int base = block_sum(before, warp_sums);

  const size_t w0 = static_cast<size_t>(b) * words +
                    static_cast<size_t>(blk) * kBlockWords +
                    tid * kWordsPerThread;
  unsigned v[kWordsPerThread];
  load_words(bits + w0, v);
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) mine += __popc(v[j]);
  // the block's exclusive scan of the threads' counts
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int r = base + incl - mine;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) r += w < warp ? warp_sums[w] : 0;

  const int plane = st.og[1] * st.og[2];
  int* out = out_coords + static_cast<size_t>(b) * st.out_rows * 3;
  const int key0 = (blk * kBlockWords + tid * kWordsPerThread) * 32;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    rank[w0 + j] = r;
    int q = r;
    for (unsigned word = v[j]; word != 0u && q < st.out_rows;
         word &= word - 1u, ++q) {
      const int key = key0 + 32 * j + __ffs(word) - 1;
      out[3 * q] = key / plane;
      out[3 * q + 1] = (key % plane) / st.og[2];
      out[3 * q + 2] = key % st.og[2];
    }
    r += __popc(v[j]);
  }
  // the frame's last thread holds the frame's count
  if (blk == gridDim.x - 1 && tid == kThreads - 1)
    counts[b] = min(r, st.out_rows);
}

// a thread an (output row, tap) of the strided map; tap 0 also writes the
// row's valid, and coords 0 on rows past the frame's last site
__global__ void __launch_bounds__(kThreads)
    strided_kernel(Stage st, Table t, int taps, long long n,
                   const int* __restrict__ counts,
                   int* __restrict__ out_coords,
                   uint8_t* __restrict__ out_valid, int* __restrict__ nbr) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const long long site = i / taps;
  const int tap = static_cast<int>(i - site * taps);
  const int b = static_cast<int>(site / st.out_rows);
  const int row = static_cast<int>(site - static_cast<long long>(b) *
                                              st.out_rows);
  const bool valid = row < counts[b];
  int* c = out_coords + 3 * site;
  if (tap == 0) {
    out_valid[site] = valid ? 1 : 0;
    if (!valid) c[0] = c[1] = c[2] = 0;
  }
  int out = -1;
  if (valid) {
    int j[3], q[3];
    tap3(tap, st.k, j);
    for (int a = 0; a < 3; ++a) q[a] = c[a] * st.s[a] + j[a] - st.p[a];
    if (inside(q[0], q[1], q[2], st.g)) {
      const int r = find(t, b, key3(q[0], q[1], q[2], st.g));
      if (r >= 0) out = r + b * st.rows;
    }
  }
  nbr[i] = out;
}

long long volume(const int* g) {
  return static_cast<long long>(g[0]) * g[1] * g[2];
}

// bitmap words a frame of an output extent: whole blocks of kBlockWords
long long bitmap_words(const Stage& st) {
  const long long words = (volume(st.og) + 31) / 32;
  return (words + kBlockWords - 1) / kBlockWords * kBlockWords;
}

int log2_slots(int rows) {
  int l = 1;
  while ((1ll << l) < 2ll * rows || (1ll << l) < kMinHashSlots) ++l;
  return l;
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// The scratch M1 needs in int32 words for `batch` frames and `n_stages`
// stages of `plan` (ops/stage_maps.py _scratch_ints), or -1 for a plan it
// does not take: a frame's hash table, then for each strided layer its
// bitmap, its words' ranks, its blocks' counts and its frames' counts.
long long scratch_ints(int batch, const int* plan, int n_stages) {
  if (batch <= 0 || n_stages <= 0 || n_stages > kMaxStages) return -1;
  const Stage* st = reinterpret_cast<const Stage*>(plan);
  long long need = static_cast<long long>(batch) << (log2_slots(st[0].rows)
                                                     + 1);
  for (int s = 0; s < n_stages; ++s) {
    const Stage& x = st[s];
    if (x.rows < 0 || volume(x.g) < 0 || volume(x.g) >= (1ll << 30) ||
        x.kind < 0 || x.kind > 2 || (x.kind == 0 && s + 1 != n_stages))
      return -1;
    if (s > 0 && x.rows != st[s - 1].out_rows) return -1;
    if (x.kind == 0) continue;
    for (int a = 0; a < 3; ++a)
      if (x.k[a] <= 0 || x.s[a] <= 0 || x.p[a] < 0) return -1;
    if (x.out_rows < 0 || volume(x.og) < 0 || volume(x.og) >= (1ll << 30))
      return -1;
    const long long words = bitmap_words(x);
    need += 2 * batch * words + round4(batch * (words / kBlockWords)) +
            round4(batch);
  }
  return need;
}

}  // namespace

// Every map of a batch: coords (batch, plan[0].rows, 3) int32 and valid
// (batch, rows) bool on the card; plan, n_stages stages of kPlanInts ints
// (struct Stage) on the host; outs (host array of device pointers), for
// each stage its submanifold map (batch * rows, 27) int32 and, where a
// strided layer follows, its map (batch * out_rows, taps) int32, the output
// coords (batch, out_rows, 3) int32 and valid (batch, out_rows) bool;
// scratch, scratch_len int32 words (scratch_ints above). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan or scratch it
// does not take.
extern "C" int d3d_stage_maps(const int* coords, const uint8_t* valid,
                              int batch, const int* plan, int n_stages,
                              void* const* outs, void* scratch,
                              long long scratch_len, void* stream) {
  static_assert(sizeof(Stage) == kPlanInts * sizeof(int), "the plan's ints");
  const long long need = scratch_ints(batch, plan, n_stages);
  if (need < 0 || need > scratch_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const Stage* st = reinterpret_cast<const Stage*>(plan);
  cudaError_t err = cudaMemsetAsync(scratch, 0, need * sizeof(int), strm);
  if (err != cudaSuccess) return static_cast<int>(err);

  int* at = static_cast<int*>(scratch);
  Table t{};
  t.slots = at;
  t.log2slots = log2_slots(st[0].rows);
  at += static_cast<long long>(batch) << (t.log2slots + 1);
  Sites in{coords, valid, st[0].rows};
  long long n = static_cast<long long>(batch) * in.rows;
  if (n > 0)
    insert_kernel<<<blocks_for(n), kThreads, 0, strm>>>(in, st[0], t, n);
  int o = 0;
  for (int s = 0; s < n_stages; ++s) {
    const Stage& x = st[s];
    n = static_cast<long long>(batch) * x.rows * kSubmOffsets;
    if (n > 0)
      subm_kernel<<<blocks_for(n), kThreads, 0, strm>>>(
          in, x, t, n, static_cast<int*>(outs[o]));
    ++o;
    if (x.kind == 0) break;
    int* nbr_s = static_cast<int*>(outs[o++]);
    int* out_coords = static_cast<int*>(outs[o++]);
    uint8_t* out_valid = static_cast<uint8_t*>(outs[o++]);
    const long long words = bitmap_words(x);
    const int blocks = static_cast<int>(words / kBlockWords);
    unsigned* bits = reinterpret_cast<unsigned*>(at);
    int* rank = at + batch * words;
    int* block_counts = rank + batch * words;
    int* counts = block_counts + round4(batch * blocks);
    at = counts + round4(batch);
    const int taps = x.kind == 1 ? 1 : x.k[0] * x.k[1] * x.k[2];
    n = static_cast<long long>(batch) * x.rows * taps;
    if (n > 0)
      candidates_kernel<<<blocks_for(n), kThreads, 0, strm>>>(in, x, taps, n,
                                                              bits, words);
    if (blocks > 0) {  // (an empty output extent has no sites)
      const dim3 grid(blocks, batch);
      count_kernel<<<grid, kThreads, 0, strm>>>(bits, words, block_counts);
      emit_kernel<<<grid, kThreads, 0, strm>>>(bits, words, block_counts, x,
                                               rank, out_coords, counts);
    }
    const int map_taps = x.k[0] * x.k[1] * x.k[2];
    n = static_cast<long long>(batch) * x.out_rows * map_taps;
    if (n > 0)
      strided_kernel<<<blocks_for(n), kThreads, 0, strm>>>(
          x, t, map_taps, n, counts, out_coords, out_valid, nbr_s);
    // the next stage's sites and their lookups: this layer's outputs
    in = Sites{out_coords, out_valid, x.out_rows};
    t = Table{};
    t.bits = bits;
    t.rank = rank;
    t.words = words;
    t.rows = x.out_rows;
  }
  return static_cast<int>(cudaGetLastError());
}
