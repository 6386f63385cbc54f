// K7 — one round of size-constrained label propagation, for Hopper.
//
// Replaces the XLA round of sparsebase_tpu/ops/partition/labelprop.py:
// _propagate (:160) with _neighbor_counts (:78), which builds an (n, k)
// float32 histogram of the neighbours' labels by a 2-D scatter-add, takes its
// largest cell, a bincount of the labels, a penalty per part and an argmax
// per row. For each row r of a CSR (int64 indptr, int32 ids that name rows),
// int32 labels in [0, k):
//   counts[r, p] = entries j of row r with labels[ids[j]] == p
//                  (with float32 weights: their sum, in entry order)
//   gmax         = max over all (r, p) of counts[r, p]
//   sizes[p]     = vertices v with labels[v] == p
//   pen[p]       = alpha * max(sizes[p] - cap, 0) * (gmax + 1) / cap_div
//                  in float32, in that order, each step rounded once
//                  (__fmul_rn, __fdiv_rn: no contraction, a true division)
//   out[r]       = the first p of the largest counts[r, p] - pen[p], or
//                  labels[r] where row r has no entries.
// A label outside [0, k) counts nowhere (the caller's labels have none).
//
// What bounds it on the H100. Its function reads indptr, ids and labels once
// and writes the new labels: at 6.25M rows and 100M entries, 50 + 400 + 25 +
// 25 MB, 0.15 ms at 3.35 TB/s. In practice the floor is the gather
// labels[ids[j]], one random read an entry from L2: 100M 4-byte gathers from
// the 25 MB labels take about 1 ms whatever issues them (chip_smoke.py's
// torch.index_select probe). So a round gathers once an entry, and from a
// 1-byte copy of the labels where k <= 255 (6.25 MB at path H; the copy is
// one coalesced pass over n).
//
// The argmax needs gmax, a grid-wide maximum, before any row can choose, so
// one C call is a memset of the part sizes, gmax and the split key, lp_bytes
// (the 1-byte copy, k <= 255), then two launches on the caller's stream (three
// with the span pass, below), with no host read. Which is chosen on the host
// from (n, k, nnz), in make_plan:
//  - stored (n * k <= nnz and k <= 6,140): lp_count counts each row once,
//    takes the part sizes and gmax, and writes each row's k cells to a
//    scratch of n * k words, no larger than the ids it read; then lp_pick
//    reads those cells (coalesced, no gather), computes the k penalties in
//    each block's prologue and takes each row's first-index argmax (a thread
//    a row up to k = 8, else a group of lanes a row). The entries are read
//    once. At path H (k = 8) the cells take 200 MB.
//  - two passes (n * k > nnz: large k on a sparse graph, or the global
//    tier): lp_count without the cells, lp_penalty for the k penalties, and
//    lp_assign, which counts each row again and takes its argmax.
//
// Counting. A group of G lanes takes a row (G = 8 for k <= 64, where rows of
// about 16 entries keep the lanes busy, else a warp). Three tiers, by k:
//  - registers (k <= 8): unweighted, each lane keeps 8 counts in registers,
//    strides the row's entries and adds 1 to the count of the label it reads
//    (8 compares, no atomics: a labelling with one dominant part costs
//    nothing extra); the group then folds the counts by shuffles (a
//    reduce-scatter: 3 steps that each send half of what is left) so that
//    lane gl holds the total of part gl. The counts are integers, so their
//    order does not matter. Against the shared-memory tier at k = 8
//    (tools/torch_k7_ab.py on the H100): 5% less device time on path H's
//    graph, the same on the planted one, 12-14% less time with weights, and
//    1.6x as fast on a row of 262,144 entries, where the group's atomics on
//    one label serialise.
//  - shared memory (8 < k <= 6,140): each group owns a k-word histogram in
//    48 KB of shared memory (no opt-in) beside the block's k-word table; its
//    lanes add 1 by shared-memory atomics.
//  - global (k > 6,140): each warp's histogram is a slice of a scratch
//    buffer in device memory (kGlobalWords words in all, at least 8 warps).
// With weights every lane of the group walks the row in entry order and adds
// the weights of the parts it owns (p = lane mod G), in a register or in its
// group's histogram, so each cell is a sum in entry order, as np.add.at
// takes it.
//
// The span pass (unweighted, stored, k <= 8). A skewed graph's hubs would
// each hold one group of 8 lanes for their whole length (kron at scale 25:
// a row of 639,917 entries, 23.4% of the entries in rows past 4,096; one
// round 27.4 ms, 11.7 ms with every row cut to 4,096). So lp_count's row
// pass hands each row of more than kSplitRows = 1,024 entries over: the
// group's first lane takes the row's slot and its first entry among the
// handed rows' entries in one 64-bit atomicAdd on the split key (rows << 36
// | entries), writes (first, row) to the slot, and the group counts nothing,
// so the row's stored cells are written 0. A second lp_count instance,
// lp_count<C, true>, on a resident grid, reads the key and cuts the handed
// entries into equal spans, one a warp (at least kSpanMin = 2,048 entries,
// so a few short rows are not spread over many warps), finds its first row
// by a binary search of the slots, counts each row's part of its span in 8
// registers a lane (4 gathers in flight), folds them over the warp and adds
// them to the row's cells with k integer atomicAdds. Integer sums do not
// depend on their order, so the cells are those of one walk. gmax stays
// exact: each warp then adds the entries it counted to the row's ticket
// after a fence; the warp that brings it to the row's length reads the
// finished cells (from L2) and takes their largest into gmax, which the row
// pass left at the other rows' largest (the handed rows' 0s count no
// higher). Weighted rows keep their walk: a split would sum each cell in
// another order than np.add.at's. The other tiers and the two-pass route do
// not split. The part sizes come from one coalesced read of the labels, a
// warp adding each distinct label once (__match_any_sync). Warps loop over
// the rows with a trip count that is the same for all their lanes, so the
// group shuffles run converged. Grids are the rows' count capped at what the
// card holds at once (the SM count, read at each launch, times each kernel's
// occupancy, asked once per shape: a query takes about 10 us of host time; a
// failed query is returned).
//
// Scratch (sb_label_prop_scratch_bytes): the sizes (k ints), gmax's key and
// the split key, the penalties (k floats), the 1-byte labels (n bytes, k <=
// 255), then the stored cells (4 n k bytes <= 4 nnz) or the global tier's
// histograms; on the stored register tier, after the cells, the slots of the
// handed rows (24 bytes each, at most nnz / (kSplitRows + 1)).
//
// Tried and dropped (tools/torch_k7_ab.py on the H100): counts in registers
// up to k = 16 (16 compares an entry and a spill: no faster than the
// shared-memory tier at k = 16); lp_pick with a group of 8 lanes a row at k
// = 8 (128 bytes in flight a warp: 0.25 ms for path H's 200 MB of cells,
// against 0.09-0.10 ms with a thread a row). For the span pass, on kron at
// scale 25 (one round): kSplitRows of 4,096 (14.56 ms: 11.1 ms left in the
// row pass), 2,048 (13.86), 512 (13.79, level with 1,024's 13.80) and 256
// (14.33: the per-row fold, atomics and ticket of many short handed rows);
// 8 gathers in flight a lane (13.84 at 1,024: L2's gather rate, not the
// loads a lane keeps in flight, sets the pace). Path A's and the planted
// graph's rounds, which hand nothing over, stayed level with the design
// before the split (0.96-1.11 ms).
//
// Known costs, left for later work: the row pass now takes half of kron's
// round (6.4 of 13.7 ms at scale 25, 6.6e10 entries/s, against the span
// pass's 9.5e10), its 8-lane groups holding one gather in flight a lane;
// with weights each lane of a group reads every entry of the row, and a hub
// is still walked by one group; every row scans all k cells, which is n * k
// work at large k; on small graphs (a few million entries) the extra launch
// of lp_bytes and the stored cells' write and read cost about what they
// save.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemWords = 12280;           // 48 KB with lp_count's static 32 bytes: no opt-in
constexpr int kNarrowK = 64;                // k up to this: groups of 8 lanes
constexpr int kRegK = 8;                    // k up to this: counts in registers, one a lane
constexpr int kByteK = 255;                 // k up to this: gathers from a 1-byte copy of the labels
constexpr int64_t kGlobalWords = 1 << 24;   // the global tier's histograms: 64 MB
constexpr int64_t kSplitRows = 1024;        // longer rows go to the span pass (ops/kernels/label_prop.py::SPLIT_ROWS)
constexpr int64_t kSpanMin = 2048;          // the least entries a warp of the span pass takes
constexpr int kSpanUnroll = 4;              // gathers in flight a lane in the span pass
constexpr int kEntryBits = 36;              // the split key: rows handed over << kEntryBits | their entries
constexpr unsigned long long kEntryMask = (1ull << kEntryBits) - 1;

// the current device's SM count into *sms
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// *blocks = want, at most the blocks of `kKernel` the card holds at once: the
// SM count read at each launch, the occupancy asked once per shape and host
// thread (a failed query is returned and asked again)
template <auto kKernel>
cudaError_t resident_grid(int threads, size_t smem, int64_t want, unsigned* blocks) {
  struct Shape {
    int threads;
    size_t smem;
    int per_sm;
  };
  thread_local Shape last{0, 0, 0};
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess && (last.threads != threads || last.smem != smem)) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, threads, smem);
    if (err == cudaSuccess) last = Shape{threads, smem, per_sm};
  }
  if (err != cudaSuccess) return err;
  const int64_t cap = (int64_t)sms * (last.per_sm > 0 ? last.per_sm : 1);
  *blocks = (unsigned)(want < 1 ? 1 : want < cap ? want : cap);
  return cudaSuccess;
}

int64_t align256(int64_t bytes) { return (bytes + 255) & ~int64_t(255); }

enum class Tier { kRegisters, kShared, kGlobal };

struct Plan {
  Tier tier;
  int group;       // lanes per row: 8 or 32
  int groups;      // rows a block takes at once
  bool stored;     // the cells kept between the launches: one read of the entries
  bool bytes;      // the gathers read a 1-byte copy of the labels
  bool split;      // unweighted, rows over kSplitRows go to the span pass (stored register tier)
  int64_t blocks;  // before the cap by the card (global tier: exact)
};

Plan make_plan(int64_t n, int64_t k, int64_t nnz) {
  Plan p{};
  p.group = k <= kNarrowK ? 8 : 32;
  const int64_t fit = kSmemWords / k - 1;  // histograms beside the block's k-word table
  if (k <= kRegK) {
    p.tier = Tier::kRegisters;
    p.groups = kThreads / p.group;
  } else if (fit >= 1) {
    p.tier = Tier::kShared;
    int64_t g = kThreads / p.group;
    if (fit < g) g = fit;
    if (p.group == 8) g &= ~int64_t(3);  // whole warps (fit >= 190 here)
    p.groups = (int)g;
  } else {
    p.tier = Tier::kGlobal;
    p.groups = kThreads / 32;
    int64_t slices = (kGlobalWords / k) & ~int64_t(7);
    if (slices < 8) slices = 8;
    const int64_t need = (n + 7) / 8 * 8;
    if (slices > need) slices = need;
    p.blocks = slices / 8;
  }
  if (p.tier != Tier::kGlobal) p.blocks = (n + p.groups - 1) / p.groups;
  if (p.blocks < 1) p.blocks = 1;
  p.stored = p.tier != Tier::kGlobal && n * k <= nnz;  // n, k < 2^31: no overflow
  p.bytes = k <= kByteK;
  p.split = p.stored && p.tier == Tier::kRegisters;
  return p;
}

// a row handed to the span pass
struct Split {
  int64_t first;            // its first entry among the handed rows' entries, in the order handed
  int64_t row;
  unsigned long long done;  // its entries counted so far (the last span to count finds all)
};

// the most rows longer than kSplitRows that nnz entries hold
int64_t split_capacity(int64_t nnz) { return nnz / (kSplitRows + 1); }

struct Args {
  const int64_t* indptr;
  const int* ids;
  const float* w;
  const int* labels;
  uint8_t* labels8;  // the 1-byte copy (255 outside [0, k)) where k <= kByteK
  int64_t n;
  int k;
  float alpha, cap, cap_div;
  uint32_t* ghist;  // the global tier's histograms
  uint32_t* cells;  // the stored route's (n, k) cells, else null
  int* sizes;
  unsigned* gmax_key;
  float* pen;
  int* out;
  unsigned long long* split_key;  // rows handed to the span pass << kEntryBits | their entries
  Split* split;                   // the rows handed over, else null (no span pass)
};

// an unsigned key that orders as the float does
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// the label of vertex `id`, from the 1-byte copy (L = uint8_t) or the labels
template <class L>
__device__ __forceinline__ int label_of(const Args& a, int id) {
  if constexpr (sizeof(L) == 1) return __ldg(a.labels8 + id);
  else return __ldg(a.labels + id);
}

// the 1-byte copy of the labels that the gathers read where k <= kByteK
__global__ void __launch_bounds__(kThreads) lp_bytes(const Args a) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < a.n; v += step) {
    const int p = __ldg(a.labels + v);
    a.labels8[v] = (unsigned)p < (unsigned)a.k ? (uint8_t)p : (uint8_t)255;
  }
}

// a cell's word as a float: an integer count, or the bits of a weighted sum
template <bool W>
__device__ __forceinline__ float cell(uint32_t word) {
  return W ? __uint_as_float(word) : __int2float_rn((int)word);
}

__device__ __forceinline__ uint32_t add_weight(uint32_t word, float w) {
  return __float_as_uint(__fadd_rn(__uint_as_float(word), w));
}

// pen[p], in the reference's order of operations
__device__ __forceinline__ float penalty(int size, unsigned gmax_key, float alpha, float cap, float cap_div) {
  const float top = __fadd_rn(key_float(gmax_key), 1.0f);
  const float over = fmaxf(__fsub_rn(__int2float_rn(size), cap), 0.0f);
  return __fdiv_rn(__fmul_rn(__fmul_rn(alpha, over), top), cap_div);
}

// the first part of the group's best score (lanes hold their own best)
template <int G>
__device__ __forceinline__ int group_argmax(float best, int bp) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off, G);
    const int op = __shfl_xor_sync(0xffffffffu, bp, off, G);
    if (ob > best || (ob == best && op < bp)) {
      best = ob;
      bp = op;
    }
  }
  return bp;
}

// The counters: count(row) (the row's lanes only), then finish() (every lane
// of the warp), then each(f), which hands lane gl its cells p = gl, gl + G,
// ... (< k) in increasing order, then done() (every lane).

// k <= kRegK counts in registers, a group of 8 lanes a row; lane gl owns cell gl
template <bool W, class L>
struct RegCounter {
  using Label = L;
  static constexpr int kGroup = 8;
  static_assert(kRegK == kGroup, "one cell a lane");
  static constexpr bool kWeighted = W, kGlobal = false, kSplits = !W;
  static __host__ __device__ int64_t hist_words(int, int) { return 0; }
  uint32_t c[kRegK] = {};  // weighted: only c[0], the lane's own cell

  __device__ __forceinline__ RegCounter(const Args&, uint32_t*, int, int, int) {}

  __device__ __forceinline__ void count(const Args& a, int64_t s, int64_t e, int gl) {
#pragma unroll
    for (int q = 0; q < kRegK; ++q) c[q] = 0;
    if (W) {  // each lane walks the row in entry order and adds the weights of its part
      for (int64_t j = s; j < e; ++j)
        if (label_of<L>(a, __ldg(a.ids + j)) == gl) c[0] = add_weight(c[0], __ldg(a.w + j));
    } else {  // a label in [k, kRegK) lands in a cell that is never read
      for (int64_t j = s + gl; j < e; j += kGroup) {
        const int p = label_of<L>(a, __ldg(a.ids + j));
#pragma unroll
        for (int q = 0; q < kRegK; ++q) c[q] += p == q;
      }
    }
  }

  // a reduce-scatter over the group: at step O a lane keeps the cells whose
  // bit O matches its own (cell index 2i + up) and sends the others to lane
  // gl ^ O; after 3 steps c[0] is the total of cell gl
  template <int O, int N>
  __device__ __forceinline__ void fold(int gl) {
    if constexpr (O < kGroup) {
      const bool up = gl & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const uint32_t lo = c[2 * i], hi = c[2 * i + 1];
        c[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
      }
      fold<2 * O, N / 2>(gl);
    }
  }

  __device__ __forceinline__ void finish(int gl) {
    if constexpr (!W) fold<1, kRegK>(gl);
  }

  // the span pass (unweighted): entries [s, e) counted by a whole warp, kSpanUnroll gathers in flight a lane,
  // then folded so that lanes l, l + 8, l + 16 and l + 24 hold in c[0] the warp's total of cell l
  __device__ __forceinline__ void count_span(const Args& a, int64_t s, int64_t e, int lane) {
#pragma unroll
    for (int q = 0; q < kRegK; ++q) c[q] = 0;
    int64_t j = s + lane;
    for (; j + 32 * (kSpanUnroll - 1) < e; j += 32 * kSpanUnroll) {
      int p[kSpanUnroll];
#pragma unroll
      for (int u = 0; u < kSpanUnroll; ++u) p[u] = __ldg(a.ids + j + 32 * u);
#pragma unroll
      for (int u = 0; u < kSpanUnroll; ++u) p[u] = label_of<L>(a, p[u]);
#pragma unroll
      for (int u = 0; u < kSpanUnroll; ++u)
#pragma unroll
        for (int q = 0; q < kRegK; ++q) c[q] += p[u] == q;
    }
    for (; j < e; j += 32) {
      const int p = label_of<L>(a, __ldg(a.ids + j));
#pragma unroll
      for (int q = 0; q < kRegK; ++q) c[q] += p == q;
    }
    fold<1, kRegK>(lane & (kGroup - 1));
    c[0] += __shfl_xor_sync(0xffffffffu, c[0], 8);
    c[0] += __shfl_xor_sync(0xffffffffu, c[0], 16);
  }

  template <class F>
  __device__ __forceinline__ void each(int gl, int k, F&& f) {
    if (gl < k) f(gl, c[0]);
  }

  __device__ __forceinline__ void done() {}
};

// a k-word histogram per group, in shared memory or (GLOBAL) in the scratch
template <int G_, bool W, bool GLOBAL, class L>
struct HistCounter {
  using Label = L;
  static constexpr int kGroup = G_;
  static constexpr bool kWeighted = W, kGlobal = GLOBAL, kSplits = false;
  static __host__ __device__ int64_t hist_words(int groups, int k) { return GLOBAL ? 0 : (int64_t)groups * k; }
  uint32_t* hist;
  const int k;

  // clears the histograms; the caller syncs the block before counting
  __device__ __forceinline__ HistCounter(const Args& a, uint32_t* smem, int group, int groups, int gl) : k(a.k) {
    if (GLOBAL) {
      hist = a.ghist + ((int64_t)blockIdx.x * groups + group) * k;
      for (int p = gl; p < k; p += G_) hist[p] = 0;
    } else {
      hist = smem + group * k;
      for (int i = threadIdx.x; i < groups * k; i += blockDim.x) smem[i] = 0;
    }
  }

  __device__ __forceinline__ void count(const Args& a, int64_t s, int64_t e, int gl) {
    if (W) {
      for (int64_t j = s; j < e; ++j) {
        const int p = label_of<L>(a, __ldg(a.ids + j));
        if ((unsigned)p < (unsigned)k && (p & (G_ - 1)) == gl) hist[p] = add_weight(hist[p], __ldg(a.w + j));
      }
    } else {
      for (int64_t j = s + gl; j < e; j += G_) {
        const int p = label_of<L>(a, __ldg(a.ids + j));
        if ((unsigned)p < (unsigned)k) atomicAdd(reinterpret_cast<int*>(hist + p), 1);
      }
    }
  }

  __device__ __forceinline__ void finish(int) { __syncwarp(); }

  // the lane that reads a cell clears it for the next row
  template <class F>
  __device__ __forceinline__ void each(int gl, int, F&& f) {
    for (int p = gl; p < k; p += G_) {
      f(p, hist[p]);
      hist[p] = 0;
    }
  }

  __device__ __forceinline__ void done() { __syncwarp(); }
};

// hands a row over kSplitRows entries to the span pass: its slot and its first entry in one atomic
__device__ __forceinline__ void hand_over(const Args& a, int64_t row, int64_t len) {
  const unsigned long long key = atomicAdd(a.split_key, (1ull << kEntryBits) | (unsigned long long)len);
  a.split[key >> kEntryBits] = Split{(int64_t)(key & kEntryMask), row, 0ull};
}

// The span pass: the handed rows' entries, in the order handed, cut into equal spans of at least kSpanMin, one a
// warp. A warp adds its counts of each row it meets to the row's stored cells (zeroed by lp_count's row pass), and
// the warp whose span completes a row (its `done` reaches the row's length) takes the row's largest cell into gmax.
template <class C>
__device__ __forceinline__ void span_pass(const Args& a) {
  const unsigned long long key = *a.split_key;
  const int64_t rows = (int64_t)(key >> kEntryBits), total = (int64_t)(key & kEntryMask);
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, k = a.k;
  int64_t span = (total + warps - 1) / warps;
  if (span < kSpanMin) span = kSpanMin;
  int64_t lo = warp * span;
  const int64_t hi = lo + span < total ? lo + span : total;
  int64_t i = 0;
  for (int64_t r = rows - 1; lo < hi && i < r;) {  // the last handed row that starts at or before lo
    const int64_t m = (i + r + 1) / 2;
    if (a.split[m].first <= lo) i = m;
    else r = m - 1;
  }
  C counter(a, nullptr, 0, 0, 0);
  for (; lo < hi; ++i) {
    const int64_t first = a.split[i].first, row = a.split[i].row;
    const int64_t s = __ldg(a.indptr + row), len = __ldg(a.indptr + row + 1) - s;
    const int64_t from = lo - first, to = hi - first < len ? hi - first : len;
    counter.count_span(a, s + from, s + to, lane);
    uint32_t* cells = a.cells + row * k;
    if (lane < k && counter.c[0]) atomicAdd(cells + lane, counter.c[0]);
    __threadfence();
    __syncwarp();
    unsigned long long before = 0;
    if (lane == 0) before = atomicAdd(&a.split[i].done, (unsigned long long)(to - from));
    before = __shfl_sync(0xffffffffu, before, 0);
    if ((int64_t)before + (to - from) == len) {  // the row's last span: its cells are complete
      __threadfence();
      float m = lane < k ? __int2float_rn((int)__ldcg(cells + lane)) : 0.0f;
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) atomicMax(a.gmax_key, order_key(m));
    }
    lo = first + to;
  }
}

// pass 1: the part sizes, the histograms' largest cell and, stored, the cells; SPANS: the span pass
template <class C, bool SPANS = false>
__global__ void __launch_bounds__(kThreads) lp_count(const Args a) {
  if constexpr (SPANS) {
    span_pass<C>(a);
    return;
  }
  extern __shared__ uint32_t smem[];
  __shared__ float warp_max[kThreads / 32];
  constexpr int G = C::kGroup;
  const int groups = blockDim.x / G;
  const int group = threadIdx.x / G, gl = threadIdx.x % G, lane = threadIdx.x & 31;
  const int k = a.k;
  int* block_sizes = C::kGlobal ? a.sizes : reinterpret_cast<int*>(smem + C::hist_words(groups, k));
  C counter(a, smem, group, groups, gl);
  if (!C::kGlobal)
    for (int p = threadIdx.x; p < k; p += blockDim.x) block_sizes[p] = 0;
  __syncthreads();
  // the sizes: the labels read once, coalesced; a warp adds each of its distinct labels once
  const int64_t vstep = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < a.n; base += vstep) {
    const int p = base + lane < a.n ? __ldg(a.labels + base + lane) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    if ((unsigned)p < (unsigned)k && lane == __ffs(peers) - 1) atomicAdd(block_sizes + p, __popc(peers));
  }
  float lmax = __int_as_float(0xff800000);  // -inf
  const int warp_first = group & ~(32 / G - 1);
  const int64_t step = (int64_t)gridDim.x * groups;
  for (int64_t blk = (int64_t)blockIdx.x * groups; blk + warp_first < a.n; blk += step) {
    const int64_t row = blk + group;
    const bool valid = row < a.n;
    if (valid) {
      const int64_t s = __ldg(a.indptr + row);
      int64_t e = __ldg(a.indptr + row + 1);
      if constexpr (C::kSplits) {
        if (a.split && e - s > kSplitRows) {  // counted by the span pass, into cells written 0 here
          if (gl == 0) hand_over(a, row, e - s);
          e = s;
        }
      }
      counter.count(a, s, e, gl);
    }
    counter.finish(gl);
    if (valid) {
      uint32_t* cells = a.cells ? a.cells + row * k : nullptr;
      counter.each(gl, k, [&](int p, uint32_t word) {
        lmax = fmaxf(lmax, cell<C::kWeighted>(word));
        if (cells) __stcs(cells + p, word);  // streamed past L2, where the labels stay
      });
    }
    counter.done();
  }
  for (int off = 16; off > 0; off >>= 1) lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
  if (lane == 0) warp_max[threadIdx.x >> 5] = lmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, warp_max[i]);
    atomicMax(a.gmax_key, order_key(m));
  }
  if (!C::kGlobal) {
    for (int p = threadIdx.x; p < k; p += blockDim.x) {
      const int c = block_sizes[p];
      if (c) atomicAdd(a.sizes + p, c);
    }
  }
}

// two passes, between them: the k penalties
__global__ void lp_penalty(const Args a) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.k) a.pen[p] = penalty(a.sizes[p], *a.gmax_key, a.alpha, a.cap, a.cap_div);
}

// two passes, pass 2: each row's histogram again, and the first part of its best score
template <class C>
__global__ void __launch_bounds__(kThreads) lp_assign(const Args a) {
  extern __shared__ uint32_t smem[];
  constexpr int G = C::kGroup;
  const int groups = blockDim.x / G;
  const int group = threadIdx.x / G, gl = threadIdx.x % G;
  const int k = a.k;
  C counter(a, smem, group, groups, gl);
  float* block_pen = reinterpret_cast<float*>(smem + C::hist_words(groups, k));
  if (!C::kGlobal)
    for (int p = threadIdx.x; p < k; p += blockDim.x) block_pen[p] = a.pen[p];
  __syncthreads();
  const float* pens = C::kGlobal ? a.pen : block_pen;
  const int warp_first = group & ~(32 / G - 1);
  const int64_t step = (int64_t)gridDim.x * groups;
  for (int64_t blk = (int64_t)blockIdx.x * groups; blk + warp_first < a.n; blk += step) {
    const int64_t row = blk + group;
    const bool valid = row < a.n;
    int64_t s = 0, e = 0;
    if (valid) {
      s = __ldg(a.indptr + row);
      e = __ldg(a.indptr + row + 1);
      counter.count(a, s, e, gl);
    }
    counter.finish(gl);
    float best = __int_as_float(0xff800000);
    int bp = INT_MAX;  // a lane without cells (k < G) never wins a tie
    if (valid) {
      counter.each(gl, k, [&](int p, uint32_t word) {
        const float score = __fsub_rn(cell<C::kWeighted>(word), pens[p]);
        if (bp == INT_MAX || score > best) {
          best = score;
          bp = p;
        }
      });
    }
    counter.done();
    bp = group_argmax<G>(best, bp);
    if (valid && gl == 0) a.out[row] = e > s ? bp : __ldg(a.labels + row);
  }
}

// stored, pass 2: the penalties in the block's prologue, then each row's
// first part of its best score from its stored cells
template <int G, bool W>
__global__ void __launch_bounds__(kThreads) lp_pick(const Args a) {
  extern __shared__ uint32_t smem[];
  float* pen = reinterpret_cast<float*>(smem);
  const int k = a.k;
  const unsigned gmax_key = *a.gmax_key;
  for (int p = threadIdx.x; p < k; p += blockDim.x) pen[p] = penalty(a.sizes[p], gmax_key, a.alpha, a.cap, a.cap_div);
  __syncthreads();
  const int groups = blockDim.x / G;
  const int group = threadIdx.x / G, gl = threadIdx.x % G;
  const int warp_first = group & ~(32 / G - 1);
  const int64_t step = (int64_t)gridDim.x * groups;
  for (int64_t blk = (int64_t)blockIdx.x * groups; blk + warp_first < a.n; blk += step) {
    const int64_t row = blk + group;
    const bool valid = row < a.n;
    float best = __int_as_float(0xff800000);
    int bp = INT_MAX;
    if (valid) {
      const uint32_t* cells = a.cells + row * k;
      for (int p = gl; p < k; p += G) {
        const float score = __fsub_rn(cell<W>(__ldcs(cells + p)), pen[p]);
        if (bp == INT_MAX || score > best) {
          best = score;
          bp = p;
        }
      }
    }
    bp = group_argmax<G>(best, bp);
    if (valid && gl == 0) a.out[row] = __ldg(a.indptr + row + 1) > __ldg(a.indptr + row) ? bp : __ldg(a.labels + row);
  }
}

// stored, k <= kRegK: a thread per row, its k cells loaded at once (a group
// per row keeps too few bytes in flight: 128 a warp)
template <bool W>
__global__ void __launch_bounds__(kThreads) lp_pick_rows(const Args a) {
  __shared__ float pen[kRegK];
  const int k = a.k;
  if (threadIdx.x < k) pen[threadIdx.x] = penalty(a.sizes[threadIdx.x], *a.gmax_key, a.alpha, a.cap, a.cap_div);
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < a.n; row += step) {
    const uint32_t* cells = a.cells + row * k;
    uint32_t word[kRegK];
#pragma unroll
    for (int p = 0; p < kRegK; ++p) word[p] = p < k ? __ldg(cells + p) : 0u;
    float best = 0.0f;
    int bp = 0;
#pragma unroll
    for (int p = 0; p < kRegK; ++p) {
      const float score = __fsub_rn(cell<W>(word[p]), pen[p < k ? p : 0]);
      if (p < k && (p == 0 || score > best)) {
        best = score;
        bp = p;
      }
    }
    a.out[row] = __ldg(a.indptr + row + 1) > __ldg(a.indptr + row) ? bp : __ldg(a.labels + row);
  }
}

template <class C>
cudaError_t run(const Plan& p, const Args& a, cudaStream_t s) {
  constexpr int G = C::kGroup;
  const int threads = p.groups * G;
  const size_t smem = (size_t)(C::hist_words(p.groups, a.k) + (C::kGlobal ? 0 : a.k)) * sizeof(uint32_t);
  unsigned blocks = (unsigned)p.blocks;  // the global tier's slices are exact
  cudaError_t err = cudaSuccess;
  if constexpr (sizeof(typename C::Label) == 1) {
    unsigned copy = 1;
    err = resident_grid<lp_bytes>(kThreads, 0, (a.n + kThreads - 1) / kThreads, &copy);
    if (err != cudaSuccess) return err;
    lp_bytes<<<copy, kThreads, 0, s>>>(a);
  }
  if (!C::kGlobal) err = resident_grid<lp_count<C>>(threads, smem, p.blocks, &blocks);
  if (err != cudaSuccess) return err;
  lp_count<C><<<blocks, threads, smem, s>>>(a);
  if constexpr (C::kSplits) {
    if (a.split) {  // a resident grid: only the card knows the entries handed over
      unsigned spans = 1;
      err = resident_grid<lp_count<C, true>>(kThreads, 0, p.blocks, &spans);
      if (err != cudaSuccess) return err;
      lp_count<C, true><<<spans, kThreads, 0, s>>>(a);
    }
  }
  if (p.stored && p.tier == Tier::kRegisters) {
    unsigned pick = 1;
    err = resident_grid<lp_pick_rows<C::kWeighted>>(kThreads, 0, (a.n + kThreads - 1) / kThreads, &pick);
    if (err != cudaSuccess) return err;
    lp_pick_rows<C::kWeighted><<<pick, kThreads, 0, s>>>(a);
  } else if (p.stored) {
    unsigned pick = 1;
    const size_t pen_bytes = (size_t)a.k * sizeof(float);
    err = resident_grid<lp_pick<G, C::kWeighted>>(kThreads, pen_bytes, (a.n + kThreads / G - 1) / (kThreads / G),
                        &pick);
    if (err != cudaSuccess) return err;
    lp_pick<G, C::kWeighted><<<pick, kThreads, pen_bytes, s>>>(a);
  } else {
    lp_penalty<<<(unsigned)((a.k + 255) / 256), 256, 0, s>>>(a);
    if (!C::kGlobal) err = resident_grid<lp_assign<C>>(threads, smem, p.blocks, &blocks);
    if (err != cudaSuccess) return err;
    lp_assign<C><<<blocks, threads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

template <bool W>
cudaError_t dispatch(const Plan& p, const Args& a, cudaStream_t s) {
  switch (p.tier) {
    case Tier::kRegisters:  // k <= kRegK <= kByteK
      return run<RegCounter<W, uint8_t>>(p, a, s);
    case Tier::kShared:
      if (p.group == 8) return run<HistCounter<8, W, false, uint8_t>>(p, a, s);  // k <= kNarrowK <= kByteK
      return p.bytes ? run<HistCounter<32, W, false, uint8_t>>(p, a, s) : run<HistCounter<32, W, false, int>>(p, a, s);
    default:  // k > kSmemWords > kByteK
      return run<HistCounter<32, W, true, int>>(p, a, s);
  }
}

}  // namespace

// Bytes of the scratch buffer that sb_label_prop_round needs for n rows, k
// parts and nnz entries: the sizes (k ints), the largest count's key, the
// penalties (k floats) and the stored cells (n * k words, where n * k <=
// nnz) or the global tier's histograms.
extern "C" int64_t sb_label_prop_scratch_bytes(int64_t n, int64_t k, int64_t nnz) {
  const Plan p = make_plan(n, k, nnz);
  int64_t bytes = 2 * align256(4 * k) + 256 + (p.bytes ? align256(n) : 0);
  if (p.tier == Tier::kGlobal) bytes += p.blocks * p.groups * k * (int64_t)sizeof(uint32_t);
  if (p.split) bytes += align256(n * k * (int64_t)sizeof(uint32_t)) + split_capacity(nnz) * (int64_t)sizeof(Split);
  else if (p.stored) bytes += n * k * (int64_t)sizeof(uint32_t);
  return bytes;
}

// 1 where a round of n rows, k parts and nnz entries, weighted or not, hands its rows of more than kSplitRows
// entries to the span pass (whether it has any is read on the card alone), else 0.
extern "C" int sb_label_prop_splits(int64_t n, int64_t k, int64_t nnz, int weighted) {
  return make_plan(n, k, nnz).split && !weighted;
}

// indptr: (n+1,) int64 with indptr[n] = nnz; ids: (nnz,) int32 in [0, n);
// weights: (nnz,) float32 or null; labels: (n,) int32; 1 <= k < 2^31;
// alpha, cap, cap_div: the float32 roundings of the reference's Python
// numbers; scratch: the bytes sb_label_prop_scratch_bytes(n, k, nnz) gives;
// out: (n,) int32, written in full.
extern "C" int sb_label_prop_round(const int64_t* indptr, const int* ids, const float* weights, const int* labels,
                                   int64_t n, int64_t nnz, int64_t k, float alpha, float cap, float cap_div,
                                   void* scratch, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const Plan p = make_plan(n, k, nnz);
  char* base = static_cast<char*>(scratch);
  const int64_t table = align256(4 * k);
  uint8_t* labels8 = p.bytes ? reinterpret_cast<uint8_t*>(base + 2 * table + 256) : nullptr;
  char* tail = base + 2 * table + 256 + (p.bytes ? align256(n) : 0);
  Split* split = p.split && !weights ? reinterpret_cast<Split*>(tail + align256(n * k * (int64_t)sizeof(uint32_t)))
                                     : nullptr;
  uint32_t* cells = p.stored ? reinterpret_cast<uint32_t*>(tail) : nullptr;
  const Args a{indptr, ids, weights, labels, labels8, n, (int)k, alpha, cap, cap_div, reinterpret_cast<uint32_t*>(tail),
               cells, reinterpret_cast<int*>(base), reinterpret_cast<unsigned*>(base + table),
               reinterpret_cast<float*>(base + table + 256), out,
               reinterpret_cast<unsigned long long*>(base + table + 8), split};
  // the sizes, the largest count and the split key
  const cudaError_t err = cudaMemsetAsync(base, 0, (size_t)(table + 256), s);
  if (err != cudaSuccess) return (int)err;
  return (int)(weights ? dispatch<true>(p, a, s) : dispatch<false>(p, a, s));
}
