// K6 — per-entry common-neighbour counts of a row-sorted CSR, for Hopper:
// Jaccard weights, the triangle sum, or the directed 3-cycle sum.
//
// Replaces the two XLA tiers of the JAX package that count, for every
// stored entry e = (u, v), the members of N(u) that lie in N(v):
// sparsebase_tpu/ops/feature/sparse_common.py::_group_runner (:53, both
// modes), a chunked binary search launched from the host in groups of 96
// blocks to stay clear of the TPU watchdog, and
// sparsebase_tpu/ops/feature/jaccard.py::_jaccard_device (:54), a flat
// ragged expansion with sum(deg(u)) slots over the entries. The reference
// library's counterpart is feature/jaccard_weights_cuda.cu:70-91 (a
// binary search per candidate).
//
// Semantics (entry e = (u, v), N(x) the sorted column ids of row x,
// duplicates kept):
// * jaccard:   c = #{t < deg u : N(u)[t] in N(v)}: every instance of a
//   candidate counts when it is a member of N(v). out_w[e] =
//   c / max(deg u + deg v - c, 1), divided in double and rounded to float:
//   the JAX host route's (inter / max(union, 1)).astype(float32), bit for
//   bit at any count (a float division of the same integers agrees with it
//   while both are below 2^24).
// * triangles: e is skipped when u == v or when it repeats entry e - 1 of
//   the same row; else c = #(distinct(N(u)) & distinct(N(v)) minus {u, v}).
//   All c are added into one int64 (*out_sum), one atomicAdd per block;
//   for a symmetric pattern the sum is six times the triangle count.
// * directed: e is skipped when v <= u or when it repeats entry e - 1;
//   else c = #{distinct w : w in N(v), w in I(u), w > u, w != v}, with I(u)
//   the sorted row ids of column u (the caller's CSC of the same matrix).
//   Each is a 3-cycle u -> v -> w -> u anchored at its least vertex u, so
//   the sum (*out_sum, as above) is the directed 3-cycle count; self-loops
//   take part in none.
//
// The kernel's contract: row u's list S (N(u); in directed mode I(u)) is
// staged once, and each entry counts in one of two directions, which give
// the same c:
// * stream: over the distinct y of N(v), look y up in S. jaccard adds the
//   multiplicity of y in S (upper bound - lower bound), which sums to the
//   instance count above; triangles and directed add 1 per y found.
// * search: over the positions t of S, search S[t] in N(v). jaccard adds 1
//   per instance found; triangles and directed take each distinct S[t] once.
//
// What bounds it on the H100: its function must read indptr (8 B a row) and
// the ids (4 B an entry) and write 4 B an entry (jaccard), 576 MB at path
// F's 4M rows and 68M entries, 0.172 ms at 3.35 TB/s (directed: the CSC's
// offsets and ids as well, and one sum out). The counting itself reads
// every entry's N(v) and its indptr pair, 6.0 GB at path F's size, in
// scattered lists of about 17 ids: random sectors of device memory and
// their latency, not the bound's bytes, set its time. The first design (a
// warp per entry, a dependent binary search in device memory per
// candidate) spent most of it waiting on those searches. This design:
// * works by row: a group of lanes owns a run of entries of one row u and
//   stages S once in shared memory; each lane then takes one entry v, whose
//   indptr[v], indptr[v + 1] loads are independent of the other lanes';
// * lets a lane stream a short N(v) (<= kLaneStreamMax ids) alone, the next
//   id loaded before the current one is looked up, each lookup a probe of a
//   hash table of S (tiers 1-3) or a binary search of S in shared memory;
//   a longer N(v) is taken by the whole group, lanes on consecutive ids
//   (coalesced), in the stream direction when deg v <= kStreamCost * |S| *
//   log2(deg v), else in the search direction (a hub v's list stays in L2);
// * leaves an entry whose cheaper direction still costs more than
//   kDeferCost lookups (two long lists) to cn_deferred, which gives each
//   such entry a block of its own, so that a row's few heavy entries do not
//   hold its group while the rest of the card idles;
// * splits the rows by entry count into tiers inside the same call
//   (classify_count, classify_place: one atomic per tier and warp, no host
//   read): 1-8 entries, 8 lanes a row; 9-16, 16 lanes; 17-32, a warp;
//   33-1,024, a block of 128 a row; longer rows, chunks of kChunk entries,
//   each block taking a run of consecutive chunks. Every launch is sized
//   from n and nnz alone and walks its tier grid-stride;
// * stages a list longer than its group's room as samples S[t * stride]
//   (stride a power of two): a lookup searches the samples in shared memory
//   and then a window of stride - 1 ids in device memory, so a hub's
//   lookups take log2(stride) device reads, not log2(deg u);
// * writes the Jaccard weights of consecutive entries from consecutive
//   lanes; the sums go through one atomicAdd per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kJaccard = 0, kTriangles = 1, kDirected = 2 };

// tiers 1-5 (tier_of): rows of 1..8, 9..16, 17..32, 33..kMidCap entries,
// and longer ones
constexpr int kGroupStage = 32;     // ids of S staged per lane group of tiers 1-3
constexpr int kMidCap = 1024;       // tier 4's rows and staged ids (4 KB)
constexpr int kBigCap = 8192;       // ids of S staged by tier 5 (32 KB)
constexpr int64_t kChunk = 512;     // tier 5: entries of a block's task
constexpr int kTiers = 6;           // tier 0: rows without entries
// plan words: count[kTiers], cursor[kTiers], tier_off[kTiers + 1], the queue's length
constexpr int kPlanWords = 3 * kTiers + 2;
constexpr int kLaneStreamMax = 32;  // a lane streams N(v) alone up to this length
constexpr int kStreamCost = 1;      // a group streams when deg v <= kStreamCost * |S| * log2(deg v)
constexpr int kDeferCost = 1024;    // lookups past which a group leaves an entry to cn_deferred

// S, row u's list: list[0, len) in device memory, and list[t * stride] for
// t < m in shared memory (stride 1: all of it; 0: none); in tiers 1-3 also, when all
// of it is staged, a hash table of its distinct ids and their counts
// (hk[slot] == -1: empty)
struct Staged {
  const int* sh;
  int m;
  int64_t stride;
  const int* list;
  int64_t len;
  const int* hk;
  const int* hc;
};

constexpr int kHashSlots = 2 * kGroupStage;  // at most half full
static_assert(kHashSlots == 64, "hash_slot takes the top 6 bits");

__device__ __forceinline__ int hash_slot(int x) { return (int)(((unsigned)x * 2654435761u) >> 26); }

__device__ __forceinline__ int s_at(const Staged& s, int64_t p) {
  return s.stride == 1 ? s.sh[p] : __ldg(s.list + p);
}

// first p in [lo, hi) with ids[p] >= x (> x when kUpper), hi if none
template <bool kUpper>
__device__ __forceinline__ int64_t bound_global(const int* __restrict__ ids, int64_t lo, int64_t hi, int x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const int y = __ldg(ids + mid);
    if (kUpper ? y <= x : y < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <bool kUpper>
__device__ __forceinline__ int bound_shared(const int* sh, int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int y = sh[mid];
    if (kUpper ? y <= x : y < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the bound of x in all of S: i samples pass, so list[(i - 1) * stride]
// passes and list[i * stride] does not (where they exist)
template <bool kUpper>
__device__ __forceinline__ int64_t s_bound(const Staged& s, int x) {
  const int i = bound_shared<kUpper>(s.sh, 0, s.m, x);
  if (s.stride == 1) return i;
  const int64_t lo = i == 0 ? 0 : (int64_t)(i - 1) * s.stride + 1;
  const int64_t hi = i == s.m ? s.len : (int64_t)i * s.stride;
  return bound_global<kUpper>(s.list, lo, hi, x);
}

// smallest power of two that leaves at most cap samples of len ids
__device__ __forceinline__ int64_t sample_stride(int64_t len, int cap) {
  int64_t st = 1;
  while ((len + st - 1) / st > cap) st <<= 1;
  return st;
}

// stages S (len ids at list) in sh, lanes `first`, `first + step`, ...
__device__ __forceinline__ Staged stage(int* sh, const int* __restrict__ list, int64_t len, int cap, int first,
                                        int step) {
  Staged s;
  s.hk = s.hc = nullptr;
  s.sh = sh;
  s.list = list;
  s.len = len;
  s.stride = sample_stride(len, cap);
  s.m = (int)((len + s.stride - 1) / s.stride);
  for (int t = first; t < s.m; t += step) sh[t] = __ldg(list + t * s.stride);
  return s;
}

__device__ __forceinline__ void prefetch_l1(const int* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// entry (u, v)'s count by streaming N(v) = ids[sv, ev) at sv + first, + step, ...
// (the next id is loaded before the current one is looked up)
template <int kMode>
__device__ __forceinline__ int64_t stream_count(const int* __restrict__ ids, int64_t sv, int64_t ev,
                                                const Staged& s, int u, int v, int first, int step) {
  int64_t c = 0;
  int64_t k = sv + first;
  if (k >= ev) return 0;
  if (step == 1)  // one lane alone: ask for the list's other 32-byte sectors at once
    for (int64_t p = (k | 7) + 1; p < ev; p += 8) prefetch_l1(ids + p);
  int y = __ldg(ids + k);
  int prev = k > sv ? __ldg(ids + k - 1) : ~y;
  while (true) {
    const int64_t next_k = k + step;
    const bool more = next_k < ev;
    const int next = more ? __ldg(ids + next_k) : 0;
    const int next_prev = !more ? 0 : step == 1 ? y : __ldg(ids + next_k - 1);
    const bool skip = prev == y  // each distinct y once
                      || (kMode == kTriangles && (y == u || y == v)) || (kMode == kDirected && (y <= u || y == v));
    if (!skip && s.hk != nullptr) {
      int slot = hash_slot(y), key;
      while ((key = s.hk[slot]) != y && key != -1) slot = (slot + 1) & (kHashSlots - 1);
      if (key == y) c += kMode == kJaccard ? s.hc[slot] : 1;
    } else if (!skip) {
      const int64_t lb = s_bound<false>(s, y);
      if (lb < s.len && s_at(s, lb) == y) c += kMode == kJaccard ? s_bound<true>(s, y) - lb : 1;
    }
    if (!more) break;
    k = next_k;
    y = next;
    prev = next_prev;
  }
  return c;
}

// entry (u, v)'s count by searching S[first], S[first + step], ... in N(v)
template <int kMode>
__device__ __forceinline__ int64_t search_count(const int* __restrict__ ids, int64_t sv, int64_t ev,
                                                const Staged& s, int u, int v, int first, int step) {
  int64_t c = 0;
  for (int64_t t = first; t < s.len; t += step) {
    const int x = s_at(s, t);
    if (kMode != kJaccard && t > 0 && s_at(s, t - 1) == x) continue;  // sets: each distinct x once
    if (kMode == kTriangles && (x == u || x == v)) continue;
    if (kMode == kDirected && (x <= u || x == v)) continue;
    const int64_t lb = bound_global<false>(ids, sv, ev, x);
    c += lb < ev && __ldg(ids + lb) == x;
  }
  return c;
}

__device__ __forceinline__ int log2_up(int64_t d) { return 64 - __clzll((long long)d); }

__device__ __forceinline__ float jaccard_weight(int64_t c, int64_t du, int64_t dv) {
  const int64_t uni = du + dv - c;
  return (float)((double)c / (double)(uni > 1 ? uni : 1));
}

struct Args {
  const int64_t* indptr;
  const int* ids;
  const int64_t* in_ptr;    // directed: the CSC
  const int* in_ids;
  int* rows;                // rows grouped by tier (classify_place)
  const int64_t* tier_off;  // tier t's rows are rows[tier_off[t], tier_off[t + 1])
  int64_t* chunk_end;       // tier 5: chunks of the rows up to rows[r], inclusive
  unsigned long long* plan; // count[kTiers], cursor[kTiers], then tier_off
  float* out_w;
  unsigned long long* out_sum;
  int64_t* defer_e;         // entries left to cn_deferred, and their rows
  int* defer_u;
  unsigned long long* defer_n;
  int64_t defer_cap;
};

// row u's S: N(u), or in directed mode I(u)
template <int kMode>
__device__ __forceinline__ void row_list(const Args& a, int u, int64_t su, int64_t du, const int** list,
                                         int64_t* len) {
  if (kMode == kDirected) {
    const int64_t si = __ldg(a.in_ptr + u);
    *list = a.in_ids + si;
    *len = __ldg(a.in_ptr + u + 1) - si;
  } else {
    *list = a.ids + su;
    *len = du;
  }
}

// One pass of the warp's lane groups (G lanes each, aligned) over their
// rows' entries: lane j of a group holds entry su + j of its row when
// `has`. A short N(v) is streamed by its lane alone; the others are taken
// one at a time by their whole group, or, when that would cost more than
// kDeferCost lookups, left to cn_deferred. Returns this lane's part of the
// sum (triangles, directed); jaccard writes the weights. Every lane of the
// warp calls it.
template <int kMode, int G>
__device__ __forceinline__ int64_t count_pass(const Args& a, const Staged& s, int u, int64_t su, int64_t du,
                                              bool has, int64_t j, int lane) {
  const unsigned full = 0xffffffffu;
  const int64_t e = su + j;
  int v = 0;
  int64_t sv = 0, ev = 0;
  bool live = false;
  if (has) {
    v = __ldg(a.ids + e);
    bool skip = false;
    if (kMode != kJaccard) {
      const bool repeat = j > 0 && __ldg(a.ids + e - 1) == v;
      skip = repeat || (kMode == kTriangles ? v == u : v <= u);
    }
    if (!skip) {
      sv = __ldg(a.indptr + v);
      ev = __ldg(a.indptr + v + 1);
      live = true;
    }
  }
  int64_t total = 0;
  const bool alone = live && ev - sv <= kLaneStreamMax;
  if (alone) {
    const int64_t c = stream_count<kMode>(a.ids, sv, ev, s, u, v, 0, 1);
    if (kMode == kJaccard) a.out_w[e] = jaccard_weight(c, du, ev - sv);
    else total += c;
  }
  bool pending = live && !alone;
  unsigned rest = __ballot_sync(full, pending);
  const int base = lane & ~(G - 1);
  const unsigned group_mask = G == 32 ? full : ((1u << G) - 1u) << base;
  while (rest) {  // warp-uniform
    const unsigned mine = rest & group_mask;
    const int src = mine ? __ffs(mine) - 1 : lane;
    const int gv = __shfl_sync(full, v, src);
    const int64_t gsv = __shfl_sync(full, sv, src), gev = __shfl_sync(full, ev, src);
    int64_t c = 0;
    bool counted = false;
    if (mine) {  // group-uniform
      const int64_t dv = gev - gsv;
      const bool stream = dv <= kStreamCost * s.len * log2_up(dv);
      if ((stream ? dv : s.len * log2_up(dv)) > kDeferCost) {
        unsigned long long slot = 0;
        if (lane == src) slot = atomicAdd(a.defer_n, 1ull);
        slot = __shfl_sync(group_mask, slot, src);
        counted = slot >= (unsigned long long)a.defer_cap;  // the queue is full: count it here
        if (!counted && lane == src) {
          a.defer_e[slot] = e;
          a.defer_u[slot] = u;
        }
      } else {
        counted = true;
      }
      if (counted) {
        const int gl = lane - base;
        c = stream ? stream_count<kMode>(a.ids, gsv, gev, s, u, gv, gl, G)
                   : search_count<kMode>(a.ids, gsv, gev, s, u, gv, gl, G);
      }
    }
    if (kMode == kJaccard) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) c += __shfl_xor_sync(full, c, off);
      if (counted && lane == src) a.out_w[e] = jaccard_weight(c, du, gev - gsv);
    } else {
      total += c;
    }
    if (mine && lane == src) pending = false;
    rest = __ballot_sync(full, pending);
  }
  return total;
}

__device__ __forceinline__ int64_t warp_sum(int64_t c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  return c;
}

// the block's sum of c; every thread gets it
__device__ __forceinline__ int64_t block_sum(int64_t c) {
  __shared__ int64_t partial[32];
  __syncthreads();  // partial is free again
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = c;
  __syncthreads();
  int64_t sum = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += partial[w];
  return sum;
}

// adds the block's lane sums into *out_sum with one atomicAdd
template <int kMode>
__device__ __forceinline__ void block_add(int64_t total, unsigned long long* __restrict__ out_sum) {
  if (kMode == kJaccard) return;
  const int64_t sum = block_sum(total);
  if (threadIdx.x == 0 && sum != 0) atomicAdd(out_sum, (unsigned long long)sum);
}

__device__ __forceinline__ int tier_of(int64_t d) {
  return d == 0 ? 0 : d <= 8 ? 1 : d <= 16 ? 2 : d <= kGroupStage ? 3 : d <= kMidCap ? 4 : 5;
}

// rows of each tier, counted with one atomicAdd per tier and warp
__global__ void __launch_bounds__(256) classify_count(const int64_t* __restrict__ indptr, int64_t n,
                                                      unsigned long long* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n; base += stride) {
    const int64_t r = base + lane;
    const int t = r < n ? tier_of(__ldg(indptr + r + 1) - __ldg(indptr + r)) : 0;
    const unsigned peers = __match_any_sync(0xffffffffu, t);
    if (t > 0 && lane == __ffs(peers) - 1) atomicAdd(count + t, (unsigned long long)__popc(peers));
  }
}

// Lists each row with entries in its tier's range of rows: tier t's rows
// are rows[tier_off[t], tier_off[t + 1]), in no fixed order. Tier 5's
// cursor packs the position (high 31 bits) and the chunks before it (low
// 33), so chunk_end rises along the list.
__global__ void __launch_bounds__(256) classify_place(const int64_t* __restrict__ indptr, int64_t n, Args a) {
  unsigned long long* count = a.plan;
  unsigned long long* cursor = a.plan + kTiers;
  int64_t* tier_off = reinterpret_cast<int64_t*>(a.plan + 2 * kTiers);
  int64_t off[kTiers + 1];
  off[0] = off[1] = 0;
  for (int t = 1; t < kTiers; ++t) off[t + 1] = off[t] + (int64_t)count[t];
  if (blockIdx.x == 0 && threadIdx.x <= kTiers) tier_off[threadIdx.x] = off[threadIdx.x];
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  constexpr unsigned long long kLow = (1ull << 33) - 1;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n; base += stride) {
    const int64_t r = base + lane;
    const int64_t d = r < n ? __ldg(indptr + r + 1) - __ldg(indptr + r) : 0;
    const int t = tier_of(d);
    const unsigned peers = __match_any_sync(0xffffffffu, t);
    const int leader = __ffs(peers) - 1;
    unsigned long long first = 0;
    if (t > 0 && t < 5 && lane == leader) first = atomicAdd(cursor + t, (unsigned long long)__popc(peers));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (t == 5) {  // one atomic a row: few rows
      const unsigned long long chunks = (unsigned long long)((d + kChunk - 1) / kChunk);
      const unsigned long long old = atomicAdd(cursor + 5, (1ull << 33) | chunks);
      const int64_t pos = off[5] + (int64_t)(old >> 33);
      a.rows[pos] = (int)r;
      a.chunk_end[pos] = (int64_t)((old & kLow) + chunks);
    } else if (t > 0) {
      a.rows[off[t] + (int64_t)first + __popc(peers & ((1u << lane) - 1u))] = (int)r;
    }
  }
}

constexpr int kGroupThreads = 256;

// tiers 1-3: a group of G lanes a row of at most G entries
template <int kMode, int G>
__global__ void __launch_bounds__(kGroupThreads) cn_groups(Args a, int tier) {
  constexpr int kGroups = 32 / G;  // rows a warp takes at once
  __shared__ int stage_ids[kGroupThreads / G][kGroupStage];
  __shared__ int hash_key[kGroupThreads / G][kHashSlots];
  __shared__ int hash_count[kGroupThreads / G][kHashSlots];
  const int lane = threadIdx.x & 31;
  const int group = lane / G, gl = lane % G;
  const int at = (threadIdx.x >> 5) * kGroups + group;
  int* sh = stage_ids[at];
  int* hk = hash_key[at];
  int* hc = hash_count[at];
  const int64_t r1 = a.tier_off[tier + 1];
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  int64_t total = 0;
  for (int64_t r = a.tier_off[tier] + warp * kGroups; r < r1; r += nwarps * kGroups) {  // warp-uniform
    const bool row_ok = r + group < r1;
    int u = 0;
    int64_t su = 0, du = 0;
    Staged s{sh, 0, 1, a.ids, 0};
    if (row_ok) {
      u = __ldg(a.rows + r + group);
      su = __ldg(a.indptr + u);
      du = __ldg(a.indptr + u + 1) - su;
      const int* list;
      int64_t len;
      row_list<kMode>(a, u, su, du, &list, &len);
      s = stage(sh, list, len, kGroupStage, gl, G);
    }
    for (int t = gl; t < kHashSlots; t += G) {
      hk[t] = -1;
      hc[t] = 0;
    }
    __syncwarp();
    if (row_ok && s.stride == 1) {
      for (int t = gl; t < s.m; t += G) {  // the ids this lane staged
        int slot = hash_slot(sh[t]);
        int prev;
        while ((prev = atomicCAS(hk + slot, -1, sh[t])) != -1 && prev != sh[t]) slot = (slot + 1) & (kHashSlots - 1);
        atomicAdd(hc + slot, 1);
      }
      s.hk = hk;
      s.hc = hc;
    }
    __syncwarp();
    total += count_pass<kMode, G>(a, s, u, su, du, row_ok && gl < du, gl, lane);
    __syncwarp();
  }
  block_add<kMode>(total, a.out_sum);
}

// Entries [j0, min(j1, deg u)) of row u by one block of B threads; stages
// S first unless it is row *staged's, already in sh.
template <int kMode, int B>
__device__ __forceinline__ int64_t block_task(const Args& a, int u, int64_t j0, int64_t j1, int cap, int* sh,
                                              int* staged, Staged* s, int64_t* su, int64_t* du) {
  if (u != *staged) {  // block-uniform
    __syncthreads();   // every lane is done with the previous list
    *su = __ldg(a.indptr + u);
    *du = __ldg(a.indptr + u + 1) - *su;
    const int* list;
    int64_t len;
    row_list<kMode>(a, u, *su, *du, &list, &len);
    *s = stage(sh, list, len, cap, threadIdx.x, B);
    *staged = u;
    __syncthreads();
  }
  const int64_t end = j1 < *du ? j1 : *du;
  int64_t total = 0;
  for (int64_t j = j0 + threadIdx.x; j - threadIdx.x < end; j += B)  // block-uniform
    total += count_pass<kMode, 32>(a, *s, u, *su, *du, j < end, j, threadIdx.x & 31);
  return total;
}

// tier 4, a block a row (chunk == 0), or tier 5, a block a run of chunks
// of `chunk` entries (consecutive chunks of a row share its staged list)
template <int kMode, int B>
__global__ void __launch_bounds__(B) cn_blocks(Args a, int tier, int cap, int64_t chunk) {
  extern __shared__ int sh[];
  const int64_t r0 = a.tier_off[tier], r1 = a.tier_off[tier + 1];
  int staged = -1;
  Staged s{sh, 0, 1, a.ids, 0};
  int64_t su = 0, du = 0, total = 0;
  if (chunk == 0) {
    for (int64_t r = r0 + blockIdx.x; r < r1; r += gridDim.x)
      total += block_task<kMode, B>(a, __ldg(a.rows + r), 0, INT64_MAX, cap, sh, &staged, &s, &su, &du);
  } else if (r1 > r0) {
    const int64_t chunks = a.chunk_end[r1 - 1], per = (chunks + gridDim.x - 1) / gridDim.x;
    const int64_t c1 = (blockIdx.x + 1) * per < chunks ? (blockIdx.x + 1) * per : chunks;
    for (int64_t c = blockIdx.x * per; c < c1; ++c) {
      int64_t lo = r0, hi = r1 - 1;  // the row: first r with chunk_end[r] > c
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (__ldg(a.chunk_end + mid) > c) hi = mid;
        else lo = mid + 1;
      }
      const int u = __ldg(a.rows + lo);
      const int64_t d = __ldg(a.indptr + u + 1) - __ldg(a.indptr + u);
      const int64_t k = c - (__ldg(a.chunk_end + lo) - (d + chunk - 1) / chunk);
      total += block_task<kMode, B>(a, u, k * chunk, (k + 1) * chunk, cap, sh, &staged, &s, &su, &du);
    }
  }
  block_add<kMode>(total, a.out_sum);
}

// the entries count_pass left: a block each, its lanes on the candidates of
// the shorter list, each searched in the longer in device memory (stride 0:
// nothing staged)
template <int kMode>
__global__ void __launch_bounds__(256) cn_deferred(Args a) {
  const unsigned long long queued = *a.defer_n;
  const int64_t count = queued < (unsigned long long)a.defer_cap ? (int64_t)queued : a.defer_cap;
  int64_t total = 0;
  for (int64_t q = blockIdx.x; q < count; q += gridDim.x) {
    const int64_t e = a.defer_e[q];
    const int u = a.defer_u[q], v = __ldg(a.ids + e);
    const int64_t su = __ldg(a.indptr + u), du = __ldg(a.indptr + u + 1) - su;
    const int64_t sv = __ldg(a.indptr + v), ev = __ldg(a.indptr + v + 1);
    Staged s{nullptr, 0, 0, a.ids, 0};
    row_list<kMode>(a, u, su, du, &s.list, &s.len);
    const int64_t c = ev - sv <= s.len ? stream_count<kMode>(a.ids, sv, ev, s, u, v, threadIdx.x, blockDim.x)
                                       : search_count<kMode>(a.ids, sv, ev, s, u, v, threadIdx.x, blockDim.x);
    if (kMode == kJaccard) {
      const int64_t inter = block_sum(c);
      if (threadIdx.x == 0) a.out_w[e] = jaccard_weight(inter, du, ev - sv);
    } else {
      total += c;
    }
  }
  block_add<kMode>(total, a.out_sum);
}

// the current device's SM count into *sms, read at each launch
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// *blocks: blocks for `tasks` tasks of `per_block` each, at most as many as
// the card holds at once on its `sms` SMs (the kernels walk their work
// grid-stride); the occupancy is asked once per kernel and host thread (a
// failed query is returned and asked again)
template <auto kKernel>
cudaError_t grid(int sms, int threads, size_t smem, int64_t tasks, int64_t per_block, unsigned* blocks) {
  thread_local int per_sm = 0;
  if (per_sm == 0) {
    int b = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kKernel, threads, smem);
    if (err != cudaSuccess) return err;
    per_sm = b < 1 ? 1 : b;
  }
  int64_t b = (tasks + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sms * per_sm;
  if (b > cap) b = cap;
  *blocks = (unsigned)(b < 1 ? 1 : b);
  return cudaSuccess;
}

template <int kMode>
cudaError_t launch_tiers(const Args& a, int64_t n, int64_t nnz, int sms, cudaStream_t s) {
  auto upto = [&](int64_t least) { return nnz / least < n ? nnz / least : n; };  // rows of >= least entries
  constexpr int T = kGroupThreads;
  constexpr size_t kMid = kMidCap * sizeof(int), kBig = kBigCap * sizeof(int);
  unsigned g1, g2, g3, g4, g5, gd;
  cudaError_t err = grid<cn_groups<kMode, 8>>(sms, T, 0, upto(1), T / 8, &g1);
  if (err == cudaSuccess) err = grid<cn_groups<kMode, 16>>(sms, T, 0, upto(9), T / 16, &g2);
  if (err == cudaSuccess) err = grid<cn_groups<kMode, 32>>(sms, T, 0, upto(17), T / 32, &g3);
  if (err == cudaSuccess) err = grid<cn_blocks<kMode, 128>>(sms, 128, kMid, upto(kGroupStage + 1), 1, &g4);
  if (err == cudaSuccess) err = grid<cn_blocks<kMode, 256>>(sms, 256, kBig, nnz / kChunk + upto(kMidCap + 1), 1, &g5);
  if (err == cudaSuccess) err = grid<cn_deferred<kMode>>(sms, 256, 0, a.defer_cap, 1, &gd);
  if (err != cudaSuccess) return err;
  cn_groups<kMode, 8><<<g1, T, 0, s>>>(a, 1);
  if (upto(9) > 0) cn_groups<kMode, 16><<<g2, T, 0, s>>>(a, 2);
  if (upto(17) > 0) cn_groups<kMode, 32><<<g3, T, 0, s>>>(a, 3);
  if (upto(kGroupStage + 1) > 0) cn_blocks<kMode, 128><<<g4, 128, kMid, s>>>(a, 4, kMidCap, 0);
  if (upto(kMidCap + 1) > 0) cn_blocks<kMode, 256><<<g5, 256, kBig, s>>>(a, 5, kBigCap, kChunk);
  cn_deferred<kMode><<<gd, 256, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// int64 words of the scratch sb_common_neighbors takes for n rows and a
// queue of cap entries
extern "C" int64_t sb_common_neighbors_scratch_words(int64_t n, int64_t cap) {
  return kPlanWords + n + cap + (n + cap + 1) / 2;
}

// indptr: (n+1,) int64; ids: (nnz,) int32, sorted within each row, every id
// < n. scratch: sb_common_neighbors_scratch_words(n, cap) int64 words the
// caller allocates, carved here into the plan (zeroed here), chunk_end (n,)
// int64, the queue of entries left to cn_deferred (defer_e (cap,) int64,
// defer_u (cap,) int32) and the tiers' row lists (rows (n,) int32). mode 0
// (jaccard) writes out_w (nnz,) float32; modes 1 (triangles) and 2
// (directed) write the sum to *out_sum. Mode 2 also reads in_ptr (n+1,)
// int64 and in_ids (nnz,) int32, the CSC of the same n x n matrix (row ids
// sorted within each column); the other modes ignore them. nnz > 0, cap > 0.
extern "C" int sb_common_neighbors(const int64_t* indptr, const int* ids, int64_t n, int64_t nnz, int mode,
                                   const int64_t* in_ptr, const int* in_ids, int64_t* scratch, int64_t cap,
                                   float* out_w, int64_t* out_sum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* plan = scratch;
  int64_t* chunk_end = plan + kPlanWords;
  int64_t* defer_e = chunk_end + n;
  int* rows = reinterpret_cast<int*>(defer_e + cap);
  int* defer_u = rows + n;
  unsigned long long* words = reinterpret_cast<unsigned long long*>(plan);
  const Args a{indptr, ids, in_ptr, in_ids, rows, plan + 2 * kTiers, chunk_end, words, out_w,
               reinterpret_cast<unsigned long long*>(out_sum), defer_e, defer_u, words + kPlanWords - 1, cap};
  int sms = 0;
  unsigned blocks = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) err = grid<classify_place>(sms, 256, 0, n, 256, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(plan, 0, kPlanWords * sizeof(int64_t), s);
  if (err == cudaSuccess && mode != kJaccard) err = cudaMemsetAsync(out_sum, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  classify_count<<<blocks, 256, 0, s>>>(indptr, n, words);
  classify_place<<<blocks, 256, 0, s>>>(indptr, n, a);
  if (mode == kTriangles) return (int)launch_tiers<kTriangles>(a, n, nnz, sms, s);
  if (mode == kDirected) return (int)launch_tiers<kDirected>(a, n, nnz, sms, s);
  return (int)launch_tiers<kJaccard>(a, n, nnz, sms, s);
}
