// K6 — per-entry common-neighbour counts of a row-sorted CSR, for Hopper:
// Jaccard weights, or the triangle sum.
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
// The candidates come from the shorter of the two lists (N(u) on a tie, N(v)
// in directed mode) and are searched in the other, which gives the same
// counts:
// * triangles, directed: the count is a set intersection, symmetric in its
//   two lists;
// * jaccard from N(v): c = sum over the distinct y of N(v) of the
//   multiplicity of y in N(u), an upper bound minus a lower bound in N(u).
// A hub row's entries then cost what their other end's list costs, not the
// hub's length each: sum(min(deg u, deg v)) searches in all, against
// sum(deg u) = sum over rows of deg^2 if the candidates always came from N(u).
//
// What bounds it on the H100: its function must read indptr (8 B a row) and
// the ids (4 B an entry) and write 4 B an entry (jaccard), 576 MB at path
// F's 4M rows and 68M entries, 0.172 ms at 3.35 TB/s (directed: the CSC's
// offsets and ids as well, and one sum out). The kernel moves far
// more than that: each entry reads its row id and four offsets, each
// candidate one id and each search step one more id, gathers that miss
// L1 where the lists are scattered. This first design makes them simple,
// not few:
// * one warp per entry, the warps grid-stride over the entries;
// * u comes from a row-of-entry array the wrapper makes (no host sync);
// * the lanes stride over the candidate list, each running a lower-bound
//   search (int64 positions) in the other list;
// * jaccard: a warp sum, then lane 0 writes the weight; triangles and
//   directed: each lane keeps a running sum, the block adds its lanes' sums
//   in shared memory and one thread adds that to the total.
// A warp whose entry joins two long lists takes longer than its neighbours:
// that imbalance stays (ROADMAP: the first candidate for a redesign).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 16;

// first position p in [lo, hi) with ids[p] >= x (hi if none)
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ ids, int64_t lo, int64_t hi, int x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// first position p in [lo, hi) with ids[p] > x (hi if none)
__device__ __forceinline__ int64_t upper_bound(const int* __restrict__ ids, int64_t lo, int64_t hi, int x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

enum Mode { kJaccard = 0, kTriangles = 1, kDirected = 2 };

// This lane's share of entry (u, v)'s count: candidates cs + lane, cs + lane
// + 32, ... of cand[cs, ce), searched in tgt[ts, te). from_u: the candidates
// are N(u). Each distinct candidate is taken at its first instance only,
// except in jaccard mode from N(u), where every instance counts.
template <int kMode>
__device__ __forceinline__ int64_t lane_count(const int* __restrict__ cand, int64_t cs, int64_t ce,
                                              const int* __restrict__ tgt, int64_t ts, int64_t te, int u, int v,
                                              bool from_u, int lane) {
  int64_t c = 0;
  for (int64_t p = cs + lane; p < ce; p += 32) {
    const int x = __ldg(cand + p);
    const bool repeat = p > cs && __ldg(cand + p - 1) == x;
    if (kMode == kTriangles || kMode == kDirected) {
      if (repeat || x == v || (kMode == kTriangles ? x == u : x <= u)) continue;
      const int64_t lb = lower_bound(tgt, ts, te, x);
      c += lb < te && __ldg(tgt + lb) == x;
    } else if (from_u) {
      const int64_t lb = lower_bound(tgt, ts, te, x);
      c += lb < te && __ldg(tgt + lb) == x;
    } else {
      if (repeat) continue;
      const int64_t lb = lower_bound(tgt, ts, te, x);
      if (lb < te && __ldg(tgt + lb) == x) c += upper_bound(tgt, lb + 1, te, x) - lb;
    }
  }
  return c;
}

__device__ __forceinline__ int64_t warp_sum(int64_t c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  return c;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
common_neighbors_kernel(const int64_t* __restrict__ indptr, const int* __restrict__ ids,
                        const int* __restrict__ row, int64_t nnz, const int64_t* __restrict__ in_ptr,
                        const int* __restrict__ in_ids, float* __restrict__ out_w,
                        unsigned long long* __restrict__ out_sum) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  int64_t total = 0;  // triangles, directed: this lane's running sum
  for (int64_t e = warp; e < nnz; e += nwarps) {
    const int u = __ldg(row + e), v = __ldg(ids + e);
    const int64_t su = __ldg(indptr + u);
    // warp-uniform: every lane read the same entry
    if (kMode == kDirected) {
      if (v <= u || (e > su && __ldg(ids + e - 1) == v)) continue;
      // N(v) in ids, I(u) in in_ids
      const int64_t sv = __ldg(indptr + v), ev = __ldg(indptr + v + 1);
      const int64_t si = __ldg(in_ptr + u), ei = __ldg(in_ptr + u + 1);
      const bool from_v = ev - sv <= ei - si;
      total += from_v ? lane_count<kDirected>(ids, sv, ev, in_ids, si, ei, u, v, false, lane)
                      : lane_count<kDirected>(in_ids, si, ei, ids, sv, ev, u, v, false, lane);
      continue;
    }
    const int64_t eu = __ldg(indptr + u + 1);
    const int64_t sv = __ldg(indptr + v), ev = __ldg(indptr + v + 1);
    if (kMode == kTriangles && (u == v || (e > su && __ldg(ids + e - 1) == v))) continue;
    const int64_t du = eu - su, dv = ev - sv;
    const bool from_u = du <= dv;
    const int64_t c = lane_count<kMode>(ids, from_u ? su : sv, from_u ? eu : ev, ids, from_u ? sv : su,
                                        from_u ? ev : eu, u, v, from_u, lane);
    if (kMode == kTriangles) {
      total += c;
    } else {
      const int64_t inter = warp_sum(c);
      if (lane == 0) {
        const int64_t uni = du + dv - inter;
        out_w[e] = (float)((double)inter / (double)(uni > 1 ? uni : 1));
      }
    }
  }
  if (kMode != kJaccard) {
    __shared__ int64_t partial[kWarps];
    total = warp_sum(total);
    if (lane == 0) partial[threadIdx.x >> 5] = total;
    __syncthreads();
    if (threadIdx.x == 0) {
      int64_t block = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) block += partial[w];
      if (block != 0) atomicAdd(out_sum, (unsigned long long)block);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

}  // namespace

// indptr: (n+1,) int64; ids: (nnz,) int32, sorted within each row, every id
// < n; row: (nnz,) int32, the row of each entry. mode 0 (jaccard) writes
// out_w (nnz,) float32; modes 1 (triangles) and 2 (directed) add into
// *out_sum, which the caller zeroes. Mode 2 also reads in_ptr (n+1,) int64
// and in_ids (nnz,) int32, the CSC of the same n x n matrix (row ids sorted
// within each column); the other modes ignore them. nnz > 0.
extern "C" int sb_common_neighbors(const int64_t* indptr, const int* ids, const int* row, int64_t nnz, int mode,
                                   const int64_t* in_ptr, const int* in_ids, float* out_w, int64_t* out_sum,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks = (nnz + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  unsigned long long* sum = reinterpret_cast<unsigned long long*>(out_sum);
  if (mode == kTriangles)
    common_neighbors_kernel<kTriangles><<<(unsigned)blocks, kThreads, 0, s>>>(indptr, ids, row, nnz, in_ptr, in_ids,
                                                                              out_w, sum);
  else if (mode == kDirected)
    common_neighbors_kernel<kDirected><<<(unsigned)blocks, kThreads, 0, s>>>(indptr, ids, row, nnz, in_ptr, in_ids,
                                                                             out_w, sum);
  else
    common_neighbors_kernel<kJaccard><<<(unsigned)blocks, kThreads, 0, s>>>(indptr, ids, row, nnz, in_ptr, in_ids,
                                                                            out_w, sum);
  return (int)cudaGetLastError();
}
