// K5 — stable LSD radix sort of non-negative integer keys, for Hopper,
// returning the permutation (perm[new] = old) or its inverse, the rank
// (rank[old] = new).
//
// Replaces the two radix-partition Pallas kernels of
// tools/pallas_attempts.py: build_radix_scalar (:109, pallas_call :150),
// which split each 8192-element block by its low 8-bit digit with a
// 256-bucket histogram, a triangular-matmul exclusive scan and one dynamic
// store per element; and build_radix_matmul (:168, pallas_call :203), the
// same partition per 512-block placed by a one-hot matmul (its f32 round
// trip drops low bits of values >= 2^24). Here the partition is exact and
// global, one 8-bit digit per pass, as many passes as the largest key
// needs. On the port's path it takes over the stable torch.argsort of
// ranks_from_sort_keys (the degree rank of preprocess_pipeline and
// DegreeReorder) and sorts the rows that are too long for K4's tiers.
//
// What bounds it on the H100: device memory, per pass one read of the keys
// for the histogram, one read of keys and ids for the placement, and one
// scattered write of each: 256 destination runs per block, so the writes
// of a warp land in few sectors when the digits cluster.
//
// Design, per pass (three launches):
// * histogram: block b counts the digits of its tile of kTile keys in
//   shared memory; a warp adds each digit once, __match_any_sync grouping
//   the lanes that hold it. Counts go to hist[digit * nblocks + b].
// * scan: block d turns row d of hist into exclusive offsets within the
//   digit and writes the digit's total. The placement adds the exclusive
//   scan of the 256 totals, so (digit, block) is one exclusive scan over
//   the device, as the Pallas kernel's per-block scan was over its block.
// * placement: block b walks its tile in rounds of kThreads elements, in
//   input order. Inside a warp an element's rank among equal digits is the
//   popcount of its __match_any_sync peers on lower lanes; a per-(warp,
//   digit) count in shared memory and a prefix over the block's warps, run
//   by one thread per digit, add the earlier warps of the round, and a
//   running per-digit offset carries the earlier rounds. Every element thus
//   keeps its input order among equal digits: the pass is stable, and so is
//   the sort. This is the Pallas kernel's per-element dynamic store, done
//   by a whole block at once.
// Keys are 32- or 64-bit (a template); ids are int32 (n < 2^31). The
// wrapper shifts keys by their minimum, so any integer keys sort, and
// counts the passes from the largest shifted key: one host sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per digit in the prefix steps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;    // keys per block per pass; ops/kernels/radix.py::TILE
constexpr int kScanThreads = 1024;
constexpr int kDigits = 256;

// Exclusive sum over the block of one int per thread; *total gets the sum.
// scratch: 33 ints of shared memory. Call once per kernel (no trailing sync).
__device__ int block_exclusive_sum(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? scratch[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < nwarps) scratch[lane] = wi - w;
    if (lane == 31) scratch[32] = wi;
  }
  __syncthreads();
  *total = scratch[32];
  return scratch[warp] + incl - v;
}

template <typename K>
__device__ __forceinline__ unsigned digit_of(K key, int shift) {
  return (unsigned)((key >> shift) & (K)0xff);
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
radix_histogram(const K* __restrict__ keys, int64_t n, int shift, int nblocks, int* __restrict__ hist) {
  __shared__ int counts[kDigits];
  counts[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {  // uniform over each warp
    const int64_t g = base + i;
    const bool live = g < n;
    const unsigned d = live ? digit_of(__ldg(keys + g), shift) : kDigits;  // kDigits: no bucket
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (live && lane == __ffs(peers) - 1) atomicAdd(&counts[d], __popc(peers));
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * nblocks + blockIdx.x] = counts[threadIdx.x];
}

// Block d: row d of hist (nblocks counts) -> exclusive offsets; totals[d].
__global__ void __launch_bounds__(kScanThreads)
radix_scan(int* __restrict__ hist, int nblocks, int* __restrict__ totals) {
  __shared__ int scratch[33];
  int* row = hist + (int64_t)blockIdx.x * nblocks;
  const int per = (nblocks + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, nblocks);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += row[i];
  int total;
  int run = block_exclusive_sum(sum, scratch, &total);
  for (int i = lo; i < hi; ++i) {
    const int c = row[i];
    row[i] = run;
    run += c;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Stable placement of block b's tile. ids_in == nullptr means ids are the
// positions. keys_out == nullptr skips the key copy (last pass). With
// inverse, out[id] = destination (the rank); else out[destination] = id.
template <typename K>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const K* __restrict__ keys_in, const int* __restrict__ ids_in, int64_t n, int shift,
              int nblocks, const int* __restrict__ hist, const int* __restrict__ totals,
              K* __restrict__ keys_out, int* __restrict__ out, bool inverse) {
  __shared__ int scratch[33];
  __shared__ int running[kDigits];             // next destination of each digit
  __shared__ int warp_count[kWarps][kDigits];  // this round: elements per (warp, digit)
  __shared__ int warp_base[kWarps][kDigits];   // this round: first destination per (warp, digit)
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int unused;
  const int digit_base = block_exclusive_sum(totals[t], scratch, &unused);
  running[t] = digit_base + hist[(int64_t)t * nblocks + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w][t] = 0;
  __syncthreads();

  const unsigned lower = (1u << lane) - 1u;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kTile; r += kThreads) {
    const int64_t g = base + r + t;
    const bool live = g < n;
    const K key = live ? keys_in[g] : (K)0;
    const unsigned d = live ? digit_of(key, shift) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (live && lane == __ffs(peers) - 1) warp_count[warp][d] = __popc(peers);
    __syncthreads();
    // one thread per digit: prefix over the warps, in warp (= input) order
    int run = running[t];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      warp_base[w][t] = run;
      run += warp_count[w][t];
      warp_count[w][t] = 0;
    }
    running[t] = run;
    __syncthreads();
    if (live) {
      const int dst = warp_base[warp][d] + __popc(peers & lower);
      const int id = ids_in ? ids_in[g] : (int)g;
      if (keys_out) keys_out[dst] = key;
      if (inverse) out[id] = dst;
      else out[dst] = id;
    }
  }
}

template <typename K>
int radix_sort(const K* keys, int64_t n, int passes, K* key_buf0, K* key_buf1, int* id_buf0,
               int* id_buf1, int* hist, int* out, bool inverse, cudaStream_t s) {
  const int nblocks = (int)((n + kTile - 1) / kTile);
  int* totals = hist + (int64_t)kDigits * nblocks;
  K* key_bufs[2] = {key_buf0, key_buf1};
  int* id_bufs[2] = {id_buf0, id_buf1};
  const K* keys_in = keys;
  const int* ids_in = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    const int shift = 8 * p;
    K* keys_out = last ? nullptr : key_bufs[p & 1];
    int* ids_out = last ? out : id_bufs[p & 1];
    radix_histogram<K><<<nblocks, kThreads, 0, s>>>(keys_in, n, shift, nblocks, hist);
    radix_scan<<<kDigits, kScanThreads, 0, s>>>(hist, nblocks, totals);
    radix_scatter<K><<<nblocks, kThreads, 0, s>>>(keys_in, ids_in, n, shift, nblocks, hist, totals,
                                                  keys_out, ids_out, last && inverse);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    keys_in = keys_out;
    ids_in = ids_out;
  }
  return 0;
}

}  // namespace

// keys: (n,) non-negative, key_bytes 4 or 8; 1 <= n < 2^31; passes in
// [1, key_bytes]. key_buf0/id_buf0: (n,) scratch when passes >= 2,
// key_buf1/id_buf1 when passes >= 3 (else null). hist: (256 * (nblocks + 1),)
// int32 scratch, nblocks = ceil(n / 4096). out: (n,) int32, the rank if
// inverse else the permutation.
extern "C" int sb_radix_sort(const void* keys, int key_bytes, int64_t n, int passes, void* key_buf0,
                             void* key_buf1, int* id_buf0, int* id_buf1, int* hist, int* out,
                             int inverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4)
    return radix_sort<uint32_t>(static_cast<const uint32_t*>(keys), n, passes,
                                static_cast<uint32_t*>(key_buf0), static_cast<uint32_t*>(key_buf1),
                                id_buf0, id_buf1, hist, out, inverse != 0, s);
  if (key_bytes == 8)
    return radix_sort<uint64_t>(static_cast<const uint64_t*>(keys), n, passes,
                                static_cast<uint64_t*>(key_buf0), static_cast<uint64_t*>(key_buf1),
                                id_buf0, id_buf1, hist, out, inverse != 0, s);
  return (int)cudaErrorInvalidValue;
}
