// K2 — CSR SpMV for Hopper:  y[r] = sum_{p in [indptr[r], indptr[r+1])} vals[p] * x[indices[p]]
//
// Replaces the per-row reduction of the main path's SpMV on the TPU:
// sparsebase_tpu/models/pipelines.py:59-61 (spmv_csr, method="cumsum")
// and :189-198 (_permute_and_spmv), a global f32 prefix sum over the
// products read off at the indptr boundaries, whose rounding grows like
// eps * sqrt(nnz). It is an XLA formulation, not a Pallas kernel.
//
// What bounds it on the H100. Counted as bytes, the function reads 4 B of
// column id and 4 B of value per entry, 8 B of indptr per row and x once,
// and writes y: 900 MB at the main path's 100M entries and 6.25M rows,
// 0.269 ms at 3.35 TB/s. What binds first is the x[col] gathers: each one
// that misses L1 costs one random 32 B sector from L2, and at the main
// path's columns almost all miss (x is 25 MB there). chip_smoke.py's
// gather probe (torch.index_select of the same ids from x cut to fit L1,
// then whole) measures that floor; the ids and values stream past with
// evict-first loads.
//
// Why the first design (one warp per row) stopped at 0.63 TB/s: at degree
// 16 half its lanes idle, and each row is a chain of three dependent reads
// (indptr[r] -> indices[p] -> x[col]) with about 128 B in flight per warp,
// roughly half what Little's law asks for at this card's rate.
//
// Design: the work is split by entries, not rows. Three launches in one C
// call, all on the caller's stream, no atomics:
// 1. tile_first_rows: for every tile of kTile entries, the first row that
//    starts in it (a binary search of indptr); the last slot is n.
// 2. csr_spmv_tiles: one block per tile. Each thread streams 8 ids and 8
//    values (two 16-byte loads each where the arrays are 16-byte aligned,
//    scalar loads otherwise) and issues its 8 x[col] gathers at once, with
//    no dependence on indptr; the products go to shared memory. Then each
//    row that meets the tile is summed from shared memory in entry order:
//    by one thread up to kSerialMax entries, by one warp (lane partials,
//    then a fixed butterfly) above. A row that starts and ends in the tile
//    is written to y; an empty row gets 0 from the tile that holds its
//    start (the last tile for rows that start at nnz). A row that crosses
//    a tile edge leaves its part in the scratch buffer: `tail` from the
//    tile it starts in, `head` from every later tile it reaches.
// 3. csr_spmv_fixup: one thread per tile whose last row runs past the
//    tile: tail[t] + head[t+1] + ... in tile order, written to y.
// Every sum is taken in one fixed order, so two runs on the same input
// give the same y bit for bit, and a row's rounding grows with its own
// degree, not with nnz.
//
// Types and conventions: int64 indptr (nnz may pass 2^31),
// int32 ids, f32 math, vals == nullptr for a pattern matrix (multiply by 1,
// a template, no branch per entry), n >= 1. The main path runs it on the
// source CSR (rows in input order); the caller then writes
// y[ro[i]] = y_old[i].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // entries per thread
constexpr int kTile = kThreads * kItems;   // ops/kernels/csr_spmv.py::TILE
constexpr int kSerialMax = 64;             // longer in-tile rows: one warp each

__global__ void __launch_bounds__(kThreads)
tile_first_rows(const int64_t* __restrict__ indptr, int64_t n, int64_t ntiles, int64_t* __restrict__ first) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > ntiles) return;
  if (t == ntiles) {
    first[t] = n;
    return;
  }
  const int64_t b = t * kTile;
  int64_t lo = 0, hi = n;  // the first r in [0, n] with indptr[r] >= b
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(indptr + mid) < b) lo = mid + 1;
    else hi = mid;
  }
  first[t] = lo;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kPattern>
__device__ __forceinline__ void load_products_vec(const int* indices, const float* vals, const float* x,
                                                  int64_t p0, float* prod) {
  const int4* ic = reinterpret_cast<const int4*>(indices + p0);
  const float4* vc = reinterpret_cast<const float4*>(vals + p0);
  int4 c[2];
  float4 v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    c[k] = __ldcs(ic + threadIdx.x + k * kThreads);
    if (!kPattern) v[k] = __ldcs(vc + threadIdx.x + k * kThreads);
  }
  float4 g[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    g[k].x = __ldg(x + c[k].x);
    g[k].y = __ldg(x + c[k].y);
    g[k].z = __ldg(x + c[k].z);
    g[k].w = __ldg(x + c[k].w);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!kPattern) {
      g[k].x *= v[k].x;
      g[k].y *= v[k].y;
      g[k].z *= v[k].z;
      g[k].w *= v[k].w;
    }
    reinterpret_cast<float4*>(prod)[threadIdx.x + k * kThreads] = g[k];
  }
}

// The row's part of the tile: the whole row to y, the part of a row that
// started before the tile to head[t], the part of one that runs past it
// to tail[t].
__device__ __forceinline__ void emit(float acc, int64_t r, int64_t a, int64_t b, int64_t p0, int64_t p1,
                                     int64_t t, float* y, float* head, float* tail) {
  if (a < p0) head[t] = acc;
  else if (b > p1) tail[t] = acc;
  else y[r] = acc;
}

// One block per tile of entries [p0, p1). first[t] .. first[t+1] are the
// rows that start in it; row first[t] - 1 may reach into it from before.
template <bool kPattern, bool kVec>
__global__ void __launch_bounds__(kThreads)
csr_spmv_tiles(const int64_t* __restrict__ indptr, const int* __restrict__ indices,
               const float* __restrict__ vals, const float* __restrict__ x,
               const int64_t* __restrict__ first, int64_t nnz, float* __restrict__ y,
               float* __restrict__ head, float* __restrict__ tail) {
  __shared__ __align__(16) float prod[kTile];
  const int64_t t = blockIdx.x;
  const int64_t p0 = t * kTile;
  const int64_t p1 = min(p0 + kTile, nnz);
  const int len = (int)(p1 - p0);

  // 1. the tile's products, read off the ids and values alone
  if (kVec && len == kTile) {
    load_products_vec<kPattern>(indices, vals, x, p0, prod);
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      float v = __ldg(x + __ldcs(indices + p0 + i));
      if (!kPattern) v *= __ldcs(vals + p0 + i);
      prod[i] = v;
    }
  }
  const int64_t r_lo = __ldg(first + t), r_hi = __ldg(first + t + 1);
  const bool has_head = r_lo > 0 && __ldg(indptr + r_lo) > p0;
  const int64_t r0 = has_head ? r_lo - 1 : r_lo;
  __syncthreads();

  // 2. every row that meets the tile, summed in entry order: warp w takes
  // 32 rows at a time, a lane each; a row of more than kSerialMax entries
  // in the tile is summed by the whole warp instead
  const int lane = threadIdx.x & 31;
  for (int64_t base = r0 + (threadIdx.x - lane); base < r_hi; base += kThreads) {
    const int64_t r = base + lane;
    int64_t a = 0, b = 0;
    int s = 0, e = 0;
    if (r < r_hi) {
      a = __ldg(indptr + r);
      b = __ldg(indptr + r + 1);
      s = (int)(max(a, p0) - p0);
      e = (int)(min(b, p1) - p0);
    }
    const bool wide = e - s > kSerialMax;
    if (r < r_hi && !wide) {
      float acc = 0.f;
      for (int i = s; i < e; ++i) acc += prod[i];
      emit(acc, r, a, b, p0, p1, t, y, head, tail);
    }
    for (unsigned m = __ballot_sync(0xffffffffu, wide); m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int sj = __shfl_sync(0xffffffffu, s, j), ej = __shfl_sync(0xffffffffu, e, j);
      float acc = 0.f;
      for (int i = sj + lane; i < ej; i += 32) acc += prod[i];
      acc = warp_sum(acc);
      if (lane == j) emit(acc, r, a, b, p0, p1, t, y, head, tail);
    }
  }
}

// The last row that starts in tile t, if it runs past the tile: its part
// there plus the heads of the tiles it reaches, in tile order.
__global__ void __launch_bounds__(kThreads)
csr_spmv_fixup(const int64_t* __restrict__ indptr, const int64_t* __restrict__ first, int64_t ntiles,
               const float* __restrict__ head, const float* __restrict__ tail, float* __restrict__ y) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntiles) return;
  const int64_t r_hi = first[t + 1];
  if (r_hi == first[t]) return;  // no row starts in this tile
  const int64_t end = indptr[r_hi];  // end of row r_hi - 1
  if (end <= (t + 1) * kTile) return;  // it ends in the tile: written there
  float acc = tail[t];
  const int64_t last = (end - 1) / kTile;
  for (int64_t u = t + 1; u <= last; ++u) acc += head[u];
  y[r_hi - 1] = acc;
}

}  // namespace

// indptr: (n+1,) int64; indices: (nnz,) int32; vals: (nnz,) f32 or null for
// a pattern matrix; x: (ncols,) f32; y: (n,) f32, written in full. n >= 1.
// Scratch from the caller: first, (ntiles+1,) int64; partial, (2*ntiles,)
// f32; ntiles = max(1, ceil(nnz / kTile)), or the call fails.
extern "C" int sb_csr_spmv(const int64_t* indptr, const int* indices, const float* vals, const float* x,
                           float* y, int64_t n, int64_t nnz, int64_t ntiles, int64_t* first, float* partial,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t want = nnz > 0 ? (nnz + kTile - 1) / kTile : 1;
  if (n < 1 || nnz < 0 || ntiles != want || ntiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  float* head = partial;
  float* tail = partial + ntiles;
  tile_first_rows<<<(unsigned)((ntiles + kThreads) / kThreads), kThreads, 0, s>>>(indptr, n, ntiles, first);
  const bool vec = (reinterpret_cast<uintptr_t>(indices) & 15) == 0 &&
                   (vals == nullptr || (reinterpret_cast<uintptr_t>(vals) & 15) == 0);
  const auto tiles = vals == nullptr ? (vec ? csr_spmv_tiles<true, true> : csr_spmv_tiles<true, false>)
                                     : (vec ? csr_spmv_tiles<false, true> : csr_spmv_tiles<false, false>);
  tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(indptr, indices, vals, x, first, nnz, y, head, tail);
  csr_spmv_fixup<<<(unsigned)((ntiles + kThreads - 1) / kThreads), kThreads, 0, s>>>(indptr, first, ntiles, head,
                                                                                    tail, y);
  return (int)cudaGetLastError();
}
