// K2 — CSR row SpMV for Hopper:  y[r] = sum_{p in [indptr[r], indptr[r+1])} vals[p] * x[indices[p]]
//
// Replaces the per-row reduction of the main path's SpMV on the TPU:
// sparsebase_tpu/models/pipelines.py:59-61 (spmv_csr, method="cumsum")
// and :189-198 (_permute_and_spmv), a global f32 prefix sum over the
// products read off at the indptr boundaries, whose rounding grows like
// eps * sqrt(nnz). It is an XLA formulation, not a Pallas kernel.
//
// What bounds it on the H100: device memory. Per entry it streams 4 B of
// column id and 4 B of value, and gathers x[col] at random: a 32 B sector
// per entry unless neighbouring entries share it or it stays in the 50 MB
// L2 (x itself is 25 MB at 6.25M columns).
//
// Design:
// * One warp per row, grid-stride over rows. The lanes stride the row, so
//   the id and value reads are coalesced; the row's sum is reduced with
//   warp shuffles. Each row's sum is taken in a fixed order (lane partial
//   sums, then a fixed butterfly), so y is deterministic, and its error
//   grows with the row's own degree, not with nnz.
// * Empty rows write 0. A pattern matrix passes vals == nullptr and
//   multiplies by 1 (template, no branch per entry).
// * indptr is int64 (nnz may pass 2^31), column ids int32, f32 math.
// * The main path runs it on the source CSR (rows in input order); the
//   caller then writes y[ro[i]] = y_old[i]. The TPU's bitcast pair gather
//   of (ro, x) by column is not needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 1 << 20;

template <bool kPattern>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int64_t* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t start = indptr[r];
    const int64_t end = indptr[r + 1];
    float acc = 0.f;
    for (int64_t p = start + lane; p < end; p += 32) {
      const float v = kPattern ? 1.f : __ldg(vals + p);
      acc += v * __ldg(x + __ldg(indices + p));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) y[r] = acc;
  }
}

}  // namespace

// indptr: (n+1,) int64; indices: (nnz,) int32; vals: (nnz,) f32 or null for
// a pattern matrix; x: (ncols,) f32; y: (n,) f32, written in full. n >= 1.
extern "C" int sb_csr_spmv(const int64_t* indptr, const int* indices, const float* vals,
                           const float* x, float* y, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vals == nullptr)
    csr_spmv_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(indptr, indices, vals, x, y, n);
  else
    csr_spmv_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(indptr, indices, vals, x, y, n);
  return (int)cudaGetLastError();
}
