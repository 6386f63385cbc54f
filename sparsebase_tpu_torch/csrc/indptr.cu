// K3 — CSR indptr from row-sorted COO rows, for Hopper:
//   indptr[r] = first position p with row[p] >= r,   r in [0, nrows]
//
// Replaces the streaming-indptr Pallas kernel
// tools/pallas_attempts.py::build_stream_indptr (:218, pallas_call :248),
// which wrote indptr[row[i]] = i at block-local run heads and left the
// empty rows and the block seams to an XLA reverse cummin; and, on the
// port's path, the torch.searchsorted of the row boundaries that stands
// for the JAX package's indptr_from_sorted_rows /
// indptr_from_sorted_rows_blocked (sparsebase_tpu/convert/kernels.py:44-148).
//
// What bounds it on the H100: device memory. Each position reads its own
// row id and its left neighbour's (neighbouring threads, neighbouring
// addresses, so the second read hits the same sectors), 4 B per entry;
// every indptr slot is written exactly once, 8 B per row.
//
// Design: one pass, no cross-block state. Position i (i in [0, nnz]) owns
// the rows in (row[i-1], row[i]], with row[-1] = -1 and row[nnz] = nrows,
// and writes i into each: a run head writes its own row's start and the
// starts of the empty rows before it, and position nnz closes the trailing
// empty rows. Those intervals tile [0, nrows], so no cummin pass and no
// atomics are needed, and nnz == 0 gives all zeros. The Pallas kernel's
// sequential grid carried nothing either; a warp here needs nothing from
// its neighbours but one row id.
//
// Known imbalance: a head after a long gap of empty rows writes the whole
// gap from one thread (a gap of 1M rows is 1M sequential stores). Correct,
// and absent from the main path's inputs; splitting long gaps across a warp
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
indptr_kernel(const int* __restrict__ row, int64_t nnz, int64_t nrows, int64_t* __restrict__ indptr) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i <= nnz; i += stride) {
    // out-of-range ids are clamped to [-1, nrows]: nothing is written out of bounds
    const int64_t prev = i == 0 ? -1 : max((int64_t)__ldg(row + i - 1), (int64_t)-1);
    const int64_t cur = i == nnz ? nrows : min((int64_t)__ldg(row + i), nrows);
    for (int64_t r = prev + 1; r <= cur; ++r) indptr[r] = i;
  }
}

}  // namespace

// row: (nnz,) int32, sorted ascending, ids in [0, nrows); indptr: (nrows+1,)
// int64, written in full.
extern "C" int sb_indptr_from_sorted_rows(const int* row, int64_t nnz, int64_t nrows,
                                          int64_t* indptr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks = (nnz + 1 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  indptr_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(row, nnz, nrows, indptr);
  return (int)cudaGetLastError();
}
