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
// What bounds it on the H100: device memory. It reads 4 B of row id per
// entry and writes 8 B per indptr slot, each once: 450 MB at the main
// path's 100M entries and 6.25M rows, 0.134 ms at 3.35 TB/s.
//
// Semantics: position i (i in [0, nnz]) owns the rows in (row[i-1], row[i]],
// with row[-1] = -1 and row[nnz] = nrows, and writes i into each: a run head
// writes its own row's start and the starts of the empty rows before it,
// and position nnz closes the trailing empty rows. Those intervals tile
// [0, nrows], so there is no second pass and no atomic, and nnz == 0 gives
// all zeros. The Pallas kernel's sequential grid carried nothing either.
//
// Why the first design (one thread per 4-byte id, 390,626 blocks) reached
// only 34% of the bound: about 8 KB per SM in flight and int64 loop
// arithmetic per entry. This one:
// * a grid of kBlocksPerSM blocks per SM walks the array grid-stride, a
//   chunk of kChunk = 512 ids per warp step;
// * each lane loads 16 ids as four int4 loads (64 B in flight instead of
//   4), striped so that each load instruction of the warp reads 512
//   contiguous bytes: lane l holds ids base + 128k + 4l .. +3, k = 0..3;
// * an id's left neighbour is in the same int4, or comes from lane l-1 by
//   __shfl_up_sync, or from lane 31 of the previous int4; lane 0 reads the
//   one id before the chunk;
// * the compares are int32; a store happens only where an id differs from
//   its neighbour (a run head) and writes its int64 position;
// * ids before the first 16-byte boundary of the array, the ids after the
//   last whole chunk, and the closing position nnz take the scalar path.
//
// Known imbalance: a head after a long gap of empty rows writes the whole
// gap from one thread (a gap of 1M rows is 1M sequential stores). Correct,
// and absent from the main path's inputs.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                  // int4 loads per lane
constexpr int kChunk = 32 * 4 * kGroups;    // ids per warp step
constexpr int kBlocksPerSM = 8;

// rows (prev, cur] start at position i
__device__ __forceinline__ void own(int64_t* indptr, int prev, int cur, int64_t i) {
  for (int64_t r = (int64_t)prev + 1; r <= cur; ++r) indptr[r] = i;
}

// position i alone: its id and its left neighbour's, read one by one
__device__ __forceinline__ void own_scalar(const int* row, int64_t i, int64_t nnz, int64_t nrows, int nrows_c,
                                           int64_t* indptr) {
  const int prev = i == 0 ? -1 : max(__ldg(row + i - 1), -1);
  if (i == nnz) {  // the closing position: rows up to nrows, which may pass the int32 range
    for (int64_t r = (int64_t)prev + 1; r <= nrows; ++r) indptr[r] = i;
    return;
  }
  const int cur = min(__ldg(row + i), nrows_c);
  if (prev < cur) own(indptr, prev, cur, i);
}

// body: nchunks chunks of kChunk ids from position `start`, whose address is
// 16-byte aligned; the rest of [0, nnz] goes through own_scalar.
__global__ void __launch_bounds__(kThreads)
indptr_kernel(const int* __restrict__ row, int64_t nnz, int64_t nrows, int64_t start, int64_t nchunks,
              int64_t* __restrict__ indptr) {
  const int lane = threadIdx.x & 31;
  const int nrows_c = (int)min(nrows, (int64_t)INT_MAX);  // ids are int32: clamping to this is exact
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = tid >> 5; c < nchunks; c += nthreads >> 5) {
    const int64_t base = start + c * kChunk;
    const int4* src = reinterpret_cast<const int4*>(row + base);
    int4 v[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) v[k] = __ldcs(src + k * 32 + lane);
    const int before = lane == 0 && base > 0 ? __ldg(row + base - 1) : -1;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      int left = __shfl_up_sync(0xffffffffu, v[k].w, 1);
      if (k > 0) {
        const int carry = __shfl_sync(0xffffffffu, v[k > 0 ? k - 1 : 0].w, 31);
        if (lane == 0) left = carry;
      } else if (lane == 0) {
        left = before;
      }
      const int ids[5] = {max(left, -1), v[k].x, v[k].y, v[k].z, v[k].w};
      const int64_t i0 = base + k * 128 + lane * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int prev = max(ids[j], -1), cur = min(ids[j + 1], nrows_c);
        if (prev < cur) own(indptr, prev, cur, i0 + j);
      }
    }
  }
  // the scalar positions: [0, start) and [start + nchunks * kChunk, nnz]
  const int64_t tail = start + nchunks * kChunk;
  const int64_t nscalar = start + (nnz + 1 - tail);
  for (int64_t k = tid; k < nscalar; k += nthreads)
    own_scalar(row, k < start ? k : tail + (k - start), nnz, nrows, nrows_c, indptr);
}

// the current device's SM count into *sms, read at each launch
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace

// row: (nnz,) int32, sorted ascending, ids in [0, nrows); indptr: (nrows+1,)
// int64, written in full.
extern "C" int sb_indptr_from_sorted_rows(const int* row, int64_t nnz, int64_t nrows,
                                          int64_t* indptr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  int64_t start = 0, nchunks = 0;
  if ((addr & 3) == 0) {  // int32-aligned (always, from torch): the body can be vectorised
    start = (int64_t)((16 - (addr & 15)) & 15) / 4;
    if (start > nnz) start = nnz;
    nchunks = (nnz - start) / kChunk;
  }
  const int64_t warps_per_block = kThreads / 32;
  int64_t blocks = (nchunks + warps_per_block - 1) / warps_per_block;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  indptr_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(row, nnz, nrows, start, nchunks, indptr);
  return (int)cudaGetLastError();
}
