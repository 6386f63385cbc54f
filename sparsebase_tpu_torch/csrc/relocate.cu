// K4 — CSR relocation for Hopper: permute rows and relabel columns of a
// CSR, with the columns of every new row sorted.
//
//   old row r moves as one block to new_indptr[ro[r]]; each column c
//   becomes co[c] and its value moves with it; inside the row the entries
//   are ordered by (new column, old in-row position).
//
// Replaces the in-kernel table gather of tools/pallas_attempts.py
// build_vector_gather (:83, pallas_call :92), out[i] = table[idx[i]], which
// on the TPU's path is the column relabel ro[col] and the payload gathers
// around the pair sort; and with it the dynamic-store placement of the
// radix kernels (:109, :168) where the main path needs it, inside each row.
// On the port's path it takes over the body of _permute_csr: the row
// expansion, col_order[indices], the packed int64 (row, col) stable sort,
// its dtype copies and the vals[order] gather
// (sparsebase_tpu/ops/permute.py:70-129, models/pipelines.py:139-171).
//
// What bounds it on the H100: device memory. Per entry it reads the 4 B
// column id and the 4 B value and writes both once; per row it reads two
// indptr slots, ro[r] and new_indptr[ro[r]] (8 B at random); co[c] is a
// 4 B gather from a table that stays in the 50 MB L2 at the main path's
// 6.25M columns. No global sort: the (row, column) key is never built.
//
// Design. The key (new column, in-row position) is unique, so any correct
// sort gives the plain stable packed sort's output bit for bit, duplicates
// included. Rows are sorted where they stand, in one of three tiers:
// * degree <= 32 (kWarpMax): one warp per row, one entry per lane. A lane's
//   rank is the count of entries with a smaller key, taken over the row's
//   lanes by shuffles; it writes its column and value straight to
//   new_indptr[ro[r]] + rank. The main path's rows average 16 entries.
// * 32 < degree <= 4096 (kBlockMax): one block per row, listed by the
//   wrapper. The keys (new column << 32 | position) are bitonic-sorted in
//   32 KB of shared memory, padded to a power of two; the value is read
//   back through the position.
// * degree > 4096: not touched here. The wrapper sorts those rows with K5
//   (csrc/radix_sort.cu) on a (row, new column) key.
// ro == nullptr keeps row positions; co == nullptr keeps the columns.
// Values: float32 ride in the kernel; a pattern matrix has none; for any
// other value type the kernel writes the source position and the wrapper
// gathers the values through it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kWarpMax = 32;     // ops/kernels/relocate.py::WARP_MAX
constexpr int kBlockMax = 4096;  // ops/kernels/relocate.py::BLOCK_MAX
constexpr int64_t kMaxBlocks = 1 << 20;

enum Payload { kPattern = 0, kFloat = 1, kSource = 2 };

template <int kPayload>
__device__ __forceinline__ void put_payload(const float* vals, float* out_vals, int64_t* out_src,
                                            int64_t src, int64_t dst) {
  if (kPayload == kFloat) out_vals[dst] = __ldg(vals + src);
  if (kPayload == kSource) out_src[dst] = src;
}

template <int kPayload>
__global__ void __launch_bounds__(kThreads)
relocate_warp_rows(const int64_t* __restrict__ indptr, const int* __restrict__ indices,
                   const float* __restrict__ vals, const int* __restrict__ ro,
                   const int* __restrict__ co, const int64_t* __restrict__ new_indptr, int64_t n,
                   int* __restrict__ out_indices, float* __restrict__ out_vals,
                   int64_t* __restrict__ out_src) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t start = __ldg(indptr + r);
    const int deg64 = (int)min(__ldg(indptr + r + 1) - start, (int64_t)kWarpMax + 1);
    if (deg64 > kWarpMax) continue;  // the block tier or K5 sorts this row
    const int deg = deg64;
    int c = 0;
    if (lane < deg) {
      c = __ldg(indices + start + lane);
      if (co) c = __ldg(co + c);
    }
    int rank = 0;
    for (int j = 0; j < deg; ++j) {
      const int cj = __shfl_sync(0xffffffffu, c, j);
      rank += (cj < c) || (cj == c && j < lane);
    }
    if (lane < deg) {
      const int64_t dst = __ldg(new_indptr + (ro ? __ldg(ro + r) : r)) + rank;
      out_indices[dst] = c;
      put_payload<kPayload>(vals, out_vals, out_src, start + lane, dst);
    }
  }
}

template <int kPayload>
__global__ void __launch_bounds__(kThreads)
relocate_block_rows(const int64_t* __restrict__ indptr, const int* __restrict__ indices,
                    const float* __restrict__ vals, const int* __restrict__ ro,
                    const int* __restrict__ co, const int64_t* __restrict__ new_indptr,
                    const int* __restrict__ rows, int64_t nrows_listed,
                    int* __restrict__ out_indices, float* __restrict__ out_vals,
                    int64_t* __restrict__ out_src) {
  __shared__ unsigned long long keys[kBlockMax];
  for (int64_t k = blockIdx.x; k < nrows_listed; k += gridDim.x) {
    const int r = rows[k];
    const int64_t start = indptr[r];
    const int64_t deg64 = indptr[r + 1] - start;
    if (deg64 > kBlockMax) continue;  // over the cap: K5 sorts it (uniform over the block)
    const int deg = (int)deg64;
    int pow2 = 1;
    while (pow2 < deg) pow2 <<= 1;
    for (int i = threadIdx.x; i < pow2; i += kThreads) {
      unsigned long long key = ~0ull;  // padding sorts last
      if (i < deg) {
        int c = __ldg(indices + start + i);
        if (co) c = __ldg(co + c);
        key = ((unsigned long long)(unsigned)c << 32) | (unsigned)i;
      }
      keys[i] = key;
    }
    __syncthreads();
    for (int size = 2; size <= pow2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < pow2; i += kThreads) {
          const int j = i ^ stride;
          if (j > i) {
            const unsigned long long a = keys[i], b = keys[j];
            const bool ascending = (i & size) == 0;
            if ((a > b) == ascending) {
              keys[i] = b;
              keys[j] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    const int64_t dst = new_indptr[ro ? ro[r] : r];
    for (int i = threadIdx.x; i < deg; i += kThreads) {
      const unsigned long long key = keys[i];
      out_indices[dst + i] = (int)(key >> 32);
      put_payload<kPayload>(vals, out_vals, out_src, start + (int64_t)(key & 0xffffffffu), dst + i);
    }
    __syncthreads();  // keys is rewritten by the next row
  }
}

template <int kPayload>
void launch(const int64_t* indptr, const int* indices, const float* vals, const int* ro,
            const int* co, const int64_t* new_indptr, int64_t n, const int* rows,
            int64_t nrows_listed, int* out_indices, float* out_vals, int64_t* out_src,
            cudaStream_t s) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  relocate_warp_rows<kPayload><<<(unsigned)blocks, kThreads, 0, s>>>(
      indptr, indices, vals, ro, co, new_indptr, n, out_indices, out_vals, out_src);
  if (nrows_listed > 0) {
    const int64_t row_blocks = nrows_listed < kMaxBlocks ? nrows_listed : kMaxBlocks;
    relocate_block_rows<kPayload><<<(unsigned)row_blocks, kThreads, 0, s>>>(
        indptr, indices, vals, ro, co, new_indptr, rows, nrows_listed, out_indices, out_vals,
        out_src);
  }
}

}  // namespace

// indptr: (n+1,) int64; indices: (nnz,) int32; vals: (nnz,) f32 when
// payload == 1, else ignored; ro: (n,) int32 bijection or null; co: int32
// table over the column ids or null; new_indptr: (n+1,) int64, the new
// row starts (new_indptr[ro[r]] is row r's block); rows: the nrows_listed
// row ids with degree > 32 (those over 4096 are skipped). Outputs (nnz,):
// out_indices int32; out_vals f32 when payload == 1; out_src int64 source
// positions when payload == 2. n >= 1.
extern "C" int sb_relocate_csr(const int64_t* indptr, const int* indices, const float* vals,
                               const int* ro, const int* co, const int64_t* new_indptr, int64_t n,
                               const int* rows, int64_t nrows_listed, int payload,
                               int* out_indices, float* out_vals, int64_t* out_src, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload == kPattern)
    launch<kPattern>(indptr, indices, vals, ro, co, new_indptr, n, rows, nrows_listed, out_indices,
                     out_vals, out_src, s);
  else if (payload == kFloat)
    launch<kFloat>(indptr, indices, vals, ro, co, new_indptr, n, rows, nrows_listed, out_indices,
                   out_vals, out_src, s);
  else if (payload == kSource)
    launch<kSource>(indptr, indices, vals, ro, co, new_indptr, n, rows, nrows_listed, out_indices,
                    out_vals, out_src, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
