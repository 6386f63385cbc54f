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
// What bounds it on the H100: by bytes, device memory. Per entry it reads
// the 4 B column id and the 4 B value and writes both once; per row it
// reads two indptr slots, ro[r] and new_indptr[ro[r]] (8 B at random);
// co[c] is a 4 B gather from a table that stays in the 50 MB L2 at the main
// path's 6.25M columns. No global sort: the (row, column) key is never
// built. What holds it on the card (PERF.md §6, PR 5): the rank count, d
// compares per entry of a row of d, and the L1 that the stage takes from
// the co[c] gathers.
//
// Design. The key (new column, in-row position) is unique, so any correct
// sort gives the plain stable packed sort's output bit for bit, duplicates
// included. Rows are sorted where they stand, in one of three tiers:
// * degree <= 32 (kWarpMax), relocate_warp_rows: a warp takes a group of
//   kGroup = 32 consecutive rows, one row header per lane, and walks the
//   groups grid-stride over a grid of kWaves times the resident warps.
//   1. Each lane's row header (indptr[r], indptr[r+1], ro[r]) was loaded
//      during the group before; new_indptr[ro[r]] is loaded now and waited
//      for only once step 2's loads are issued. A warp scan of the degrees
//      of the group's rows of <= 32 entries places them one after another
//      in the warp's stage in shared memory (at most 32 * 32 entries);
//      longer rows are left out of the stage, so a row of 262,144 entries
//      in a group costs this tier nothing.
//   2. The staged ids are read in rounds of kRound, each lane holding
//      kQuads quads of 4 consecutive entries: one 16-byte load per quad
//      where the id array is 16-byte aligned and the group holds no longer
//      row, so that the staged entries are one contiguous range; else 4
//      loads through each entry's row. All the ids of a round are loaded,
//      then all their co[c] gathers are issued, then the new columns go to
//      the stage: 20 gathers in flight per lane.
//   3. Lanes take consecutive staged entries (coalesced value loads). Each
//      entry's row comes from a byte table in the stage; its value load is
//      issued first; its rank is the count of entries of its row with a
//      smaller (new column, position), read from the stage; it writes its
//      column and value to new_indptr[ro[row]] + rank. The next group's
//      headers load meanwhile. This loop stays rolled: unrolled 20 times
//      with the values in registers it ran 1.6x slower.
//   The same pass appends the group's longer rows to two lists on the
//   device, through one atomic per warp and list.
// * 32 < degree <= 4096 (kBlockMax), relocate_block_rows: one block per
//   listed row, over a fixed grid that reads the list's length from device
//   memory. The keys (new column << 32 | position) are bitonic-sorted in
//   32 KB of shared memory, padded to a power of two; the value is read
//   back through the position. The list's order does not matter: each row
//   is sorted alone.
// * degree > 4096: listed, not sorted here. The wrapper reads that list's
//   length (its one host sync) and sorts those rows with K5
//   (csrc/radix_sort.cu) on a (row, new column) key.
// ro == nullptr keeps row positions; co == nullptr keeps the columns.
// Values: float32 ride in the kernel; a pattern matrix has none; for any
// other value type the kernel writes the source position and the wrapper
// gathers the values through it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpMax = 32;                // ops/kernels/relocate.py::WARP_MAX
constexpr int kBlockMax = 4096;             // ops/kernels/relocate.py::BLOCK_MAX
constexpr int kGroup = 32;                  // rows per warp step: one header per lane
constexpr int kStage = kGroup * kWarpMax;   // staged entries of a group, at most
constexpr int kQuads = 5;                   // quads of 4 entries per lane and round
constexpr int kRound = 32 * 4 * kQuads;     // 640 entries: one round at path A's mean of 512
constexpr int kWaves = 2;                   // warp tier grid: resident warps times this
constexpr int kRowBlocksPerSM = 4;          // block tier grid
constexpr unsigned kFull = 0xffffffffu;

enum Payload { kPattern = 0, kFloat = 1, kSource = 2 };

// One warp's group of rows in shared memory: 5,760 B.
struct Stage {
  int cols[kStage];              // new column of each staged entry
  int64_t src_base[kGroup];      // row start - first staged slot: source = src_base + slot
  int64_t dst[kGroup];           // new_indptr[ro[row]]
  int info[kGroup];              // first staged slot << 8 | staged degree (0: not in this tier)
  unsigned char row_of[kStage];  // group lane of each staged entry's row
};

template <int kPayload>
__device__ __forceinline__ void put_payload(const float* vals, float* out_vals, int64_t* out_src,
                                            int64_t src, int64_t dst) {
  if (kPayload == kFloat) out_vals[dst] = __ldg(vals + src);
  if (kPayload == kSource) out_src[dst] = src;
}

// appends the lanes' rows where `take` holds to list[*count ...]
__device__ __forceinline__ void append_rows(bool take, int row, int* count, int* list) {
  const unsigned mask = __ballot_sync(kFull, take);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(kFull, base, 0);
  if (take) list[base + __popc(mask & ((1u << lane) - 1))] = row;
}

// a group's row headers: indptr[r], indptr[r+1] and ro[r] of lane's row r
struct Header {
  int64_t start = 0, end = 0;
  int new_r = 0;
};

__device__ __forceinline__ Header load_header(const int64_t* indptr, const int* ro, int64_t r,
                                              int64_t n) {
  Header h;
  if (r < n) {
    h.start = __ldg(indptr + r);
    h.end = __ldg(indptr + r + 1);
    h.new_r = ro ? __ldg(ro + r) : (int)r;
  }
  return h;
}

// nvcc -Xptxas -v (sm_90a, CUDA 12.8): 75 registers in each payload's
// instance, no spills, 46,080 B of shared memory per block (8 stages), so
// 3 blocks (24 warps) per SM, held by registers.
template <int kPayload>
__global__ void __launch_bounds__(kThreads)
relocate_warp_rows(const int64_t* __restrict__ indptr, const int* __restrict__ indices,
                   const float* __restrict__ vals, const int* __restrict__ ro,
                   const int* __restrict__ co, const int64_t* __restrict__ new_indptr, int64_t n,
                   bool aligned, int* __restrict__ counts, int* __restrict__ block_rows,
                   int* __restrict__ over_rows, int* __restrict__ out_indices,
                   float* __restrict__ out_vals, int64_t* __restrict__ out_src) {
  __shared__ Stage stages[kThreads / 32];
  Stage& st = stages[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t ngroups = (n + kGroup - 1) / kGroup;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  Header h = load_header(indptr, ro, g * kGroup + lane, n);
  for (; g < ngroups; g += nwarps) {
    // 1. the row headers, one row per lane (loaded during the group before)
    const int64_t r = g * kGroup + lane;
    const int64_t deg = h.end - h.start;
    const int sdeg = deg <= kWarpMax ? (int)deg : 0;
    const int64_t dst = sdeg > 0 ? __ldg(new_indptr + h.new_r) : 0;  // waited for in step 2
    int soff = sdeg;  // inclusive scan of the staged degrees
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, soff, d);
      if (lane >= d) soff += t;
    }
    const int total = __shfl_sync(kFull, soff, 31);
    soff -= sdeg;
    const bool mid = deg > kWarpMax && deg <= kBlockMax, over = deg > kBlockMax;
    const bool contiguous = __ballot_sync(kFull, mid || over) == 0;
    append_rows(mid, (int)r, counts, block_rows);
    append_rows(over, (int)r, counts + 1, over_rows);
    st.info[lane] = soff << 8 | sdeg;
    st.src_base[lane] = h.start - soff;
    for (int p = 0; p < sdeg; ++p) st.row_of[soff + p] = (unsigned char)lane;
    __syncwarp();

    // the staged entries are [e0, e0 + total) when no row was left out:
    // quads then start at a0 = e0 rounded down to 4 entries, `shift` before
    const bool vec = aligned && contiguous;
    const int64_t e0 = __shfl_sync(kFull, h.start, 0);
    const int shift = vec ? (int)(e0 & 3) : 0;
    const int64_t a0 = e0 - shift;
    const int span = total + shift;

    // 2. every id of a round, then every co[c] gather, then the stage
    for (int base = 0; base < span; base += kRound) {
      int c[4 * kQuads];
#pragma unroll
      for (int k = 0; k < kQuads; ++k) {
        const int v0 = base + (k * 32 + lane) * 4;
        if (vec) {
          if (v0 < span) {
            const int4 q = __ldg(reinterpret_cast<const int4*>(indices + a0 + v0));
            c[4 * k] = q.x, c[4 * k + 1] = q.y, c[4 * k + 2] = q.z, c[4 * k + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = v0 + t;
            if (j < total) c[4 * k + t] = __ldg(indices + st.src_base[st.row_of[j]] + j);
          }
        }
      }
      if (co) {
#pragma unroll
        for (int s = 0; s < 4 * kQuads; ++s) {
          const int j = base + ((s >> 2) * 32 + lane) * 4 + (s & 3) - shift;
          if (j >= 0 && j < total) c[s] = __ldg(co + c[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < 4 * kQuads; ++s) {
        const int j = base + ((s >> 2) * 32 + lane) * 4 + (s & 3) - shift;
        if (j >= 0 && j < total) st.cols[j] = c[s];
      }
    }
    st.dst[lane] = dst;
    __syncwarp();

    // the next group's headers load while this one is ranked and stored
    if (g + nwarps < ngroups) h = load_header(indptr, ro, (g + nwarps) * kGroup + lane, n);

    // 3. lanes on consecutive staged entries: each loads its value, counts
    //    its rank in the stage while the load is in flight, and stores
    for (int j = lane; j < total; j += 32) {
      const int row = st.row_of[j];
      const int64_t src = st.src_base[row] + j;
      float v = 0.f;
      if (kPayload == kFloat) v = __ldg(vals + src);
      const int info = st.info[row];
      const int first = info >> 8, end = first + (info & 255);
      const unsigned col = (unsigned)st.cols[j];
      int rank = 0;  // entries of the row before (col, j): column ids are >= 0
#pragma unroll 4
      for (int q = first; q < end; ++q) rank += (unsigned)st.cols[q] < col + (q < j);
      const int64_t at = st.dst[row] + rank;
      out_indices[at] = (int)col;
      if (kPayload == kFloat) out_vals[at] = v;
      if (kPayload == kSource) out_src[at] = src;
    }
    __syncwarp();  // the next group rewrites the stage
  }
}

template <int kPayload>
__global__ void __launch_bounds__(kThreads)
relocate_block_rows(const int64_t* __restrict__ indptr, const int* __restrict__ indices,
                    const float* __restrict__ vals, const int* __restrict__ ro,
                    const int* __restrict__ co, const int64_t* __restrict__ new_indptr,
                    const int* __restrict__ rows, const int* __restrict__ count,
                    int* __restrict__ out_indices, float* __restrict__ out_vals,
                    int64_t* __restrict__ out_src) {
  __shared__ unsigned long long keys[kBlockMax];
  const int nrows_listed = *count;  // written by relocate_warp_rows on this stream
  for (int k = blockIdx.x; k < nrows_listed; k += gridDim.x) {
    const int r = rows[k];
    const int64_t start = indptr[r];
    const int deg = (int)(indptr[r + 1] - start);  // 32 < deg <= kBlockMax
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

// the current device's SM count into *sms, read at each launch
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <int kPayload>
cudaError_t launch(const int64_t* indptr, const int* indices, const float* vals, const int* ro,
            const int* co, const int64_t* new_indptr, int64_t n, int* rows, int64_t block_cap,
            int* counts, int* out_indices, float* out_vals, int64_t* out_src, cudaStream_t s) {
  thread_local int resident = 0;  // warp tier blocks per SM: asked once per host thread, a failed query returned
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess && resident == 0) {
    int b = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, relocate_warp_rows<kPayload>, kThreads, 0);
    if (err == cudaSuccess) resident = b < 1 ? 1 : b;
  }
  if (err != cudaSuccess) return err;
  const bool aligned = (reinterpret_cast<uintptr_t>(indices) & 15) == 0;
  const int64_t ngroups = (n + kGroup - 1) / kGroup;
  const int64_t warps_per_block = kThreads / 32;
  int64_t blocks = (ngroups + warps_per_block - 1) / warps_per_block;
  const int64_t cap = (int64_t)sms * resident * kWaves;
  if (blocks > cap) blocks = cap;
  err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return err;
  relocate_warp_rows<kPayload><<<(unsigned)blocks, kThreads, 0, s>>>(
      indptr, indices, vals, ro, co, new_indptr, n, aligned, counts, rows, rows + block_cap,
      out_indices, out_vals, out_src);
  relocate_block_rows<kPayload><<<(unsigned)(sms * kRowBlocksPerSM), kThreads, 0, s>>>(
      indptr, indices, vals, ro, co, new_indptr, rows, counts, out_indices, out_vals, out_src);
  return cudaGetLastError();
}

}  // namespace

// indptr: (n+1,) int64; indices: (nnz,) int32; vals: (nnz,) f32 when
// payload == 1, else ignored; ro: (n,) int32 bijection or null; co: int32
// table over the column ids or null; new_indptr: (n+1,) int64, the new
// row starts (new_indptr[ro[r]] is row r's block). rows: int32 scratch,
// block_cap slots for the rows of 33..4096 entries, then room for the rows
// over 4096; counts: (2,) int32, set here to those two lists' lengths.
// Outputs (nnz,): out_indices int32; out_vals f32 when payload == 1;
// out_src int64 source positions when payload == 2. n >= 1.
extern "C" int sb_relocate_csr(const int64_t* indptr, const int* indices, const float* vals,
                               const int* ro, const int* co, const int64_t* new_indptr, int64_t n,
                               int payload, int* rows, int64_t block_cap, int* counts,
                               int* out_indices, float* out_vals, int64_t* out_src, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload == kPattern)
    return (int)launch<kPattern>(indptr, indices, vals, ro, co, new_indptr, n, rows, block_cap,
                                 counts, out_indices, out_vals, out_src, s);
  if (payload == kFloat)
    return (int)launch<kFloat>(indptr, indices, vals, ro, co, new_indptr, n, rows, block_cap,
                               counts, out_indices, out_vals, out_src, s);
  if (payload == kSource)
    return (int)launch<kSource>(indptr, indices, vals, ro, co, new_indptr, n, rows, block_cap,
                                counts, out_indices, out_vals, out_src, s);
  return (int)cudaErrorInvalidValue;
}
