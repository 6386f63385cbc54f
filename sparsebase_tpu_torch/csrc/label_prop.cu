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
// What bounds it on the H100: device memory. Its function reads indptr,
// ids and labels once and writes the new labels: at 6.25M rows and 100M
// entries, 50 + 400 + 25 + 25 MB, 0.15 ms at 3.35 TB/s. The labels (25 MB)
// fit in the 50 MB L2, so the gathers labels[ids[j]] are served there.
//
// The argmax needs gmax, a grid-wide maximum, before any row can choose. So
// one C call is a memset and three launches on the caller's stream, with no
// host read:
//  1. lp_count: each row's histogram, the largest cell of the grid (an
//     atomicMax on an order-preserving integer key of the float) and the part
//     sizes (a block table, flushed by k atomics a block);
//  2. lp_penalty: pen[p] for the k parts;
//  3. lp_assign: each row's histogram again and its first-index argmax.
// Reading the entries twice costs 400 MB more than the bound; keeping the
// histograms instead would cost n * k words.
//
// Design. A group of G lanes takes a row (G = 8 for k <= 64, where path H's
// rows of about 16 entries keep the lanes busy, else a warp). Each group owns
// a k-word histogram in shared memory; its lanes stride the row's entries and
// add 1 by shared-memory atomics: the counts are integers, so their order
// does not matter and the result is exact. With weights, every lane of the
// group walks the row in entry order and adds the weights of the parts it
// owns (p = lane mod G), so each cell is a sum in entry order, as np.add.at
// and the CPU's index_put_(accumulate=True) take it. The lane that reads a
// cell clears it for the next row. Warps loop over the rows with a trip count
// that is the same for all their lanes, so the group shuffles of the argmax
// run converged.
//
// Tiers. The block holds (groups + 1) * k words in 48 KB of shared memory
// (no opt-in): k up to 6,140. Past that, each warp's histogram is a slice of
// a scratch buffer in device memory (the global tier, kGlobalWords words in
// all, at least 8 warps), and the sizes go straight to device atomics. Row
// length needs no tier: a histogram's size is k, not the row's length; a
// long row takes its group longer.
//
// Known costs, left for later work: the second pass over the entries; a
// group of 8 lanes walks a row of 262,144 entries alone; every row scans all
// k cells, which is n * k work at large k.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemWords = 12280;           // 48 KB with lp_count's static 32 bytes: no opt-in
constexpr int kNarrowK = 64;                // k up to this: groups of 8 lanes
constexpr int kBlocksPerSM = 8;
constexpr int64_t kGlobalWords = 1 << 24;   // the global tier's histograms: 64 MB

// the current device's SM count into *sms
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

int64_t align256(int64_t bytes) { return (bytes + 255) & ~int64_t(255); }

struct Plan {
  int group;       // lanes per row: 8 or 32
  int groups;      // rows a block takes at once
  bool global;     // histograms in the scratch buffer
  int64_t blocks;
};

Plan make_plan(int64_t n, int64_t k) {
  Plan p;
  p.group = k <= kNarrowK ? 8 : 32;
  const int64_t fit = kSmemWords / k - 1;  // histograms beside the block's k-word table
  if (fit >= 1) {
    p.global = false;
    int64_t g = kThreads / p.group;
    if (fit < g) g = fit;
    if (p.group == 8) g &= ~int64_t(3);  // whole warps (fit >= 191 here)
    p.groups = (int)g;
    p.blocks = (n + g - 1) / g;  // capped by the SM count at launch
  } else {
    p.global = true;
    p.groups = kThreads / 32;
    int64_t slices = (kGlobalWords / k) & ~int64_t(7);
    if (slices < 8) slices = 8;
    const int64_t need = (n + 7) / 8 * 8;
    if (slices > need) slices = need;
    p.blocks = slices / 8;
  }
  if (p.blocks < 1) p.blocks = 1;
  return p;
}

// an unsigned key that orders as the float does
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

template <bool W>
__device__ __forceinline__ float cell(uint32_t word) {
  return W ? __uint_as_float(word) : __int2float_rn((int)word);
}

// the entries s..e of one row into its group's histogram (see the header)
template <int G, bool W>
__device__ __forceinline__ void accumulate(uint32_t* hist, const int* __restrict__ ids, const float* __restrict__ w,
                                           const int* __restrict__ labels, int64_t s, int64_t e, int gl, int k) {
  if (W) {
    for (int64_t j = s; j < e; ++j) {
      const int p = __ldg(labels + __ldg(ids + j));
      if ((unsigned)p < (unsigned)k && (p & (G - 1)) == gl)
        hist[p] = __float_as_uint(__fadd_rn(__uint_as_float(hist[p]), __ldg(w + j)));
    }
  } else {
    for (int64_t j = s + gl; j < e; j += G) {
      const int p = __ldg(labels + __ldg(ids + j));
      if ((unsigned)p < (unsigned)k) atomicAdd(reinterpret_cast<int*>(hist + p), 1);
    }
  }
}

// pass 1: the histograms' largest cell and the part sizes
template <int G, bool W, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
lp_count(const int64_t* __restrict__ indptr, const int* __restrict__ ids, const float* __restrict__ w,
         const int* __restrict__ labels, int64_t n, int k, uint32_t* __restrict__ ghist, int* __restrict__ sizes,
         unsigned* __restrict__ gmax_key) {
  extern __shared__ uint32_t smem[];
  __shared__ float warp_max[kThreads / 32];
  const int groups = blockDim.x / G;
  const int group = threadIdx.x / G, gl = threadIdx.x % G, lane = threadIdx.x & 31;
  uint32_t* hist = GLOBAL ? ghist + ((int64_t)blockIdx.x * groups + group) * k : smem + group * k;
  int* block_sizes = reinterpret_cast<int*>(smem + groups * k);
  if (GLOBAL) {
    for (int p = gl; p < k; p += G) hist[p] = 0;
  } else {
    for (int i = threadIdx.x; i < (groups + 1) * k; i += blockDim.x) smem[i] = 0;
  }
  __syncthreads();
  float lmax = __int_as_float(0xff800000);  // -inf
  const int warp_first = group & ~(32 / G - 1);
  const int64_t step = (int64_t)gridDim.x * groups;
  for (int64_t blk = (int64_t)blockIdx.x * groups; blk + warp_first < n; blk += step) {
    const int64_t row = blk + group;
    const bool valid = row < n;
    if (valid) {
      if (gl == 0) {
        const int own = __ldg(labels + row);
        if ((unsigned)own < (unsigned)k) atomicAdd(GLOBAL ? sizes + own : block_sizes + own, 1);
      }
      accumulate<G, W>(hist, ids, w, labels, __ldg(indptr + row), __ldg(indptr + row + 1), gl, k);
    }
    __syncwarp();
    if (valid) {
      for (int p = gl; p < k; p += G) {
        lmax = fmaxf(lmax, cell<W>(hist[p]));
        hist[p] = 0;
      }
    }
    __syncwarp();
  }
  for (int off = 16; off > 0; off >>= 1) lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
  if (lane == 0) warp_max[threadIdx.x >> 5] = lmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, warp_max[i]);
    atomicMax(gmax_key, order_key(m));
  }
  if (!GLOBAL) {
    for (int p = threadIdx.x; p < k; p += blockDim.x) {
      const int c = block_sizes[p];
      if (c) atomicAdd(sizes + p, c);
    }
  }
}

// between the passes: the k penalties, in the reference's order of operations
__global__ void lp_penalty(const int* __restrict__ sizes, const unsigned* __restrict__ gmax_key, int k, float alpha,
                           float cap, float cap_div, float* __restrict__ pen) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= k) return;
  const float top = __fadd_rn(key_float(*gmax_key), 1.0f);
  const float over = fmaxf(__fsub_rn(__int2float_rn(sizes[p]), cap), 0.0f);
  pen[p] = __fdiv_rn(__fmul_rn(__fmul_rn(alpha, over), top), cap_div);
}

// pass 2: each row's histogram again, and the first part of its best score
template <int G, bool W, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
lp_assign(const int64_t* __restrict__ indptr, const int* __restrict__ ids, const float* __restrict__ w,
          const int* __restrict__ labels, int64_t n, int k, uint32_t* __restrict__ ghist,
          const float* __restrict__ pen, int* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int groups = blockDim.x / G;
  const int group = threadIdx.x / G, gl = threadIdx.x % G;
  uint32_t* hist = GLOBAL ? ghist + ((int64_t)blockIdx.x * groups + group) * k : smem + group * k;
  float* block_pen = reinterpret_cast<float*>(smem + groups * k);
  if (GLOBAL) {
    for (int p = gl; p < k; p += G) hist[p] = 0;
  } else {
    for (int i = threadIdx.x; i < groups * k; i += blockDim.x) smem[i] = 0;
    for (int p = threadIdx.x; p < k; p += blockDim.x) block_pen[p] = pen[p];
  }
  __syncthreads();
  const float* pens = GLOBAL ? pen : block_pen;
  const int warp_first = group & ~(32 / G - 1);
  const int64_t step = (int64_t)gridDim.x * groups;
  for (int64_t blk = (int64_t)blockIdx.x * groups; blk + warp_first < n; blk += step) {
    const int64_t row = blk + group;
    const bool valid = row < n;
    int64_t s = 0, e = 0;
    if (valid) {
      s = __ldg(indptr + row);
      e = __ldg(indptr + row + 1);
      accumulate<G, W>(hist, ids, w, labels, s, e, gl, k);
    }
    __syncwarp();
    float best = __int_as_float(0xff800000);
    int bp = INT_MAX;  // a lane without cells (k < G) never wins a tie
    if (valid) {
      for (int p = gl; p < k; p += G) {
        const float score = __fsub_rn(cell<W>(hist[p]), pens[p]);
        hist[p] = 0;
        if (bp == INT_MAX || score > best) {
          best = score;
          bp = p;
        }
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off, G);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off, G);
      if (ob > best || (ob == best && op < bp)) {
        best = ob;
        bp = op;
      }
    }
    if (valid && gl == 0) out[row] = e > s ? bp : __ldg(labels + row);
    __syncwarp();
  }
}

struct Args {
  const int64_t* indptr;
  const int* ids;
  const float* w;
  const int* labels;
  int64_t n;
  int k;
  float alpha, cap, cap_div;
  uint32_t* ghist;
  int* sizes;
  unsigned* gmax_key;
  float* pen;
  int* out;
};

template <int G, bool W, bool GLOBAL>
void run(const Plan& p, const Args& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)p.blocks, threads = (unsigned)(p.groups * G);
  const size_t smem = GLOBAL ? 0 : (size_t)(p.groups + 1) * a.k * sizeof(uint32_t);
  lp_count<G, W, GLOBAL><<<blocks, threads, smem, s>>>(a.indptr, a.ids, a.w, a.labels, a.n, a.k, a.ghist, a.sizes,
                                                       a.gmax_key);
  lp_penalty<<<(unsigned)((a.k + 255) / 256), 256, 0, s>>>(a.sizes, a.gmax_key, a.k, a.alpha, a.cap, a.cap_div,
                                                           a.pen);
  lp_assign<G, W, GLOBAL><<<blocks, threads, smem, s>>>(a.indptr, a.ids, a.w, a.labels, a.n, a.k, a.ghist, a.pen,
                                                        a.out);
}

template <bool W>
void dispatch(const Plan& p, const Args& a, cudaStream_t s) {
  if (p.global)
    run<32, W, true>(p, a, s);
  else if (p.group == 8)
    run<8, W, false>(p, a, s);
  else
    run<32, W, false>(p, a, s);
}

}  // namespace

// Bytes of the scratch buffer that sb_label_prop_round needs for n rows and k
// parts: the sizes (k ints), the largest count's key, the penalties (k
// floats) and, in the global tier, the histograms.
extern "C" int64_t sb_label_prop_scratch_bytes(int64_t n, int64_t k) {
  const Plan p = make_plan(n, k);
  int64_t bytes = 2 * align256(4 * k) + 256;
  if (p.global) bytes += p.blocks * p.groups * k * (int64_t)sizeof(uint32_t);
  return bytes;
}

// indptr: (n+1,) int64; ids: (nnz,) int32 in [0, n); weights: (nnz,) float32
// or null; labels: (n,) int32; 1 <= k < 2^31; alpha, cap, cap_div: the
// float32 roundings of the reference's Python numbers; scratch: the bytes
// sb_label_prop_scratch_bytes(n, k) gives; out: (n,) int32, written in full.
extern "C" int sb_label_prop_round(const int64_t* indptr, const int* ids, const float* weights, const int* labels,
                                   int64_t n, int64_t k, float alpha, float cap, float cap_div, void* scratch,
                                   int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  Plan p = make_plan(n, k);
  if (!p.global) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    const int64_t cap = (int64_t)sms * kBlocksPerSM;
    if (p.blocks > cap) p.blocks = cap;
  }
  char* base = static_cast<char*>(scratch);
  const int64_t table = align256(4 * k);
  Args a{indptr, ids, weights, labels, n, (int)k, alpha, cap, cap_div,
         reinterpret_cast<uint32_t*>(base + 2 * table + 256), reinterpret_cast<int*>(base),
         reinterpret_cast<unsigned*>(base + table), reinterpret_cast<float*>(base + table + 256), out};
  const cudaError_t err = cudaMemsetAsync(base, 0, (size_t)(table + 256), s);  // sizes and the largest count
  if (err != cudaSuccess) return (int)err;
  if (weights)
    dispatch<true>(p, a, s);
  else
    dispatch<false>(p, a, s);
  return (int)cudaGetLastError();
}
