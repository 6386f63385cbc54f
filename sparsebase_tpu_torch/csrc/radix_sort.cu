// K5 — stable LSD radix sort of integer keys, for Hopper, returning the
// permutation (perm[new] = old) or its inverse, the rank (rank[old] = new),
// and on request the sorted keys.
//
// Replaces the two radix-partition Pallas kernels of
// tools/pallas_attempts.py: build_radix_scalar (:109, pallas_call :150),
// which split each 8192-element block by its low 8-bit digit with a
// 256-bucket histogram, a triangular-matmul exclusive scan and one dynamic
// store per element; and build_radix_matmul (:168, pallas_call :203), the
// same partition per 512-block placed by a one-hot matmul (its f32 round
// trip drops low bits of values >= 2^24). Here the partition is exact and
// global, one digit of up to 8 bits per pass. On the port's path it is the
// stable degree rank of preprocess_pipeline and DegreeReorder, the sort of
// the rows that are too long for K4's tiers, and the (row, column) sort of
// a COO.
//
// What bounds it on the H100: device memory. The keys are read once for
// the histograms of every digit; each pass that runs reads keys and ids once
// and writes them once, scattered over up to 256 runs per block. What the
// design does about it:
//
// * The host plans the passes from what the caller states about the keys
//   (which bits can be set); the device thins them: a digit on which all
//   keys agree permutes nothing, and its pass returns at once on a flag in
//   device memory. No key is read back to the host, shifted or copied:
//   signed keys sort by flipping the sign bit where the top digit is taken.
// * radix_count reads the keys once and counts every planned digit in
//   shared memory. A warp holds 512 consecutive keys; the bits on which
//   they differ come from one OR and one AND per thread and two warp
//   reductions, and a digit on which all 512 agree costs one addition.
//   Any other digit is one shared-memory atomic per key. Its last block (an
//   atomic ticket) scans each digit's 256 totals, marks the passes that run,
//   and says which buffer each reads and which one is the last: that one
//   writes the result.
// * radix_pass is one launch per planned pass. A block takes its tile by an
//   atomic ticket, so the tiles before it are always running or done. Each
//   thread holds 16 keys, a warp 512 consecutive ones. The warps first count
//   their digits (shared-memory atomics); thread d sums the warps' counts of
//   digit d and publishes the tile's count at once, so that later tiles can
//   read it while this one still ranks its keys. A key's rank among the
//   equal digits of its tile is then a running per-(warp, digit) count,
//   started at the counts of the warps before, plus the popcount of the
//   lower lanes that hold the same digit (one ballot per bit of the digit),
//   with no block barrier inside the loop. After ranking, thread d looks
//   back over the earlier tiles (decoupled look-back: a count, then an
//   inclusive prefix, each with its flag in the same 64-bit word; the flags
//   carry the pass number, so one zeroed table serves every pass). Keys and
//   ids are laid out by digit in shared memory and written from there, so
//   neighbouring threads store to neighbouring addresses of one bucket. A
//   last pass that writes the rank alone skips that stage: each thread
//   stores its keys' destinations at their ids, which on a first pass are
//   its own consecutive positions. Equal digits keep their input order in
//   every pass: the sort is stable.
// * Registers decide how many blocks an SM holds (16 keys of 8 bytes are 32
//   registers a thread): ranks are packed two to a register, ids are loaded
//   where they are used, and the launch bounds ask for kMinBlocks blocks.
//   A block does one tile and ends: the blocks that wait for memory are
//   hidden behind the others that the SM holds and the ones it starts next.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per digit in the prefix steps
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // keys per thread
constexpr int kTile = kThreads * kItems;  // keys per block per pass; ops/kernels/radix.py::TILE
constexpr int kDigits = 256;
constexpr int kMaxPasses = 8;           // ops/kernels/radix.py::MAX_PASSES
constexpr int kCountBlocks = 132 * 8;   // radix_count walks the tiles with at most this many blocks
constexpr int kHeaderBytes = 32768;     // ops/kernels/radix.py::HEADER_BYTES
constexpr int kMinBlocks = 3;  // blocks of radix_pass per SM that the register budget must allow
constexpr unsigned kFull = 0xffffffffu;

// One digit: ((key >> shift) & mask) ^ flip. flip is the digit's top bit
// where that bit is the sign of a signed key, else 0.
struct Pass {
  int shift;
  unsigned mask;
  unsigned flip;
};

struct Passes {
  int count;
  Pass p[kMaxPasses];
};

// The head of the scratch buffer, zeroed before every sort.
struct Header {
  unsigned hist[kMaxPasses][kDigits];  // keys per digit value, over all keys
  unsigned scan[kMaxPasses][kDigits];  // its exclusive scan: where each bucket starts
  int ticket[kMaxPasses];              // next tile of each pass
  int done;                            // blocks of radix_count that have finished
  int source[kMaxPasses];              // 0: pass skipped; 1: reads the caller's keys; 2, 3: buffer 0, 1
  int last[kMaxPasses];                // 1 on the last pass that runs
};
static_assert(sizeof(Header) <= kHeaderBytes, "Header outgrew its room in the scratch buffer");

template <typename K>
struct Buffers {
  const K* keys;  // the caller's, never written
  K* key_buf0;
  K* key_buf1;
  int* id_buf0;
  int* id_buf1;
  int* out;        // rank or permutation
  K* sorted_keys;  // or null
  int64_t n;
  int inverse;
};

template <typename K>
__device__ __forceinline__ unsigned digit_of(K key, Pass ps) {
  return ((unsigned)(key >> ps.shift) & ps.mask) ^ ps.flip;
}

// The lanes of the warp whose key is valid and has the digit d (valid lanes
// only; an invalid lane's result means nothing). One ballot per bit of the
// digit: its cost does not grow with the number of distinct digits in the
// warp, as __match_any_sync's does.
__device__ __forceinline__ unsigned lanes_with_digit(unsigned d, bool valid, unsigned mask) {
  unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    if ((mask >> bit) == 0) break;  // uniform: the pass's digit has fewer bits
    const bool set = (d >> bit) & 1u;
    const unsigned with = __ballot_sync(kFull, set);
    peers &= set ? with : ~with;
  }
  return peers;
}

// Exclusive sum over the block of one value per thread. scratch: 33 words
// of shared memory; the caller syncs before it reuses them.
__device__ unsigned block_exclusive_sum(unsigned v, unsigned* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < kWarps ? scratch[lane] : 0;
    unsigned wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < kWarps) scratch[lane] = wi - w;
  }
  __syncthreads();
  return scratch[warp] + incl - v;
}

__device__ __forceinline__ unsigned warp_and(unsigned v) { return __reduce_and_sync(kFull, v); }
__device__ __forceinline__ unsigned warp_or(unsigned v) { return __reduce_or_sync(kFull, v); }
__device__ __forceinline__ uint64_t warp_and(uint64_t v) {
  return ((uint64_t)__reduce_and_sync(kFull, (unsigned)(v >> 32)) << 32) | __reduce_and_sync(kFull, (unsigned)v);
}
__device__ __forceinline__ uint64_t warp_or(uint64_t v) {
  return ((uint64_t)__reduce_or_sync(kFull, (unsigned)(v >> 32)) << 32) | __reduce_or_sync(kFull, (unsigned)v);
}

// Counts every planned digit of every key; the last block to finish plans
// the passes on the device.
template <typename K>
__global__ void __launch_bounds__(kThreads)
radix_count(const K* __restrict__ keys, int64_t n, int ntiles, Passes passes, Header* __restrict__ h) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* counts = reinterpret_cast<unsigned*>(smem);  // [passes.count][kDigits]
  unsigned* scratch = counts + kMaxPasses * kDigits;     // 33 words
  int* live = reinterpret_cast<int*>(scratch + 33);      // [kMaxPasses], last block only
  int* is_last = live + kMaxPasses;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int p = 0; p < passes.count; ++p) counts[p * kDigits + t] = 0;
  __syncthreads();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t warp_base = (int64_t)tile * kTile + warp * (32 * kItems);  // a warp's keys are consecutive
    if (warp_base >= n) continue;  // uniform over the warp
    const int warp_keys = (int)(n - warp_base < 32 * kItems ? n - warp_base : 32 * kItems);
    K key[kItems];
    K any = 0, all = ~(K)0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t g = warp_base + i * 32 + lane;
      key[i] = g < n ? __ldg(keys + g) : (K)0;
      if (g < n) {
        any |= key[i];
        all &= key[i];
      }
    }
    any = warp_or(any);
    const K differ = any ^ warp_and(all);  // bits on which the warp's keys differ
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p >= passes.count) break;
      const Pass ps = passes.p[p];
      if (((unsigned)(differ >> ps.shift) & ps.mask) == 0) {  // one digit in all of the warp's keys
        if (lane == 0) atomicAdd(&counts[p * kDigits + digit_of(any, ps)], (unsigned)warp_keys);
        continue;
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (i * 32 + lane < warp_keys) atomicAdd(&counts[p * kDigits + digit_of(key[i], ps)], 1u);
      }
    }
  }
  __syncthreads();
  for (int p = 0; p < passes.count; ++p) {
    const unsigned c = counts[p * kDigits + t];
    if (c) atomicAdd(&h->hist[p][t], c);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) *is_last = atomicAdd(&h->done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*is_last) return;

  // The last block: every count is in. A digit with a single bucket moves
  // nothing; pass 0 runs whatever it holds, so that some pass writes the result.
  __threadfence();
  if (t < kMaxPasses) live[t] = t == 0;
  __syncthreads();
  for (int p = 0; p < passes.count; ++p) {
    const unsigned c = *(volatile unsigned*)&h->hist[p][t];
    if (c != 0 && c != (unsigned)n) live[p] = 1;
    h->scan[p][t] = block_exclusive_sum(c, scratch);
    __syncthreads();
  }
  if (t == 0) {
    int running = 0, last = 0;
    for (int p = 0; p < passes.count; ++p) {
      if (!live[p]) continue;  // source stays 0
      h->source[p] = running == 0 ? 1 : 2 + ((running - 1) & 1);
      ++running;
      last = p;
    }
    h->last[last] = 1;
  }
}

// One pass: the stable placement of one tile by one digit.
template <typename K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
radix_pass(Buffers<K> b, int p, Pass ps, Header* __restrict__ h, unsigned long long* state) {
  const int source = h->source[p];
  if (source == 0) return;  // a digit on which all keys agree
  extern __shared__ __align__(16) unsigned char smem[];
  K* stage_keys = reinterpret_cast<K*>(smem);                    // [kTile], by digit
  int* stage_ids = reinterpret_cast<int*>(stage_keys + kTile);   // [kTile]
  int* warp_count = stage_ids + kTile;                           // [kWarps][kDigits]
  int* tile_start = warp_count + kWarps * kDigits;               // [kDigits] first stage slot of each digit
  int* shift_out = tile_start + kDigits;                         // [kDigits] destination less stage slot
  unsigned* scratch = reinterpret_cast<unsigned*>(shift_out + kDigits);  // 33 words
  int* my_tile = reinterpret_cast<int*>(scratch + 33);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool last = h->last[p] != 0;
  const K* keys_in = source == 1 ? b.keys : source == 2 ? b.key_buf0 : b.key_buf1;
  const int* ids_in = source == 1 ? nullptr : source == 2 ? b.id_buf0 : b.id_buf1;  // null: ids are the positions
  K* keys_out = last ? b.sorted_keys : source == 2 ? b.key_buf1 : b.key_buf0;
  int* ids_out = last ? b.out : source == 2 ? b.id_buf1 : b.id_buf0;
  const bool inverse = last && b.inverse;
  const bool direct = inverse && !keys_out;  // the rank alone: no key moves

  if (t == 0) *my_tile = atomicAdd(&h->ticket[p], 1);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w * kDigits + t] = 0;
  __syncthreads();
  const int tile = *my_tile;
  const int64_t base = (int64_t)tile * kTile;
  const int64_t warp_base = base + warp * (32 * kItems);  // a warp's keys are consecutive

  K key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t g = warp_base + i * 32 + lane;
    key[i] = g < b.n ? keys_in[g] : (K)0;
  }
  // The tile's counts come first, so that the tiles after this one can read
  // them while this one ranks its keys: each warp counts its digits.
  int* my_count = warp_count + warp * kDigits;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (warp_base + i * 32 + lane < b.n) atomicAdd(&my_count[digit_of(key[i], ps)], 1);
  }
  __syncthreads();

  // thread t owns digit t: the warps' counts become each warp's first rank
  // in the tile, and their sum is published
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w * kDigits + t];
    warp_count[w * kDigits + t] = (int)count;
    count += (unsigned)c;
  }
  const unsigned partial_flag = 2u * p + 1u, prefix_flag = 2u * p + 2u;  // above every earlier pass's
  volatile unsigned long long* slots = state;
  slots[(int64_t)tile * kDigits + t] = ((unsigned long long)(tile > 0 ? partial_flag : prefix_flag) << 32) | count;
  if (!direct) tile_start[t] = (int)block_exclusive_sum(count, scratch);
  __syncthreads();

  // rank of each key among the equal digits of its tile, in input order:
  // the running count of its (warp, digit) plus the lower lanes that hold
  // the same digit
  unsigned rank2[kItems / 2];  // two ranks to a register
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = warp_base + i * 32 + lane < b.n;
    const unsigned d = digit_of(key[i], ps);
    const unsigned peers = lanes_with_digit(d, valid, ps.mask);
    const int leader = valid ? __ffs(peers) - 1 : lane;
    int before = 0;
    if (valid && lane == leader) {
      before = my_count[d];
      my_count[d] = before + __popc(peers);
    }
    __syncwarp();
    const unsigned r = (unsigned)(__shfl_sync(kFull, before, leader) + __popc(peers & lower));
    if (i & 1) rank2[i / 2] |= r << 16;
    else rank2[i / 2] = r;
  }

  // the keys of digit t in the tiles before this one: by now most of them
  // have published
  unsigned earlier = 0;
  if (tile > 0) {
    for (int64_t j = tile - 1;; --j) {  // tile 0 always holds a prefix: the walk ends there at the latest
      unsigned long long word = slots[j * kDigits + t];
      while ((unsigned)(word >> 32) != partial_flag && (unsigned)(word >> 32) != prefix_flag) {
        __nanosleep(20);
        word = slots[j * kDigits + t];
      }
      earlier += (unsigned)word;
      if ((unsigned)(word >> 32) == prefix_flag) break;
    }
    slots[(int64_t)tile * kDigits + t] = ((unsigned long long)prefix_flag << 32) | (earlier + count);
  }
  const int first = (int)(h->scan[p][t] + earlier);  // where this tile's keys of digit t go
  shift_out[t] = direct ? first : first - tile_start[t];
  __syncthreads();

  if (direct) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t g = warp_base + i * 32 + lane;
      if (g < b.n) {
        const int r = (int)((rank2[i / 2] >> (16 * (i & 1))) & 0xffffu);
        ids_out[ids_in ? ids_in[g] : (int)g] = shift_out[digit_of(key[i], ps)] + r;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t g = warp_base + i * 32 + lane;
    if (g < b.n) {
      const int slot = tile_start[digit_of(key[i], ps)] + (int)((rank2[i / 2] >> (16 * (i & 1))) & 0xffffu);
      stage_keys[slot] = key[i];
      stage_ids[slot] = ids_in ? ids_in[g] : (int)g;
    }
  }
  __syncthreads();

  const int tile_n = (int)(b.n - base < kTile ? b.n - base : kTile);
  for (int j = t; j < tile_n; j += kThreads) {  // neighbouring threads, neighbouring destinations
    const K k = stage_keys[j];
    const int dst = j + shift_out[digit_of(k, ps)];
    const int item = stage_ids[j];
    if (keys_out) keys_out[dst] = k;
    if (inverse) ids_out[item] = dst;
    else ids_out[dst] = item;
  }
}

template <typename K>
int radix_sort(const Passes& passes, Buffers<K> b, void* scratch, int64_t scratch_bytes, cudaStream_t s) {
  const int ntiles = (int)((b.n + kTile - 1) / kTile);
  if (scratch_bytes < kHeaderBytes + (int64_t)ntiles * kDigits * 8) return (int)cudaErrorInvalidValue;
  Header* h = static_cast<Header*>(scratch);
  unsigned long long* state = reinterpret_cast<unsigned long long*>(static_cast<unsigned char*>(scratch) + kHeaderBytes);
  const int count_smem = (kMaxPasses * kDigits + 33 + kMaxPasses + 1) * 4;
  const int pass_smem = kTile * ((int)sizeof(K) + 4) + (kWarps * kDigits + 2 * kDigits + 33 + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(radix_pass<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, pass_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, kHeaderBytes + (size_t)ntiles * kDigits * 8, s);
  if (err != cudaSuccess) return (int)err;
  const int count_blocks = ntiles < kCountBlocks ? ntiles : kCountBlocks;
  radix_count<K><<<count_blocks, kThreads, count_smem, s>>>(b.keys, b.n, ntiles, passes, h);
  for (int p = 0; p < passes.count; ++p) {
    radix_pass<K><<<ntiles, kThreads, pass_smem, s>>>(b, p, passes.p[p], h, state);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys: (n,) integers of key_bytes 4 or 8, read in place; 1 <= n < 2^31.
// plan: 3 ints per pass (shift, bits, flip), 1 <= npasses <= 8, low digit
// first; bits in [1, 8]; flip non-zero where the digit's top bit is the sign
// bit of signed keys. key_buf0/id_buf0: (n,) scratch when npasses >= 2,
// key_buf1/id_buf1 when npasses >= 3 (else null). scratch: scratch_bytes >=
// 32768 + 2048 * ceil(n / 4096), 8-byte aligned. out: (n,) int32, the rank
// if inverse else the permutation. sorted_keys: (n,) like keys, or null.
extern "C" int sb_radix_sort(const void* keys, int key_bytes, int64_t n, int npasses, const int* plan,
                             void* key_buf0, void* key_buf1, int* id_buf0, int* id_buf1, void* scratch,
                             int64_t scratch_bytes, int* out, void* sorted_keys, int inverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || npasses < 1 || npasses > kMaxPasses) return (int)cudaErrorInvalidValue;
  Passes passes;
  passes.count = npasses;
  for (int p = 0; p < npasses; ++p) {
    const int shift = plan[3 * p], bits = plan[3 * p + 1];
    if (shift < 0 || bits < 1 || bits > 8 || shift + bits > 8 * key_bytes) return (int)cudaErrorInvalidValue;
    passes.p[p].shift = shift;
    passes.p[p].mask = (1u << bits) - 1u;
    passes.p[p].flip = plan[3 * p + 2] ? 1u << (bits - 1) : 0u;
  }
  if (key_bytes == 4) {
    Buffers<uint32_t> b{static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(key_buf0),
                        static_cast<uint32_t*>(key_buf1), id_buf0, id_buf1, out,
                        static_cast<uint32_t*>(sorted_keys), n, inverse};
    return radix_sort<uint32_t>(passes, b, scratch, scratch_bytes, s);
  }
  if (key_bytes == 8) {
    Buffers<uint64_t> b{static_cast<const uint64_t*>(keys), static_cast<uint64_t*>(key_buf0),
                        static_cast<uint64_t*>(key_buf1), id_buf0, id_buf1, out,
                        static_cast<uint64_t*>(sorted_keys), n, inverse};
    return radix_sort<uint64_t>(passes, b, scratch, scratch_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}
