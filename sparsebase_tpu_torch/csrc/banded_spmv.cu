// K1 — DIA (banded) SpMV for Hopper:  y[i] = sum_d data[d, i] * x[i + offsets[d]]
//
// Replaces sparsebase_tpu/ops/kernels/banded_spmv.py::_kernel and
// ::_kernel_tiled (the Pallas TPU kernels behind banded_spmv_pallas).
//
// What bounds it on the H100: device-memory bandwidth. Each stored band
// element is read once (4 B in f32, 2 B in bf16) and used in one
// multiply-add; x and y are O(n) and x's window (i + offset) is reused by
// neighbouring rows from L1/L2. At 33 diagonals the band is ~97% of the
// bytes moved.
//
// Design:
// * One thread per output row, grid-stride over rows. For a fixed
//   diagonal d, the warp's 32 threads read data[d, i..i+31]: one
//   coalesced 128 B (f32) segment. x[i + off] is read the same way.
// * The TPU kernel pads x into a 128-lane-aligned window (x_pad / pad_al)
//   because Mosaic cannot slice at unaligned lane offsets; here a column
//   outside [0, m) is skipped explicitly instead, which also handles
//   rectangular matrices and any n.
// * Offsets arrive as a device int32 array and are staged into shared
//   memory per block (the first kStaged of them; the rest, for very wide
//   bands, read through the cache). The kernel does not specialise per
//   matrix: the compile-time offsets of the TPU kernel were a Mosaic
//   constraint.
// * The band is f32 or bf16 (template); products accumulate in f32 in
//   diagonal order, and y is f32.
// * Two layouts of the band: "strided" (k, n), element (d, i) at d*n + i;
//   "tiled" (nb, k, B), element (d, i) at (i/B)*k*B + d*B + i%B, with the
//   last tile zero-padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStaged = 1024;  // offsets kept in shared memory (4 KB)
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool kTiled>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const int* __restrict__ offsets, const T* __restrict__ data,
                const float* __restrict__ x, float* __restrict__ y,
                int k, int64_t n, int64_t m, int64_t block) {
  __shared__ int s_off[kStaged];
  const int ks = k < kStaged ? k : kStaged;
  for (int d = threadIdx.x; d < ks; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int64_t base, step;
    if (kTiled) {
      const int64_t t = i / block;
      base = t * (int64_t)k * block + (i - t * block);
      step = block;
    } else {
      base = i;
      step = n;
    }
    float acc = 0.f;
    for (int d = 0; d < k; ++d) {
      const int off = d < kStaged ? s_off[d] : __ldg(offsets + d);
      const int64_t j = i + off;
      if (j >= 0 && j < m) acc += to_f32(data[base + (int64_t)d * step]) * __ldg(x + j);
    }
    y[i] = acc;
  }
}

template <typename T, bool kTiled>
void launch(const int* offsets, const void* data, const float* x, float* y,
            int k, int64_t n, int64_t m, int64_t block, cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dia_spmv_kernel<T, kTiled><<<(unsigned)blocks, kThreads, 0, stream>>>(
      offsets, static_cast<const T*>(data), x, y, k, n, m, block);
}

}  // namespace

// offsets: (k,) int32; data: the band in the chosen layout, f32 or bf16;
// x: (m,) f32; y: (n,) f32, written in full. n >= 1; block is the tile
// width of the tiled layout (ignored for the strided one).
extern "C" int sb_dia_spmv(const int* offsets, const void* data, const float* x, float* y,
                           int k, int64_t n, int64_t m, int64_t block, int tiled, int bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (tiled) launch<__nv_bfloat16, true>(offsets, data, x, y, k, n, m, block, s);
    else launch<__nv_bfloat16, false>(offsets, data, x, y, k, n, m, block, s);
  } else {
    if (tiled) launch<float, true>(offsets, data, x, y, k, n, m, block, s);
    else launch<float, false>(offsets, data, x, y, k, n, m, block, s);
  }
  return (int)cudaGetLastError();
}
