// Standalone event-density pyramid.
//
// Replaces the TPU kernel _counts_pallas (sast_tpu/ops/pallas/density.py,
// kernel _slab_kernel, public density_ratio_tpu): the per-channel count of
// non-zero cells of the uint8 NHWC input max-pooled by 4, 8, 16 and 32. The
// Python wrapper (ops/density.py) divides the counts by each level's
// (H/k)(W/k)C, the normalisation of the JAX package.
//
// Bound on the H100: one read of the input, 19.7 MB at gen4-base b4
// (4, 384, 640, 20), about 5.9 us at 3.35 TB/s; the arithmetic is a few
// integer ops per byte. What the design does about it: one block per
// (image, 32x32 tile) reads its tile once with 16-byte loads into shared
// memory (each tile row is 32 C contiguous bytes) and finishes the whole
// pyramid there (pyramid.cuh); only 4 C integer atomics per block leave it.
#include <cuda_runtime.h>

#include <cstdint>

#include "pyramid.cuh"

namespace {

constexpr int kTile = 32;

// x: (B, H, W, C) uint8; counts: (B, 4, C) int32, zeroed by the caller.
// Grid (W/32, H/32, B).
__global__ void __launch_bounds__(256) density_kernel(const uint8_t* __restrict__ x,
                               int* __restrict__ counts, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* tile = smem;                   // [32][32][C]
  uint8_t* occ = tile + kTile * kTile * C;  // [64][C]
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  // A tile row is 32 C bytes, a multiple of 16 because C % 4 == 0.
  const int row_vecs = kTile * C / 16;
  for (int i = threadIdx.x; i < kTile * row_vecs; i += blockDim.x) {
    const int r = i / row_vecs;
    const int v = i % row_vecs;
    const uint4* src = reinterpret_cast<const uint4*>(
        x + ((static_cast<size_t>(b) * H + y0 + r) * W + x0) * C);
    reinterpret_cast<uint4*>(tile)[i] = src[v];
  }
  __syncthreads();
  sast::density_tile(tile, kTile, 0, 0, C, occ,
                     counts + static_cast<size_t>(b) * 4 * C);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/density.py): H, W % 32 == 0,
// C % 4 == 0 and C <= 32, x 16-byte aligned.
extern "C" int sast_density_counts(const void* x, void* counts, int B, int H,
                                   int W, int C, void* stream) {
  const size_t smem = kTile * kTile * C + 64 * C;
  const dim3 grid(W / kTile, H / kTile, B);
  density_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<int*>(counts), H, W, C);
  return static_cast<int>(cudaGetLastError());
}
