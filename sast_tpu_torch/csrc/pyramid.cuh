// Event-density pyramid of one 32x32 input tile, for the stem kernel
// (stem_conv.cu, fused variant). The standalone density kernel (density.cu)
// computes the same counts in registers.
//
// The ratio of the JAX package (sast_tpu/ops/sparse.py non_zero_ratio)
// max-pools a uint8 NHWC input by 4, 8, 16 and 32 and counts, per channel,
// the pooled cells that are non-zero. For non-negative values "max != 0" is
// "any != 0", so a cell is occupied iff any of its pixels is. A 32x32 tile
// holds whole cells of every level: 8x8 cells at pool 4, 4x4 at 8, 2x2 at
// 16 and one at 32. Each block therefore finishes its own counts and adds
// them to the (B, 4, C) int32 totals with integer atomics, which are exact
// and do not depend on the order in which blocks run.
#pragma once

#include <cstdint>

namespace sast {

// tile: shared memory, pixel (row, col) channel c at
//   tile[(row * tile_w + col) * C + c]; the 32x32 core starts at (r0, c0).
// occ: shared scratch of 64 * C bytes.
// counts_b: this image's (4, C) int32 totals in device memory.
// Every thread of the block must call it (it holds a barrier).
__device__ inline void density_tile(const uint8_t* tile, int tile_w, int r0,
                                    int c0, int C, uint8_t* occ,
                                    int* counts_b) {
  // Level 0: occupancy of the 8x8 pool-4 cells, one (cell, channel) per
  // thread; neighbouring threads read neighbouring channels.
  for (int t = threadIdx.x; t < 64 * C; t += blockDim.x) {
    const int c = t % C;
    const int cell = t / C;
    const int cy = cell >> 3, cx = cell & 7;
    unsigned any = 0;
    for (int dy = 0; dy < 4; ++dy) {
      const uint8_t* p =
          tile + ((r0 + 4 * cy + dy) * tile_w + c0 + 4 * cx) * C + c;
      any |= p[0] | p[C] | p[2 * C] | p[3 * C];
    }
    occ[cell * C + c] = any != 0;
  }
  __syncthreads();
  // Levels 0-3 of one channel per thread: 64 + 16 + 4 + 1 cells.
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int n0 = 0, n1 = 0, n2 = 0;
    unsigned l2 = 0;  // bit q: pool-16 cell q is occupied
    for (int y1 = 0; y1 < 4; ++y1) {
      for (int x1 = 0; x1 < 4; ++x1) {
        const int a = ((2 * y1) * 8 + 2 * x1) * C + c;
        const unsigned o00 = occ[a], o01 = occ[a + C];
        const unsigned o10 = occ[a + 8 * C], o11 = occ[a + 9 * C];
        n0 += o00 + o01 + o10 + o11;
        const unsigned o = o00 | o01 | o10 | o11;
        n1 += o;
        l2 |= o << ((y1 >> 1) * 2 + (x1 >> 1));
      }
    }
    n2 = __popc(l2);
    const int n3 = l2 != 0;
    if (n0) atomicAdd(counts_b + 0 * C + c, n0);
    if (n1) atomicAdd(counts_b + 1 * C + c, n1);
    if (n2) atomicAdd(counts_b + 2 * C + c, n2);
    if (n3) atomicAdd(counts_b + 3 * C + c, n3);
  }
}

}  // namespace sast
