// Standalone event-density pyramid (kernel B): one launch from the uint8
// input to the final (B, 4, C) fp32 ratio.
//
// Replaces the TPU kernel _counts_pallas (sast_tpu/ops/pallas/density.py,
// kernel _slab_kernel, public density_ratio_tpu): per image and channel,
// the share of non-zero cells of the uint8 NHWC input max-pooled by 4, 8,
// 16 and 32, the count divided by each level's (H/k)(W/k)C. For
// non-negative values "max != 0" is "any != 0", so a cell is occupied iff
// any of its pixels is non-zero, and a level-k cell iff any of its four
// level-(k-1) cells is.
//
// Bound on the H100: one read of the input, 19.7 MB at gen4-base b4
// (4, 384, 640, 20), about 5.9 us at 3.35 TB/s; the arithmetic is a few
// integer operations per 4 bytes. What the design does about it:
// - One warp per 32x32 tile (whole cells of every level), eight tiles per
//   block. Lane (cy, cx) owns the pool-4 cells (cy, cx) and (cy + 4, cx).
//   A cell row is 4 pixels x C bytes = C/4 16-byte loads (C % 4 == 0), and
//   its word k holds channels 4 (k mod C/4) .. + 3, so a cell's occupancy is
//   the OR of its 16 rows' words per channel group, tested four channels at
//   a time with __vcmpne4: nothing passes through shared memory.
// - Levels 1-3 are ORs over lanes (shuffles across cx and cy neighbours).
//   Counts are per-byte sums of 0/1 flags, four channels to a word (at most
//   64 per tile and byte); the warp's sums go to the block's int32 counts.
// - Each block writes its (4, C) counts to a partials buffer; the last
//   block of an image to arrive (a per-image ticket, which it resets to 0
//   for the next launch) sums that image's partials (integers: exact in any
//   order) and divides each by the level's cell count with a correctly
//   rounded division, as the plain version's tensor division does, so the
//   ratio is bit-equal to it. No float atomics, no zeroing launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kWarps = 8;  // tiles per block
constexpr uint32_t kOnes = 0x01010101u;

__device__ __forceinline__ uint32_t warp_or(uint32_t v, int mask) {
  return v | __shfl_xor_sync(0xffffffffu, v, mask);
}
__device__ __forceinline__ uint32_t warp_add(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Occupancy of the pool-4 cell whose top-left pixel is at p (row stride
// `row` bytes): per channel group g, 0xff in byte q where channel 4g + q
// has a non-zero pixel.
template <int NV>
__device__ __forceinline__ void cell_occupancy(const uint8_t* p, size_t row, uint32_t (&occ)[NV]) {
  uint32_t acc[NV];
#pragma unroll
  for (int g = 0; g < NV; ++g) acc[g] = 0;
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const uint4* r = reinterpret_cast<const uint4*>(p + dy * row);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const uint4 v = __ldg(r + j);
      acc[(4 * j) % NV] |= v.x;
      acc[(4 * j + 1) % NV] |= v.y;
      acc[(4 * j + 2) % NV] |= v.z;
      acc[(4 * j + 3) % NV] |= v.w;
    }
  }
#pragma unroll
  for (int g = 0; g < NV; ++g) occ[g] = __vcmpne4(acc[g], 0u);
}

// x: (B, H, W, C) uint8, C = 4 NV; out: (B, 4, C) fp32; part: (B, gridDim.x,
// 4, C) int32; ticket: (B,) uint32, 0 between launches. Grid (blocks per
// image, B), kWarps warps per block.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32) density_kernel(const uint8_t* __restrict__ x,
                                                              float* __restrict__ out,
                                                              int* __restrict__ part,
                                                              unsigned int* __restrict__ ticket,
                                                              int H, int W) {
  constexpr int C = 4 * NV;
  __shared__ int cnt[4 * C];  // [level][channel]
  __shared__ bool last;
  const int b = blockIdx.y, nblk = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  const int tiles_x = W / kTile;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile < (H / kTile) * tiles_x) {
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    const int cx = lane & 7, cy = lane >> 3;
    const size_t row = (size_t)W * C;
    const uint8_t* p = x + ((size_t)b * H + ty * kTile + 4 * cy) * row + (tx * kTile + 4 * cx) * C;
    uint32_t a[NV], d[NV];  // cells (cy, cx) and (cy + 4, cx)
    cell_occupancy<NV>(p, row, a);
    cell_occupancy<NV>(p + 16 * row, row, d);
    // Representatives of a level's cell: level 1 cx, cy even; level 2 cx %
    // 4 == 0, cy == 0; level 3 lane 0 (both halves of the tile).
    const bool rep1 = (lane & 9) == 0, rep2 = (lane & 27) == 0, rep3 = lane == 0;
    uint32_t n[4][NV];
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      n[0][g] = (a[g] & kOnes) + (d[g] & kOnes);
      const uint32_t a1 = warp_or(warp_or(a[g], 1), 8), d1 = warp_or(warp_or(d[g], 1), 8);
      n[1][g] = rep1 ? (a1 & kOnes) + (d1 & kOnes) : 0u;
      const uint32_t a2 = warp_or(warp_or(a1, 2), 16), d2 = warp_or(warp_or(d1, 2), 16);
      n[2][g] = rep2 ? (a2 & kOnes) + (d2 & kOnes) : 0u;
      const uint32_t t3 = warp_or(a2, 4) | warp_or(d2, 4);  // every lane shuffles
      n[3][g] = rep3 ? t3 & kOnes : 0u;
    }
    // Per-byte sums over the warp (at most 64 each), then lane l < C adds
    // channel l of each level to the block's counts.
#pragma unroll
    for (int lv = 0; lv < 4; ++lv) {
      uint32_t mine = 0;
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        const uint32_t s = warp_add(n[lv][g]);
        if ((lane >> 2) == g) mine = s;
      }
      if (lane < C) atomicAdd(&cnt[lv * C + lane], (int)((mine >> (8 * (lane & 3))) & 0xffu));
    }
  }
  __syncthreads();

  int* own = part + ((size_t)b * nblk + blockIdx.x) * 4 * C;
  for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) own[i] = cnt[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket + b, 1u) == (unsigned int)(nblk - 1);
    if (last) ticket[b] = 0u;  // for the next launch on this stream
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int* all = part + (size_t)b * nblk * 4 * C;
  for (int e = threadIdx.x; e < nblk * 4 * C; e += blockDim.x)
    atomicAdd(&cnt[e % (4 * C)], __ldcg(all + e));
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) {
    const int k = 4 << (i / C);  // pool factor of the level
    out[(size_t)b * 4 * C + i] = __fdiv_rn((float)cnt[i], (float)((H / k) * (W / k) * C));
  }
}

int blocks_per_image(int H, int W) {
  return ((H / kTile) * (W / kTile) + kWarps - 1) / kWarps;
}

template <int NV>
int launch(const void* x, void* out, void* part, void* ticket, int B, int H, int W,
           cudaStream_t s) {
  const dim3 grid(blocks_per_image(H, W), B);
  density_kernel<NV><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(out), static_cast<int*>(part),
      static_cast<unsigned int*>(ticket), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the per-block partial counts one launch needs.
extern "C" long long sast_density_partials_bytes(int B, int H, int W, int C) {
  return (long long)B * blocks_per_image(H, W) * 4 * C * 4;
}

// Shapes are checked by the Python wrapper (ops/density.py): H, W % 32 == 0,
// C % 4 == 0 and C <= 32, x 16-byte aligned; ticket holds B zeros.
extern "C" int sast_density_ratio(const void* x, void* out, void* part, void* ticket, int B,
                                  int H, int W, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4: return launch<1>(x, out, part, ticket, B, H, W, s);
    case 8: return launch<2>(x, out, part, ticket, B, H, W, s);
    case 12: return launch<3>(x, out, part, ticket, B, H, W, s);
    case 16: return launch<4>(x, out, part, ticket, B, H, W, s);
    case 20: return launch<5>(x, out, part, ticket, B, H, W, s);
    case 24: return launch<6>(x, out, part, ticket, B, H, W, s);
    case 28: return launch<7>(x, out, part, ticket, B, H, W, s);
    case 32: return launch<8>(x, out, part, ticket, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
