// Stem convolution of the SAST backbone, optionally fused with the
// event-density pyramid.
//
// Replaces the TPU kernel _stem_fwd_raw (sast_tpu/ops/pallas/stem_conv.py,
// public stem_conv_density_raw_7x4 and stem_conv_raw_7x4) and, as the same
// function, _stem_fwd_pallas (stem_conv_density_7x4 / stem_conv_7x4).
//
// y = conv(replicate_pad(x, 3), w, stride 4), no bias: a 7x7/stride-4
// convolution of the native uint8 NHWC event histogram (B, H, W, C) into
// (B, H/4, W/4, Cout), accumulated in fp32. With `counts`, the same input
// read also yields the (B, 4, C) non-zero cell counts of the density pyramid
// (pyramid.cuh).
//
// What bounds it on the H100 at gen4-base b4 (4, 384, 640, 20) -> (4, 96,
// 160, 64): bytes. 19.7 MB of uint8 in and 7.9 MB of bf16 out take about
// 8 us at 3.35 TB/s; the 7.7 GFLOP take about 8 us on the bf16 tensor cores.
//
// bf16 weights (the main path): an implicit GEMM on the tensor cores,
// stem_mma_kernel. M is the output pixels, N is Cout, and K is ordered
// (kh, kw, c), so that for one output pixel and one kernel row kh the K
// slice is 7 C *contiguous* bytes of one input row (pixels 4 ox - 3 ... 4 ox
// + 3). Each kh slice is padded to a multiple of 16 with zero weights. A
// first small launch, arrange_kernel, gathers the (Cout, C, 7, 7) weight
// once per call into a workspace as (7, S, Cout, 16) bf16, the layout the
// fragments read, through an index that ops/stem_conv.py stem_weight_index
// states (kept on the card per shape); the same C entry zeroes the counts
// and launches both, so the wrapper issues no tensor operation for them.
// - A persistent grid (about one block per SM) walks tiles of 8 x 16 output
//   pixels x up to 64 output channels. The tile's 35 x 68 uint8 halo is
//   copied with cp.async into one of two shared buffers while the previous
//   tile computes; coordinates are clamped at the image edge, which *is* the
//   replicate pad (TMA would fill zeros), so no padded copy is ever written.
// - A fragments come straight from the uint8 halo: 4 consecutive K bytes per
//   thread and row, widened to bf16 in registers (exact for 0..255). B
//   fragments come from the weights, resident in shared memory for the
//   block's life where they fit (gen4: 7 x 144 x 64 bf16 = 127 KB), else
//   streamed one kh slice at a time.
// - mma.sync.m16n8k16 bf16 with fp32 sums; 8 warps, each 32 pixels x up to
//   32 channels; rounded to bf16 at the store. Both operands use the same
//   permutation of k inside each block of 16 (common.cuh load_k4 does the
//   same), so every fragment load is one 4- or 8-byte load.
// - The tile's one or two 32 x 32 input cells feed density_tile from the
//   same shared halo; the counts stay integer atomics, which are exact.
//
// fp32 weights (the card-vs-CPU parity runs): stem_conv_kernel, the first
// version, on the fp32 CUDA cores (no TF32): one block per (image, 32 x 32
// input tile); for each kernel row the 8 input rows it needs are widened to
// fp32 into a staging buffer and the (7, C, Cout) weight slice of that row is
// copied to shared memory; each thread accumulates 16 output channels of one
// output pixel.
#include <cstdint>

#include "common.cuh"
#include "pyramid.cuh"

namespace {

using namespace sast;

constexpr int kTile = 32;  // input rows/cols per block (fp32 kernel)
constexpr int kOut = 8;    // output rows/cols per block (fp32 kernel)
constexpr int kK = 7;      // kernel edge
constexpr int kPad = 3;    // replicate pad
constexpr int kHalo = kTile + kK - 4;  // 35 input rows/cols per block
constexpr int kCoPerThread = 16;
constexpr long long kSmemLimit = 227 * 1024;

size_t smem_bytes(int C, int Cout, bool density) {
  return sizeof(float) * (kK * C * Cout + kOut * kHalo * (C + 1)) +
         kHalo * kHalo * C + (density ? 64 * C : 0);
}

// x: (B, H, W, C) uint8; w: (7, 7, C, Cout) fp32 (kh, kw, cin, cout);
// y: (B, H/4, W/4, Cout) fp32; counts: (B, 4, C) int32 or nullptr.
// Grid (W/32, H/32, B); block 64 * Cout/16 threads.
__global__ void __launch_bounds__(512) stem_conv_kernel(const uint8_t* __restrict__ x,
                                 const float* __restrict__ w,
                                 float* __restrict__ y, int* __restrict__ counts,
                                 int H, int W, int C, int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int CS = C + 1;
  float* wsm = reinterpret_cast<float*>(smem);   // [7][C][Cout]
  float* stage = wsm + kK * C * Cout;            // [8][35][C + 1]
  uint8_t* tile =
      reinterpret_cast<uint8_t*>(stage + kOut * kHalo * CS);  // [35][35][C]
  uint8_t* occ = tile + kHalo * kHalo * C;                    // [64][C]

  const int b = blockIdx.z;
  const int iy0 = blockIdx.y * kTile - kPad;
  const int ix0 = blockIdx.x * kTile - kPad;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // 1. The uint8 halo tile, 4 bytes per load (C % 4 == 0), edge-clamped.
  {
    const int cw = C / 4;
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
    uint32_t* tw = reinterpret_cast<uint32_t*>(tile);
    for (int i = tid; i < kHalo * kHalo * cw; i += nthreads) {
      const int word = i % cw;
      const int pix = i / cw;
      const int col = pix % kHalo;
      const int row = pix / kHalo;
      const int gy = min(max(iy0 + row, 0), H - 1);
      const int gx = min(max(ix0 + col, 0), W - 1);
      tw[i] = xw[((static_cast<size_t>(b) * H + gy) * W + gx) * cw + word];
    }
  }
  __syncthreads();

  if (counts != nullptr) {
    sast::density_tile(tile, kHalo, kPad, kPad, C, occ,
                 counts + static_cast<size_t>(b) * 4 * C);
  }

  const int p = tid & 63;  // output pixel of this thread within the block
  const int orow = p >> 3, ocol = p & 7;
  const int co0 = (tid >> 6) * kCoPerThread;
  float acc[kCoPerThread];
#pragma unroll
  for (int j = 0; j < kCoPerThread; ++j) acc[j] = 0.f;

  for (int ki = 0; ki < kK; ++ki) {
    __syncthreads();  // the previous row's readers are done
    // Output row r reads tile row 4 r + ki.
    for (int i = tid; i < kOut * kHalo * C; i += nthreads) {
      const int c = i % C;
      const int rc = i / C;
      const int col = rc % kHalo;
      const int r = rc / kHalo;
      stage[(r * kHalo + col) * CS + c] =
          static_cast<float>(tile[((4 * r + ki) * kHalo + col) * C + c]);
    }
    {
      const float4* src =
          reinterpret_cast<const float4*>(w + static_cast<size_t>(ki) * kK * C * Cout);
      float4* dst = reinterpret_cast<float4*>(wsm);
      for (int i = tid; i < kK * C * Cout / 4; i += nthreads) dst[i] = src[i];
    }
    __syncthreads();
    const float* srow = stage + (orow * kHalo + 4 * ocol) * CS;
    for (int kj = 0; kj < kK; ++kj) {
      const float* sx = srow + kj * CS;
      const float* wk = wsm + kj * C * Cout + co0;
      for (int c = 0; c < C; ++c) {
        const float xv = sx[c];
        const float4* wv = reinterpret_cast<const float4*>(wk + c * Cout);
#pragma unroll
        for (int q = 0; q < kCoPerThread / 4; ++q) {
          const float4 wq = wv[q];
          acc[4 * q + 0] += xv * wq.x;
          acc[4 * q + 1] += xv * wq.y;
          acc[4 * q + 2] += xv * wq.z;
          acc[4 * q + 3] += xv * wq.w;
        }
      }
    }
  }

  const int Ho = H / 4, Wo = W / 4;
  const int oy = blockIdx.y * kOut + orow;
  const int ox = blockIdx.x * kOut + ocol;
  float* out = y + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * Cout + co0;
#pragma unroll
  for (int j = 0; j < kCoPerThread; ++j) out[j] = acc[j];
}

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on the tensor cores.

constexpr int kTOH = 8, kTOW = 16;      // output pixels per tile
constexpr int kHR = 4 * kTOH + 3;       // 35 halo rows
constexpr int kHC = 4 * kTOW + 4;       // 68 halo columns: 67 + the K-pad overrun
constexpr int kMmaThreads = 256;        // 8 warps: 4 along M x 2 along N
constexpr int kMaxBlocksPerSm = 2;

inline int align128(int v) { return (v + 127) / 128 * 128; }

// Shared-memory layout of one block. Byte offsets; the weights come first.
struct MmaPlan {
  int S;          // k-steps of 16 per kernel row: ceil(7 C / 16)
  int nb;         // output channels per slice (a multiple of 16, <= 64)
  int nslices;    // slices of Cout
  int resident;   // all 7 kernel rows of a slice stay in shared memory
  int nbuf;       // halo buffers (2: the next tile's halo lands while this one computes)
  int tile0, tile1, occ, total;
};

bool mma_plan(int C, int Cout, bool density, MmaPlan* P) {
  P->S = (7 * C + 15) / 16;
  P->nslices = (Cout + 63) / 64;
  P->nb = ((Cout + P->nslices - 1) / P->nslices + 15) / 16 * 16;
  const int halo = align128(kHR * kHC * C);
  const int occ = density ? 64 * C : 0;
  const int w_all = align128(7 * P->S * P->nb * 32), w_row = align128(P->S * P->nb * 32);
  for (int resident = 1; resident >= 0; --resident) {
    for (int nbuf = 2; nbuf >= 1; --nbuf) {
      const int wb = resident ? w_all : w_row;
      const long long total = (long long)wb + (long long)nbuf * halo + occ;
      if (total <= kSmemLimit) {
        P->resident = resident;
        P->nbuf = nbuf;
        P->tile0 = wb;
        P->tile1 = wb + (nbuf - 1) * halo;
        P->occ = wb + nbuf * halo;
        P->total = (int)total;
        return true;
      }
    }
  }
  return false;
}

// The weight w, flat, as the kernel's B operand wt: wt[e] = w[idx[e]], or
// zero where idx[e] < 0. One thread per entry.
__global__ void arrange_kernel(const __nv_bfloat16* __restrict__ w, const int* __restrict__ idx,
                               __nv_bfloat16* __restrict__ wt, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) wt[e] = idx[e] >= 0 ? w[idx[e]] : __float2bfloat16_rn(0.f);
}

// Bytes `first` and `first + 1` of v as a packed bf16 pair (exact: 0..255).
// 0x4B0000bb is the float 2^23 + bb; bf16 keeps the top 16 bits of a float,
// which hold all of a value below 256.
__device__ __forceinline__ uint32_t u8_pair_bf16(uint32_t v, int first) {
  const float f0 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + first)) - 8388608.f;
  const float f1 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7541 + first)) - 8388608.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The uint8 halo of one tile into `buf` by cp.async: rows iy0 .. iy0 + 34,
// columns ix0 .. ix0 + 67, each clamped into the image.
__device__ void issue_halo(const uint8_t* x, uint8_t* buf, int b, int iy0, int ix0, int H,
                           int W, int C) {
  const int cw = C >> 2;  // 4-byte words per pixel
  const int wpr = kHC * cw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool inside = ix0 >= 0 && ix0 + kHC <= W;
  for (int r = warp; r < kHR; r += kMmaThreads / 32) {
    const int gy = min(max(iy0 + r, 0), H - 1);
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(x + ((size_t)b * H + gy) * W * C);
    uint32_t* dst = reinterpret_cast<uint32_t*>(buf) + r * wpr;
    if (inside) {
      const uint32_t* s = src + ix0 * cw;
      for (int j = lane; j < wpr; j += 32) cp_async4(dst + j, s + j);
    } else {
      for (int j = lane; j < wpr; j += 32) {
        const int col = j / cw;
        const int gx = min(max(ix0 + col, 0), W - 1);
        cp_async4(dst + j, src + gx * cw + (j - col * cw));
      }
    }
  }
}

// Kernel rows [kh0, kh0 + nrows) of slice columns [n0, n0 + nb) of the
// (7, S, Cout, 16) weight tiles into wsm as (nrows, S, nb, 16).
__device__ void copy_weights(const __nv_bfloat16* wt, __nv_bfloat16* wsm, int kh0, int nrows,
                             int S, int Cout, int n0, int nb) {
  const uint4* src = reinterpret_cast<const uint4*>(wt);
  uint4* dst = reinterpret_cast<uint4*>(wsm);
  const int row = nb * 2;  // uint4 per (kh, s): nb rows of 32 bytes
  for (int i = threadIdx.x; i < nrows * S * row; i += kMmaThreads) {
    const int ks = i / row, q = i - ks * row;
    dst[i] = src[((size_t)(kh0 * S + ks) * Cout + n0) * 2 + q];
  }
}

// x: (B, H, W, C) uint8; wt: (7, S, Cout, 16) bf16 from arrange_kernel; y: (B, H/4, W/4, Cout)
// bf16; counts: (B, 4, C) int32 or nullptr. Persistent grid over
// nslices x B x H/32 x ceil(W/64) tiles, slice-major.
__global__ void __launch_bounds__(kMmaThreads) stem_mma_kernel(
    const uint8_t* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    __nv_bfloat16* __restrict__ y, int* __restrict__ counts, int B, int H, int W, int C,
    int Cout, MmaPlan P) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* occ = smem + P.occ;
  const int S = P.S;
  const int Ho = H / 4, Wo = W / 4;
  const int tiles_x = (Wo + kTOW - 1) / kTOW, tiles_y = Ho / kTOH;
  const int spatial = B * tiles_y * tiles_x;
  const int ntiles = spatial * P.nslices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  auto where = [&](int tile, int& sl, int& b, int& ty, int& tx) {
    sl = tile / spatial;
    int r = tile - sl * spatial;
    tx = r % tiles_x;
    r /= tiles_x;
    ty = r % tiles_y;
    b = r / tiles_y;
  };
  auto issue = [&](int tile, uint8_t* buf) {
    int sl, b, ty, tx;
    where(tile, sl, b, ty, tx);
    issue_halo(x, buf, b, ty * 4 * kTOH - kPad, tx * 4 * kTOW - kPad, H, W, C);
    cp_async_commit();
  };

  int loaded = -1;  // the slice whose weights are resident
  int tile = blockIdx.x;
  if (P.nbuf == 2 && tile < ntiles) issue(tile, smem + P.tile0);
  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    int sl, b, ty, tx;
    where(tile, sl, b, ty, tx);
    uint8_t* halo = smem + ((it & 1) ? P.tile1 : P.tile0);
    if (P.nbuf == 2) {
      const int next = tile + gridDim.x;
      if (next < ntiles) {
        issue(next, smem + ((it & 1) ? P.tile0 : P.tile1));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      issue(tile, halo);
      cp_async_wait<0>();
    }
    const int n0 = sl * P.nb;
    const int nb = min(P.nb, Cout - n0);  // columns of this slice
    if (P.resident && sl != loaded) {
      copy_weights(wt, wsm, 0, kK, S, Cout, n0, nb);
      loaded = sl;
    }
    __syncthreads();
    if (counts != nullptr && sl == 0) {
      int* cb = counts + (size_t)b * 4 * C;
      sast::density_tile(halo, kHC, kPad, kPad, C, occ, cb);
      if (tx * 4 * kTOW + kTile < W) {
        __syncthreads();  // occ is reused
        sast::density_tile(halo, kHC, kPad, kPad + kTile, C, occ, cb);
      }
    }

    const int ncw = nb / 2;  // columns of each warp: 8 .. 32
    const int nt = ncw / 8;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    // Row mt * 16 + g (+ 8) of the warp's 32 pixels is output pixel
    // (2 wm + mt, g (+ 8)) of the tile; its kh = 0 bytes start at halo row
    // 4 (2 wm + mt), column 4 (g (+ 8)).
    const uint8_t* ap[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ap[mt][h] = halo + ((4 * (2 * wm + mt)) * kHC + 4 * (g + 8 * h)) * C + 4 * t;
    for (int kh = 0; kh < kK; ++kh) {
      if (!P.resident) {
        __syncthreads();  // the previous kernel row's readers are done
        copy_weights(wt, wsm, kh, 1, S, Cout, n0, nb);
        __syncthreads();
      }
      const __nv_bfloat16* bp =
          wsm + (size_t)(P.resident ? kh * S * nb : 0) * 16 + (wn * ncw + g) * 16 + 4 * t;
      const int roff = kh * kHC * C;
      for (int s = 0; s < S; ++s) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(ap[mt][h] + roff + s * 16);
            a[mt][h] = u8_pair_bf16(v, 0);
            a[mt][h + 2] = u8_pair_bf16(v, 2);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nt) {
            const uint2 bv = *reinterpret_cast<const uint2*>(bp + (size_t)(s * nb + j * 8) * 16);
            mma_bf16(acc[0][j], a[0], bv.x, bv.y);
            mma_bf16(acc[1][j], a[1], bv.x, bv.y);
          }
        }
      }
    }

    // Stores: element e of acc[mt][j] is pixel row mt * 16 + g + 8 (e >> 1),
    // column j * 8 + 2 t + (e & 1) of the warp's block.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int oy = ty * kTOH + 2 * wm + mt;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = tx * kTOW + g + 8 * h;
        if (ox >= Wo) continue;
        __nv_bfloat16* out =
            y + (((size_t)b * Ho + oy) * Wo + ox) * Cout + n0 + wn * ncw + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nt)
            *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
                __floats2bfloat162_rn(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
    }
    __syncthreads();  // the halo buffer and the weights are free again
  }
}

// Blocks of the persistent grid for one shared-memory size: the SMs times
// the blocks that fit on one, asked of the runtime once per size.
int mma_grid(int smem, int ntiles, int* grid) {
  constexpr int SLOTS = 8;
  static int known_smem[SLOTS], known_blocks[SLOTS];
  static int n_known = 0;
  int blocks = 0;
  for (int i = 0; i < n_known; ++i)
    if (known_smem[i] == smem) blocks = known_blocks[i];
  if (blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        stem_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_mma_kernel, kMmaThreads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    per_sm = per_sm < 1 ? 1 : (per_sm > kMaxBlocksPerSm ? kMaxBlocksPerSm : per_sm);
    blocks = sms * per_sm;
    known_smem[n_known % SLOTS] = smem;
    known_blocks[n_known % SLOTS] = blocks;
    if (n_known < SLOTS) ++n_known;
  }
  *grid = ntiles < blocks ? ntiles : blocks;
  return 0;
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/stem_conv.py): H, W % 32 == 0,
// C % 4 == 0 and C <= 32, Cout % 16 == 0 and Cout <= 128, pointers aligned.

// Both entries zero `counts` (B, 4, C) int32 first, on the same stream.

// fp32 weights (7, 7, C, Cout), fp32 output.
extern "C" int sast_stem_conv7x4(const void* x, const void* w, void* y, void* counts, int B,
                                 int H, int W, int C, int Cout, void* stream) {
  const size_t smem = smem_bytes(C, Cout, counts != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(W / kTile, H / kTile, B);
  const dim3 block(64 * (Cout / kCoPerThread));
  const auto s = static_cast<cudaStream_t>(stream);
  if (counts != nullptr &&
      (err = cudaMemsetAsync(counts, 0, sizeof(int) * 4 * B * C, s)) != cudaSuccess)
    return static_cast<int>(err);
  stem_conv_kernel<<<grid, block, smem, s>>>(static_cast<const uint8_t*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(y),
                                               static_cast<int*>(counts), H, W, C, Cout);
  return static_cast<int>(cudaGetLastError());
}

// Workspace elements (bf16) of the bf16 entry: the arranged weight.
extern "C" long long sast_stem_conv7x4_mma_workspace(int C, int Cout) {
  return (long long)kK * ((kK * C + 15) / 16) * Cout * 16;
}

// bf16 weights (Cout, C, 7, 7), bf16 output; `idx` (int32) and `wt` hold
// sast_stem_conv7x4_mma_workspace(C, Cout) elements.
extern "C" int sast_stem_conv7x4_mma(const void* x, const void* w, const void* idx, void* wt,
                                     void* y, void* counts, int B, int H, int W, int C, int Cout,
                                     void* stream) {
  MmaPlan P;
  if (!mma_plan(C, Cout, counts != nullptr, &P)) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = P.nslices * B * (H / (4 * kTOH)) * ((W / 4 + kTOW - 1) / kTOW);
  int grid = 0;
  const int rc = mma_grid(P.total, ntiles, &grid);
  if (rc != 0) return rc;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (counts != nullptr &&
      (err = cudaMemsetAsync(counts, 0, sizeof(int) * 4 * B * C, s)) != cudaSuccess)
    return static_cast<int>(err);
  const int nw = static_cast<int>(sast_stem_conv7x4_mma_workspace(C, Cout));
  arrange_kernel<<<(nw + 255) / 256, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(w),
                                                   static_cast<const int*>(idx),
                                                   static_cast<__nv_bfloat16*>(wt), nw);
  stem_mma_kernel<<<grid, kMmaThreads, P.total, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<__nv_bfloat16*>(y), static_cast<int*>(counts), B, H, W, C, Cout, P);
  return static_cast<int>(cudaGetLastError());
}
