// Stem convolution of the SAST backbone, optionally fused with the
// event-density pyramid.
//
// Replaces the TPU kernel _stem_fwd_raw (sast_tpu/ops/pallas/stem_conv.py,
// public stem_conv_density_raw_7x4 and stem_conv_raw_7x4) and, as the same
// function, _stem_fwd_pallas (stem_conv_density_7x4 / stem_conv_7x4).
//
// y = conv(replicate_pad(x, 3), w, stride 4), no bias: a 7x7/stride-4
// convolution of the native uint8 NHWC event histogram (B, H, W, C) into
// (B, H/4, W/4, Cout) in fp32 or bf16, accumulated in fp32. With `counts`,
// the same input read also yields the (B, 4, C) non-zero cell counts of the
// density pyramid (pyramid.cuh).
//
// Bound on the H100 at gen4-base b4 (4, 384, 640, 20) -> (4, 96, 160, 64):
// 19.7 MB of uint8 in and 7.9 MB of bf16 out take about 8 us at 3.35 TB/s;
// the 7.7 GFLOP take about 8 us on the bf16 tensor cores. This first
// version runs on the fp32 CUDA cores instead (about 115 us at 67 TFLOP/s),
// so it is bound by operations. What the design does about the bytes:
//
// - One block per (image, 32x32 input tile), which is 8x8 output pixels x
//   Cout channels and exactly one pool-32 density cell.
// - The tile's 35x35 halo (input rows/cols -3..31) is read once into shared
//   memory as uint8. Coordinates are clamped at the image edge, which *is*
//   the replicate pad: no padded copy is ever written to device memory.
// - For each kernel row ki, the 8 input rows it needs are widened once to
//   fp32 into a staging buffer (channel stride C + 1, so a warp's 32 pixels
//   hit 32 different banks), and the (7, C, Cout) weight slice of that row
//   is copied to shared memory; each thread then accumulates 16 output
//   channels of one output pixel in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pyramid.cuh"

namespace {

constexpr int kTile = 32;  // input rows/cols per block
constexpr int kOut = 8;    // output rows/cols per block
constexpr int kK = 7;      // kernel edge
constexpr int kPad = 3;    // replicate pad
constexpr int kHalo = kTile + kK - 4;  // 35 input rows/cols per block
constexpr int kCoPerThread = 16;

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

size_t smem_bytes(int C, int Cout, bool density) {
  return sizeof(float) * (kK * C * Cout + kOut * kHalo * (C + 1)) +
         kHalo * kHalo * C + (density ? 64 * C : 0);
}

// x: (B, H, W, C) uint8; w: (7, 7, C, Cout) fp32 (kh, kw, cin, cout);
// y: (B, H/4, W/4, Cout); counts: (B, 4, C) int32 or nullptr.
// Grid (W/32, H/32, B); block 64 * Cout/16 threads.
template <typename OutT>
__global__ void __launch_bounds__(512) stem_conv_kernel(const uint8_t* __restrict__ x,
                                 const float* __restrict__ w,
                                 OutT* __restrict__ y, int* __restrict__ counts,
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
  OutT* out = y + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * Cout + co0;
#pragma unroll
  for (int j = 0; j < kCoPerThread; ++j) store(out + j, acc[j]);
}

template <typename OutT>
cudaError_t launch(const uint8_t* x, const float* w, void* y, int* counts,
                   int B, int H, int W, int C, int Cout, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, Cout, counts != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(W / kTile, H / kTile, B);
  const dim3 block(64 * (Cout / kCoPerThread));
  stem_conv_kernel<OutT><<<grid, block, smem, stream>>>(
      x, w, static_cast<OutT*>(y), counts, H, W, C, Cout);
  return cudaGetLastError();
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/stem_conv.py): H, W % 32 == 0,
// C % 4 == 0 and C <= 32, Cout % 16 == 0 and Cout <= 128, pointers aligned.
extern "C" int sast_stem_conv7x4(const void* x, const void* w, void* y,
                                 void* counts, int B, int H, int W, int C,
                                 int Cout, int out_bf16, void* stream) {
  const auto* xu = static_cast<const uint8_t*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* cnt = static_cast<int*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(xu, wf, y, cnt, B, H, W, C, Cout, s)
               : launch<float>(xu, wf, y, cnt, B, H, W, C, Cout, s);
  return static_cast<int>(err);
}
