// Device helpers shared by the port's CUDA sources (stem_conv.cu,
// rows_gemm.cuh and the block kernels built on it): number conversions, bf16 packing, the tensor-core
// product, warp reductions, cp.async, and the row routines of the attention
// block whose rounding the forward and the backward's recomputation must
// share (the LayerNorm statistics, the softmax, GELU).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Device code only, so nothing here is shared between the libraries built
// from it (rows_gemm.cuh, which keeps host-side state, is included inside
// each source's own anonymous namespace). No anonymous namespace inside: nvcc's generated launch stubs name a
// source's own one, and a second, brought in by `using namespace sast`,
// makes that name ambiguous.
namespace sast {

constexpr float MASK_VALUE = -1e4f;  // logit of a masked key

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four consecutive k of one operand row as two packed bf16 pairs (fp32 rows
// are rounded). A thread takes k 4t .. 4t + 3 of each 16 for both halves of
// its fragment, on both operands: one permutation of k inside each block of
// 16, which a dot product does not see, and one 8- or 16-byte load.
__device__ __forceinline__ void load_k4(const __nv_bfloat16* p, uint32_t& lo, uint32_t& hi) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  lo = v.x; hi = v.y;
}
__device__ __forceinline__ void load_k4(const float* p, uint32_t& lo, uint32_t& hi) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  lo = pack_bf16(v.x, v.y); hi = pack_bf16(v.z, v.w);
}

// c += a b on the tensor cores, bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Global to shared memory without the registers: 4 bytes through L1, 16
// bytes past it, or 16 zero bytes where `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Mean and reciprocal standard deviation of one row of C values, a warp per
// row: lane l sums columns l, l + 32, ... in that order (x(c) reads column
// c), two-pass variance. The forward's LN2 and the backward's recomputation
// both call this, so they round alike.
template <typename X>
__device__ __forceinline__ void row_stats(X x, int C, float eps, float& mu, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += x(c);
  mu = warp_sum(s) / (float)C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) { const float d = x(c) - mu; v += d * d; }
  rstd = rsqrtf(warp_sum(v) / (float)C + eps);
}
__device__ __forceinline__ float layer_norm(float x, float mu, float rstd, float scale,
                                            float bias) {
  return (x - mu) * rstd * scale + bias;
}

// Logit of one query-key pair: the scaled product, or exactly MASK_VALUE
// for a masked key.
__device__ __forceinline__ float masked_logit(bool keep, float s, float scale) {
  return keep ? s * scale : MASK_VALUE;
}

// The tanh form of GELU, as the forward's MLP and the backward's
// recomputation take it, and its derivative.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (x + 0.044715f * x * x * x));
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * x * x);
}

// Softmax in place over the hw real keys of one row of logits, a warp per
// row; entries hw .. R (the pad keys) become 0.
__device__ __forceinline__ void softmax_row(float* p, int hw, int R) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int n = lane; n < hw; n += 32) mx = fmaxf(mx, p[n]);
  mx = warp_max(mx);
  float s = 0.f;
  for (int n = lane; n < hw; n += 32) { const float e = expf(p[n] - mx); p[n] = e; s += e; }
  s = warp_sum(s);
  for (int n = lane; n < R; n += 32) p[n] = n < hw ? p[n] / s : 0.f;
}

}  // namespace sast
