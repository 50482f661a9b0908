// Greedy NMS keep mask.
//
// Replaces the TPU kernel greedy_keep (sast_tpu/ops/pallas/nms_keep.py,
// kernel _keep_kernel), itself the in-VMEM form of _greedy_keep_scan
// (sast_tpu/ops/nms.py): over score-sorted candidates, box i is kept iff its
// score is > 0 and no kept box j < i overlaps it with
// inter / (area_j + area_i - inter + 1e-12) > thr.
//
// Bound on the H100: latency. The K steps depend on each other, so the time
// is K times the latency of one step, not bytes (16 K per image) or
// operations (about 20 K^2 / 2 per image). What the design does about it:
//
// - One block per image, 1024 threads; thread t owns candidates
//   t, t + 1024, ... and keeps their boxes, areas and kept flags in
//   registers. Only the boxes, areas and scores that every thread reads at
//   step i live in shared memory (a broadcast read).
// - A step is one IoU test per owned earlier kept box and one
//   __syncthreads_or; the owner of box i then sets its flag in a register,
//   so no second barrier is needed.
// - A candidate whose score is <= 0 cannot be kept: its step skips the IoU
//   tests and the barrier (the branch is uniform across the block). After
//   the confidence threshold most of the K = 1000 slots are such padding.
//
// The mask must equal the plain version (ops/nms_keep.py) and the JAX scan
// bit for bit. A contracted multiply-add in area or inter would round once
// where they round twice and flip borderline IoUs, so every operation is an
// explicitly rounded intrinsic and this source is built with -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;  // candidates per thread: K <= 4096

__device__ inline float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
}

// boxes: (N, K, 4) fp32 xyxy, scores: (N, K) fp32, both sorted by
// descending score per image; keep: (N, K) bytes 0/1. Grid N, block 1024.
__global__ void __launch_bounds__(kThreads) greedy_keep_kernel(const float* __restrict__ boxes,
                                   const float* __restrict__ scores,
                                   uint8_t* __restrict__ keep, int K,
                                   float thr) {
  extern __shared__ float sm[];
  float* sx1 = sm;
  float* sy1 = sm + K;
  float* sx2 = sm + 2 * K;
  float* sy2 = sm + 3 * K;
  float* sar = sm + 4 * K;
  float* ssc = sm + 5 * K;
  const size_t n = blockIdx.x;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + n * K;
  const float* sc = scores + n * K;
  const int tid = threadIdx.x;

  float x1[kItems], y1[kItems], x2[kItems], y2[kItems], ar[kItems];
  bool kept[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int j = tid + t * kThreads;
    kept[t] = false;
    if (j < K) {
      const float4 b = bx[j];
      x1[t] = b.x, y1[t] = b.y, x2[t] = b.z, y2[t] = b.w;
      ar[t] = area_of(b.x, b.y, b.z, b.w);
      sx1[j] = b.x, sy1[j] = b.y, sx2[j] = b.z, sy2[j] = b.w;
      sar[j] = ar[t];
      ssc[j] = sc[j];
    }
  }
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    // A candidate with score <= 0 is never kept; the branch is uniform
    // across the block, so no barrier is skipped by only some threads.
    if (!(ssc[i] > 0.f)) continue;
    const float xi1 = sx1[i], yi1 = sy1[i], xi2 = sx2[i], yi2 = sy2[i];
    const float ari = sar[i];
    int hit = 0;
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int j = tid + t * kThreads;
      if (j < i && kept[t]) {
        const float iw =
            fmaxf(__fsub_rn(fminf(x2[t], xi2), fmaxf(x1[t], xi1)), 0.f);
        const float ih =
            fmaxf(__fsub_rn(fminf(y2[t], yi2), fmaxf(y1[t], yi1)), 0.f);
        const float inter = __fmul_rn(iw, ih);
        const float uni =
            __fadd_rn(__fsub_rn(__fadd_rn(ar[t], ari), inter), 1e-12f);
        hit |= __fdiv_rn(inter, uni) > thr;
      }
    }
    const int suppressed = __syncthreads_or(hit);
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      if (tid + t * kThreads == i) kept[t] = !suppressed;
    }
  }

#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int j = tid + t * kThreads;
    if (j < K) keep[n * K + j] = kept[t] ? 1 : 0;
  }
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/nms_keep.py): K <= 4096,
// contiguous fp32 inputs with 16-byte aligned boxes.
extern "C" int sast_greedy_keep(const void* boxes, const void* scores,
                                void* keep, int N, int K, float thr,
                                void* stream) {
  const size_t smem = sizeof(float) * 6 * K;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_keep_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), K, thr);
  return static_cast<int>(cudaGetLastError());
}
