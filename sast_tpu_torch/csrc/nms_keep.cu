// Greedy NMS keep mask, for sm_90a.
//
// Replaces the TPU kernel greedy_keep (sast_tpu/ops/pallas/nms_keep.py,
// kernel _keep_kernel), itself the in-VMEM form of _greedy_keep_scan
// (sast_tpu/ops/nms.py): over score-sorted candidates, box i is kept iff its
// score is > 0 and no kept box j < i overlaps it with
// inter / (area_j + area_i - inter + 1e-12) > thr.
//
// Bound on the H100: latency. The decisions depend on each other, so the
// time is the number of dependent steps times the latency of one, not bytes
// (16 K per image) or operations (about 20 K^2 / 2 per image). The design
// splits the work in two launches so that only a short chain is serial:
//
// 1. mask_kernel, over the whole card: a grid of (upper-triangle pair of
//    64-candidate tiles, image), four threads per row j of its row tile,
//    16 columns each. It computes the 64-bit word mask[n, j, w]: bit b is
//    set iff candidates j and i = 64 w + b are both valid, i is later
//    (i > j, i < K) and IoU(j, i) > thr. Pairs with an invalid candidate
//    are not tested: an invalid row is never read and an invalid column
//    is never kept either way. The column tile's boxes, areas and validity
//    are staged in shared memory. Words of a row below its own tile
//    (w < j / 64) are never written nor read. The (N, K, W) words,
//    W = ceil(K / 64), are 0.5 MB at (4, 1000) and stay in L2 for the
//    second launch.
// 2. scan_kernel, one warp per image. The K bits of `removed` live in the
//    lanes' registers, lane l holding words l and l + 32. The rows come in
//    chunks of 64 (one row tile, 512 W contiguous bytes, copied whole in
//    16-byte pieces) through a ring of NST chunks in shared memory, filled
//    by cp.async ahead of the scan (at K <= 1024 the ring holds the whole
//    image). For chunk c the owner of word c broadcasts it (__shfl_sync);
//    the warp then walks, in order, the chunk's candidates that are valid
//    and not yet removed: the lowest such one is kept, its row's word c
//    clears the candidates it suppresses, and each lane ORs the row's later
//    words into its own (loads beside the chain's own, so they add no
//    latency). Suppressed and invalid candidates cost nothing, so the
//    dependent chain is one step per kept candidate (find the lowest bit,
//    one shared-memory load, two logic operations), with no barrier of more
//    than one warp.
//
// The mask must equal the plain version (ops/nms_keep.py) and the JAX scan
// bit for bit. A contracted multiply-add in area or inter would round once
// where they round twice and flip borderline IoUs, so every operation is an
// explicitly rounded intrinsic and this source is built with -fmad=false.
// area_j + area_i is commutative in IEEE arithmetic, so the bit equals the
// test of the sequential scan whichever of the two boxes comes first.
#include "common.cuh"

namespace nk {
namespace {

using namespace sast;

constexpr int TILE = 64;       // candidates per mask word and per scan chunk
constexpr int MAX_K = 4096;    // W <= 64 words: two per lane
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 227 * 1024;
typedef unsigned long long u64;

// Words of one image's mask, rounded up to an even count so that every
// image, and so every chunk of 64 rows, starts 16-byte aligned.
__host__ __device__ __forceinline__ long long image_words(int K, int W) {
  return ((long long)K * W + 1) / 2 * 2;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU(a, b) > thr, every operation rounded on its own.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  return __fdiv_rn(inter, uni) > thr;
}

// Lowest set bit of a nonzero word.
__device__ __forceinline__ int lowest(u64 x) {
  const unsigned lo = (unsigned)x;
  return lo ? __ffs(lo) - 1 : 31 + __ffs((unsigned)(x >> 32));
}

constexpr int PARTS = 4;              // threads per row of the mask launch
constexpr int SEG = TILE / PARTS;     // columns per thread

// boxes (N, K) float4 xyxy, scores (N, K); mask (N, K, W) words, images
// image_words(K, W) apart. Grid (W (W + 1) / 2, N), block TILE x PARTS:
// block x is the pair (row tile rb, column tile cb >= rb); thread t takes
// row t / 4, columns 16 (t % 4) on.
__global__ void __launch_bounds__(TILE * PARTS) mask_kernel(const float4* __restrict__ boxes,
                                                            const float* __restrict__ scores,
                                                            int K, int W, float thr,
                                                            u64* __restrict__ mask) {
  __shared__ float4 cbox[TILE];
  __shared__ float carea[TILE];
  __shared__ bool cvalid[TILE];
  const int n = blockIdx.y;
  int t = blockIdx.x, rb = 0;
  for (; t >= W - rb; ++rb) t -= W - rb;  // row tile rb has W - rb column tiles
  const int cb = rb + t;
  const float4* bx = boxes + (size_t)n * K;
  const float* sc = scores + (size_t)n * K;
  const int ncol = min(TILE, K - cb * TILE);
  if ((int)threadIdx.x < ncol) {
    const float4 b = bx[cb * TILE + threadIdx.x];
    cbox[threadIdx.x] = b;
    carea[threadIdx.x] = area_of(b);
    cvalid[threadIdx.x] = sc[cb * TILE + threadIdx.x] > 0.f;
  }
  __syncthreads();
  const int j = rb * TILE + threadIdx.x / PARTS, part = threadIdx.x % PARTS;
  u64 word = 0;
  if (j < K && sc[j] > 0.f) {
    const float4 bj = bx[j];
    const float aj = area_of(bj);
    // Bits of candidates i > j only.
    const int lo = max(part * SEG, j + 1 - cb * TILE), hi = min(part * SEG + SEG, ncol);
#pragma unroll 4
    for (int b = lo; b < hi; ++b)
      if (cvalid[b] && overlaps(bj, aj, cbox[b], carea[b], thr)) word |= 1ull << b;
  }
  word |= __shfl_xor_sync(FULL, word, 1);  // the row's four threads are lanes 4q .. 4q + 3
  word |= __shfl_xor_sync(FULL, word, 2);
  if (part == 0 && j < K) mask[n * image_words(K, W) + (size_t)j * W + cb] = word;
}

// scores (N, K); mask as above; keep (N, K) bytes 0/1. Grid N, one warp.
// Shared memory: the ring of NST chunks [NST][TILE][W] words, then the
// image's K scores.
template <int NST>
__global__ void __launch_bounds__(32) scan_kernel(const float* __restrict__ scores,
                                                  const u64* __restrict__ mask, int K, int W,
                                                  uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* ring = reinterpret_cast<u64*>(smem);
  float* sc = reinterpret_cast<float*>(smem + (size_t)NST * TILE * W * sizeof(u64));
  const int n = blockIdx.x, lane = threadIdx.x;
  const int chunks = (K + TILE - 1) / TILE;
  const u64* rows = mask + n * image_words(K, W);
  uint8_t* out = keep + (size_t)n * K;

  for (int i = lane; i < K; i += 32) cp_async4(sc + i, scores + (size_t)n * K + i);
  // Chunk c: rows 64 c .. 64 c + 63, contiguous in the mask, into ring slot
  // c % NST in 16-byte pieces (the words below c come along unread). One
  // commit group per chunk, also when there is none, so that group g is
  // chunk g (the scores ride with 0).
  auto fetch = [&](int c) {
    if (c < chunks) {
      char* dst = reinterpret_cast<char*>(ring + (size_t)(c % NST) * TILE * W);
      const char* src = reinterpret_cast<const char*>(rows + (size_t)c * TILE * W);
      const int bytes = min(TILE, K - c * TILE) * W * (int)sizeof(u64);  // a multiple of 8
      for (int off = lane * 16; off < bytes; off += 32 * 16) {
        if (off + 16 <= bytes) cp_async16(dst + off, src + off);
        else cp_async8(dst + off, src + off);
      }
    }
    cp_async_commit();
  };
  for (int c = 0; c < NST - 1; ++c) fetch(c);

  u64 own0 = 0, own1 = 0;  // removed: words lane and lane + 32
  for (int c = 0; c < chunks; ++c) {
    __syncwarp();          // every lane is done with chunk c - 1's slot
    fetch(c + NST - 1);    // into that slot
    cp_async_wait<NST - 1>();
    __syncwarp();          // chunk c (and the scores) visible to every lane
    const u64* chunk = ring + (size_t)(c % NST) * TILE * W;
    const int i0 = c * TILE, nr = min(TILE, K - i0);
    const bool v0 = lane < nr && sc[i0 + lane] > 0.f;
    const bool v1 = lane + 32 < nr && sc[i0 + lane + 32] > 0.f;
    const u64 valid = (u64)__ballot_sync(FULL, v0) | ((u64)__ballot_sync(FULL, v1) << 32);
    const u64 removed = __shfl_sync(FULL, c < 32 ? own0 : own1, c & 31);
    const bool mine0 = lane > c && lane < W, mine1 = lane + 32 > c && lane + 32 < W;
    u64 todo = valid & ~removed, kept = 0;
    while (todo) {
      const int r = lowest(todo);  // the lowest candidate still open is kept
      const u64* row = chunk + r * W;
      kept |= 1ull << r;
      todo &= (todo - 1) & ~row[c];
      if (mine0) own0 |= row[lane];
      if (mine1) own1 |= row[lane + 32];
    }
    if (lane < nr) out[i0 + lane] = (kept >> lane) & 1;
    if (lane + 32 < nr) out[i0 + lane + 32] = (kept >> (lane + 32)) & 1;
  }
}

template <int NST>
int launch_scan(const float* scores, const u64* mask, int N, int K, int W, uint8_t* keep,
                cudaStream_t s) {
  const int bytes = NST * TILE * W * (int)sizeof(u64) + K * (int)sizeof(float);
  static bool ready = false;  // the attribute is asked once per instantiation
  if (!ready && bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<NST>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  scan_kernel<NST><<<N, 32, bytes, s>>>(scores, mask, K, W, keep);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace nk

// Bytes of the mask workspace of one call.
extern "C" long long sast_greedy_keep_workspace(int N, int K) {
  const int W = (K + nk::TILE - 1) / nk::TILE;
  return N * nk::image_words(K, W) * (long long)sizeof(nk::u64);
}

// Shapes are checked by the Python wrapper (ops/nms_keep.py): 0 < K <= 4096,
// N > 0, contiguous fp32 inputs with 16-byte aligned boxes, a workspace of
// sast_greedy_keep_workspace(N, K) bytes. Two launches on `stream`.
extern "C" int sast_greedy_keep(const void* boxes, const void* scores, void* keep, void* work,
                                long long nwork, int N, int K, float thr, void* stream) {
  using namespace nk;
  if (N <= 0 || K <= 0 || K > MAX_K || N > 65535 || nwork < sast_greedy_keep_workspace(N, K))
    return (int)cudaErrorInvalidValue;
  const int W = (K + TILE - 1) / TILE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* mask = static_cast<u64*>(work);
  const float* sc = static_cast<const float*>(scores);
  mask_kernel<<<dim3(W * (W + 1) / 2, N), TILE * PARTS, 0, s>>>(
      static_cast<const float4*>(boxes), sc, K, W, thr, mask);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // The ring: the whole image up to W = 16 (K <= 1024), else 128 KB of it.
  uint8_t* kp = static_cast<uint8_t*>(keep);
  if (W <= 16) return launch_scan<16>(sc, mask, N, K, W, kp, s);
  if (W <= 32) return launch_scan<8>(sc, mask, N, K, W, kp, s);
  return launch_scan<4>(sc, mask, N, K, W, kp, s);
}
