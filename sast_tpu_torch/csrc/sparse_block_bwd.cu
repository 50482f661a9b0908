// Backward of the sparse window block's MLP branch over the kept-first work
// list, for sm_90a.
//
// Replaces the TPU kernel _mlp_bwd_kernel behind _sparse_block_bwd_impl
// (sast_tpu/ops/pallas/sparse_block.py). The block splits at
// h1 = z + ls1 * proj:
//   MLP kernel (needs h1, g): recompute u = h1 Wglu + b, m = val * gelu(gate),
//     mlp = m Wout + b; dls2, dWout, dbout, dWglu, dbglu; writes
//     gh1 + (1 - keep) * g, the cotangent the attention branch goes on from.
// The attention branch is attn_bwd.cu. Slots at or beyond n_win pass the
// cotangent through (g -> gh1). ops/sparse_block.py states the arithmetic
// (what is rounded where); sparse_block_mlp_bwd_plain there is the plain
// version.
//
// What differs from the TPU kernel. There the grid is sequential and the
// weight gradients accumulate in constant-index fp32 VMEM blocks. Here blocks
// run in no order, so every window's contribution X^T G is added to fp32
// accumulators in device memory with atomicAdd (red.global.add.f32); the
// wrapper zeroes them. The sum's order, and so the last bits of a parameter
// gradient, vary from run to run; with no kept window nothing is added and
// every parameter gradient is exactly zero. Column sums (biases, LayerScale)
// are reduced in shared memory first, one atomic per column and window.
//
// What bounds it on an H100: operations, like the forward (the backward is
// the forward's recomputation plus about twice its products, on the same
// hw x C tokens). The design is the forward's: one thread block of 8 warps
// owns one window; a persistent grid of at most 4 blocks per SM walks the
// slots, which bounds the scratch. The products g W^T run through block_gemm
// of window_block.cuh against an (in, out)-contiguous copy of each matrix;
// the products that contract over the window's rows (X^T G) run through
// tn_product in fp32 FMA, a 4 x 4 register tile per thread. Buffers are
// placed by plan_bwd(): in shared memory in a fixed order while they fit,
// else in a per-block scratch in device memory (L2) that the wrapper
// allocates; at C = 512 [val|gate] (60 x 2688 fp32) lives there.

#include "window_block.cuh"

namespace wb {
namespace {

constexpr int NBUF = 16;
constexpr int GRID_BLOCKS_PER_SM = 4;

// Buffers of the MLP kernel, in placement order.
enum { G_KEEP = 0, G_COL, G_H1, G_GM, G_M, G_U, G_COUNT };
constexpr int G_MANDATORY = 2;

// smem[i] is the byte offset of buffer i in dynamic shared memory, or -1 when
// it lives at scr[i] in the block's scratch.
struct BwdPlan {
  int smem[NBUF];
  long long scr[NBUF];
  int total;
  long long scratch_per_block;
};

struct BwdArgs {
  Args f;            // window geometry, work list, weights as (out, in) rows
  const void* g;     // cotangent of the block's output, in y's type
  const float* h1;   // the forward's saved residual
  float* gh1;        // gh1 + (1 - keep) * g
  const void *wglu_io, *wout_io;  // (in, out) rows
  // fp32 accumulators, matrices as (in, out): dwglu, dbglu, dwout, dbout, dls2.
  float* acc[5];
  BwdPlan P;
};

inline bool plan_bwd(int hw, int C, int I, int wbytes, BwdPlan* P) {
  const long long R = hw <= 64 ? 64 : 80;
  long long sizes[NBUF] = {0};
  const long long rc32 = R * (C + PAD) * 4;
  sizes[G_KEEP] = R;
  sizes[G_COL] = C * 4;
  sizes[G_H1] = rc32;
  sizes[G_GM] = rc32;
  sizes[G_M] = R * (I + PAD) * wbytes;
  sizes[G_U] = R * (2 * I + PAD) * 4;
  long long off = 0, s = 0;
  for (int i = 0; i < NBUF; ++i) { P->smem[i] = -1; P->scr[i] = 0; }
  for (int i = 0; i < G_COUNT; ++i) {
    const long long b = align128(sizes[i]);
    if (off + b <= SMEM_LIMIT) {
      P->smem[i] = (int)off; off += b;
    } else if (i < G_MANDATORY) {
      return false;
    } else {
      P->scr[i] = s; s += b;
    }
  }
  P->total = (int)off;
  P->scratch_per_block = s;
  return true;
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (x + 0.044715f * x * x * x));
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * x * x);
}

template <typename WT>
__device__ __forceinline__ float round_to(float v) { return to_f<WT>(from_f<WT>(v)); }

// out(k, n) = sum over r < rows of X[r][k] * G[r][n], for k < K, n < N, in
// fp32 FMA; a thread owns 4 x 4 outputs. With ROUND, X is rounded to WT first
// (the value the forward's product saw). K % 4 == 0, N % 4 == 0. No barrier.
template <bool ROUND, typename WT, typename XT, typename GT, typename Epi>
__device__ __forceinline__ void tn_product(const XT* X, int ldx, const GT* G, int ldg, int rows,
                                           int K, int N, Epi epi) {
  const int ntn = N >> 2;
  const int ntiles = (K >> 2) * ntn;
  for (int tile = threadIdx.x; tile < ntiles; tile += THREADS) {
    const int kt = tile / ntn;
    const int k0 = kt << 2, n0 = (tile - kt * ntn) << 2;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float4 xv = load_y4(X + r * ldx + k0);
      const float4 gv = load_y4(G + r * ldg + n0);
      float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
      if (ROUND) {
#pragma unroll
        for (int i = 0; i < 4; ++i) xs[i] = round_to<WT>(xs[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], gs[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(k0 + i, n0 + j, acc[i][j]);
  }
}

// dst[n] += sum over r < rows of buf[r][n], one thread per column.
__device__ __forceinline__ void colsum_add(const float* buf, int ld, int rows, int N, float* dst) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += buf[r * ld + n];
    atomicAdd(dst + n, s);
  }
}

template <typename T>
__device__ __forceinline__ T* buffer(const BwdPlan& P, int i, unsigned char* smem,
                                     unsigned char* scratch) {
  return reinterpret_cast<T*>(P.smem[i] >= 0 ? smem + P.smem[i] : scratch + P.scr[i]);
}

// ---------------------------------------------------------------------------
// MLP branch of one kept window. Ends with a barrier.
template <typename YT, typename WT, int MT>
__device__ void mlp_bwd_window(const BwdArgs& b, int wid, unsigned char* smem,
                               unsigned char* scratch) {
  constexpr int R = MT * 16;
  const Args& a = b.f;
  const int hw = a.hw, C = a.C, I = a.I;
  const int ldc = C + PAD, ldm = I + PAD, ldu = 2 * I + PAD;
  unsigned char* skeep = buffer<unsigned char>(b.P, G_KEEP, smem, scratch);
  float* col = buffer<float>(b.P, G_COL, smem, scratch);
  float* h1f = buffer<float>(b.P, G_H1, smem, scratch);
  float* gm = buffer<float>(b.P, G_GM, smem, scratch);
  WT* mbuf = buffer<WT>(b.P, G_M, smem, scratch);
  float* ug = buffer<float>(b.P, G_U, smem, scratch);
  const WT* wglu = static_cast<const WT*>(a.wglu);
  const WT* wout = static_cast<const WT*>(a.wout);
  const WT* wglu_io = static_cast<const WT*>(b.wglu_io);
  const WT* wout_io = static_cast<const WT*>(b.wout_io);
  const YT* g = static_cast<const YT*>(b.g);
  float *dwglu = b.acc[0], *dbglu = b.acc[1], *dwout = b.acc[2], *dbout = b.acc[3],
        *dls2 = b.acc[4];
  const size_t base = (size_t)wid * hw * C;
  const unsigned char* gkeep = a.keep + (size_t)wid * hw;

  // h1 -> h1f; g_h2 = keep ? g : 0 -> gm; rows from hw to R are zero.
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x * 4; idx < R * C; idx += THREADS * 4) {
    const int r = idx / C, c = idx - r * C;
    const bool real = r < hw;
    *reinterpret_cast<float4*>(h1f + r * ldc + c) = real ? load_y4(b.h1 + base + idx) : zero4;
    *reinterpret_cast<float4*>(gm + r * ldc + c) =
        real && gkeep[r] ? load_y4(g + base + idx) : zero4;
  }
  for (int r = threadIdx.x; r < R; r += THREADS) skeep[r] = r < hw ? gkeep[r] : 0;
  for (int c = threadIdx.x; c < C; c += THREADS) col[c] = 0.f;
  __syncthreads();

  // Recompute [val | gate] = h1 Wglu + b (kept in fp32) and m = val * gelu(gate).
  block_gemm<MT, 2, 2, WT>(
      h1f, ldc, [&](int s, int n) { return wglu + (size_t)(s * I + n) * C; }, I, C,
      [&](int m, int n, const float (&v)[2]) {
        const float val = v[0] + a.bglu[n], gate = v[1] + a.bglu[I + n];
        ug[m * ldu + n] = val;
        ug[m * ldu + I + n] = gate;
        mbuf[m * ldm + n] = from_f<WT>(val * gelu_tanh(gate));
      });
  __syncthreads();
  // mlp = m Wout + b, used only for dls2 = sum_rows g_h2 * mlp.
  block_gemm<MT, 2, 1, WT>(
      mbuf, ldm, [&](int, int n) { return wout + (size_t)n * I; }, C, I,
      [&](int m, int n, const float (&v)[1]) {
        if (m >= hw) return;
        const float gh2 = gm[m * ldc + n];
        if (gh2 != 0.f) atomicAdd(col + n, gh2 * (v[0] + a.bout[n]));
      });
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) atomicAdd(dls2 + c, col[c]);
  // g_mlp = g_h2 * ls2, in place.
  for (int idx = threadIdx.x; idx < hw * C; idx += THREADS) {
    const int r = idx / C, c = idx - r * C;
    gm[r * ldc + c] *= a.ls2[c];
  }
  __syncthreads();
  colsum_add(gm, ldc, hw, C, dbout);
  tn_product<false, WT>(mbuf, ldm, gm, ldc, hw, I, C, [&](int k, int n, float v) {
    atomicAdd(dwout + (size_t)k * C + n, v);
  });
  // g_m = g_mlp Wout^T; g_u = [g_m * act | gelu'(gate) * g_m * val], in place
  // over [val | gate].
  block_gemm<MT, 2, 1, WT>(
      gm, ldc, [&](int, int n) { return wout_io + (size_t)n * C; }, I, C,
      [&](int m, int n, const float (&v)[1]) {
        const float val = ug[m * ldu + n], gate = ug[m * ldu + I + n];
        ug[m * ldu + n] = v[0] * gelu_tanh(gate);
        ug[m * ldu + I + n] = gelu_tanh_grad(gate) * (v[0] * val);
      });
  __syncthreads();
  colsum_add(ug, ldu, hw, 2 * I, dbglu);
  tn_product<true, WT>(h1f, ldc, ug, ldu, hw, C, 2 * I, [&](int k, int n, float v) {
    atomicAdd(dwglu + (size_t)k * 2 * I + n, v);
  });
  // gh1 = g_h2 + g_u Wglu^T, plus the unkept tokens' own cotangent.
  block_gemm<MT, 2, 1, WT>(
      ug, ldu, [&](int, int n) { return wglu_io + (size_t)n * 2 * I; }, C, 2 * I,
      [&](int m, int n, const float (&v)[1]) {
        if (m >= hw) return;
        const size_t o = base + (size_t)m * C + n;
        const float gv = to_f<YT>(g[o]);
        b.gh1[o] = skeep[m] ? gv + v[0] : gv;
      });
  __syncthreads();
}

template <typename YT, typename WT, int MT>
__global__ void __launch_bounds__(THREADS) mlp_bwd_kernel(const BwdArgs b) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Args& a = b.f;
  unsigned char* scratch = a.scratch + (size_t)blockIdx.x * b.P.scratch_per_block;
  const size_t wsize = (size_t)a.hw * a.C;
  const YT* g = static_cast<const YT*>(b.g);
  const int n_win = *a.n_win;
  for (int slot = blockIdx.x; slot < a.M; slot += gridDim.x) {
    const int wid = a.ids[slot];
    if (slot >= n_win) {
      // Unkept window: out == y there, so its cotangent rides through gh1.
      for (size_t i = threadIdx.x; i < wsize; i += THREADS)
        b.gh1[wid * wsize + i] = to_f<YT>(g[wid * wsize + i]);
      continue;
    }
    mlp_bwd_window<YT, WT, MT>(b, wid, smem, scratch);
  }
}

// ---------------------------------------------------------------------------
// Host side.

// Blocks of one launch: a persistent grid of at most GRID_BLOCKS_PER_SM per SM.
inline int bwd_grid(int M, int* grid) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int cap = sms * GRID_BLOCKS_PER_SM;
  *grid = M < cap ? M : cap;
  return 0;
}

struct BwdLaunchFn {
  const BwdArgs& b; long long scratch_bytes; cudaStream_t stream;
  template <typename YT, typename WT, int MT> int operator()() const {
    int grid = 0;
    int rc = bwd_grid(b.f.M, &grid);
    if (rc != 0) return rc;
    if (scratch_bytes < (long long)grid * b.P.scratch_per_block) return (int)cudaErrorInvalidValue;
    // The attribute is set once per kernel instantiation of this library.
    static bool ready = false;
    auto kernel = mlp_bwd_kernel<YT, WT, MT>;
    if (!ready) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SMEM_LIMIT);
      if (e != cudaSuccess) return (int)e;
      ready = true;
    }
    kernel<<<grid, THREADS, b.P.total, stream>>>(b);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace wb

// Pointer table, in this order: h1, keep, g, ids, n_win, gh1, wglu, bglu,
// wout, bout, ls2, wglu_io, wout_io, dwglu, dbglu, dwout, dbout, dls2 (18).
// Matrices w* are (out, in) rows, w*_io (in, out) rows, both in the weights'
// type; vectors and accumulators fp32; accumulators (in, out), zeroed by the
// caller.
extern "C" int sast_sparse_block_bwd(const void* const* p, int np, void* scratch,
                                     long long nscratch, int M, int hw, int C, int I, int heads,
                                     int dh, int y_bf16, int w_bf16, void* stream) {
  using namespace wb;
  if (np != 18) return (int)cudaErrorInvalidValue;
  if (hw > 80 || C % 16 || dh % 16 || I % 16 || heads * dh != C || M <= 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs b{};
  Args& a = b.f;
  a.M = M; a.hw = hw; a.C = C; a.I = I; a.heads = heads; a.dh = dh; a.mode = SPARSE;
  a.scale = (float)(1.0 / sqrt((double)dh));
  a.scratch = static_cast<unsigned char*>(scratch);
  a.keep = static_cast<const unsigned char*>(p[1]);
  a.ids = static_cast<const int*>(p[3]);
  a.n_win = static_cast<const int*>(p[4]);
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  auto out32 = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  b.h1 = f32(0); b.g = p[2]; b.gh1 = out32(5);
  a.wglu = p[6]; a.bglu = f32(7); a.wout = p[8]; a.bout = f32(9); a.ls2 = f32(10);
  b.wglu_io = p[11]; b.wout_io = p[12];
  for (int i = 0; i < 5; ++i) b.acc[i] = out32(13 + i);
  if (!plan_bwd(hw, C, I, w_bf16 ? 2 : 4, &b.P)) return (int)cudaErrorInvalidValue;
  return dispatch(hw, y_bf16, w_bf16, BwdLaunchFn{b, nscratch, static_cast<cudaStream_t>(stream)});
}

// Bytes of scratch one launch needs; -1 if the window does not fit shared
// memory, -2 on a CUDA error.
extern "C" long long sast_sparse_block_bwd_scratch_bytes(int M, int hw, int C, int I, int w_bf16) {
  using namespace wb;
  BwdPlan P;
  if (hw > 80 || !plan_bwd(hw, C, I, w_bf16 ? 2 : 4, &P)) return -1;
  int grid = 0;
  if (bwd_grid(M, &grid) != 0) return -2;
  return (long long)grid * P.scratch_per_block;
}
