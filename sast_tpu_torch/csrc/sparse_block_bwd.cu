// Backward of the sparse window block over the kept-first work list, for
// sm_90a: the MLP-branch kernel and the attention-branch kernel.
//
// Replaces the TPU kernels _mlp_bwd_kernel and _attn_bwd_kernel behind
// _sparse_block_bwd_impl (sast_tpu/ops/pallas/sparse_block.py). The block
// splits at h1 = z + ls1 * proj:
//   MLP kernel (needs h1, g): recompute u = h1 Wglu + b, m = val * gelu(gate),
//     mlp = m Wout + b; dls2, dWout, dbout, dWglu, dbglu; writes
//     gh1 + (1 - keep) * g, the cotangent the attention kernel goes on from.
//   attention kernel (needs y, gh1): recompute LN2, the per-head softmax,
//     attn_out and proj; dls1, dWproj, dbproj; softmax backward head by head;
//     dWqkv, dbqkv; LN2 backward (dscale, dbias); writes dy.
// Slots at or beyond n_win pass the cotangent through (g -> gh1 -> dy).
// ops/sparse_block.py states the arithmetic (what is rounded where);
// sparse_window_block_bwd_plain there is the plain version of both kernels.
//
// What differs from the TPU kernels. There the grid is sequential and the
// weight gradients accumulate in constant-index fp32 VMEM blocks. Here blocks
// run in no order, so every window's contribution X^T G is added to fp32
// accumulators in device memory with atomicAdd (red.global.add.f32); the
// wrapper zeroes them. The sum's order, and so the last bits of a parameter
// gradient, vary from run to run; with no kept window nothing is added and
// every parameter gradient is exactly zero. Column sums (biases, LayerScale,
// LayerNorm) are reduced in shared memory first, one atomic per column and
// window.
//
// What bounds them on an H100: operations, like the forward (the backward is
// the forward's recomputation plus about twice its products, on the same
// hw x C tokens). The design is the forward's: one thread block of 8 warps
// owns one window; a persistent grid of at most 4 blocks per SM walks the
// slots, which bounds the scratch. The forward's recomputation is the
// forward's own code (load_window, ln2_rows, head_probs, block_gemm of
// window_block.cuh). The products g W^T run through block_gemm against an
// (in, out)-contiguous copy of each matrix; the products that contract over
// the window's rows (X^T G, and dS^T q, dS k, P^T g_ao of the softmax
// backward) run through tn_product in fp32 FMA, a 4 x 4 register tile per
// thread. The attention matrices are recomputed head by head in the backward
// loop rather than kept for all heads. Buffers are placed by plan_bwd(): in
// shared memory in a fixed order while they fit, else in a per-block scratch
// in device memory (L2) that the wrapper allocates; at C = 512 most of the
// window-wide buffers (g_qkv is 60 x 1536 fp32, [val|gate] 60 x 2688 fp32)
// live there.

#include "window_block.cuh"

namespace wb {
namespace {

enum Which { MLP_BWD = 0, ATTN_BWD = 1 };
constexpr int NBUF = 16;
constexpr int GRID_BLOCKS_PER_SM = 4;

// Buffers of the MLP kernel, in placement order.
enum { G_KEEP = 0, G_COL, G_H1, G_GM, G_M, G_U, G_COUNT };
// Buffers of the attention kernel, in placement order; the first H_MANDATORY
// must be in shared memory.
enum { H_KEEP = 0, H_STATS, H_COL, H_Q, H_K, H_VH, H_VT, H_P, H_DP, H_DST,
       H_Z, H_GH, H_ATTN, H_GAO, H_GQKV, H_COUNT };
constexpr int G_MANDATORY = 2, H_MANDATORY = 10;

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
  const void* g;     // MLP kernel: cotangent of the block's output, in y's type
  const float* h1;   // MLP kernel: the forward's saved residual
  float* gh1;        // gh1 + (1 - keep) * g: written by MLP, read by attention
  void* dy;          // attention kernel: output, in y's type
  const void *wqkv_io, *wproj_io, *wglu_io, *wout_io;  // (in, out) rows
  // fp32 accumulators, matrices as (in, out). MLP: dwglu, dbglu, dwout,
  // dbout, dls2. Attention: dwqkv, dbqkv, dwproj, dbproj, dls1, ds2, db2.
  float* acc[7];
  BwdPlan P;
};

inline bool plan_bwd(int which, int hw, int C, int I, int dh, int wbytes, BwdPlan* P) {
  const long long R = hw <= 64 ? 64 : 80;
  long long sizes[NBUF] = {0};
  int count, mandatory;
  const long long rc32 = R * (C + PAD) * 4;
  if (which == MLP_BWD) {
    sizes[G_KEEP] = R;
    sizes[G_COL] = C * 4;
    sizes[G_H1] = rc32;
    sizes[G_GM] = rc32;
    sizes[G_M] = R * (I + PAD) * wbytes;
    sizes[G_U] = R * (2 * I + PAD) * 4;
    count = G_COUNT; mandatory = G_MANDATORY;
  } else {
    sizes[H_KEEP] = R;
    sizes[H_STATS] = 2 * R * 4;
    sizes[H_COL] = 3 * C * 4;
    sizes[H_Q] = sizes[H_K] = sizes[H_VH] = R * (dh + PAD) * wbytes;
    sizes[H_VT] = dh * (R + PAD) * wbytes;
    sizes[H_P] = sizes[H_DP] = sizes[H_DST] = R * (R + PAD) * 4;
    sizes[H_Z] = sizes[H_GH] = rc32;
    sizes[H_ATTN] = sizes[H_GAO] = R * (C + PAD) * wbytes;
    sizes[H_GQKV] = R * (3 * C + PAD) * 4;
    count = H_COUNT; mandatory = H_MANDATORY;
  }
  long long off = 0, s = 0;
  for (int i = 0; i < NBUF; ++i) { P->smem[i] = -1; P->scr[i] = 0; }
  for (int i = 0; i < count; ++i) {
    const long long b = align128(sizes[i]);
    if (off + b <= SMEM_LIMIT) {
      P->smem[i] = (int)off; off += b;
    } else if (i < mandatory) {
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
// Attention branch of one kept window. Ends with a barrier.
template <typename YT, typename WT, int MT>
__device__ void attn_bwd_window(const BwdArgs& b, int wid, unsigned char* smem,
                                unsigned char* scratch) {
  constexpr int R = MT * 16;
  const Args& a = b.f;
  const int hw = a.hw, C = a.C, dh = a.dh;
  const int ldc = C + PAD, ldq = dh + PAD, ldv = R + PAD, ldp = R + PAD, lda = C + PAD,
            ldg = 3 * C + PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* skeep = buffer<unsigned char>(b.P, H_KEEP, smem, scratch);
  float* stats = buffer<float>(b.P, H_STATS, smem, scratch);
  float* col = buffer<float>(b.P, H_COL, smem, scratch);
  WT* qh = buffer<WT>(b.P, H_Q, smem, scratch);
  WT* kh = buffer<WT>(b.P, H_K, smem, scratch);
  WT* vh = buffer<WT>(b.P, H_VH, smem, scratch);
  WT* vt = buffer<WT>(b.P, H_VT, smem, scratch);
  float* P = buffer<float>(b.P, H_P, smem, scratch);
  float* dP = buffer<float>(b.P, H_DP, smem, scratch);
  float* dST = buffer<float>(b.P, H_DST, smem, scratch);
  float* zf = buffer<float>(b.P, H_Z, smem, scratch);
  float* gh = buffer<float>(b.P, H_GH, smem, scratch);
  WT* attn = buffer<WT>(b.P, H_ATTN, smem, scratch);
  WT* gao = buffer<WT>(b.P, H_GAO, smem, scratch);
  float* gqkv = buffer<float>(b.P, H_GQKV, smem, scratch);
  const WT* wproj = static_cast<const WT*>(a.wproj);
  const WT* wproj_io = static_cast<const WT*>(b.wproj_io);
  const WT* wqkv_io = static_cast<const WT*>(b.wqkv_io);
  const YT* y = static_cast<const YT*>(a.y);
  YT* dy = static_cast<YT*>(b.dy);
  float *dwqkv = b.acc[0], *dbqkv = b.acc[1], *dwproj = b.acc[2], *dbproj = b.acc[3],
        *dls1 = b.acc[4], *ds2 = b.acc[5], *db2 = b.acc[6];
  const size_t base = (size_t)wid * hw * C;
  const unsigned char* gkeep = a.keep + (size_t)wid * hw;

  // y -> zf; gh1 = keep ? gh1_in : 0 -> gh; rows from hw to R are zero.
  load_window<YT, MT>(a, wid, y + base, zf, skeep);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x * 4; idx < R * C; idx += THREADS * 4) {
    const int r = idx / C, c = idx - r * C;
    *reinterpret_cast<float4*>(gh + r * ldc + c) =
        r < hw && gkeep[r] ? load_y4(b.gh1 + base + idx) : zero4;
  }
  for (int c = threadIdx.x; c < 3 * C; c += THREADS) col[c] = 0.f;
  __syncthreads();
  ln2_rows<MT>(a, zf, skeep, stats);
  __syncthreads();

  // Recompute attn_out, head by head, as the forward does.
  for (int h = 0; h < a.heads; ++h) {
    head_probs<WT, MT>(a, h, zf, skeep, qh, kh, vt, static_cast<WT*>(nullptr), P);
    block_gemm<MT, 1, 1, WT>(
        P, ldp, [&](int, int n) { return vt + n * ldv; }, dh, R,
        [&](int m, int n, const float (&v)[1]) { attn[m * lda + h * dh + n] = from_f<WT>(v[0]); });
    __syncthreads();
  }

  // proj = attn_out Wproj + b, used only for dls1 = sum_rows gh1 * proj.
  block_gemm<MT, 2, 1, WT>(
      attn, lda, [&](int, int n) { return wproj + (size_t)n * C; }, C, C,
      [&](int m, int n, const float (&v)[1]) {
        if (m >= hw) return;
        const float gv = gh[m * ldc + n];
        if (gv != 0.f) atomicAdd(col + n, gv * (v[0] + a.bproj[n]));
      });
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) atomicAdd(dls1 + c, col[c]);
  // g_proj = gh1 * ls1, in place.
  for (int idx = threadIdx.x; idx < hw * C; idx += THREADS) {
    const int r = idx / C, c = idx - r * C;
    gh[r * ldc + c] *= a.ls1[c];
  }
  __syncthreads();
  colsum_add(gh, ldc, hw, C, dbproj);
  tn_product<false, WT>(attn, lda, gh, ldc, hw, C, C, [&](int k, int n, float v) {
    atomicAdd(dwproj + (size_t)k * C + n, v);
  });
  // g_ao = g_proj Wproj^T, kept in WT like attn_out.
  block_gemm<MT, 2, 1, WT>(
      gh, ldc, [&](int, int n) { return wproj_io + (size_t)n * C; }, C, C,
      [&](int m, int n, const float (&v)[1]) { gao[m * lda + n] = from_f<WT>(v[0]); });
  __syncthreads();

  // Softmax backward per head: q, k, v and P are recomputed.
  for (int h = 0; h < a.heads; ++h) {
    head_probs<WT, MT>(a, h, zf, skeep, qh, kh, vt, vh, P);
    // dP = g_ao_h v^T
    block_gemm<MT, 1, 1, WT>(
        gao + h * dh, lda, [&](int, int n) { return vh + n * ldq; }, R, dh,
        [&](int m, int n, const float (&v)[1]) { dP[m * ldp + n] = v[0]; });
    __syncthreads();
    // dS = P * (dP - sum_k dP * P) at kept keys, 0 elsewhere; dP becomes dS,
    // and dST its transpose. Rows and columns from hw to R are zero.
    for (int r = warp; r < R; r += WARPS) {
      float* dr = dP + r * ldp;
      const float* pr = P + r * ldp;
      float s = 0.f;
      if (r < hw) {
        for (int n = lane; n < hw; n += 32) s += dr[n] * pr[n];
        s = warp_sum(s);
      }
      for (int n = lane; n < R; n += 32) {
        const float ds = (r < hw && n < hw && skeep[n]) ? pr[n] * (dr[n] - s) : 0.f;
        dr[n] = ds;
        dST[n * ldp + r] = ds;
      }
    }
    __syncthreads();
    // gq = scale * dS k, gk = scale * dS^T q, gv = P^T g_ao_h.
    tn_product<false, WT>(dST, ldp, kh, ldq, hw, R, dh, [&](int q, int d, float v) {
      gqkv[q * ldg + h * dh + d] = v * a.scale;
    });
    tn_product<false, WT>(dP, ldp, qh, ldq, hw, R, dh, [&](int k, int d, float v) {
      gqkv[k * ldg + C + h * dh + d] = v * a.scale;
    });
    tn_product<true, WT>(P, ldp, gao + h * dh, lda, hw, R, dh, [&](int k, int d, float v) {
      gqkv[k * ldg + 2 * C + h * dh + d] = v;
    });
    __syncthreads();
  }

  colsum_add(gqkv, ldg, hw, 3 * C, dbqkv);
  tn_product<true, WT>(zf, ldc, gqkv, ldg, hw, C, 3 * C, [&](int k, int n, float v) {
    atomicAdd(dwqkv + (size_t)k * 3 * C + n, v);
  });
  // g_z = gh1 + g_qkv Wqkv^T -> gh (g_proj is dead).
  block_gemm<MT, 2, 1, WT>(
      gqkv, ldg, [&](int, int n) { return wqkv_io + (size_t)n * 3 * C; }, C, 3 * C,
      [&](int m, int n, const float (&v)[1]) {
        if (m >= hw) return;
        gh[m * ldc + n] = v[0] + (skeep[m] ? b.gh1[base + (size_t)m * C + n] : 0.f);
      });
  __syncthreads();

  // z = where(keep, LN2(y), y): LayerNorm backward on kept rows; an unkept
  // row adds its pass-through cotangent to g_z.
  for (int r = warp; r < hw; r += WARPS) {
    const float* gz = gh + r * ldc;
    const size_t o = base + (size_t)r * C;
    if (!skeep[r]) {
      for (int c = lane; c < C; c += 32) dy[o + c] = from_f<YT>(b.gh1[o + c] + gz[c]);
      continue;
    }
    const float mu = stats[r], rstd = stats[R + r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f<YT>(y[o + c]) - mu) * rstd;
      const float gx = gz[c] * a.ln2s[c];
      s1 += gx;
      s2 += gx * xh;
      atomicAdd(col + C + c, gz[c] * xh);
      atomicAdd(col + 2 * C + c, gz[c]);
    }
    const float mean_g = warp_sum(s1) / (float)C, mean_gx = warp_sum(s2) / (float)C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f<YT>(y[o + c]) - mu) * rstd;
      const float gx = gz[c] * a.ln2s[c];
      dy[o + c] = from_f<YT>(rstd * (gx - mean_g - xh * mean_gx));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    atomicAdd(ds2 + c, col[C + c]);
    atomicAdd(db2 + c, col[2 * C + c]);
  }
  __syncthreads();
}

template <typename YT, typename WT, int MT>
__global__ void __launch_bounds__(THREADS) attn_bwd_kernel(const BwdArgs b) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Args& a = b.f;
  unsigned char* scratch = a.scratch + (size_t)blockIdx.x * b.P.scratch_per_block;
  const size_t wsize = (size_t)a.hw * a.C;
  YT* dy = static_cast<YT*>(b.dy);
  const int n_win = *a.n_win;
  for (int slot = blockIdx.x; slot < a.M; slot += gridDim.x) {
    const int wid = a.ids[slot];
    if (slot >= n_win) {
      for (size_t i = threadIdx.x; i < wsize; i += THREADS)
        dy[wid * wsize + i] = from_f<YT>(b.gh1[wid * wsize + i]);
      continue;
    }
    attn_bwd_window<YT, WT, MT>(b, wid, smem, scratch);
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
  const BwdArgs& b; int which; long long scratch_bytes; cudaStream_t stream;
  template <typename YT, typename WT, int MT> int operator()() const {
    int grid = 0;
    int rc = bwd_grid(b.f.M, &grid);
    if (rc != 0) return rc;
    if (scratch_bytes < (long long)grid * b.P.scratch_per_block) return (int)cudaErrorInvalidValue;
    // The attribute is set once per kernel instantiation of this library.
    static bool ready[2] = {false, false};
    if (which == MLP_BWD) {
      auto kernel = mlp_bwd_kernel<YT, WT, MT>;
      if (!ready[0]) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)SMEM_LIMIT);
        if (e != cudaSuccess) return (int)e;
        ready[0] = true;
      }
      kernel<<<grid, THREADS, b.P.total, stream>>>(b);
    } else {
      auto kernel = attn_bwd_kernel<YT, WT, MT>;
      if (!ready[1]) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)SMEM_LIMIT);
        if (e != cudaSuccess) return (int)e;
        ready[1] = true;
      }
      kernel<<<grid, THREADS, b.P.total, stream>>>(b);
    }
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace wb

// Pointer tables, in this order.
// which 0 (MLP kernel): h1, keep, g, ids, n_win, gh1, wglu, bglu, wout, bout,
//   ls2, wglu_io, wout_io, dwglu, dbglu, dwout, dbout, dls2                (18)
// which 1 (attention kernel): y, keep, gh1, ids, n_win, dy, ln2_scale,
//   ln2_bias, wqkv, bqkv, wproj, bproj, ls1, wqkv_io, wproj_io, dwqkv, dbqkv,
//   dwproj, dbproj, dls1, dln2_scale, dln2_bias                            (22)
// Matrices w* are (out, in) rows, w*_io (in, out) rows, both in the weights'
// type; vectors and accumulators fp32; accumulators (in, out), zeroed by the
// caller.
extern "C" int sast_sparse_block_bwd(int which, const void* const* p, int np, void* scratch,
                                     long long nscratch, int M, int hw, int C, int I, int heads,
                                     int dh, float eps, int y_bf16, int w_bf16, void* stream) {
  using namespace wb;
  if (which != MLP_BWD && which != ATTN_BWD) return (int)cudaErrorInvalidValue;
  if (np != (which == MLP_BWD ? 18 : 22)) return (int)cudaErrorInvalidValue;
  if (hw > 80 || C % 16 || dh % 16 || I % 16 || heads * dh != C || M <= 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs b{};
  Args& a = b.f;
  a.M = M; a.hw = hw; a.C = C; a.I = I; a.heads = heads; a.dh = dh; a.mode = SPARSE;
  a.eps = eps;
  a.scale = (float)(1.0 / sqrt((double)dh));
  a.scratch = static_cast<unsigned char*>(scratch);
  a.keep = static_cast<const unsigned char*>(p[1]);
  a.ids = static_cast<const int*>(p[3]);
  a.n_win = static_cast<const int*>(p[4]);
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  auto out32 = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  if (which == MLP_BWD) {
    b.h1 = f32(0); b.g = p[2]; b.gh1 = out32(5);
    a.wglu = p[6]; a.bglu = f32(7); a.wout = p[8]; a.bout = f32(9); a.ls2 = f32(10);
    b.wglu_io = p[11]; b.wout_io = p[12];
    for (int i = 0; i < 5; ++i) b.acc[i] = out32(13 + i);
  } else {
    a.y = p[0]; b.gh1 = out32(2); b.dy = const_cast<void*>(p[5]);
    a.ln2s = f32(6); a.ln2b = f32(7); a.wqkv = p[8]; a.bqkv = f32(9);
    a.wproj = p[10]; a.bproj = f32(11); a.ls1 = f32(12);
    b.wqkv_io = p[13]; b.wproj_io = p[14];
    for (int i = 0; i < 7; ++i) b.acc[i] = out32(15 + i);
  }
  if (!plan_bwd(which, hw, C, I, dh, w_bf16 ? 2 : 4, &b.P)) return (int)cudaErrorInvalidValue;
  return dispatch(hw, y_bf16, w_bf16,
                  BwdLaunchFn{b, which, nscratch, static_cast<cudaStream_t>(stream)});
}

// Bytes of scratch one launch needs; -1 if the window does not fit shared
// memory, -2 on a CUDA error.
extern "C" long long sast_sparse_block_bwd_scratch_bytes(int which, int M, int hw, int C, int I,
                                                         int dh, int y_bf16, int w_bf16) {
  using namespace wb;
  (void)y_bf16;
  BwdPlan P;
  if (hw > 80 || !plan_bwd(which, hw, C, I, dh, w_bf16 ? 2 : 4, &P)) return -1;
  int grid = 0;
  if (bwd_grid(M, &grid) != 0) return -2;
  return (long long)grid * P.scratch_per_block;
}
