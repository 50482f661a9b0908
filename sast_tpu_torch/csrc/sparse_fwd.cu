// The sparse window block (kernel E), for sm_90a: the masked SAST block on
// the kept windows as a short sequence of launches over their tokens.
//
// Replaces the TPU kernel _block_kernel behind _sparse_window_block_impl /
// sparse_window_block (sast_tpu/ops/pallas/sparse_block.py), which computes
// _fwd_window on the kept-first work list ids = argsort(~win_keep, stable):
//   z   = where(keep, LN2(y), y)                  two-pass variance, fp32
//   per head: q,k,v = z Wqkv + b;  P = softmax(mask(q k^T * dh^-0.5));  P v
//   h1  = z + ls1 * (attn_out Wproj + b)
//   h2  = h1 + ls2 * ((val * gelu_tanh(gate)) Wout + b),  [val|gate] = h1 Wglu + b
//   out = where(keep, h2, y)
// Activations are fp32; the operands of every product are rounded to the
// weights' type WT (bf16 or float); products accumulate in fp32. These are
// the rounding points of window_block.cuh's routine (kernels D and F, and
// this kernel's first design) and of ops/block.py block_window_plain, the
// plain version; the LN2 row statistics, the softmax rows and GELU are
// common.cuh's routines, which the backward's recomputation runs too.
//
// Rows are the tokens of the kept windows (rows_gemm.cuh): row i is token
// i % hw of window ids[i / hw], for i < n_win * hw (n_win is read on the
// device; blocks beyond it return at once). The launches:
//   1. prep: z (fp32) and Zr = round(z); slots at or beyond n_win copy y to
//      out, and to h1 when it is asked for.
//   2. GEMM  QKV = round(Zr Wqkv + b).
//   3. core, one block per (kept window, head): masked logits, the softmax,
//      AO = round(round(P) v) for the head.
//   4. GEMM  h1 = z + ls1 * (AO Wproj + b) (fp32, in place over z), H1r =
//      round(h1), and the h1 output at the row's token when asked for.
//   5. GEMM  [val | gate] = H1r Wglu + b, a block taking columns n and I + n
//      together; epilogue m = round(val * gelu(gate)).
//   6. GEMM  out = where(keep, h1 + ls2 * (m Wout + b), y), at the row's token.
// Every product runs on the tensor cores from cp.async-staged shared-memory
// tiles (mma.sync.m16n8k16 bf16, fp32 sums) with bf16 weights; fp32 weights
// run the same tiles on fp32 FMA (no TF32). No float atomics.
//
// What bounds it on an H100: operations (2 hw (4 C^2 + 3 C I) + 4 hw^2 C per
// kept window). A window is too small to fill the card (stage 4 of the b4
// step keeps 3-16 windows for 132 SMs), so each product is a grid of 64 x 64
// tiles over all kept tokens, and each weight tile is read once per 64 rows,
// not once per window. The compact intermediates pass through device memory
// (mostly L2); the wrapper allocates them as one workspace.

#include <type_traits>

#include "common.cuh"

namespace sf {
namespace {

using namespace sast;
#include "rows_gemm.cuh"

struct Args {
  const void* y;              // (M, hw, C) YT
  const unsigned char* keep;  // (M, hw)
  void* out;                  // (M, hw, C) YT
  float* h1;                  // (M, hw, C), or null
  const int* ids;             // work list
  const int* n_win;           // kept windows, on the device
  const float *ln2s, *ln2b, *bqkv, *bproj, *ls1, *bglu, *bout, *ls2;
  const void *wqkv, *wproj, *wglu, *wout;  // (out, in) rows
  // Workspace, over the Rmax = M hw rows.
  float* zh;   // (Rmax, C) z, then h1
  void* zr;    // (Rmax, C) WT: Zr, then AO
  void* qkv;   // (Rmax, max(3C, I)) WT: QKV, then m
  void* h1r;   // (Rmax, C) WT
  int M, hw, C, I, heads, dh;
  float eps, scale;
};

__host__ __device__ __forceinline__ Rows rows_of(const Args& a) { return Rows{a.ids, a.n_win, a.hw}; }

// ---------------------------------------------------------------------------
// 1. prep: a warp per token row j of the work list's order, ROWS rows per
// block.
constexpr int ROWS = 16;

template <typename YT, typename WT>
__global__ void __launch_bounds__(THREADS) prep_kernel(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = a.hw, C = a.C, n_win = *a.n_win;
  const YT* y = static_cast<const YT*>(a.y);
  WT* zr = static_cast<WT*>(a.zr);
  for (int j = blockIdx.x * ROWS + warp; j < (blockIdx.x + 1) * ROWS; j += WARPS) {
    if (j >= a.M * hw) return;
    const int slot = j / hw;
    const size_t tk = (size_t)a.ids[slot] * hw + (j - slot * hw), o = tk * C;
    const YT* yr = y + o;
    if (slot >= n_win) {
      // Skipped window: y passes through (and as h1).
      YT* out = static_cast<YT*>(a.out);
      for (int c = lane; c < C; c += 32) {
        out[o + c] = yr[c];
        if (a.h1 != nullptr) a.h1[o + c] = to_f<YT>(yr[c]);
      }
      continue;
    }
    const bool kept = a.keep[tk] != 0;
    float mu = 0.f, rstd = 0.f;
    if (kept) row_stats([&](int c) { return to_f<YT>(yr[c]); }, C, a.eps, mu, rstd);
    const size_t i = (size_t)j * C;  // kept row j of the compact buffers
    for (int c = lane; c < C; c += 32) {
      const float x = to_f<YT>(yr[c]);
      const float z = kept ? layer_norm(x, mu, rstd, a.ln2s[c], a.ln2b[c]) : x;
      a.zh[i + c] = z;
      zr[i + c] = from_f<WT>(z);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. core: one block per (kept window, head), everything in shared memory.

// Shared-memory layout of the core (bytes), R = 16 MT rows.
struct CoreLayout {
  int ldq, ldp;  // elements: [R][dh] rows in WT, [R][R] fp32 rows
  int q, k, v, p, keep, total;
};

inline CoreLayout core_layout(int R, int dh, int wbytes) {
  CoreLayout L;
  L.ldq = dh + 8; L.ldp = R + 4;
  int off = 0;
  auto take = [&](long long bytes) { const int o = off; off += align128(bytes); return o; };
  L.q = take((long long)R * L.ldq * wbytes); L.k = take((long long)R * L.ldq * wbytes);
  L.v = take((long long)R * L.ldq * wbytes); L.p = take((long long)R * L.ldp * 4);
  L.keep = take(R);
  L.total = off;
  return L;
}

template <typename WT, int MT>
__global__ void __launch_bounds__(THREADS) core_kernel(const Args a, const CoreLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = MT * 16;
  const int h = blockIdx.x, slot = blockIdx.y;
  if (slot >= *a.n_win) return;
  const int wid = a.ids[slot];
  const int hw = a.hw, C = a.C, dh = a.dh;
  const size_t i0 = (size_t)slot * hw;
  const int warp = threadIdx.x >> 5;
  WT* q = reinterpret_cast<WT*>(smem + L.q);
  WT* k = reinterpret_cast<WT*>(smem + L.k);
  WT* v = reinterpret_cast<WT*>(smem + L.v);
  float* P = reinterpret_cast<float*>(smem + L.p);
  unsigned char* skeep = smem + L.keep;
  const int ldq = L.ldq, ldp = L.ldp;
  const WT* QKV = static_cast<const WT*>(a.qkv);

  // The head's q, k, v as [R][dh] rows; rows from hw to R are 0.
  for (int e = threadIdx.x; e < R * dh / 4; e += THREADS) {
    const int r = e / (dh / 4), d = (e - r * (dh / 4)) * 4;
    const bool in = r < hw;
    const size_t row = (i0 + r) * 3 * C + h * dh + d;
    float x[4];
    load4(QKV + row, in, x); store4(q + r * ldq + d, x);
    load4(QKV + row + C, in, x); store4(k + r * ldq + d, x);
    load4(QKV + row + 2 * C, in, x); store4(v + r * ldq + d, x);
  }
  for (int r = threadIdx.x; r < R; r += THREADS)
    skeep[r] = r < hw ? a.keep[(size_t)wid * hw + r] : 0;
  __syncthreads();

  // logits = q k^T * scale, masked keys exactly MASK_VALUE; the softmax of
  // the real rows over the hw real keys (pad keys 0).
  mm<MT, false, false, false>(q, ldq, k, ldq, R, dh, [&](int m, int n, float s) {
    P[m * ldp + n] = masked_logit(skeep[n], s, a.scale);
  });
  __syncthreads();
  for (int r = warp; r < hw; r += WARPS) softmax_row(P + r * ldp, hw, R);
  __syncthreads();

  // attn_out of the head = round(round(P) v), over Zr (dead since launch 2).
  WT* AO = static_cast<WT*>(a.zr);
  mm<MT, false, false, true>(P, ldp, v, ldq, dh, R, [&](int m, int n, float s) {
    if (m < hw) AO[(i0 + m) * C + h * dh + n] = from_f<WT>(s);
  });
}

// ---------------------------------------------------------------------------
// Epilogues of launches 4 and 6.

// h1 = z + ls1 * (v + b) over z; H1r = round(h1); the h1 output if asked.
template <typename WT>
struct H1Epi {
  static constexpr bool PAIR = false, COLSUM = false;
  Rows w; float* zh; WT* h1r; float* h1; const float *bias, *ls1; int C;
  __device__ float operator()(int i, int n, float v) const {
    const size_t o = (size_t)i * C + n;
    const float h = zh[o] + ls1[n] * (v + bias[n]);
    zh[o] = h;
    h1r[o] = from_f<WT>(h);
    if (h1 != nullptr) h1[token(w, i) * C + n] = h;
    return 0.f;
  }
};

// out = h1 + ls2 * (v + b) at kept tokens, y at the others, at the row's token.
template <typename YT>
struct OutEpi {
  static constexpr bool PAIR = false, COLSUM = false;
  Rows w; const unsigned char* keep; const YT* y; YT* out; const float* zh;
  const float *bias, *ls2; int C;
  __device__ float operator()(int i, int n, float v) const {
    const size_t tk = token(w, i), o = tk * C + n;
    out[o] = keep[tk] ? from_f<YT>(zh[(size_t)i * C + n] + ls2[n] * (v + bias[n])) : y[o];
    return 0.f;
  }
};

// ---------------------------------------------------------------------------
// Host side.

struct Plan {
  long long off[4];  // workspace offsets, in the order of Args' workspace fields
  long long bytes;
  CoreLayout core;
};

inline int make_plan(int M, int hw, int C, int I, int dh, int wbytes, Plan* P) {
  if (hw > 80 || C % 16 || dh % 16 || I % 16 || M <= 0) return -1;
  P->core = core_layout(hw <= 64 ? 64 : 80, dh, wbytes);
  if (P->core.total > SMEM_LIMIT) return -1;
  const long long rows = (long long)M * hw;
  const long long sizes[] = {rows * C * 4, rows * C * wbytes,
                             rows * (3 * C > I ? 3 * C : I) * wbytes, rows * C * wbytes};
  long long off = 0;
  for (int i = 0; i < 4; ++i) { P->off[i] = off; off += (sizes[i] + 255) / 256 * 256; }
  P->bytes = off;
  return 0;
}

template <typename YT, typename WT, int MT>
int run(const Args& a, const Plan& P, cudaStream_t s) {
  const int C = a.C, I = a.I, rmax = a.M * a.hw;
  const Rows w = rows_of(a);
  static bool core_ready = false;
  int rc = allow_smem(core_kernel<WT, MT>, P.core.total, core_ready);
  if (rc != 0) return rc;
  prep_kernel<YT, WT><<<(rmax + ROWS - 1) / ROWS, THREADS, 0, s>>>(a);
  rc = rows_gemm<WT, WT, false>(w, rmax, GemmOp{a.zr, a.wqkv, 3 * C, C, 0},
                                StoreEpi<WT>{static_cast<WT*>(a.qkv), a.bqkv, 3 * C}, s);
  if (rc != 0) return rc;
  core_kernel<WT, MT><<<dim3(a.heads, a.M), THREADS, P.core.total, s>>>(a, P.core);
  WT* h1r = static_cast<WT*>(a.h1r);
  WT* m = static_cast<WT*>(a.qkv);  // over QKV, dead after the core
  rc = rows_gemm<WT, WT, false>(w, rmax, GemmOp{a.zr, a.wproj, C, C, 0},
                                H1Epi<WT>{w, a.zh, h1r, a.h1, a.bproj, a.ls1, C}, s);
  if (rc == 0)
    rc = rows_gemm<WT, WT, false>(w, rmax, GemmOp{h1r, a.wglu, I, C, I},
                                  GluEpi<WT>{m, nullptr, a.bglu, I}, s);
  if (rc == 0)
    rc = rows_gemm<WT, WT, false>(
        w, rmax, GemmOp{m, a.wout, C, I, 0},
        OutEpi<YT>{w, a.keep, static_cast<const YT*>(a.y), static_cast<YT*>(a.out), a.zh,
                   a.bout, a.ls2, C}, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

template <int MT>
int dispatch_types(const Args& a, const Plan& P, int y_bf16, int w_bf16, cudaStream_t s) {
  if (!w_bf16) return run<float, float, MT>(a, P, s);
  return y_bf16 ? run<bf16, bf16, MT>(a, P, s) : run<float, bf16, MT>(a, P, s);
}

}  // namespace
}  // namespace sf

// Workspace bytes one launch needs; -1 if a window does not fit the card's
// shared memory or the shape is not built.
extern "C" long long sast_sparse_fwd_workspace(int M, int hw, int C, int I, int dh, int w_bf16) {
  sf::Plan P;
  const int rc = sf::make_plan(M, hw, C, I, dh, w_bf16 ? 2 : 4, &P);
  return rc < 0 ? rc : P.bytes;
}

// Pointer table, in this order: y, keep, out, h1 (null unless wanted), ids,
// n_win, ln2_scale, ln2_bias, wqkv, bqkv, wproj, bproj, ls1, wglu, bglu,
// wout, bout, ls2 (18). Matrices as (out, in) rows in the weights' type;
// vectors fp32.
extern "C" int sast_sparse_fwd(const void* const* p, int np, void* work, long long nwork, int M,
                               int hw, int C, int I, int heads, int dh, float eps, int y_bf16,
                               int w_bf16, void* stream) {
  using namespace sf;
  if (np != 18 || heads * dh != C || (y_bf16 && !w_bf16)) return (int)cudaErrorInvalidValue;
  Plan P;
  if (make_plan(M, hw, C, I, dh, w_bf16 ? 2 : 4, &P) != 0 || nwork < P.bytes)
    return (int)cudaErrorInvalidValue;
  Args a{};
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  a.y = p[0]; a.keep = static_cast<const unsigned char*>(p[1]); a.out = const_cast<void*>(p[2]);
  a.h1 = static_cast<float*>(const_cast<void*>(p[3]));
  a.ids = static_cast<const int*>(p[4]); a.n_win = static_cast<const int*>(p[5]);
  a.ln2s = f32(6); a.ln2b = f32(7); a.wqkv = p[8]; a.bqkv = f32(9); a.wproj = p[10];
  a.bproj = f32(11); a.ls1 = f32(12); a.wglu = p[13]; a.bglu = f32(14); a.wout = p[15];
  a.bout = f32(16); a.ls2 = f32(17);
  unsigned char* w = static_cast<unsigned char*>(work);
  a.zh = reinterpret_cast<float*>(w + P.off[0]); a.zr = w + P.off[1];
  a.qkv = w + P.off[2]; a.h1r = w + P.off[3];
  a.M = M; a.hw = hw; a.C = C; a.I = I; a.heads = heads; a.dh = dh;
  a.eps = eps;
  a.scale = (float)(1.0 / sqrt((double)dh));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hw <= 64 ? dispatch_types<4>(a, P, y_bf16, w_bf16, s)
                  : dispatch_types<5>(a, P, y_bf16, w_bf16, s);
}
