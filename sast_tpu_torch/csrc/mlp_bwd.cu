// Backward of the sparse window block's MLP branch, for sm_90a: a short
// sequence of launches over the kept-first work list.
//
// Replaces the TPU kernel _mlp_bwd_kernel behind _sparse_block_bwd_impl
// (sast_tpu/ops/pallas/sparse_block.py). The block splits at
// h1 = z + ls1 * proj; given h1 (the forward's saved residual) and g (the
// cotangent of the block's output), this recomputes u = h1 Wglu + b,
// m = val * gelu(gate) and mlp = m Wout + b, and writes
// gh1 + (1 - keep) * g, the cotangent that the attention branch (attn_bwd.cu)
// goes on from, and the fp32 gradients of wglu, bglu, wout, bout and ls2.
// Slots at or beyond n_win pass the cotangent through (g -> gh1).
// ops/sparse_block.py sparse_block_mlp_bwd_plain is its plain version and
// states every rounding point; they are the same here.
//
// Rows are the tokens of the kept windows (rows_gemm.cuh): row i is token
// i % hw of window ids[i / hw], for i < n_win * hw. The launches:
//   1. prep: H1r = round(h1), g_mlp = keep * g * ls2 (fp32); later slots
//      copy g to gh1.
//   2. GEMM  [val | gate] = H1r Wglu + b, a block taking columns n and I + n
//      together; epilogue: val, gate (fp32) and m = round(val * gelu(gate)).
//   3. GEMM  mlp = m Wout + b; epilogue: per-block column sums of
//      keep * g * mlp for dls2 (mlp itself is never stored).
//   4. GEMM  g_m = round(g_mlp) Wout^T; epilogue: g_u = [g_m * gelu(gate) |
//      gelu'(gate) * g_m * val] (fp32), in place over [val | gate].
//   5. GEMM  gh1 = keep * g + round(g_u) Wglu^T, plus (1 - keep) * g,
//      scattered to the window's tokens.
//   6. split-K GEMMs dWout = m^T g_mlp and dWglu = H1r^T g_u, with the
//      column sums for bout and bglu, into per-split partials.
//   7. reduce: every partial summed in a fixed order into the gradients.
// No float atomics: gh1 and every gradient are the same bits from run to
// run, every gradient is written whole, and with no kept window every
// gradient is exactly zero.
//
// Every product runs on the tensor cores from cp.async-staged shared-memory
// tiles (mma.sync.m16n8k16 bf16, fp32 sums) with bf16 weights; where the
// plain version multiplies a bf16 value by an fp32 one (X^T G), the fp32
// operand is split into bf16 hi + lo. fp32 weights run the same tiles on
// fp32 FMA (no TF32). The weights are read as stored, (out, in) rows: the
// products g W^T take them through ldmatrix.trans, so no transposed copy is
// made per call.
//
// What bounds it on an H100: operations at stages 3-4 (18 hw C I per kept
// window), bytes at stages 1-2 (the fp32 [val | gate] and g_u, 2I wide, pass
// through device memory, mostly L2). The wrapper allocates the compact
// intermediates and the partials as one workspace.

#include <type_traits>

#include "common.cuh"

namespace mb {
namespace {

using namespace sast;
#include "rows_gemm.cuh"

struct Args {
  const float* h1;            // (M, hw, C)
  const unsigned char* keep;  // (M, hw)
  const void* g;              // (M, hw, C) YT
  const int* ids;             // work list
  const int* n_win;           // kept windows, on the device
  float* gh1;                 // (M, hw, C)
  const void *wglu, *wout;    // (out, in) rows: (2I, C), (C, I)
  const float *bglu, *bout, *ls2;
  float *dwglu, *dbglu, *dwout, *dbout, *dls2;
  // Workspace, over the Rmax = M hw rows.
  void* h1r;   // (Rmax, C) WT
  float* gm;   // (Rmax, C) g_mlp
  float* u;    // (Rmax, 2I) [val | gate], then g_u
  void* m;     // (Rmax, I) WT
  float* part_ls2;                 // (row blocks, C)
  float *part_wout, *part_bout;    // (nso, I, C), (nso, C)
  float *part_wglu, *part_bglu;    // (nsg, C, 2I), (nsg, 2I)
  int M, hw, C, I, nso, nsg, chunk_o, chunk_g;
};

__host__ __device__ __forceinline__ Rows rows_of(const Args& a) { return Rows{a.ids, a.n_win, a.hw}; }

// ---------------------------------------------------------------------------
// 1. prep: a warp per token row j of the work list's order, ROWS rows per
// block: kept slots get H1r and g_mlp; later slots copy g to gh1.
constexpr int ROWS = 16;

template <typename YT, typename WT>
__global__ void __launch_bounds__(THREADS) prep_kernel(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = a.hw, C = a.C, n_win = *a.n_win;
  const YT* g = static_cast<const YT*>(a.g);
  WT* h1r = static_cast<WT*>(a.h1r);
  for (int j = blockIdx.x * ROWS + warp; j < (blockIdx.x + 1) * ROWS; j += WARPS) {
    if (j >= a.M * hw) return;
    const int slot = j / hw;
    const size_t tk = (size_t)a.ids[slot] * hw + (j - slot * hw), o = tk * C;
    if (slot >= n_win) {
      for (int c = lane; c < C; c += 32) a.gh1[o + c] = to_f<YT>(g[o + c]);
      continue;
    }
    const bool kept = a.keep[tk] != 0;
    const size_t i = (size_t)j * C;  // kept row j of the compact buffers
    for (int c = lane; c < C; c += 32) {
      h1r[i + c] = from_f<WT>(a.h1[o + c]);
      a.gm[i + c] = kept ? to_f<YT>(g[o + c]) * a.ls2[c] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Epilogues of launches 4 and 5.

// g_u = [g_m * gelu(gate) | gelu'(gate) * g_m * val] over [val | gate] (rows
// of 2I), for g_m = v at column n < I.
struct GuEpi {
  static constexpr bool PAIR = false, COLSUM = false;
  float* u; int I;
  __device__ float operator()(int i, int n, float v) const {
    float* row = u + (size_t)i * 2 * I;
    const float val = row[n], gate = row[I + n];
    row[n] = v * gelu_tanh(gate);
    row[I + n] = gelu_tanh_grad(gate) * (v * val);
    return 0.f;
  }
};

// gh1 = g + v at kept tokens, g at the others, at the row's token.
template <typename YT>
struct Gh1Epi {
  static constexpr bool PAIR = false, COLSUM = false;
  Rows w; const unsigned char* keep; const YT* g; float* gh1; int C;
  __device__ float operator()(int i, int n, float v) const {
    const size_t tk = token(w, i), o = tk * C + n;
    const float gv = to_f<YT>(g[o]);
    gh1[o] = keep[tk] ? gv + v : gv;
    return 0.f;
  }
};

// ---------------------------------------------------------------------------
// Host side.

struct Plan {
  long long off[9];  // workspace offsets, in the order of Args' workspace fields
  long long bytes;
  int nso, nsg, chunk_o, chunk_g, rb;
};

inline int make_plan(int M, int hw, int C, int I, int wbytes, Plan* P) {
  if (C % 16 || I % 16 || M <= 0) return -1;
  int sms = 0;
  if (sm_count(&sms) != 0) return -2;
  const long long rows = (long long)M * hw;
  const int tiles_c = (C + BM - 1) / BM, tiles_i = (I + BM - 1) / BM;
  const int tiles_2i = (2 * I + BN - 1) / BN;
  split_k((int)rows, tiles_i * tiles_c, sms, &P->nso, &P->chunk_o);
  split_k((int)rows, tiles_c * tiles_2i, sms, &P->nsg, &P->chunk_g);
  P->rb = (int)((rows + BM - 1) / BM);
  const long long sizes[] = {
      rows * C * wbytes, rows * C * 4, rows * 2 * I * 4, rows * I * wbytes,
      (long long)P->rb * C * 4,
      (long long)P->nso * I * C * 4, (long long)P->nso * C * 4,
      (long long)P->nsg * C * 2 * I * 4, (long long)P->nsg * 2 * I * 4};
  long long off = 0;
  for (int i = 0; i < 9; ++i) { P->off[i] = off; off += (sizes[i] + 255) / 256 * 256; }
  P->bytes = off;
  return 0;
}

template <typename YT, typename WT>
int run(const Args& a, const Plan& P, cudaStream_t s) {
  const int C = a.C, I = a.I, rmax = a.M * a.hw;
  const Rows w = rows_of(a);
  const YT* g = static_cast<const YT*>(a.g);
  prep_kernel<YT, WT><<<(rmax + ROWS - 1) / ROWS, THREADS, 0, s>>>(a);
  int rc = rows_gemm<WT, WT, false>(w, rmax, GemmOp{a.h1r, a.wglu, I, C, I},
                                    GluEpi<WT>{static_cast<WT*>(a.m), a.u, a.bglu, I}, s);
  if (rc == 0)
    rc = rows_gemm<WT, WT, false>(w, rmax, GemmOp{a.m, a.wout, C, I, 0},
                                  KeptColsumEpi<YT>{w, a.keep, g, a.bout, a.part_ls2, C}, s);
  if (rc == 0)  // Wout stored (C, I) is Wout^T's (K, N) rows
    rc = rows_gemm<WT, float, true>(w, rmax, GemmOp{a.gm, a.wout, I, C, 0}, GuEpi{a.u, I}, s);
  if (rc == 0)  // Wglu stored (2I, C) likewise
    rc = rows_gemm<WT, float, true>(w, rmax, GemmOp{a.u, a.wglu, C, 2 * I, 0},
                                    Gh1Epi<YT>{w, a.keep, g, a.gh1, C}, s);
  if (rc == 0) rc = tn_gemm<WT>(w, P.nso, TnOp{a.m, a.gm, a.part_wout, a.part_bout, I, C, a.chunk_o}, s);
  if (rc == 0)
    rc = tn_gemm<WT>(w, P.nsg, TnOp{a.h1r, a.u, a.part_wglu, a.part_bglu, C, 2 * I, a.chunk_g}, s);
  if (rc != 0) return rc;
  ReduceArgs r;
  const long long ci2 = (long long)C * 2 * I, ic = (long long)I * C;
  const int lo = reduce_lanes(P.nso), lg = reduce_lanes(P.nsg), lrb = reduce_lanes(P.rb);
  r.job[0] = ReduceJob{a.dwglu, a.part_wglu, (int)ci2, ci2, a.chunk_g, lg};
  r.job[1] = ReduceJob{a.dbglu, a.part_bglu, 2 * I, 2 * I, a.chunk_g, lg};
  r.job[2] = ReduceJob{a.dwout, a.part_wout, (int)ic, ic, a.chunk_o, lo};
  r.job[3] = ReduceJob{a.dbout, a.part_bout, C, C, a.chunk_o, lo};
  r.job[4] = ReduceJob{a.dls2, a.part_ls2, C, C, BM, lrb};
  reduce(w, r, 5, s);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mb

// Workspace bytes one launch needs; -1 if the shape is not built, -2 on a
// CUDA error.
extern "C" long long sast_mlp_bwd_workspace(int M, int hw, int C, int I, int w_bf16) {
  mb::Plan P;
  const int rc = mb::make_plan(M, hw, C, I, w_bf16 ? 2 : 4, &P);
  return rc < 0 ? rc : P.bytes;
}

// Pointer table, in this order: h1, keep, g, ids, n_win, gh1, wglu, bglu,
// wout, bout, ls2, dwglu, dbglu, dwout, dbout, dls2 (16). Matrices w* are
// (out, in) rows in the weights' type; vectors fp32; the gradients fp32,
// matrices (in, out), written whole (no zeroing needed).
extern "C" int sast_mlp_bwd(const void* const* p, int np, void* work, long long nwork, int M,
                            int hw, int C, int I, int y_bf16, int w_bf16, void* stream) {
  using namespace mb;
  if (np != 16 || (y_bf16 && !w_bf16)) return (int)cudaErrorInvalidValue;
  Plan P;
  if (make_plan(M, hw, C, I, w_bf16 ? 2 : 4, &P) != 0 || nwork < P.bytes)
    return (int)cudaErrorInvalidValue;
  Args a{};
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  auto out32 = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  a.h1 = f32(0); a.keep = static_cast<const unsigned char*>(p[1]); a.g = p[2];
  a.ids = static_cast<const int*>(p[3]); a.n_win = static_cast<const int*>(p[4]);
  a.gh1 = out32(5);
  a.wglu = p[6]; a.bglu = f32(7); a.wout = p[8]; a.bout = f32(9); a.ls2 = f32(10);
  a.dwglu = out32(11); a.dbglu = out32(12); a.dwout = out32(13); a.dbout = out32(14);
  a.dls2 = out32(15);
  unsigned char* w = static_cast<unsigned char*>(work);
  a.h1r = w + P.off[0]; a.gm = reinterpret_cast<float*>(w + P.off[1]);
  a.u = reinterpret_cast<float*>(w + P.off[2]); a.m = w + P.off[3];
  a.part_ls2 = reinterpret_cast<float*>(w + P.off[4]);
  a.part_wout = reinterpret_cast<float*>(w + P.off[5]);
  a.part_bout = reinterpret_cast<float*>(w + P.off[6]);
  a.part_wglu = reinterpret_cast<float*>(w + P.off[7]);
  a.part_bglu = reinterpret_cast<float*>(w + P.off[8]);
  a.M = M; a.hw = hw; a.C = C; a.I = I;
  a.nso = P.nso; a.nsg = P.nsg; a.chunk_o = P.chunk_o; a.chunk_g = P.chunk_g;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!w_bf16) return run<float, float>(a, P, s);
  return y_bf16 ? run<bf16, bf16>(a, P, s) : run<float, bf16>(a, P, s);
}
