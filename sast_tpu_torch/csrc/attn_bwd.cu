// Backward of the sparse window block's attention branch, for sm_90a: a
// short sequence of launches over the kept-first work list.
//
// Replaces the TPU kernel _attn_bwd_kernel behind _sparse_block_bwd_impl
// (sast_tpu/ops/pallas/sparse_block.py). Given y and gh1 (the cotangent of
// h1 = z + ls1 * proj, from the MLP-branch kernel in mlp_bwd.cu),
// it recomputes LN2, qkv, the per-head softmax, attn_out and proj, and
// writes dy and the fp32 gradients of wqkv, bqkv, wproj, bproj, ls1,
// ln2_scale and ln2_bias. Slots at or beyond n_win pass gh1 through to dy.
// ops/sparse_block.py sparse_block_attn_bwd_plain is its plain version and
// states the arithmetic; the rounding points are the same here. The LN2 row
// statistics and the softmax rows are common.cuh's routines, which the
// forward (window_block.cuh) runs too.
//
// Rows are the tokens of the kept windows, gathered through the work list:
// kept row i is token i % hw of window ids[i / hw], for i < n_win * hw (n_win
// is read on the device; blocks beyond it return at once). The launches:
//   1. prep: z = where(keep, LN2(y), y) rounded to the weights' type (Zr),
//      the row statistics, g_proj = keep * gh1 * ls1 (fp32); unkept windows
//      copy gh1 to dy.
//   2. GEMM  QKV = round(Zr Wqkv + b).      3. GEMM  GAO = round(round(g_proj) Wproj^T).
//   4. core, one block per (kept window, head): logits, softmax, attn_out of
//      the head (AO), dP = g_ao v^T, dS, and the head's gq, gk, gv (G_qkv,
//      fp32). At stage 4 of the B = 12 training step that is 19 x 16 = 304
//      blocks where one block per window gave 19.
//   5. GEMM  proj = AO Wproj + b; epilogue: per-block column sums of gh1 * proj.
//   6. GEMM  GZ = round(G_qkv) Wqkv^T.
//   7. finish: g_z = keep * gh1 + GZ, LayerNorm backward, dy; per-window
//      column sums for ln2_scale and ln2_bias.
//   8. split-K GEMMs dWqkv = Zr^T G_qkv and dWproj = AO^T g_proj, with the
//      column sums for bqkv and bproj, into per-split partials.
//   9. reduce: every partial summed in a fixed order into the gradients.
// No float atomics: dy and every gradient are the same bits from run to run,
// and with no kept window every gradient is exactly zero.
//
// Every product runs on the tensor cores from shared-memory tiles
// (mma.sync.m16n8k16 bf16, fp32 sums) with bf16 weights. Where the plain
// version multiplies a bf16 value by an fp32 one (X^T G, dS k, dS^T q), the
// fp32 operand is split into hi = RN(x) and lo = RN(x - hi) and both bf16
// products go into one fp32 sum (about 16 significant bits of x). With fp32
// weights the same tiles run on fp32 FMA (no TF32).
//
// What bounds it on an H100: operations at stages 3-4 (24 hw C^2 + 12 hw^2 C
// per kept window), bytes at stages 1-2 (the fp32 cotangents). The compact
// intermediates (Zr, QKV, GAO, AO, G_qkv, GZ over the kept rows) pass through
// device memory, mostly L2; the wrapper allocates them as one workspace.
// The GEMM, split-K, reduce and tile-product machinery is rows_gemm.cuh's,
// which kernels G (mlp_bwd.cu) and E (sparse_fwd.cu) run too.

#include <type_traits>

#include "common.cuh"

namespace ab {
namespace {

using namespace sast;
#include "rows_gemm.cuh"

// ---------------------------------------------------------------------------
// Shared arguments.

struct Args {
  const void* y;              // (M, hw, C) YT
  const unsigned char* keep;  // (M, hw)
  const float* gh1;           // (M, hw, C)
  const int* ids;             // work list
  const int* n_win;           // kept windows, on the device
  void* dy;                   // (M, hw, C) YT
  const float *ln2s, *ln2b, *bqkv, *bproj, *ls1;
  const void *wqkv, *wproj;        // (out, in) rows
  const void *wqkv_io, *wproj_io;  // (in, out) rows
  float *dwqkv, *dbqkv, *dwproj, *dbproj, *dls1, *ds2, *db2;
  // Workspace, over the Rmax = M hw rows.
  void* zr;     // (Rmax, C) WT
  float* st;    // (Rmax, 2): mean, rstd
  float* gp;    // (Rmax, C) g_proj
  void* qkv;    // (Rmax, 3C) WT; GZ (Rmax, C) fp32 overlays it after the core
  void* gao;    // (Rmax, C) WT
  void* ao;     // (Rmax, C) WT
  float* gq;    // (Rmax, 3C) G_qkv
  float* part_ls1;   // (row blocks, C)
  float* part_ln;    // (row blocks of ROWS, 2, C)
  float *part_wqkv, *part_bqkv;    // (nsq, C, 3C), (nsq, 3C)
  float *part_wproj, *part_bproj;  // (nsp, C, C), (nsp, C)
  int M, hw, C, heads, dh, nsq, nsp, chunk_q, chunk_p;
  float eps, scale;
};

// The kept rows of this launch (rows_gemm.cuh).
__host__ __device__ __forceinline__ Rows rows_of(const Args& a) { return Rows{a.ids, a.n_win, a.hw}; }

// ---------------------------------------------------------------------------
// 1. prep and 7. finish: a warp per token row, ROWS rows per block; in
// finish a lane holds the row's columns lane + 32 j in registers (C <= 32 NJ).
constexpr int ROWS = 16;
constexpr int NJ = 16;

// Row j of the work list's token order (slot j / hw, token j % hw): kept
// slots get z, their statistics and g_proj; later slots copy gh1 to dy.
template <typename YT, typename WT>
__global__ void __launch_bounds__(THREADS) prep_kernel(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = a.hw, C = a.C, n_win = *a.n_win;
  const YT* y = static_cast<const YT*>(a.y);
  WT* zr = static_cast<WT*>(a.zr);
  for (int j = blockIdx.x * ROWS + warp; j < (blockIdx.x + 1) * ROWS; j += WARPS) {
    if (j >= a.M * hw) return;
    const int slot = j / hw, r = j - slot * hw;
    const size_t tk = (size_t)a.ids[slot] * hw + r;
    const size_t o = tk * C;
    if (slot >= n_win) {
      YT* dy = static_cast<YT*>(a.dy);
      for (int c = lane; c < C; c += 32) dy[o + c] = from_f<YT>(a.gh1[o + c]);
      continue;
    }
    const bool kept = a.keep[tk] != 0;
    const YT* yr = y + o;
    float mu = 0.f, rstd = 0.f;
    // The forward's LN2 (window_block.cuh ln2_rows), read from y.
    if (kept) row_stats([&](int c) { return to_f<YT>(yr[c]); }, C, a.eps, mu, rstd);
    const size_t i = (size_t)j * C;  // kept row j of the compact buffers
    for (int c = lane; c < C; c += 32) {
      const float x = to_f<YT>(yr[c]);
      zr[i + c] = from_f<WT>(kept ? layer_norm(x, mu, rstd, a.ln2s[c], a.ln2b[c]) : x);
      a.gp[i + c] = kept ? a.gh1[o + c] * a.ls1[c] : 0.f;
    }
    if (lane == 0) { a.st[2 * j] = mu; a.st[2 * j + 1] = rstd; }
  }
}

// ---------------------------------------------------------------------------
// 4. core: one block per (kept window, head), everything in shared memory.

// Shared-memory layout of the core (bytes), R = 16 MT rows.
struct CoreLayout {
  int ldq, ldp;  // elements: [R][dh] rows in WT, [R][R] fp32 rows
  int q, k, v, gao, p, ds, keep, total;
};

inline CoreLayout core_layout(int R, int dh, int wbytes) {
  CoreLayout L;
  L.ldq = dh + 8; L.ldp = R + 4;
  int off = 0;
  auto take = [&](long long bytes) { const int o = off; off += align128(bytes); return o; };
  L.q = take((long long)R * L.ldq * wbytes); L.k = take((long long)R * L.ldq * wbytes);
  L.v = take((long long)R * L.ldq * wbytes); L.gao = take((long long)R * L.ldq * wbytes);
  L.p = take((long long)R * L.ldp * 4); L.ds = take((long long)R * L.ldp * 4);
  L.keep = take(R);
  L.total = off;
  return L;
}

// Four blocks per SM with bf16 weights (54 KB of shared memory at hw <= 64).
template <typename WT, int MT>
__global__ void __launch_bounds__(THREADS, std::is_same<WT, float>::value ? 2 : 4) core_kernel(const Args a, const CoreLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = MT * 16;
  const int h = blockIdx.x, slot = blockIdx.y;
  if (slot >= *a.n_win) return;
  const int wid = a.ids[slot];
  const int hw = a.hw, C = a.C, dh = a.dh;
  const size_t i0 = (size_t)slot * hw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WT* q = reinterpret_cast<WT*>(smem + L.q);
  WT* k = reinterpret_cast<WT*>(smem + L.k);
  WT* v = reinterpret_cast<WT*>(smem + L.v);
  WT* gao = reinterpret_cast<WT*>(smem + L.gao);
  float* P = reinterpret_cast<float*>(smem + L.p);
  float* dS = reinterpret_cast<float*>(smem + L.ds);
  unsigned char* skeep = smem + L.keep;
  const int ldq = L.ldq, ldp = L.ldp;
  const WT* QKV = static_cast<const WT*>(a.qkv);
  const WT* GAO = static_cast<const WT*>(a.gao);

  // The head's q, k, v and g_ao as [R][dh] rows; rows from hw to R are 0.
  for (int e = threadIdx.x; e < R * dh / 4; e += THREADS) {
    const int r = e / (dh / 4), d = (e - r * (dh / 4)) * 4;
    const bool in = r < hw;
    const size_t row = (i0 + r) * 3 * C + h * dh + d;
    float x[4];
    load4(QKV + row, in, x); store4(q + r * ldq + d, x);
    load4(QKV + row + C, in, x); store4(k + r * ldq + d, x);
    load4(QKV + row + 2 * C, in, x); store4(v + r * ldq + d, x);
    load4(GAO + (i0 + r) * C + h * dh + d, in, x); store4(gao + r * ldq + d, x);
  }
  for (int r = threadIdx.x; r < R; r += THREADS)
    skeep[r] = r < hw ? a.keep[(size_t)wid * hw + r] : 0;
  __syncthreads();

  // logits = q k^T * scale and their softmax, as the forward (common.cuh);
  // the pad rows are 0 here, since the products below sum over all R rows.
  mm<MT, false, false, false>(q, ldq, k, ldq, R, dh, [&](int m, int n, float s) {
    P[m * ldp + n] = masked_logit(skeep[n], s, a.scale);
  });
  __syncthreads();
  for (int r = warp; r < R; r += WARPS) {
    if (r < hw) {
      softmax_row(P + r * ldp, hw, R);
    } else {
      for (int n = lane; n < R; n += 32) P[r * ldp + n] = 0.f;
    }
  }
  __syncthreads();

  // attn_out of the head = round(round(P) v); dP = g_ao v^T (into dS).
  WT* AO = static_cast<WT*>(a.ao);
  mm<MT, false, false, true>(P, ldp, v, ldq, dh, R, [&](int m, int n, float s) {
    if (m < hw) AO[(i0 + m) * C + h * dh + n] = from_f<WT>(s);
  });
  mm<MT, false, false, false>(gao, ldq, v, ldq, R, dh, [&](int m, int n, float s) {
    dS[m * ldp + n] = s;
  });
  __syncthreads();
  // dS = P * (dP - sum_k dP * P) at kept keys, 0 elsewhere, in place.
  for (int r = warp; r < R; r += WARPS) {
    float* dr = dS + r * ldp;
    const float* pr = P + r * ldp;
    float s = 0.f;
    if (r < hw) {
      for (int n = lane; n < hw; n += 32) s += dr[n] * pr[n];
      s = warp_sum(s);
    }
    for (int n = lane; n < R; n += 32)
      dr[n] = (r < hw && n < hw && skeep[n]) ? pr[n] * (dr[n] - s) : 0.f;
  }
  __syncthreads();
  // gq = scale dS k, gk = scale dS^T q, gv = round(P)^T g_ao.
  float* G = a.gq;
  mm<MT, true, false, true>(dS, ldp, k, ldq, dh, R, [&](int m, int n, float s) {
    if (m < hw) G[(i0 + m) * 3 * C + h * dh + n] = s * a.scale;
  });
  mm<MT, true, true, true>(dS, ldp, q, ldq, dh, R, [&](int m, int n, float s) {
    if (m < hw) G[(i0 + m) * 3 * C + C + h * dh + n] = s * a.scale;
  });
  mm<MT, false, true, true>(P, ldp, gao, ldq, dh, R, [&](int m, int n, float s) {
    if (m < hw) G[(i0 + m) * 3 * C + 2 * C + h * dh + n] = s;
  });
}

// ---------------------------------------------------------------------------
// 7. finish: g_z = keep * gh1 + GZ, LayerNorm backward, dy, for the kept rows
// of this block; then the block's column sums for ln2_scale and ln2_bias.
template <typename YT>
__global__ void __launch_bounds__(THREADS) finish_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Rows kr = rows_of(a);
  const int nk = kept_rows(kr);
  if (blockIdx.x * ROWS >= nk) return;
  const int C = a.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const YT* y = static_cast<const YT*>(a.y);
  YT* dy = static_cast<YT*>(a.dy);
  const float* GZ = reinterpret_cast<const float*>(a.qkv);
  float sd[NJ], sb[NJ];  // this lane's column sums of g_z * xhat and g_z
#pragma unroll
  for (int q = 0; q < NJ; ++q) sd[q] = sb[q] = 0.f;
  for (int i = blockIdx.x * ROWS + warp; i < (blockIdx.x + 1) * ROWS && i < nk; i += WARPS) {
    const size_t tk = token(kr, i);
    const size_t o = tk * C;
    const float* gz = GZ + (size_t)i * C;
    if (!a.keep[tk]) {
      // z = y there: the cotangent passes through, plus g_z.
      for (int c = lane; c < C; c += 32) dy[o + c] = from_f<YT>(a.gh1[o + c] + gz[c]);
      continue;
    }
    const float mu = a.st[2 * i], rstd = a.st[2 * i + 1];
    float g[NJ], xh[NJ];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int c = lane + 32 * q;
      g[q] = xh[q] = 0.f;
      if (c < C) {
        g[q] = a.gh1[o + c] + gz[c];
        xh[q] = (to_f<YT>(y[o + c]) - mu) * rstd;
        const float gx = g[q] * a.ln2s[c];
        s1 += gx;
        s2 += gx * xh[q];
        sd[q] += g[q] * xh[q];
        sb[q] += g[q];
      }
    }
    const float mean_g = warp_sum(s1) / (float)C, mean_gx = warp_sum(s2) / (float)C;
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int c = lane + 32 * q;
      if (c < C) dy[o + c] = from_f<YT>(rstd * (g[q] * a.ln2s[c] - mean_g - xh[q] * mean_gx));
    }
  }
  // The block's column sums, warps in order.
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][2][C]
#pragma unroll
  for (int q = 0; q < NJ; ++q) {
    const int c = lane + 32 * q;
    if (c < C) { red[(warp * 2) * C + c] = sd[q]; red[(warp * 2 + 1) * C + c] = sb[q]; }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float d = 0.f, b = 0.f;
    for (int w = 0; w < WARPS; ++w) { d += red[(w * 2) * C + c]; b += red[(w * 2 + 1) * C + c]; }
    a.part_ln[(size_t)blockIdx.x * 2 * C + c] = d;
    a.part_ln[(size_t)blockIdx.x * 2 * C + C + c] = b;
  }
}

// ---------------------------------------------------------------------------
// Host side.

struct Plan {
  long long off[16];  // workspace offsets, in the order of Args' workspace fields
  long long bytes;
  CoreLayout core;
  int nsq, nsp, chunk_q, chunk_p, rb;
};

inline int make_plan(int M, int hw, int C, int dh, int wbytes, Plan* P) {
  if (hw > 80 || C % 16 || dh % 16 || C > 512 || M <= 0) return -1;
  const int R = hw <= 64 ? 64 : 80;
  P->core = core_layout(R, dh, wbytes);
  if (P->core.total > SMEM_LIMIT) return -1;
  int sms = 0;
  if (sm_count(&sms) != 0) return -2;
  const long long rows = (long long)M * hw;
  const int tiles_c = (C + BM - 1) / BM, tiles_3c = (3 * C + BN - 1) / BN;
  split_k((int)rows, tiles_c * tiles_3c, sms, &P->nsq, &P->chunk_q);
  split_k((int)rows, tiles_c * tiles_c, sms, &P->nsp, &P->chunk_p);
  P->rb = (int)((rows + BM - 1) / BM);
  const long long qkv_bytes = rows * 3 * C * wbytes;  // also holds GZ, rows x C fp32
  const long long sizes[] = {
      rows * C * wbytes, rows * 2 * 4, rows * C * 4, qkv_bytes, rows * C * wbytes,
      rows * C * wbytes, rows * 3 * C * 4, (long long)P->rb * C * 4,
      (rows + ROWS - 1) / ROWS * 2 * C * 4,
      (long long)P->nsq * C * 3 * C * 4, (long long)P->nsq * 3 * C * 4,
      (long long)P->nsp * C * C * 4, (long long)P->nsp * C * 4};
  long long off = 0;
  for (int i = 0; i < 13; ++i) { P->off[i] = off; off += (sizes[i] + 255) / 256 * 256; }
  P->bytes = off;
  return 0;
}

template <typename YT, typename WT, int MT>
int run(Args a, const Plan& P, cudaStream_t s) {
  const int C = a.C, N3 = 3 * C, rmax = a.M * a.hw;
  const Rows w = rows_of(a);
  static bool core_ready = false;
  int rc = allow_smem(core_kernel<WT, MT>, P.core.total, core_ready);
  if (rc != 0) return rc;
  const int row_blocks = (rmax + ROWS - 1) / ROWS;
  prep_kernel<YT, WT><<<row_blocks, THREADS, 0, s>>>(a);
  rc = rows_gemm<WT, WT, false>(w, rmax, GemmOp{a.zr, a.wqkv, N3, C, 0},
                                StoreEpi<WT>{static_cast<WT*>(a.qkv), a.bqkv, N3}, s);
  if (rc == 0)
    rc = rows_gemm<WT, float, false>(w, rmax, GemmOp{a.gp, a.wproj_io, C, C, 0},
                                     StoreEpi<WT>{static_cast<WT*>(a.gao), nullptr, C}, s);
  if (rc != 0) return rc;
  core_kernel<WT, MT><<<dim3(a.heads, a.M), THREADS, P.core.total, s>>>(a, P.core);
  rc = rows_gemm<WT, WT, false>(w, rmax, GemmOp{a.ao, a.wproj, C, C, 0},
                                KeptColsumEpi<float>{w, a.keep, a.gh1, a.bproj, a.part_ls1, C}, s);
  if (rc == 0)  // GZ overlays qkv, dead after the core
    rc = rows_gemm<WT, float, false>(w, rmax, GemmOp{a.gq, a.wqkv_io, C, N3, 0},
                                     StoreEpi<float>{reinterpret_cast<float*>(a.qkv), nullptr, C}, s);
  if (rc != 0) return rc;
  finish_kernel<YT><<<row_blocks, THREADS, WARPS * 2 * C * sizeof(float), s>>>(a);
  rc = tn_gemm<WT>(w, P.nsq, TnOp{a.zr, a.gq, a.part_wqkv, a.part_bqkv, C, N3, a.chunk_q}, s);
  if (rc == 0) rc = tn_gemm<WT>(w, P.nsp, TnOp{a.ao, a.gp, a.part_wproj, a.part_bproj, C, C, a.chunk_p}, s);
  if (rc != 0) return rc;
  ReduceArgs r;
  const long long cc3 = (long long)C * N3, cc = (long long)C * C;
  const int lq = reduce_lanes(P.nsq), lp = reduce_lanes(P.nsp), lrb = reduce_lanes(P.rb),
            lrows = reduce_lanes((rmax + ROWS - 1) / ROWS);
  r.job[0] = ReduceJob{a.dwqkv, a.part_wqkv, (int)cc3, cc3, a.chunk_q, lq};
  r.job[1] = ReduceJob{a.dbqkv, a.part_bqkv, N3, N3, a.chunk_q, lq};
  r.job[2] = ReduceJob{a.dwproj, a.part_wproj, (int)cc, cc, a.chunk_p, lp};
  r.job[3] = ReduceJob{a.dbproj, a.part_bproj, C, C, a.chunk_p, lp};
  r.job[4] = ReduceJob{a.dls1, a.part_ls1, C, C, BM, lrb};
  r.job[5] = ReduceJob{a.ds2, a.part_ln, C, 2 * C, ROWS, lrows};
  r.job[6] = ReduceJob{a.db2, a.part_ln + C, C, 2 * C, ROWS, lrows};
  reduce(w, r, 7, s);
  return (int)cudaGetLastError();
}

struct RunFn {
  const Args& a; const Plan& P; cudaStream_t s;
  template <typename YT, typename WT, int MT> int go() const { return run<YT, WT, MT>(a, P, s); }
};

template <int MT>
int dispatch_types(int y_bf16, int w_bf16, const RunFn& fn) {
  if (y_bf16 && !w_bf16) return (int)cudaErrorInvalidValue;
  if (!w_bf16) return fn.template go<float, float, MT>();
  if (y_bf16) return fn.template go<bf16, bf16, MT>();
  return fn.template go<float, bf16, MT>();
}

}  // namespace
}  // namespace ab

// Workspace bytes one launch needs; -1 if a window does not fit the card's
// shared memory or the shape is not built, -2 on a CUDA error.
extern "C" long long sast_attn_bwd_workspace(int M, int hw, int C, int dh, int w_bf16) {
  ab::Plan P;
  const int rc = ab::make_plan(M, hw, C, dh, w_bf16 ? 2 : 4, &P);
  return rc < 0 ? rc : P.bytes;
}

// Pointer table, in this order: y, keep, gh1, ids, n_win, dy, ln2_scale,
// ln2_bias, wqkv, bqkv, wproj, bproj, ls1, wqkv_io, wproj_io, dwqkv, dbqkv,
// dwproj, dbproj, dls1, dln2_scale, dln2_bias (22). Matrices w* are (out, in)
// rows and w*_io (in, out) rows, in the weights' type; vectors fp32; the
// gradients fp32, matrices (in, out), written whole (no zeroing needed).
extern "C" int sast_attn_bwd(const void* const* p, int np, void* work, long long nwork, int M,
                             int hw, int C, int heads, int dh, float eps, int y_bf16, int w_bf16,
                             void* stream) {
  using namespace ab;
  if (np != 22 || heads * dh != C) return (int)cudaErrorInvalidValue;
  Plan P;
  if (make_plan(M, hw, C, dh, w_bf16 ? 2 : 4, &P) != 0 || nwork < P.bytes)
    return (int)cudaErrorInvalidValue;
  Args a{};
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  auto out32 = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  a.y = p[0]; a.keep = static_cast<const unsigned char*>(p[1]); a.gh1 = f32(2);
  a.ids = static_cast<const int*>(p[3]); a.n_win = static_cast<const int*>(p[4]);
  a.dy = const_cast<void*>(p[5]);
  a.ln2s = f32(6); a.ln2b = f32(7); a.wqkv = p[8]; a.bqkv = f32(9); a.wproj = p[10];
  a.bproj = f32(11); a.ls1 = f32(12); a.wqkv_io = p[13]; a.wproj_io = p[14];
  a.dwqkv = out32(15); a.dbqkv = out32(16); a.dwproj = out32(17); a.dbproj = out32(18);
  a.dls1 = out32(19); a.ds2 = out32(20); a.db2 = out32(21);
  unsigned char* w = static_cast<unsigned char*>(work);
  a.zr = w + P.off[0]; a.st = reinterpret_cast<float*>(w + P.off[1]);
  a.gp = reinterpret_cast<float*>(w + P.off[2]); a.qkv = w + P.off[3]; a.gao = w + P.off[4];
  a.ao = w + P.off[5]; a.gq = reinterpret_cast<float*>(w + P.off[6]);
  a.part_ls1 = reinterpret_cast<float*>(w + P.off[7]);
  a.part_ln = reinterpret_cast<float*>(w + P.off[8]);
  a.part_wqkv = reinterpret_cast<float*>(w + P.off[9]);
  a.part_bqkv = reinterpret_cast<float*>(w + P.off[10]);
  a.part_wproj = reinterpret_cast<float*>(w + P.off[11]);
  a.part_bproj = reinterpret_cast<float*>(w + P.off[12]);
  a.M = M; a.hw = hw; a.C = C; a.heads = heads; a.dh = dh;
  a.nsq = P.nsq; a.nsp = P.nsp; a.chunk_q = P.chunk_q; a.chunk_p = P.chunk_p;
  a.eps = eps;
  a.scale = (float)(1.0 / sqrt((double)dh));
  const RunFn fn{a, P, static_cast<cudaStream_t>(stream)};
  return hw <= 64 ? dispatch_types<4>(y_bf16, w_bf16, fn) : dispatch_types<5>(y_bf16, w_bf16, fn);
}
