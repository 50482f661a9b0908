// Backward of the sparse window block's attention branch, for sm_90a: a
// short sequence of launches over the kept-first work list.
//
// Replaces the TPU kernel _attn_bwd_kernel behind _sparse_block_bwd_impl
// (sast_tpu/ops/pallas/sparse_block.py). Given y and gh1 (the cotangent of
// h1 = z + ls1 * proj, from the MLP-branch kernel in sparse_block_bwd.cu),
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

#include <type_traits>

#include "common.cuh"

namespace ab {
namespace {

using namespace sast;
using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long SMEM_LIMIT = 227 * 1024;
constexpr int BM = 64, BN = 64, BK = 32;  // GEMM tiles
constexpr int LDK = BK + 8;               // [row][k] tiles, elements
constexpr int NST = 3;                    // cp.async stages of the GEMM tiles
constexpr int SPLIT_BLOCKS_PER_SM = 8;    // split-K target at full density

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// A fragment of a [k][m] tile (m contiguous): four 8 x 8 matrices, transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// Four consecutive k of an fp32 row as load_k4 (common.cuh) takes them, as
// hi = RN(x) and lo = RN(x - hi).
__device__ __forceinline__ void split4(const float4 v, uint32_t& hlo, uint32_t& hhi,
                                       uint32_t& llo, uint32_t& lhi) {
  const float a = bf16_round(v.x), b = bf16_round(v.y), c = bf16_round(v.z), d = bf16_round(v.w);
  hlo = pack_bf16(a, b); hhi = pack_bf16(c, d);
  llo = pack_bf16(v.x - a, v.y - b); lhi = pack_bf16(v.z - c, v.w - d);
}

// Four elements of a row into WT, zero where `ok` is false.
__device__ __forceinline__ void load4(const float* p, bool ok, float (&v)[4]) {
  if (ok) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
}
__device__ __forceinline__ void load4(const bf16* p, bool ok, float (&v)[4]) {
  if (ok) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) p[q] = from_f<T>(v[q]);
}

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

__device__ __forceinline__ int kept_rows(const Args& a) { return *a.n_win * a.hw; }
// Token index (window id * hw + r) of kept row i.
__device__ __forceinline__ size_t token(const Args& a, int i) {
  const int slot = i / a.hw;
  return (size_t)a.ids[slot] * a.hw + (i - slot * a.hw);
}

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
// GEMM over the kept rows: out[i][n] = sum_k A[i][k] B[n][k] for i < n_win hw,
// n < N. A (Rmax, K) in AT (WT, or fp32 rounded to WT on the way into shared
// memory); B (N, K) rows in WT. 64 x 64 tiles, k in steps of 32.
enum { E_QKV = 0, E_GAO = 1, E_PROJ = 2, E_GZ = 3 };

struct GemmOp {
  const void* A; const void* B; int N, K; int epi;
};

// A row-major tile of `rows` x BK elements of T from (src, ld) at (r0, k0)
// into shared memory (row stride LDK) by cp.async; rows at or beyond
// `rmax` and k at or beyond K read as zero. K % 16 == 0.
template <typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src, int ld, int r0, int rmax,
                                           int k0, int K) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = BK / EPC;        // chunks per row
  for (int c = threadIdx.x; c < BM * CPR; c += THREADS) {
    const int r = c / CPR, k = (c - r * CPR) * EPC;
    const bool valid = r0 + r < rmax && k0 + k < K;
    cp_async16_zfill(dst + r * LDK + k, valid ? src + (size_t)(r0 + r) * ld + k0 + k : src, valid);
  }
}

template <typename WT, typename AT, int EPI>
__global__ void __launch_bounds__(THREADS) rows_gemm_kernel(const Args a, const GemmOp op) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = kept_rows(a);
  const int i0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (i0 >= nk) return;
  const int N = op.N, K = op.K;
  // NST stages of (A tile in AT, B tile in WT); fp32 A is rounded to WT in
  // the fragment loads.
  constexpr int STAGE = BM * LDK * (sizeof(AT) + sizeof(WT));
  auto As = [&](int st) { return reinterpret_cast<AT*>(smem + st * STAGE); };
  auto Bs = [&](int st) { return reinterpret_cast<WT*>(smem + st * STAGE + BM * LDK * sizeof(AT)); };
  const AT* A = static_cast<const AT*>(op.A);
  const WT* B = static_cast<const WT*>(op.B);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr bool FP32 = std::is_same<WT, float>::value;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nsteps = (K + BK - 1) / BK;
  // One commit group per step, empty past the end, so that waiting for all
  // but the newest NST - 1 groups always means this step's tiles are in.
  auto issue = [&](int ks) {
    if (ks < nsteps) {
      tile_async(As(ks % NST), A, K, i0, nk, ks * BK, K);
      tile_async(Bs(ks % NST), B, K, n0, N, ks * BK, K);
    }
    cp_async_commit();
  };
  for (int ks = 0; ks < NST - 1; ++ks) issue(ks);
  for (int ks = 0; ks < nsteps; ++ks) {
    issue(ks + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();
    const AT* at = As(ks % NST);
    const WT* bt = Bs(ks % NST);
    if constexpr (FP32) {
      const int tm = tid >> 4, tn = tid & 15;  // rows 4 tm .., columns 4 tn ..
      for (int kk = 0; kk < BK; kk += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          av[q] = *reinterpret_cast<const float4*>(at + (4 * tm + q) * LDK + kk);
          bv[q] = *reinterpret_cast<const float4*>(bt + (4 * tn + q) * LDK + kk);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = acc[r][c];
            s = fmaf(av[r].x, bv[c].x, s); s = fmaf(av[r].y, bv[c].y, s);
            s = fmaf(av[r].z, bv[c].z, s); s = fmaf(av[r].w, bv[c].w, s);
            acc[r][c] = s;
          }
      }
    } else {
      const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm .., columns 32 wn ..
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4];
        load_k4(at + (wm * 16 + g) * LDK + kk + 4 * t, af[0], af[2]);
        load_k4(at + (wm * 16 + g + 8) * LDK + kk + 4 * t, af[1], af[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b0, b1;
          load_k4(bt + (wn * 32 + j * 8 + g) * LDK + kk + 4 * t, b0, b1);
          mma_bf16(acc[j], af, b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue, element by element: (row r, column c) of the tile.
  float* cs = reinterpret_cast<float*>(smem);  // E_PROJ: [BM][BN + 1], over the dead tiles
  auto epi = [&](int r, int c, float v) {
    const int i = i0 + r, n = n0 + c;
    const bool in = i < nk && n < N;
    if (EPI == E_QKV) {
      if (in) static_cast<WT*>(a.qkv)[(size_t)i * N + n] = from_f<WT>(v + a.bqkv[n]);
    } else if (EPI == E_GAO) {
      if (in) static_cast<WT*>(a.gao)[(size_t)i * N + n] = from_f<WT>(v);
    } else if (EPI == E_GZ) {
      if (in) reinterpret_cast<float*>(a.qkv)[(size_t)i * N + n] = v;
    } else {
      float contrib = 0.f;
      if (in) {
        const size_t tk = token(a, i);
        if (a.keep[tk]) contrib = a.gh1[tk * N + n] * (v + a.bproj[n]);
      }
      cs[r * (BN + 1) + c] = contrib;
    }
  };
  if constexpr (FP32) {
    const int tm = tid >> 4, tn = tid & 15;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) epi(4 * tm + r, 4 * tn + c, acc[r][c]);
  } else {
    const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epi(wm * 16 + g + (e >> 1) * 8, wn * 32 + j * 8 + 2 * t + (e & 1), acc[j][e]);
  }
  if (EPI == E_PROJ) {
    // dls1: this block's column sums, rows in order.
    __syncthreads();
    if (tid < BN && n0 + tid < N) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += cs[r * (BN + 1) + tid];
      a.part_ls1[(size_t)blockIdx.y * N + n0 + tid] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. core: one block per (kept window, head), everything in shared memory.

// Elements k .. k + 3 of row `row` of a shared buffer stored [row][k], or,
// with TR, stored [k][row] (read transposed, one element at a time).
template <bool TR, typename T>
__device__ __forceinline__ float4 get4(const T* p, int ld, int row, int k) {
  if constexpr (TR) {
    return make_float4(to_f<T>(p[k * ld + row]), to_f<T>(p[(k + 1) * ld + row]),
                       to_f<T>(p[(k + 2) * ld + row]), to_f<T>(p[(k + 3) * ld + row]));
  } else {
    float v[4];
    load4(p + row * ld + k, true, v);
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}
// The permuted-k fragment pair of one row, as load_k4 (rounded to bf16).
template <bool TR, typename T>
__device__ __forceinline__ void frag_of(const T* p, int ld, int row, int k, uint32_t& lo,
                                        uint32_t& hi) {
  if constexpr (TR) {
    const float4 v = get4<true>(p, ld, row, k);
    lo = pack_bf16(v.x, v.y); hi = pack_bf16(v.z, v.w);
  } else {
    load_k4(p + row * ld + k, lo, hi);
  }
}

// out(m, n) = sum_k A(m, k) B(n, k) for m < 16 MT, n < N (N % 8 == 0, K % 16
// == 0), both operands in shared memory: A(m, k) is A[m][k], or A[k][m] with
// AT; B(n, k) is B[n][k], or B[k][n] with BT. bf16 weights: tensor cores, a
// warp task per 16 x 8 output tile; A in WT, or fp32 rounded (SPLIT false) or
// split into hi and lo (SPLIT true). fp32 weights: FMA, a warp task is 16
// rows x 32 columns, one column per lane.
template <int MT, bool SPLIT, bool AT, bool BT, typename WT, typename AE, typename Epi>
__device__ __forceinline__ void mm(const AE* A, int lda, const WT* B, int ldb, int N, int K,
                                   Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (std::is_same<WT, float>::value) {
    const int ntasks = MT * ((N + 31) / 32);
    for (int task = warp; task < ntasks; task += WARPS) {
      const int mt = task % MT;
      const int n = (task / MT) * 32 + lane;
      const bool valid = n < N;
      const int nb = valid ? n : N - 1;
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.f;
      for (int k0 = 0; k0 < K; k0 += 4) {
        const float4 bv = get4<BT>(B, ldb, nb, k0);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float4 av = get4<AT>(A, lda, mt * 16 + r, k0);
          float s = acc[r];
          s = fmaf(av.x, bv.x, s); s = fmaf(av.y, bv.y, s);
          s = fmaf(av.z, bv.z, s); s = fmaf(av.w, bv.w, s);
          acc[r] = s;
        }
      }
      if (valid) {
#pragma unroll
        for (int r = 0; r < 16; ++r) epi(mt * 16 + r, n, acc[r]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    for (int task = warp; task < MT * (N / 8); task += WARPS) {
      const int mt = task % MT, tile = task / MT;
      const int m = mt * 16 + g, n = tile * 8 + g;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < K; k0 += 16) {
        const int k = k0 + 4 * t;
        uint32_t b0, b1, af[4];
        frag_of<BT>(B, ldb, n, k, b0, b1);
        if constexpr (SPLIT) {
          uint32_t lo[4];
          split4(get4<AT>(A, lda, m, k), af[0], af[2], lo[0], lo[2]);
          split4(get4<AT>(A, lda, m + 8, k), af[1], af[3], lo[1], lo[3]);
          mma_bf16(acc, lo, b0, b1);
        } else {
          frag_of<AT>(A, lda, m, k, af[0], af[2]);
          frag_of<AT>(A, lda, m + 8, k, af[1], af[3]);
        }
        mma_bf16(acc, af, b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epi(mt * 16 + g + (e >> 1) * 8, tile * 8 + 2 * t + (e & 1), acc[e]);
    }
  }
}

// Shared-memory layout of the core (bytes), R = 16 MT rows.
struct CoreLayout {
  int ldq, ldp;  // elements: [R][dh] rows in WT, [R][R] fp32 rows
  int q, k, v, gao, p, ds, keep, total;
};

inline int align128(long long x) { return (int)((x + 127) / 128 * 128); }

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
  const int nk = kept_rows(a);
  if (blockIdx.x * ROWS >= nk) return;
  const int hw = a.hw, C = a.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const YT* y = static_cast<const YT*>(a.y);
  YT* dy = static_cast<YT*>(a.dy);
  const float* GZ = reinterpret_cast<const float*>(a.qkv);
  float sd[NJ], sb[NJ];  // this lane's column sums of g_z * xhat and g_z
#pragma unroll
  for (int q = 0; q < NJ; ++q) sd[q] = sb[q] = 0.f;
  for (int i = blockIdx.x * ROWS + warp; i < (blockIdx.x + 1) * ROWS && i < nk; i += WARPS) {
    const size_t tk = token(a, i);
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
// 8. split-K: part[s][m][n] = sum over kept rows i of split s of X[i][m] G[i][n]
// (X in WT, G fp32), and for the first row of tiles partb[s][n] = sum_i G[i][n].
// BK rows x 64 columns of T from (src, ld) at (r0, c0) into shared memory
// (row stride LD) by cp.async; rows at or beyond `rmax` and columns at or
// beyond `ld` read as zero. ld % 16 == 0.
template <int LD, typename T>
__device__ __forceinline__ void panel_async(T* dst, const T* src, int ld, int r0, int rmax,
                                            int c0) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = 64 / EPC;
  for (int c = threadIdx.x; c < BK * CPR; c += THREADS) {
    const int r = c / CPR, k = (c - r * CPR) * EPC;
    const bool valid = r0 + r < rmax && c0 + k < ld;
    cp_async16_zfill(dst + r * LD + k, valid ? src + (size_t)(r0 + r) * ld + c0 + k : src, valid);
  }
}

struct TnOp {
  const void* X; const float* G; float* part; float* partb; int Mo, No, chunk;
};

template <typename WT>
__global__ void __launch_bounds__(THREADS) tn_gemm_kernel(const Args a, const TnOp op) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDX = BM + 8, LDG = BN + 4;
  constexpr bool FP32 = std::is_same<WT, float>::value;
  const int nk = kept_rows(a);
  const int split = blockIdx.z;
  const int ib = split * op.chunk;
  if (ib >= nk) return;
  const int ie = min(ib + op.chunk, nk);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Mo = op.Mo, No = op.No;
  // NST stages of an X panel [BK][LDX] in WT and a G panel [BK][LDG] fp32.
  constexpr int XBYTES = (BK * LDX * (int)sizeof(WT) + 127) / 128 * 128;
  constexpr int STAGE = XBYTES + BK * LDG * 4;
  const WT* X = static_cast<const WT*>(op.X);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool colsum = blockIdx.y == 0 && tid < BN;
  float bsum = 0.f;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nsteps = (ie - ib + BK - 1) / BK;
  auto issue = [&](int it) {
    if (it < nsteps) {
      unsigned char* base = smem + (it % NST) * STAGE;
      panel_async<LDX>(reinterpret_cast<WT*>(base), X, Mo, ib + it * BK, ie, m0);
      panel_async<LDG>(reinterpret_cast<float*>(base + XBYTES), op.G, No, ib + it * BK, ie, n0);
    }
    cp_async_commit();
  };
  for (int it = 0; it < NST - 1; ++it) issue(it);
  for (int it = 0; it < nsteps; ++it) {
    issue(it + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();
    const WT* Xs = reinterpret_cast<const WT*>(smem + (it % NST) * STAGE);
    const float* Gs = reinterpret_cast<const float*>(smem + (it % NST) * STAGE + XBYTES);
    if (colsum)
      for (int r = 0; r < BK; ++r) bsum += Gs[r * LDG + tid];
    if constexpr (FP32) {
      const int tm = tid >> 4, tn = tid & 15;  // rows 4 tm .., columns 4 tn ..
      for (int r = 0; r < BK; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + r * LDX + 4 * tm);
        const float4 gv = *reinterpret_cast<const float4*>(Gs + r * LDG + 4 * tn);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, gs[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], gs[j], acc[i][j]);
      }
    } else {
      const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm .., columns 32 wn ..
      const int mat = lane >> 3, mr = lane & 7;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, Xs + (kk + mr + (mat >> 1) * 8) * LDX + wm * 16 + (mat & 1) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* gp = Gs + (kk + 2 * t) * LDG + wn * 32 + j * 8 + g;
          const float v0 = gp[0], v1 = gp[LDG], v2 = gp[8 * LDG], v3 = gp[9 * LDG];
          const float h0 = bf16_round(v0), h1 = bf16_round(v1), h2 = bf16_round(v2),
                      h3 = bf16_round(v3);
          mma_bf16(acc[j], af, pack_bf16(h0, h1), pack_bf16(h2, h3));
          mma_bf16(acc[j], af, pack_bf16(v0 - h0, v1 - h1), pack_bf16(v2 - h2, v3 - h3));
        }
      }
    }
    __syncthreads();
  }

  float* part = op.part + (size_t)split * Mo * No;
  auto put = [&](int m, int n, float v) {
    if (m0 + m < Mo && n0 + n < No) part[(size_t)(m0 + m) * No + n0 + n] = v;
  };
  if constexpr (FP32) {
    const int tm = tid >> 4, tn = tid & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) put(4 * tm + i, 4 * tn + j, acc[i][j]);
  } else {
    const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put(wm * 16 + g + (e >> 1) * 8, wn * 32 + j * 8 + 2 * t + (e & 1), acc[j][e]);
  }
  if (colsum && n0 + tid < No) op.partb[(size_t)split * No + n0 + tid] = bsum;
}

// ---------------------------------------------------------------------------
// 9. reduce: each gradient element sums its partials, units in order.
enum { U_SPLIT_Q = 0, U_SPLIT_P = 1, U_ROW_BLOCKS = 2, U_ROWS = 3 };
constexpr int NJOBS = 7;
// `lanes` threads sum one element (1, or a warp of 32 where a job can have
// many partials); each job's threads start on a warp boundary.
struct ReduceJob { float* dst; const float* src; int n; long long stride; int unit, lanes; };
struct ReduceArgs { ReduceJob job[NJOBS]; int total; };

__device__ __forceinline__ int job_threads(const ReduceJob& j) { return (j.n * j.lanes + 31) / 32 * 32; }

__global__ void __launch_bounds__(THREADS) reduce_kernel(const Args a, const ReduceArgs r) {
  int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= r.total) return;
  int j = 0;
  while (e >= job_threads(r.job[j])) { e -= job_threads(r.job[j]); ++j; }
  const ReduceJob& job = r.job[j];
  const int nk = kept_rows(a);
  int units = (nk + ROWS - 1) / ROWS;
  if (job.unit == U_SPLIT_Q) units = (nk + a.chunk_q - 1) / a.chunk_q;
  else if (job.unit == U_SPLIT_P) units = (nk + a.chunk_p - 1) / a.chunk_p;
  else if (job.unit == U_ROW_BLOCKS) units = (nk + BM - 1) / BM;
  const int lane = e % job.lanes;
  e /= job.lanes;
  // Fixed order: lane l takes units l, l + lanes, ... into four partial sums
  // (four loads in flight), then the lanes' sums meet in a fixed butterfly.
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  if (e < job.n) {
    int u = lane;
    for (; u + 3 * job.lanes < units; u += 4 * job.lanes)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[q] += job.src[(size_t)(u + q * job.lanes) * job.stride + e];
    for (int q = 0; u < units; u += job.lanes, ++q) p[q] += job.src[(size_t)u * job.stride + e];
  }
  float sum = (p[0] + p[1]) + (p[2] + p[3]);
  if (job.lanes == 32) sum = warp_sum(sum);
  if (e < job.n && lane == 0) job.dst[e] = sum;
}

// ---------------------------------------------------------------------------
// Host side.

struct Plan {
  long long off[16];  // workspace offsets, in the order of Args' workspace fields
  long long bytes;
  CoreLayout core;
  int nsq, nsp, chunk_q, chunk_p, rb;
};

inline int sm_count(int* sms) {
  static int known = 0;
  if (known == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&known, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = known;
  return 0;
}

// Split-K of one weight gradient: enough splits that the card has
// SPLIT_BLOCKS_PER_SM blocks per SM when every window is kept.
inline void split_k(int rows, int tiles, int sms, int* nsplit, int* chunk) {
  int want = (SPLIT_BLOCKS_PER_SM * sms + tiles - 1) / tiles;
  if (want < 1) want = 1;
  int c = (rows + want - 1) / want;
  c = (c + BK - 1) / BK * BK;
  *chunk = c;
  *nsplit = (rows + c - 1) / c;
}

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
  const int M = a.M, C = a.C, N3 = 3 * C;
  const dim3 rb_c((C + BN - 1) / BN, P.rb), rb_3c((N3 + BN - 1) / BN, P.rb);
  // NST stages of an A and a B tile; A in WT or fp32.
  const size_t tiles = NST * BM * LDK * (2 * sizeof(WT));
  const size_t tiles_f32 = NST * BM * LDK * (sizeof(float) + sizeof(WT));
  // Above 48 KB of dynamic shared memory a kernel needs the attribute: set
  // once per instantiation of this library.
  static bool ready = false;
  if (!ready) {
    const void* kernels[] = {
        (const void*)core_kernel<WT, MT>, (const void*)rows_gemm_kernel<WT, WT, E_QKV>,
        (const void*)rows_gemm_kernel<WT, float, E_GAO>, (const void*)rows_gemm_kernel<WT, WT, E_PROJ>,
        (const void*)rows_gemm_kernel<WT, float, E_GZ>, (const void*)tn_gemm_kernel<WT>};
    for (const void* k : kernels) {
      const cudaError_t e =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
      if (e != cudaSuccess) return (int)e;
    }
    ready = true;
  }
  const int row_blocks = (M * a.hw + ROWS - 1) / ROWS;
  prep_kernel<YT, WT><<<row_blocks, THREADS, 0, s>>>(a);
  rows_gemm_kernel<WT, WT, E_QKV><<<rb_3c, THREADS, tiles, s>>>(a, GemmOp{a.zr, a.wqkv, N3, C, 0});
  rows_gemm_kernel<WT, float, E_GAO><<<rb_c, THREADS, tiles_f32, s>>>(a, GemmOp{a.gp, a.wproj_io, C, C, 0});
  const dim3 heads(a.heads, M);
  core_kernel<WT, MT><<<heads, THREADS, P.core.total, s>>>(a, P.core);
  rows_gemm_kernel<WT, WT, E_PROJ><<<rb_c, THREADS, tiles, s>>>(a, GemmOp{a.ao, a.wproj, C, C, 0});
  rows_gemm_kernel<WT, float, E_GZ><<<rb_c, THREADS, tiles_f32, s>>>(a, GemmOp{a.gq, a.wqkv_io, C, N3, 0});
  finish_kernel<YT><<<row_blocks, THREADS, WARPS * 2 * C * sizeof(float), s>>>(a);
  const size_t tn_smem =
      NST * (align128((long long)BK * (BM + 8) * sizeof(WT)) + BK * (BN + 4) * sizeof(float));
  const dim3 gq((N3 + BN - 1) / BN, (C + BM - 1) / BM, P.nsq), gp((C + BN - 1) / BN, (C + BM - 1) / BM, P.nsp);
  tn_gemm_kernel<WT><<<gq, THREADS, tn_smem, s>>>(
      a, TnOp{a.zr, a.gq, a.part_wqkv, a.part_bqkv, C, N3, a.chunk_q});
  tn_gemm_kernel<WT><<<gp, THREADS, tn_smem, s>>>(
      a, TnOp{a.ao, a.gp, a.part_wproj, a.part_bproj, C, C, a.chunk_p});
  ReduceArgs r;
  const long long cc3 = (long long)C * N3, cc = (long long)C * C;
  // A warp per element where a job has more than 64 partials at most.
  const int rows = M * a.hw;
  auto lanes = [](long long units) { return units > 64 ? 32 : 1; };
  const int lq = lanes(P.nsq), lp = lanes(P.nsp), lrb = lanes(P.rb),
            lrows = lanes((rows + ROWS - 1) / ROWS);
  r.job[0] = ReduceJob{a.dwqkv, a.part_wqkv, (int)cc3, cc3, U_SPLIT_Q, lq};
  r.job[1] = ReduceJob{a.dbqkv, a.part_bqkv, N3, N3, U_SPLIT_Q, lq};
  r.job[2] = ReduceJob{a.dwproj, a.part_wproj, (int)cc, cc, U_SPLIT_P, lp};
  r.job[3] = ReduceJob{a.dbproj, a.part_bproj, C, C, U_SPLIT_P, lp};
  r.job[4] = ReduceJob{a.dls1, a.part_ls1, C, C, U_ROW_BLOCKS, lrb};
  r.job[5] = ReduceJob{a.ds2, a.part_ln, C, 2 * C, U_ROWS, lrows};
  r.job[6] = ReduceJob{a.db2, a.part_ln + C, C, 2 * C, U_ROWS, lrows};
  r.total = 0;
  for (int j = 0; j < NJOBS; ++j) r.total += (r.job[j].n * r.job[j].lanes + 31) / 32 * 32;
  const int rblocks = (r.total + THREADS - 1) / THREADS;
  reduce_kernel<<<rblocks, THREADS, 0, s>>>(a, r);
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
