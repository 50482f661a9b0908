// The masked SAST block of one attention window, for sm_90a: the device
// routine shared by the fused (every window), sparse (kept windows, one
// block per work-list slot) and looped (kept windows, persistent grid)
// block kernels.
//
// Replaces the bodies of the TPU kernels _tile_kernel
// (sast_tpu/ops/pallas/fused_block.py), _block_kernel and _looped_kernel
// (sast_tpu/ops/pallas/sparse_block.py), which all compute _fwd_window:
//   z   = where(keep, LN2(y), y)                  two-pass variance, fp32
//   per head: q,k,v = z Wqkv + b;  P = softmax(mask(q k^T * dh^-0.5));  P v
//   h1  = z + ls1 * (attn_out Wproj + b)
//   h2  = h1 + ls2 * ((val * gelu_tanh(gate)) Wout + b),  [val|gate] = h1 Wglu + b
//   out = where(keep, h2, y)
// Activations are fp32; the operands of every product are rounded to the
// weights' type WT (bf16 or float); products accumulate in fp32.
//
// What bounds it on an H100: operations. One window is 2*hw*(4 C^2 + 3 C I)
// + 4 hw^2 C operations (gen4-base stage 4: 0.37 GFLOP) against hw*C tokens
// in and out, and the weights come from the 50 MB L2, not from device
// memory, after the first block. The design: one thread block of 8 warps
// owns one window. z/h1 stay on chip in fp32 for the whole block (the
// residuals and LN2 need fp32). Nothing 3C- or 2I-wide is ever whole: q, k, v
// exist for one head at a time, and the gated activation m is the only
// I-wide buffer. Where a buffer does not fit the 227 KB of shared memory
// (attn_out and m at C = 512, m in fp32 at C = 256) it lives in a per-block
// scratch in device memory that the wrapper allocates and that stays in L2;
// plan() decides, and the kernel reads either through one generic pointer.
// Weights are never staged: each warp reads its B fragments straight from
// global memory (L2), as (out, in) rows, so every block re-reads all four
// matrices once per window; that re-read is the price of skipping windows
// and the reason a batched matrix product wins when most windows are kept.
//
// Products, bf16 weights: mma.sync.m16n8k16 (bf16 x bf16 -> fp32). A warp
// task is all row tiles x NT column tiles; A fragments come from shared
// memory (fp32 buffers are rounded to bf16 in the load), B fragments from
// the (out, in) weight rows. Both operands use the same permutation of k
// inside each block of 16 (a thread takes 4 consecutive k for its two
// fragment halves), which turns every fragment load into one 8- or 16-byte
// load; a dot product does not care about the order of k. Rows pad from hw
// to 64 or 80 with zero rows of z that are never stored. fp32 weights: plain
// FMA (no TF32), a warp task is 16 rows x 32 columns, one column per lane.
//
// Buffers, per block (R = 64 or 80 rows, +16 elements of row padding
// against bank conflicts): shared: zf R x C fp32 (z, then h1); keep R;
// qh, kh R x dh and vt dh x R in WT; P R x R fp32; shared or scratch:
// attn_out R x C in WT; m R x I in WT, which overlays qh..attn_out (dead by
// then); looped mode only, where it fits: one window of raw y as the
// cp.async landing buffer of the next slot.

#pragma once

#include <type_traits>

#include "common.cuh"

// Everything is internal to the translation unit that includes this file:
// two libraries are built from it and loaded into one process, and the
// remembered launch state below must not be shared between them (static
// locals of templates with external linkage are process-wide).
namespace wb {
namespace {

using namespace sast;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 16;
constexpr long long SMEM_LIMIT = 227 * 1024;
constexpr int MAX_BLOCKS_PER_SM = 4;  // looped grid: at most this many per SM

enum Mode { FUSED = 0, SPARSE = 1, LOOPED = 2 };

// Byte offsets into dynamic shared memory; attn / m / pf are -1 where the
// buffer is not in shared memory (attn, m: in the scratch; pf: no prefetch).
struct Layout {
  int zf, keep, qh, kh, vt, p, attn, m, pf, total;
  long long attn_scratch, m_scratch, scratch_per_block;
};

struct Args {
  const void* y;
  const unsigned char* keep;
  void* out;
  float* h1;        // null unless the caller wants the residual
  const int* ids;   // work list (sparse, looped)
  const int* n_win; // kept windows, on the device
  const float *ln2s, *ln2b;
  const void* wqkv; const float* bqkv;
  const void* wproj; const float* bproj; const float* ls1;
  const void* wglu; const float* bglu;
  const void* wout; const float* bout; const float* ls2;
  unsigned char* scratch;
  int M, hw, C, I, heads, dh, mode;
  float eps, scale;
  Layout L;
};

inline long long align128(long long x) { return (x + 127) / 128 * 128; }

// Shared-memory and scratch layout of one block. False if even the
// mandatory buffers do not fit.
inline bool plan(int mode, int hw, int C, int I, int dh, int ybytes, int wbytes, Layout* L) {
  const long long R = hw <= 64 ? 64 : 80;
  long long off = 0;
  L->zf = (int)off; off += align128(R * (C + PAD) * 4);
  L->keep = (int)off; off += align128(R);
  const long long region = off;
  L->qh = (int)off; off += align128(R * (dh + PAD) * wbytes);
  L->kh = (int)off; off += align128(R * (dh + PAD) * wbytes);
  L->vt = (int)off; off += align128(dh * (R + PAD) * wbytes);
  L->p = (int)off; off += align128(R * (R + PAD) * 4);
  if (off > SMEM_LIMIT) return false;
  const long long attn_b = align128(R * (C + PAD) * wbytes);
  const long long m_b = align128(R * (I + PAD) * wbytes);
  const long long pf_b = align128((long long)hw * C * ybytes);
  long long end = off;
  L->attn = -1;
  if (off + attn_b <= SMEM_LIMIT) { L->attn = (int)off; end = off + attn_b; }
  L->m = -1;
  if (region + m_b <= SMEM_LIMIT) { L->m = (int)region; if (region + m_b > end) end = region + m_b; }
  L->pf = -1;
  if (mode == LOOPED && end + pf_b <= SMEM_LIMIT) { L->pf = (int)end; end += pf_b; }
  L->total = (int)end;
  long long s = 0;
  L->attn_scratch = s; if (L->attn < 0) s += attn_b;
  L->m_scratch = s; if (L->m < 0) s += m_b;
  L->scratch_per_block = s;
  return true;
}

// out(m, n)[b] = sum_k A[m][k] * brow(b, n)[k] for m < 16 MT, n < N, on the
// tensor cores. brow(b, n) is row n of the b-th (out, in) operand. N % 8 == 0,
// K % 16 == 0. epi(m, n, v) gets the NB sums of one output element.
template <int MT, int NT, int NB, typename AT, typename BRow, typename Epi>
__device__ __forceinline__ void gemm_mma(const AT* A, int lda, BRow brow, int N, int K, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = N >> 3;
  const int ntasks = (ntiles + NT - 1) / NT;
  for (int task = warp; task < ntasks; task += WARPS) {
    float acc[NB][MT][NT][4];
    const __nv_bfloat16* bp[NB][NT];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int tile = min(task * NT + j, ntiles - 1);
        bp[b][j] = brow(b, tile * 8 + g) + 4 * t;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[b][mt][j][e] = 0.f;
      }
    const AT* ap = A + g * lda + 4 * t;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        load_k4(ap + (mt * 16) * lda + k0, a[mt][0], a[mt][2]);
        load_k4(ap + (mt * 16 + 8) * lda + k0, a[mt][1], a[mt][3]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 bv = *reinterpret_cast<const uint2*>(bp[b][j] + k0);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[b][mt][j], a[mt], bv.x, bv.y);
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int tile = task * NT + j;
      if (tile >= ntiles) break;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) v[b] = acc[b][mt][j][e];
          epi(mt * 16 + g + (e >> 1) * 8, tile * 8 + 2 * t + (e & 1), v);
        }
    }
  }
}

// The same function in fp32 FMA: a warp task is 16 rows x 32 columns, one
// column per lane; A rows are broadcast reads. K % 4 == 0.
template <int MT, int NB, typename BRow, typename Epi>
__device__ __forceinline__ void gemm_fma(const float* A, int lda, BRow brow, int N, int K, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntasks = MT * ((N + 31) / 32);
  for (int task = warp; task < ntasks; task += WARPS) {
    const int mt = task % MT;
    const int n = (task / MT) * 32 + lane;
    const bool valid = n < N;
    const float* bp[NB];
    float acc[NB][16];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      bp[b] = brow(b, valid ? n : N - 1);
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[b][r] = 0.f;
    }
    const float* ap = A + (mt * 16) * lda;
    for (int k0 = 0; k0 < K; k0 += 4) {
      float4 bv[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) bv[b] = *reinterpret_cast<const float4*>(bp[b] + k0);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(ap + r * lda + k0);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float s = acc[b][r];
          s = fmaf(av.x, bv[b].x, s);
          s = fmaf(av.y, bv[b].y, s);
          s = fmaf(av.z, bv[b].z, s);
          s = fmaf(av.w, bv[b].w, s);
          acc[b][r] = s;
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float v[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) v[b] = acc[b][r];
        epi(mt * 16 + r, n, v);
      }
    }
  }
}

template <int MT, int NT, int NB, typename WT, typename AT, typename BRow, typename Epi>
__device__ __forceinline__ void block_gemm(const AT* A, int lda, BRow brow, int N, int K, Epi epi) {
  if constexpr (std::is_same<WT, float>::value) {
    gemm_fma<MT, NB>(A, lda, brow, N, K, epi);
  } else {
    gemm_mma<MT, NT, NB, AT>(A, lda, brow, N, K, epi);
  }
}

// Four consecutive tokens' channels of a window as fp32.
__device__ __forceinline__ float4 load_y4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_y4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

// Window `wid` into zf (fp32, zero rows from hw to R) and its keep flags.
// `src` is the window's hw x C tokens, in global memory or in the landing
// buffer of the prefetch.
template <typename YT, int MT>
__device__ void load_window(const Args& a, int wid, const YT* src, float* zf,
                            unsigned char* skeep) {
  constexpr int R = MT * 16;
  const int C = a.C, ldz = C + PAD;
  for (int idx = threadIdx.x * 4; idx < R * C; idx += THREADS * 4) {
    const int r = idx / C, c = idx - r * C;
    const float4 v = r < a.hw ? load_y4(src + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(zf + r * ldz + c) = v;
  }
  for (int r = threadIdx.x; r < R; r += THREADS)
    skeep[r] = r < a.hw ? a.keep[(size_t)wid * a.hw + r] : 0;
}

// LN2 in place on the kept rows of zf (common.cuh row_stats). No barrier
// inside.
template <int MT>
__device__ __forceinline__ void ln2_rows(const Args& a, float* zf, const unsigned char* skeep) {
  const int C = a.C, ldz = C + PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < a.hw; r += WARPS) {
    if (!skeep[r]) continue;
    float* zr = zf + r * ldz;
    float mu, rstd;
    row_stats([&](int c) { return zr[c]; }, C, a.eps, mu, rstd);
    for (int c = lane; c < C; c += 32) zr[c] = layer_norm(zr[c], mu, rstd, a.ln2s[c], a.ln2b[c]);
  }
}

// Head h of the window in zf: q, k (R x dh) and v transposed (dh x R) in WT,
// and the softmax P (R x R fp32; rows below hw, pad keys 0). Ends with a
// barrier.
template <typename WT, int MT>
__device__ __forceinline__ void head_probs(const Args& a, int h, const float* zf, const unsigned char* skeep,
                           WT* qh, WT* kh, WT* vt, float* P) {
  constexpr int R = MT * 16;
  const int hw = a.hw, C = a.C, dh = a.dh;
  const int ldz = C + PAD, ldq = dh + PAD, ldv = R + PAD, ldp = R + PAD;
  const int warp = threadIdx.x >> 5;
  const WT* wqkv = static_cast<const WT*>(a.wqkv);
  // q, k, v of this head: columns [sec * C + h * dh, + dh) of z Wqkv.
  block_gemm<MT, 1, 1, WT>(
      zf, ldz,
      [&](int, int n) {
        const int sec = n / dh;
        return wqkv + (size_t)(sec * C + h * dh + (n - sec * dh)) * C;
      },
      3 * dh, C,
      [&](int m, int n, const float (&v)[1]) {
        const int sec = n / dh, d = n - sec * dh;
        const WT w = from_f<WT>(v[0] + a.bqkv[sec * C + h * dh + d]);
        if (sec == 0) qh[m * ldq + d] = w;
        else if (sec == 1) kh[m * ldq + d] = w;
        else vt[d * ldv + m] = w;
      });
  __syncthreads();
  // logits = q k^T * scale; masked keys get exactly MASK_VALUE.
  block_gemm<MT, 1, 1, WT>(
      qh, ldq, [&](int, int n) { return kh + n * ldq; }, R, dh,
      [&](int m, int n, const float (&v)[1]) {
        P[m * ldp + n] = masked_logit(skeep[n], v[0], a.scale);
      });
  __syncthreads();
  // Softmax over the hw real keys; the pad keys get weight 0.
  for (int r = warp; r < hw; r += WARPS) softmax_row(P + r * ldp, hw, R);
  __syncthreads();
}

// The block on the window held in zf. Ends with a barrier. With `alias`
// the output buffer is the input buffer, so unkept tokens are left alone.
template <typename YT, typename WT, int MT>
__device__ void compute_window(const Args& a, int wid, unsigned char* smem, unsigned char* scratch,
                               bool alias) {
  constexpr int R = MT * 16;
  const int hw = a.hw, C = a.C, I = a.I, dh = a.dh;
  const int ldz = C + PAD, ldv = R + PAD, ldp = R + PAD, lda = C + PAD, ldm = I + PAD;
  float* zf = reinterpret_cast<float*>(smem + a.L.zf);
  const unsigned char* skeep = smem + a.L.keep;
  WT* qh = reinterpret_cast<WT*>(smem + a.L.qh);
  WT* kh = reinterpret_cast<WT*>(smem + a.L.kh);
  WT* vt = reinterpret_cast<WT*>(smem + a.L.vt);
  float* P = reinterpret_cast<float*>(smem + a.L.p);
  WT* attn = reinterpret_cast<WT*>(a.L.attn >= 0 ? smem + a.L.attn : scratch + a.L.attn_scratch);
  WT* mbuf = reinterpret_cast<WT*>(a.L.m >= 0 ? smem + a.L.m : scratch + a.L.m_scratch);
  const WT* wproj = static_cast<const WT*>(a.wproj);
  const WT* wglu = static_cast<const WT*>(a.wglu);
  const WT* wout = static_cast<const WT*>(a.wout);
  const size_t base = (size_t)wid * hw * C;

  __syncthreads();
  ln2_rows<MT>(a, zf, skeep);
  __syncthreads();

  for (int h = 0; h < a.heads; ++h) {
    head_probs<WT, MT>(a, h, zf, skeep, qh, kh, vt, P);
    block_gemm<MT, 1, 1, WT>(
        P, ldp, [&](int, int n) { return vt + n * ldv; }, dh, R,
        [&](int m, int n, const float (&v)[1]) { attn[m * lda + h * dh + n] = from_f<WT>(v[0]); });
    __syncthreads();
  }

  // h1 = z + ls1 * (attn_out Wproj + b), in place over z.
  block_gemm<MT, 2, 1, WT>(
      attn, lda, [&](int, int n) { return wproj + (size_t)n * C; }, C, C,
      [&](int m, int n, const float (&v)[1]) {
        const float h1v = zf[m * ldz + n] + a.ls1[n] * (v[0] + a.bproj[n]);
        zf[m * ldz + n] = h1v;
        if (a.h1 != nullptr && m < hw) a.h1[base + (size_t)m * C + n] = h1v;
      });
  __syncthreads();
  // m = val * gelu(gate), [val | gate] = h1 Wglu + b; m overlays qh..attn.
  block_gemm<MT, 2, 2, WT>(
      zf, ldz, [&](int b, int n) { return wglu + (size_t)(b * I + n) * C; }, I, C,
      [&](int m, int n, const float (&v)[2]) {
        const float val = v[0] + a.bglu[n], gate = v[1] + a.bglu[I + n];
        mbuf[m * ldm + n] = from_f<WT>(val * gelu_tanh(gate));
      });
  __syncthreads();
  const YT* yin = static_cast<const YT*>(a.y);
  YT* out = static_cast<YT*>(a.out);
  block_gemm<MT, 2, 1, WT>(
      mbuf, ldm, [&](int, int n) { return wout + (size_t)n * I; }, C, I,
      [&](int m, int n, const float (&v)[1]) {
        if (m >= hw) return;
        const size_t o = base + (size_t)m * C + n;
        if (skeep[m]) out[o] = from_f<YT>(zf[m * ldz + n] + a.ls2[n] * (v[0] + a.bout[n]));
        else if (!alias) out[o] = yin[o];
      });
  __syncthreads();
}

template <typename YT, typename WT, int MT>
__global__ void __launch_bounds__(THREADS) window_block_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* scratch = a.scratch + (size_t)blockIdx.x * a.L.scratch_per_block;
  const YT* y = static_cast<const YT*>(a.y);
  const size_t wsize = (size_t)a.hw * a.C;
  if (a.mode == FUSED) {
    const int wid = blockIdx.x;
    load_window<YT, MT>(a, wid, y + wid * wsize, reinterpret_cast<float*>(smem + a.L.zf),
                        smem + a.L.keep);
    compute_window<YT, WT, MT>(a, wid, smem, scratch, false);
  } else if (a.mode == SPARSE) {
    const int wid = a.ids[blockIdx.x];
    if ((int)blockIdx.x >= *a.n_win) {
      // Unkept window: pass y through (and as h1, which no backward reads).
      YT* out = static_cast<YT*>(a.out);
      for (size_t i = threadIdx.x; i < wsize; i += THREADS) {
        const YT v = y[wid * wsize + i];
        out[wid * wsize + i] = v;
        if (a.h1 != nullptr) a.h1[wid * wsize + i] = to_f<YT>(v);
      }
      return;
    }
    load_window<YT, MT>(a, wid, y + wid * wsize, reinterpret_cast<float*>(smem + a.L.zf),
                        smem + a.L.keep);
    compute_window<YT, WT, MT>(a, wid, smem, scratch, false);
  } else {
    // Persistent walk over the kept slots; out aliases y. While a window is
    // computed, the next one lands in the prefetch buffer.
    const int n = *a.n_win;
    const bool pf = a.L.pf >= 0;
    YT* land = reinterpret_cast<YT*>(smem + (pf ? a.L.pf : 0));
    const int wbytes = (int)(wsize * sizeof(YT));
    auto prefetch = [&](int wid) {
      const char* src = reinterpret_cast<const char*>(y + wid * wsize);
      for (int off = threadIdx.x * 16; off < wbytes; off += THREADS * 16)
        cp_async16(reinterpret_cast<char*>(land) + off, src + off);
      cp_async_commit();
    };
    int slot = blockIdx.x;
    if (pf && slot < n) prefetch(a.ids[slot]);
    for (; slot < n; slot += gridDim.x) {
      const int wid = a.ids[slot];
      if (pf) {
        cp_async_wait<0>();
        __syncthreads();
      }
      load_window<YT, MT>(a, wid, pf ? land : y + wid * wsize,
                          reinterpret_cast<float*>(smem + a.L.zf), smem + a.L.keep);
      __syncthreads();
      const int next = slot + gridDim.x;
      if (pf && next < n) prefetch(a.ids[next]);
      compute_window<YT, WT, MT>(a, wid, smem, scratch, true);
    }
  }
}

// Grid of one launch: a block per window or slot; in looped mode at most
// the blocks the card holds at once (SMs x blocks per SM, capped). The
// attribute and the occupancy are asked of the CUDA runtime once per shared-memory
// size of this instantiation and then remembered: the calls cost more host
// time than the launch.
template <typename YT, typename WT, int MT>
int grid_of(const Args& a, int* grid) {
  auto kernel = window_block_kernel<YT, WT, MT>;
  constexpr int SLOTS = 16;  // shared-memory sizes remembered (a model has 4)
  static int known_total[SLOTS];
  static int known_resident[SLOTS];
  static int n_known = 0;
  int resident = 0;
  for (int i = 0; i < n_known; ++i)
    if (known_total[i] == a.L.total) resident = known_resident[i];
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, a.L.total);
    if (e != cudaSuccess) return (int)e;
    per_sm = per_sm < 1 ? 1 : (per_sm > MAX_BLOCKS_PER_SM ? MAX_BLOCKS_PER_SM : per_sm);
    resident = sms * per_sm;
    known_total[n_known % SLOTS] = a.L.total;
    known_resident[n_known % SLOTS] = resident;
    if (n_known < SLOTS) ++n_known;
  }
  *grid = a.M;
  if (a.mode == LOOPED && resident < a.M) *grid = resident;
  return 0;
}

template <typename YT, typename WT, int MT>
int launch_as(const Args& a, long long scratch_bytes, cudaStream_t stream) {
  int grid = 0;
  const int rc = grid_of<YT, WT, MT>(a, &grid);
  if (rc != 0) return rc;
  if (scratch_bytes < (long long)grid * a.L.scratch_per_block) return (int)cudaErrorInvalidValue;
  window_block_kernel<YT, WT, MT><<<grid, THREADS, a.L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

// Calls fn.template operator()<YT, WT, MT>() for the built combination.
template <typename F>
int dispatch(int hw, int y_bf16, int w_bf16, F fn) {
  if (y_bf16 && !w_bf16) return (int)cudaErrorInvalidValue;
  if (hw <= 64) {
    if (!w_bf16) return fn.template operator()<float, float, 4>();
    if (y_bf16) return fn.template operator()<__nv_bfloat16, __nv_bfloat16, 4>();
    return fn.template operator()<float, __nv_bfloat16, 4>();
  }
  if (!w_bf16) return fn.template operator()<float, float, 5>();
  if (y_bf16) return fn.template operator()<__nv_bfloat16, __nv_bfloat16, 5>();
  return fn.template operator()<float, __nv_bfloat16, 5>();
}

struct LaunchFn {
  const Args& a; long long scratch_bytes; cudaStream_t stream;
  template <typename YT, typename WT, int MT> int operator()() const {
    return launch_as<YT, WT, MT>(a, scratch_bytes, stream);
  }
};

struct GridFn {
  const Args& a; int* grid;
  template <typename YT, typename WT, int MT> int operator()() const {
    return grid_of<YT, WT, MT>(a, grid);
  }
};

// Bytes of scratch one launch needs; -1 if the window does not fit shared
// memory, -2 on a CUDA error.
inline long long scratch_bytes(int mode, int M, int hw, int C, int I, int dh, int y_bf16,
                               int w_bf16) {
  Args a{};
  a.M = M; a.hw = hw; a.C = C; a.I = I; a.dh = dh; a.mode = mode;
  if (hw > 80 || !plan(mode, hw, C, I, dh, y_bf16 ? 2 : 4, w_bf16 ? 2 : 4, &a.L)) return -1;
  int grid = 0;
  if (dispatch(hw, y_bf16, w_bf16, GridFn{a, &grid}) != 0) return -2;
  return (long long)grid * a.L.scratch_per_block;
}

inline int launch(int mode, const void* y, const void* keep, void* out, void* h1, const void* ids,
                  const void* n_win, const void* const* w, void* scratch, long long nscratch,
                  int M, int hw, int C, int I, int heads, int dh, float eps, int y_bf16,
                  int w_bf16, void* stream) {
  Args a{};
  a.y = y; a.keep = static_cast<const unsigned char*>(keep); a.out = out;
  a.h1 = static_cast<float*>(h1);
  a.ids = static_cast<const int*>(ids); a.n_win = static_cast<const int*>(n_win);
  a.ln2s = static_cast<const float*>(w[0]); a.ln2b = static_cast<const float*>(w[1]);
  a.wqkv = w[2]; a.bqkv = static_cast<const float*>(w[3]);
  a.wproj = w[4]; a.bproj = static_cast<const float*>(w[5]);
  a.ls1 = static_cast<const float*>(w[6]);
  a.wglu = w[7]; a.bglu = static_cast<const float*>(w[8]);
  a.wout = w[9]; a.bout = static_cast<const float*>(w[10]);
  a.ls2 = static_cast<const float*>(w[11]);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.M = M; a.hw = hw; a.C = C; a.I = I; a.heads = heads; a.dh = dh; a.mode = mode;
  a.eps = eps;
  a.scale = (float)(1.0 / sqrt((double)dh));
  if (hw > 80 || C % 16 || dh % 16 || I % 16 || heads * dh != C || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (mode != FUSED && (ids == nullptr || n_win == nullptr)) return (int)cudaErrorInvalidValue;
  if (!plan(mode, hw, C, I, dh, y_bf16 ? 2 : 4, w_bf16 ? 2 : 4, &a.L))
    return (int)cudaErrorInvalidValue;
  return dispatch(hw, y_bf16, w_bf16, LaunchFn{a, nscratch, static_cast<cudaStream_t>(stream)});
}

}  // namespace
}  // namespace wb

// The C entry points of one library: NAME launches, NAME_scratch_bytes sizes
// the scratch. Weights come in the order ln2_scale, ln2_bias, wqkv, bqkv,
// wproj, bproj, ls1, wglu, bglu, wout, bout, ls2; matrices as (out, in) rows.
#define SAST_WINDOW_BLOCK_ENTRY(NAME)                                                          \
  extern "C" int NAME(int mode, const void* y, const void* keep, void* out, void* h1,          \
                      const void* ids, const void* n_win, const void* w0, const void* w1,      \
                      const void* w2, const void* w3, const void* w4, const void* w5,          \
                      const void* w6, const void* w7, const void* w8, const void* w9,          \
                      const void* w10, const void* w11, void* scratch, long long nscratch,     \
                      int M, int hw, int C, int I, int heads, int dh, float eps, int y_bf16,   \
                      int w_bf16, void* stream) {                                              \
    const void* w[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};                    \
    return wb::launch(mode, y, keep, out, h1, ids, n_win, w, scratch, nscratch, M, hw, C, I,   \
                      heads, dh, eps, y_bf16, w_bf16, stream);                                 \
  }                                                                                            \
  extern "C" long long NAME##_scratch_bytes(int mode, int M, int hw, int C, int I, int dh,     \
                                            int y_bf16, int w_bf16) {                          \
    return wb::scratch_bytes(mode, M, hw, C, I, dh, y_bf16, w_bf16);                           \
  }
