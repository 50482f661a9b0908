// Tile products over the kept rows of a work list, for sm_90a: the machinery
// that the block kernels written as launches over the kept tokens share
// (attn_bwd.cu, kernel H; mlp_bwd.cu, kernel G; sparse_fwd.cu, kernel E).
//
// Row i of a launch is token i % hw of window ids[i / hw], for i < n_win hw;
// n_win is read on the device, and blocks beyond it return at once. The
// intermediates over those rows are compact: row i of a workspace buffer.
//   rows_gemm_kernel  out[i][n] = sum_k A[i][k] B(n, k): 64 x 64 tiles, k in
//                     steps of 32 through a ring of NST cp.async stages, the
//                     result staged in shared memory for an epilogue functor
//                     (coalesced stores, per-block column sums, paired columns)
//   tn_gemm_kernel    split-K X^T G (X in WT, G fp32 split into bf16 hi + lo)
//                     into per-split partials, with G's column sums
//   reduce_kernel     every partial summed in a fixed order: no float atomics,
//                     so the results are the same bits from run to run
//   mm                a product of two shared-memory tiles inside one block
// bf16 weights run on the tensor cores (mma.sync.m16n8k16, fp32 sums); fp32
// weights run the same tiles in fp32 FMA (no TF32).
//
// Include this file INSIDE the including source's own anonymous namespace,
// after common.cuh, <type_traits> and `using namespace sast;`. Then every
// kernel, launch helper and remembered launch state here is private to that
// library: static locals of templates with external linkage are shared
// between two libraries loaded into one process, and an anonymous namespace
// of a header's own, brought in beside the source's, makes nvcc's generated
// launch stubs name an ambiguous namespace.

#pragma once

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long SMEM_LIMIT = 227 * 1024;
constexpr int BM = 64, BN = 64, BK = 32;  // GEMM tiles
constexpr int LDK = BK + 8;               // [row][k] tiles, elements
constexpr int LDN = BN + 8;               // [k][n] tiles of a transposed B, elements
constexpr int LDC = BN + 1;               // the staged result, fp32
constexpr int NST = 3;                    // cp.async stages of the GEMM tiles
constexpr int SPLIT_BLOCKS_PER_SM = 8;    // split-K target at full density

inline int align128(long long x) { return (int)((x + 127) / 128 * 128); }

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The rows of one launch: the work list and the window size.
struct Rows {
  const int* ids;    // kept-first window ids
  const int* n_win;  // kept windows, on the device
  int hw;
};
__device__ __forceinline__ int kept_rows(const Rows& w) { return *w.n_win * w.hw; }
// Token index (window id * hw + r) of kept row i.
__device__ __forceinline__ size_t token(const Rows& w, int i) {
  const int slot = i / w.hw;
  return (size_t)w.ids[slot] * w.hw + (i - slot * w.hw);
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8j .. 8j + 7 give the
// row addresses of matrix j. With .trans a lane gets a column pair of each.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// Two consecutive k of a row as one packed bf16 pair (fp32 rows are rounded).
__device__ __forceinline__ uint32_t load_k2(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }
__device__ __forceinline__ uint32_t load_k2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}

// Four consecutive k of an fp32 row as load_k4 (common.cuh) takes them, as
// hi = RN(x) and lo = RN(x - hi).
__device__ __forceinline__ void split4(const float4 v, uint32_t& hlo, uint32_t& hhi,
                                       uint32_t& llo, uint32_t& lhi) {
  const float a = bf16_round(v.x), b = bf16_round(v.y), c = bf16_round(v.z), d = bf16_round(v.w);
  hlo = pack_bf16(a, b); hhi = pack_bf16(c, d);
  llo = pack_bf16(v.x - a, v.y - b); lhi = pack_bf16(v.z - c, v.w - d);
}

// Four elements of a row into fp32, zero where `ok` is false.
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
// GEMM over the kept rows: out[i][n] = sum_k A[i][k] B(n, k) for i < n_win hw,
// n < N. A (rows, K) compact, in AT: the weights' type WT, or fp32 rounded to
// WT on the way into the fragments. B is a weight in WT: (N, K) rows, B(n, k)
// = B[n][k], which is how a weight stored (out, in) multiplies; or, with BT,
// (K, N) rows, B(n, k) = B[k][n], which is how the same storage multiplies
// transposed (g W^T), read through ldmatrix.trans without a transposed copy.
// With `pair` = I (Epi::PAIR) B has 2I rows and a block takes the columns n
// and I + n together: tile columns [0, 32) are B rows n0 + c and [32, 64)
// rows I + n0 + c, so the epilogue sees both halves of the row (N = I).
// K % 16 == 0; with BT, N % 8 == 0.
//
// An epilogue functor Epi has `static constexpr bool PAIR, COLSUM` and
//   PAIR:   void operator()(int i, int n, float v, float v2)
//   else:   float operator()(int i, int n, float v), whose return value is
//           the element's share of a column sum, and with COLSUM
//           colsum(row block, n, sum over the block's 64 rows, in order).
struct GemmOp {
  const void* A; const void* B; int N, K; int pair;
};

// `rows` x BK elements of T into shared memory (row stride LDK) by cp.async:
// row r from src(r) + k0, zeros where src(r) is null or k >= K. K % 16 == 0.
template <typename T, typename Src>
__device__ __forceinline__ void tile_async(T* dst, int rows, int k0, int K, const T* base, Src src) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = BK / EPC;        // chunks per row
  for (int c = threadIdx.x; c < rows * CPR; c += THREADS) {
    const int r = c / CPR, k = (c - r * CPR) * EPC;
    const T* p = src(r);
    const bool valid = p != nullptr && k0 + k < K;
    cp_async16_zfill(dst + r * LDK + k, valid ? p + k0 + k : base, valid);
  }
}

// BK rows x 64 columns of T from (src, ld) at (r0, c0) into shared memory
// (row stride LD) by cp.async; rows at or beyond `rmax` and columns at or
// beyond `ld` read as zero. ld % (16 / sizeof(T)) == 0.
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

template <typename WT, typename AT, bool BT>
__host__ __device__ constexpr int gemm_stage_bytes() {
  return BM * LDK * (int)sizeof(AT) + (BT ? BK * LDN : BN * LDK) * (int)sizeof(WT);
}
template <typename WT, typename AT, bool BT>
__host__ __device__ constexpr int gemm_smem_bytes() {
  const int tiles = NST * gemm_stage_bytes<WT, AT, BT>(), staged = BM * LDC * 4;
  return tiles > staged ? tiles : staged;
}

template <typename WT, typename AT, bool BT, typename Epi>
__global__ void __launch_bounds__(THREADS) rows_gemm_kernel(const Rows w, const GemmOp op, const Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = kept_rows(w);
  const int i0 = blockIdx.y * BM;
  if (i0 >= nk) return;
  constexpr bool FP32 = std::is_same<WT, float>::value;
  constexpr bool PAIR = Epi::PAIR;
  constexpr int HALF = BN / 2;
  const int N = op.N, K = op.K;
  const int n0 = blockIdx.x * (PAIR ? HALF : BN);
  // NST stages of (A tile in AT, B tile in WT); fp32 A is rounded to WT in
  // the fragment loads.
  constexpr int ABYTES = BM * LDK * (int)sizeof(AT);
  constexpr int STAGE = gemm_stage_bytes<WT, AT, BT>();
  auto As = [&](int st) { return reinterpret_cast<AT*>(smem + st * STAGE); };
  auto Bs = [&](int st) { return reinterpret_cast<WT*>(smem + st * STAGE + ABYTES); };
  const AT* A = static_cast<const AT*>(op.A);
  const WT* B = static_cast<const WT*>(op.B);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
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
      const int k0 = ks * BK;
      tile_async(As(ks % NST), BM, k0, K, A, [&](int r) -> const AT* {
        return i0 + r < nk ? A + (size_t)(i0 + r) * K : nullptr;
      });
      if constexpr (BT) {
        panel_async<LDN>(Bs(ks % NST), B, N, k0, K, n0);
      } else {
        tile_async(Bs(ks % NST), BN, k0, K, B, [&](int r) -> const WT* {
          const int c = PAIR ? (r & (HALF - 1)) : r;
          if (n0 + c >= N) return nullptr;
          return B + (size_t)((PAIR && r >= HALF ? op.pair : 0) + n0 + c) * K;
        });
      }
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
      if constexpr (BT) {
        for (int k = 0; k < BK; ++k) {
          const float4 bv = *reinterpret_cast<const float4*>(bt + k * LDN + 4 * tn);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float av = at[(4 * tm + r) * LDK + k];
            acc[r][0] = fmaf(av, bv.x, acc[r][0]); acc[r][1] = fmaf(av, bv.y, acc[r][1]);
            acc[r][2] = fmaf(av, bv.z, acc[r][2]); acc[r][3] = fmaf(av, bv.w, acc[r][3]);
          }
        }
      } else {
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
      }
    } else {
      const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm .., columns 32 wn ..
      if constexpr (BT) {
        // The standard fragment layout on both operands: A pairs (k 2t, 2t + 1)
        // and (2t + 8, 2t + 9); B through ldmatrix.trans of the [k][n] tile.
        const int mat = lane >> 3, mr = lane & 7;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          const AT* ap = at + (wm * 16 + g) * LDK + kk + 2 * t;
          const uint32_t af[4] = {load_k2(ap), load_k2(ap + 8 * LDK), load_k2(ap + 8),
                                  load_k2(ap + 8 * LDK + 8)};
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, bt + (kk + (mat & 1) * 8 + mr) * LDN + wn * 32 + jp * 16 + (mat >> 1) * 8);
            mma_bf16(acc[2 * jp], af, b[0], b[1]);
            mma_bf16(acc[2 * jp + 1], af, b[2], b[3]);
          }
        }
      } else {
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
    }
    __syncthreads();
  }

  // The result into shared memory over the dead tiles, then the epilogue
  // element by element, consecutive threads on consecutive columns.
  float* cs = reinterpret_cast<float*>(smem);  // [BM][LDC]
  if constexpr (FP32) {
    const int tm = tid >> 4, tn = tid & 15;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) cs[(4 * tm + r) * LDC + 4 * tn + c] = acc[r][c];
  } else {
    const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cs[(wm * 16 + g + (e >> 1) * 8) * LDC + wn * 32 + j * 8 + 2 * t + (e & 1)] = acc[j][e];
  }
  __syncthreads();
  if constexpr (PAIR) {
    for (int e = tid; e < BM * HALF; e += THREADS) {
      const int r = e / HALF, c = e - r * HALF;
      if (i0 + r < nk && n0 + c < N) epi(i0 + r, n0 + c, cs[r * LDC + c], cs[r * LDC + HALF + c]);
    }
  } else {
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e - r * BN;
      float contrib = 0.f;
      if (i0 + r < nk && n0 + c < N) contrib = epi(i0 + r, n0 + c, cs[r * LDC + c]);
      if constexpr (Epi::COLSUM) cs[r * LDC + c] = contrib;
    }
    if constexpr (Epi::COLSUM) {
      // The block's column sums, rows in order.
      __syncthreads();
      if (tid < BN && n0 + tid < N) {
        float s = 0.f;
        for (int r = 0; r < BM; ++r) s += cs[r * LDC + tid];
        epi.colsum(blockIdx.y, n0 + tid, s);
      }
    }
  }
}

// Above 48 KB of dynamic shared memory a kernel needs the attribute: asked
// once per kernel of this library.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool& ready) {
  if (ready || bytes <= 48 * 1024) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
  if (e != cudaSuccess) return (int)e;
  ready = true;
  return 0;
}

// Launch of rows_gemm_kernel over at most `rmax` rows (the grid; blocks
// beyond the kept rows return at once).
template <typename WT, typename AT, bool BT, typename Epi>
int rows_gemm(const Rows& w, int rmax, const GemmOp& op, const Epi& epi, cudaStream_t s) {
  constexpr int bytes = gemm_smem_bytes<WT, AT, BT>();
  static bool ready = false;
  const int rc = allow_smem(rows_gemm_kernel<WT, AT, BT, Epi>, bytes, ready);
  if (rc != 0) return rc;
  const int cols = Epi::PAIR ? BN / 2 : BN;
  const dim3 grid((op.N + cols - 1) / cols, (rmax + BM - 1) / BM);
  rows_gemm_kernel<WT, AT, BT, Epi><<<grid, THREADS, bytes, s>>>(w, op, epi);
  return 0;
}

// Epilogue: dst[i][n] = round(v + bias[n]) (no bias: round(v)), row stride ld.
template <typename T>
struct StoreEpi {
  static constexpr bool PAIR = false, COLSUM = false;
  T* dst; const float* bias; int ld;
  __device__ float operator()(int i, int n, float v) const {
    dst[(size_t)i * ld + n] = from_f<T>(bias != nullptr ? v + bias[n] : v);
    return 0.f;
  }
};

// Epilogue: per-block column sums of keep * c * (v + bias) over the kept
// tokens into part[row block][n], where c is the cotangent of the tokens
// (its rows of N, in GT). Nothing is stored.
template <typename GT>
struct KeptColsumEpi {
  static constexpr bool PAIR = false, COLSUM = true;
  Rows w; const unsigned char* keep; const GT* c; const float* bias; float* part; int N;
  __device__ float operator()(int i, int n, float v) const {
    const size_t tk = token(w, i);
    return keep[tk] ? to_f<GT>(c[tk * N + n]) * (v + bias[n]) : 0.f;
  }
  __device__ void colsum(int rb, int n, float s) const { part[(size_t)rb * N + n] = s; }
};

// Epilogue of [val | gate] = X Wglu + b (paired columns): m = round(val *
// gelu_tanh(gate)), rows of I in WT; with u, val and gate in fp32 too (rows
// of 2I).
template <typename WT>
struct GluEpi {
  static constexpr bool PAIR = true, COLSUM = false;
  WT* m; float* u; const float* bias; int I;
  __device__ void operator()(int i, int n, float v, float v2) const {
    const float val = v + bias[n], gate = v2 + bias[I + n];
    m[(size_t)i * I + n] = from_f<WT>(val * gelu_tanh(gate));
    if (u != nullptr) {
      u[(size_t)i * 2 * I + n] = val;
      u[(size_t)i * 2 * I + I + n] = gate;
    }
  }
};

// ---------------------------------------------------------------------------
// Split-K: part[s][m][n] = sum over kept rows i of split s of X[i][m] G[i][n]
// (X in WT, G fp32), and for the first row of tiles partb[s][n] = sum_i G[i][n].
struct TnOp {
  const void* X; const float* G; float* part; float* partb; int Mo, No, chunk;
};

template <typename WT>
__global__ void __launch_bounds__(THREADS) tn_gemm_kernel(const Rows w, const TnOp op) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDX = BM + 8, LDG = BN + 4;
  constexpr bool FP32 = std::is_same<WT, float>::value;
  const int nk = kept_rows(w);
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

template <typename WT>
__host__ __device__ constexpr int tn_smem_bytes() {
  return NST * (((BK * (BM + 8) * (int)sizeof(WT) + 127) / 128 * 128) + BK * (BN + 4) * 4);
}

template <typename WT>
int tn_gemm(const Rows& w, int nsplit, const TnOp& op, cudaStream_t s) {
  constexpr int bytes = tn_smem_bytes<WT>();
  static bool ready = false;
  const int rc = allow_smem(tn_gemm_kernel<WT>, bytes, ready);
  if (rc != 0) return rc;
  const dim3 grid((op.No + BN - 1) / BN, (op.Mo + BM - 1) / BM, nsplit);
  tn_gemm_kernel<WT><<<grid, THREADS, bytes, s>>>(w, op);
  return 0;
}

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

// Split-K of one weight gradient over at most `rows` rows, `tiles` output
// tiles: enough splits that the card has SPLIT_BLOCKS_PER_SM blocks per SM
// when every window is kept; splits of a multiple of BK rows.
inline void split_k(int rows, int tiles, int sms, int* nsplit, int* chunk) {
  int want = (SPLIT_BLOCKS_PER_SM * sms + tiles - 1) / tiles;
  if (want < 1) want = 1;
  int c = (rows + want - 1) / want;
  c = (c + BK - 1) / BK * BK;
  *chunk = c;
  *nsplit = (rows + c - 1) / c;
}

// ---------------------------------------------------------------------------
// Reduce: dst[e] = sum over units u < ceil(kept rows / chunk) of
// src[u * stride + e], units in a fixed order. `lanes` threads sum one
// element (1, or a warp of 32 where a job can have many partials); each
// job's threads start on a warp boundary.
struct ReduceJob { float* dst; const float* src; int n; long long stride; int chunk, lanes; };
constexpr int MAX_JOBS = 8;
struct ReduceArgs { ReduceJob job[MAX_JOBS]; int total; };

__device__ __host__ __forceinline__ int job_threads(const ReduceJob& j) {
  return (j.n * j.lanes + 31) / 32 * 32;
}
// A warp per element where a job has more than 64 partials at most.
inline int reduce_lanes(long long units) { return units > 64 ? 32 : 1; }

__global__ void __launch_bounds__(THREADS) reduce_kernel(const Rows w, const ReduceArgs r) {
  int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= r.total) return;
  int j = 0;
  while (e >= job_threads(r.job[j])) { e -= job_threads(r.job[j]); ++j; }
  const ReduceJob& job = r.job[j];
  const int units = (kept_rows(w) + job.chunk - 1) / job.chunk;
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

// Launch of reduce_kernel over the first `njobs` jobs of r.
inline void reduce(const Rows& w, ReduceArgs r, int njobs, cudaStream_t s) {
  r.total = 0;
  for (int j = 0; j < njobs; ++j) r.total += job_threads(r.job[j]);
  reduce_kernel<<<(r.total + THREADS - 1) / THREADS, THREADS, 0, s>>>(w, r);
}

// ---------------------------------------------------------------------------
// A product of two shared-memory tiles inside one block.

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
