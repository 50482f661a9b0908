// The sparse window block (kernels E and F), for sm_90a: the masked SAST
// block on the kept windows as a short sequence of launches over their
// tokens (E), or the same steps as phases of one persistent cooperative
// launch (F, a second entry point of this library).
//
// E replaces the TPU kernel _block_kernel behind _sparse_window_block_impl /
// sparse_window_block (sast_tpu/ops/pallas/sparse_block.py), which computes
// _fwd_window on the kept-first work list ids = argsort(~win_keep, stable).
// With the identity work list (ids = 0..M-1, n_win = M) the same launches
// are the dense fused block (kernel D, ops/fused_block.py), which replaces
// the TPU kernel _tile_kernel behind fused_window_block
// (sast_tpu/ops/pallas/fused_block.py):
//   z   = where(keep, LN2(y), y)                  two-pass variance, fp32
//   per head: q,k,v = z Wqkv + b;  P = softmax(mask(q k^T * dh^-0.5));  P v
//   h1  = z + ls1 * (attn_out Wproj + b)
//   h2  = h1 + ls2 * ((val * gelu_tanh(gate)) Wout + b),  [val|gate] = h1 Wglu + b
//   out = where(keep, h2, y)
// Activations are fp32; the operands of every product are rounded to the
// weights' type WT (bf16 or float); products accumulate in fp32. These are
// the rounding points of ops/block.py block_window_plain, the plain
// version; the LN2 row statistics, the softmax rows and GELU are
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
// Kernel F replaces the TPU kernel _looped_kernel behind
// sparse_window_block_looped (the same function on a persistent grid of 8
// programs that walk the kept-first slots). Here it is one kernel launched
// with cudaLaunchCooperativeKernel on as many blocks as the card holds at
// once (2 or 3 per SM, by the call's rows: WIDE_ROWS), running 0. the work
// list itself (a stable compaction of win_keep into ids and n_win, one
// block), then steps 1-6 above, with a grid barrier (cooperative_groups)
// between two phases. In each phase block b takes the phase's tiles b,
// b + gridDim.x, ... (counted on the device from n_win) and runs them
// through the same device routines as E's kernels (prep_rows, gemm_tile
// with the same epilogues, core_item), so every output element is summed in
// E's order and F's output equals E's bit for bit. F writes out whole (prep
// copies y at skipped slots) and no h1. An optional clock times its phases.
//
// What bounds them on an H100: operations (2 hw (4 C^2 + 3 C I) + 4 hw^2 C
// per kept window). A window is too small to fill the card (stage 4 of the
// b4 step keeps 3-16 windows for 132 SMs), so each product is a grid of 64 x
// 64 tiles over all kept tokens, and each weight tile is read once per 64
// rows, not once per window. The compact intermediates pass through device
// memory (mostly L2); the wrappers allocate them as one workspace. E pays a
// launch and its ramp per step; F pays a grid barrier instead, and sorts
// nothing on the host side of the call.

#include <cooperative_groups.h>

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

// Rows b ROWS .. (b + 1) ROWS - 1 of the work list's order.
template <typename YT, typename WT>
__device__ __forceinline__ void prep_rows(const Args& a, const int b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = a.hw, C = a.C, n_win = *a.n_win;
  const YT* y = static_cast<const YT*>(a.y);
  WT* zr = static_cast<WT*>(a.zr);
  for (int j = b * ROWS + warp; j < (b + 1) * ROWS; j += WARPS) {
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

template <typename YT, typename WT>
__global__ void __launch_bounds__(THREADS) prep_kernel(const Args a) {
  prep_rows<YT, WT>(a, blockIdx.x);
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

// Head h of the window in slot `slot` (< n_win), in the shared memory
// `smem` (L.total bytes).
template <typename WT, int MT>
__device__ __forceinline__ void core_item(const Args& a, const CoreLayout& L, const int h,
                                          const int slot, unsigned char* smem) {
  constexpr int R = MT * 16;
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

template <typename WT, int MT>
__global__ void __launch_bounds__(THREADS) core_kernel(const Args a, const CoreLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  if ((int)blockIdx.y >= *a.n_win) return;
  core_item<WT, MT>(a, L, blockIdx.x, blockIdx.y, smem);
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
// Kernel F: the six launches above as phases of one cooperative launch.

// 0. The work list ids = argsort(~win_keep, stable) and n_win, by one
// block: each thread counts the kept windows of a contiguous chunk, a block
// scan turns the counts into offsets, and each thread writes its chunk's
// kept windows from its offset and its skipped ones from n_win + (chunk
// start - offset). `scan` is WARPS ints of shared memory.
__device__ __forceinline__ void build_work_list(const unsigned char* win_keep, const int M,
                                                int* ids, int* n_win, int* scan) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = (M + THREADS - 1) / THREADS;
  const int b = min(tid * per, M), e = min(b + per, M);
  int n = 0;
  for (int i = b; i < e; ++i) n += win_keep[i] != 0;
  int x = n;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += v;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < WARPS ? scan[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += v;
    }
    if (lane < WARPS) scan[lane] = t;
  }
  __syncthreads();
  const int total = scan[WARPS - 1];
  int k = x - n + (warp > 0 ? scan[warp - 1] : 0), u = total + b - k;
  for (int i = b; i < e; ++i) {
    if (win_keep[i] != 0) ids[k++] = i;
    else ids[u++] = i;
  }
  if (tid == 0) *n_win = total;
}

// Every tile of one GEMM over the nk kept rows: block b takes tiles b,
// b + gridDim.x, ..., row block t / columns, column block t % columns.
template <typename WT, typename Epi>
__device__ __forceinline__ void gemm_phase(unsigned char* smem, const int nk, const GemmOp& op,
                                           const Epi& epi) {
  const int cols = Epi::PAIR ? BN / 2 : BN;
  const int nc = (op.N + cols - 1) / cols, tiles = nc * ((nk + BM - 1) / BM);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();  // the previous tile's epilogue is done with the shared memory
    gemm_tile<WT, WT, false>(smem, nk, t / nc, t % nc, op, epi);
  }
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Phases 0-6 with a grid barrier between two; a.ids and a.n_win are ids
// and n_win, which phase 0 writes. MINB blocks per SM bound the registers
// (see WIDE_ROWS). With `stamps` (8 zeros, or null) block 0 writes the
// card's clock in ns at its start and after each barrier (stamps[1..6]),
// and every block its end into stamps[7] (the latest), so phase k took
// stamps[k + 1] - stamps[k], its barrier included.
template <typename YT, typename WT, int MT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    looped_kernel(const Args a, const unsigned char* win_keep, int* ids, int* n_win,
                  const CoreLayout L, unsigned long long* stamps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int C = a.C, I = a.I, nb = gridDim.x;
  const bool clock = stamps != nullptr && threadIdx.x == 0;
  auto sync = [&](int k) {
    grid.sync();
    if (clock && blockIdx.x == 0) stamps[k] = globaltimer();
  };
  if (clock && blockIdx.x == 0) stamps[0] = globaltimer();
  if (blockIdx.x == 0) build_work_list(win_keep, a.M, ids, n_win, reinterpret_cast<int*>(smem));
  sync(1);
  const int nw = *n_win, nk = nw * a.hw;
  for (int b = blockIdx.x; b < (a.M * a.hw + ROWS - 1) / ROWS; b += nb) prep_rows<YT, WT>(a, b);
  sync(2);
  gemm_phase<WT>(smem, nk, GemmOp{a.zr, a.wqkv, 3 * C, C, 0},
                 StoreEpi<WT>{static_cast<WT*>(a.qkv), a.bqkv, 3 * C});
  sync(3);
  for (int t = blockIdx.x; t < a.heads * nw; t += nb) {
    __syncthreads();
    core_item<WT, MT>(a, L, t % a.heads, t / a.heads, smem);
  }
  sync(4);
  const Rows w = rows_of(a);
  WT* h1r = static_cast<WT*>(a.h1r);
  WT* m = static_cast<WT*>(a.qkv);  // over QKV, dead after the core
  gemm_phase<WT>(smem, nk, GemmOp{a.zr, a.wproj, C, C, 0},
                 H1Epi<WT>{w, a.zh, h1r, nullptr, a.bproj, a.ls1, C});
  sync(5);
  gemm_phase<WT>(smem, nk, GemmOp{h1r, a.wglu, I, C, I}, GluEpi<WT>{m, nullptr, a.bglu, I});
  sync(6);
  gemm_phase<WT>(smem, nk, GemmOp{m, a.wout, C, I, 0},
                 OutEpi<YT>{w, a.keep, static_cast<const YT*>(a.y), static_cast<YT*>(a.out), a.zh,
                            a.bout, a.ls2, C});
  if (stamps != nullptr) {
    __syncthreads();  // every thread of the block is done
    if (clock) atomicMax(stamps + 7, globaltimer());
  }
}

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

// Kernel F's workspace: E's, then ids (M ints) and n_win.
inline long long looped_bytes(const Plan& P, int M) { return P.bytes + (M + 1LL) * 4; }

// One cooperative launch of looped_kernel. `blocks` 0 takes as many blocks
// as the card holds at once (the occupancy at this shared memory times the
// SMs, asked once per instantiation and size); a larger grid is refused by
// the launch, and its error returned.
template <typename YT, typename WT, int MT, int MINB>
int run_looped(const Args& a, const unsigned char* win_keep, int* ids, int* n_win,
               unsigned long long* stamps, const Plan& P, int blocks, cudaStream_t s) {
  const int gemm = gemm_smem_bytes<WT, WT, false>();
  const int smem = P.core.total > gemm ? P.core.total : gemm;
  auto kernel = looped_kernel<YT, WT, MT, MINB>;
  static int known_smem = -1, per_sm = 0;
  if (smem != known_smem) {
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    known_smem = smem;
  }
  if (blocks == 0) {
    int sms = 0;
    const int rc = sm_count(&sms);
    if (rc != 0) return rc;
    blocks = per_sm * sms;
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  }
  Args args = a;
  CoreLayout layout = P.core;
  void* params[] = {&args, &win_keep, &ids, &n_win, &layout, &stamps};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                    dim3(blocks), dim3(THREADS), params, smem, s);
  // A refused launch also sets the runtime's last error, which the next
  // launch of this library would report as its own: take it back here.
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// Rows (M hw) from which F runs 3 blocks per SM (80 registers) rather than
// 2 (118 in bf16, 128 in fp32). On the H100 at the b4 stage shapes, window
// density 0.4 (PERF.md section 6, kernel F), 3 blocks per SM took 18%
// (bf16) and 15% (fp32) less time at 61440 rows; at 15360 rows 3% less in
// bf16 but 13% more in fp32; at 3840 and 960 rows up to 23% more.
constexpr int WIDE_ROWS = 32768;

template <int MT, int MINB>
int dispatch_looped(const Args& a, const unsigned char* win_keep, int* ids, int* n_win,
                    unsigned long long* stamps, const Plan& P, int blocks, int y_bf16, int w_bf16,
                    cudaStream_t s) {
  if (!w_bf16)
    return run_looped<float, float, MT, MINB>(a, win_keep, ids, n_win, stamps, P, blocks, s);
  return y_bf16 ? run_looped<bf16, bf16, MT, MINB>(a, win_keep, ids, n_win, stamps, P, blocks, s)
                : run_looped<float, bf16, MT, MINB>(a, win_keep, ids, n_win, stamps, P, blocks, s);
}

template <int MT>
int dispatch_looped(const Args& a, const unsigned char* win_keep, int* ids, int* n_win,
                    unsigned long long* stamps, const Plan& P, int blocks, int y_bf16, int w_bf16,
                    cudaStream_t s) {
  return a.M * a.hw >= WIDE_ROWS
             ? dispatch_looped<MT, 3>(a, win_keep, ids, n_win, stamps, P, blocks, y_bf16, w_bf16, s)
             : dispatch_looped<MT, 2>(a, win_keep, ids, n_win, stamps, P, blocks, y_bf16, w_bf16, s);
}

// The weight operands from a pointer table, in PARAM_KEYS order: ln2_scale,
// ln2_bias, wqkv, bqkv, wproj, bproj, ls1, wglu, bglu, wout, bout, ls2.
inline void set_weights(Args& a, const void* const* p) {
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  a.ln2s = f32(0); a.ln2b = f32(1); a.wqkv = p[2]; a.bqkv = f32(3); a.wproj = p[4];
  a.bproj = f32(5); a.ls1 = f32(6); a.wglu = p[7]; a.bglu = f32(8); a.wout = p[9];
  a.bout = f32(10); a.ls2 = f32(11);
}

// The workspace buffers and the shape.
inline void set_shape(Args& a, const Plan& P, void* work, int M, int hw, int C, int I, int heads,
                      int dh, float eps) {
  unsigned char* w = static_cast<unsigned char*>(work);
  a.zh = reinterpret_cast<float*>(w + P.off[0]); a.zr = w + P.off[1];
  a.qkv = w + P.off[2]; a.h1r = w + P.off[3];
  a.M = M; a.hw = hw; a.C = C; a.I = I; a.heads = heads; a.dh = dh;
  a.eps = eps;
  a.scale = (float)(1.0 / sqrt((double)dh));
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
  a.y = p[0]; a.keep = static_cast<const unsigned char*>(p[1]); a.out = const_cast<void*>(p[2]);
  a.h1 = static_cast<float*>(const_cast<void*>(p[3]));
  a.ids = static_cast<const int*>(p[4]); a.n_win = static_cast<const int*>(p[5]);
  set_weights(a, p + 6);
  set_shape(a, P, work, M, hw, C, I, heads, dh, eps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hw <= 64 ? dispatch_types<4>(a, P, y_bf16, w_bf16, s)
                  : dispatch_types<5>(a, P, y_bf16, w_bf16, s);
}

// Kernel F's workspace bytes, as sast_sparse_fwd_workspace.
extern "C" long long sast_looped_fwd_workspace(int M, int hw, int C, int I, int dh, int w_bf16) {
  sf::Plan P;
  const int rc = sf::make_plan(M, hw, C, I, dh, w_bf16 ? 2 : 4, &P);
  return rc < 0 ? rc : sf::looped_bytes(P, M);
}

// Kernel F, one cooperative launch: the work list of win_keep on the card,
// then E's six launches as phases (out is written whole; no h1). Pointer
// table: y, keep, out, win_keep (M bytes), the weights as in
// sast_sparse_fwd, then the phase clock (8 uint64 zeros, or null; see
// looped_kernel) (17). `blocks` 0 fills the card.
extern "C" int sast_looped_fwd(const void* const* p, int np, void* work, long long nwork, int M,
                               int hw, int C, int I, int heads, int dh, float eps, int y_bf16,
                               int w_bf16, int blocks, void* stream) {
  using namespace sf;
  if (np != 17 || heads * dh != C || (y_bf16 && !w_bf16) || blocks < 0)
    return (int)cudaErrorInvalidValue;
  Plan P;
  if (make_plan(M, hw, C, I, dh, w_bf16 ? 2 : 4, &P) != 0 || nwork < looped_bytes(P, M))
    return (int)cudaErrorInvalidValue;
  int* ids = reinterpret_cast<int*>(static_cast<unsigned char*>(work) + P.bytes);
  Args a{};
  a.y = p[0]; a.keep = static_cast<const unsigned char*>(p[1]); a.out = const_cast<void*>(p[2]);
  a.ids = ids; a.n_win = ids + M;
  set_weights(a, p + 4);
  set_shape(a, P, work, M, hw, C, I, heads, dh, eps);
  const unsigned char* win_keep = static_cast<const unsigned char*>(p[3]);
  auto* stamps = static_cast<unsigned long long*>(const_cast<void*>(p[16]));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hw <= 64
             ? dispatch_looped<4>(a, win_keep, ids, ids + M, stamps, P, blocks, y_bf16, w_bf16, s)
             : dispatch_looped<5>(a, win_keep, ids, ids + M, stamps, P, blocks, y_bf16, w_bf16, s);
}
