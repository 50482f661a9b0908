// Sparse window block kernels: the masked SAST block on kept windows only.
//
// Replaces the TPU kernels _block_kernel (behind sparse_window_block) and
// _looped_kernel (behind sparse_window_block_looped) of
// sast_tpu/ops/pallas/sparse_block.py. Both walk the kept-first work list
// ids = argsort(~win_keep, stable) and read n_win from device memory:
//   mode 1 (sparse): one thread block per slot; blocks of slots >= n_win
//     copy their window through (and, when asked, as h1);
//   mode 2 (looped): a persistent grid of a few blocks per SM; block b takes
//     slots b, b + grid, ... < n_win, the next window arriving by cp.async
//     while this one is computed; the output buffer is the input buffer.
// The window routine, its bound (operations; weights re-read from L2 by
// every block) and its layout are in window_block.cuh.

#include "window_block.cuh"

SAST_WINDOW_BLOCK_ENTRY(sast_sparse_window_block)
