// Looped sparse window block kernel (F): the masked SAST block on kept
// windows only, on a persistent grid.
//
// Replaces the TPU kernel _looped_kernel behind sparse_window_block_looped
// (sast_tpu/ops/pallas/sparse_block.py). It walks the kept-first work list
// ids = argsort(~win_keep, stable) and reads n_win from device memory
// (mode 2 of window_block.cuh; mode 1 has no caller): a persistent grid of a
// few blocks per SM, block b taking slots b, b + grid, ... < n_win, the next
// window arriving by cp.async while this one is computed; the output buffer
// is the input buffer. The window routine, its bound (operations; weights
// re-read from L2 by every block) and its layout are in window_block.cuh.

#include "window_block.cuh"

SAST_WINDOW_BLOCK_ENTRY(sast_sparse_window_block)
