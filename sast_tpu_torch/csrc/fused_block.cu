// Dense fused window block kernel: the masked SAST block on every window.
//
// Replaces the TPU kernel _tile_kernel behind _fused_fwd / fused_window_block
// (sast_tpu/ops/pallas/fused_block.py). Mode 0 of the shared routine: one
// thread block per window, no work list. The window routine, its bound
// (operations; weights re-read from L2 by every block) and its layout are in
// window_block.cuh.

#include "window_block.cuh"

SAST_WINDOW_BLOCK_ENTRY(sast_fused_window_block)
