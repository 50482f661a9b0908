"""Sparse window block: the masked SAST block on kept windows only.

Replaces the TPU kernels ``_sparse_window_block_impl`` / ``_block_kernel``
and ``sparse_window_block_looped`` / ``_looped_kernel``
(sast_tpu/ops/pallas/sparse_block.py). Both walk the kept-first work list
``argsort(~win_keep, stable)``: slots below ``n_win`` run the block
(``ops/block.block_window_plain`` is its plain version), the rest pass
``y`` through. The CUDA kernels are ``csrc/sparse_block.cu`` over the shared
device routine ``csrc/window_block.cuh``, whose note says what bounds them
on the H100 and how a window is laid out on chip.

- ``sparse_window_block``: one thread block per work-list slot; with
  ``save_h1`` it also returns the fp32 post-attention residual h1, the one
  tensor a backward over the same work list needs.
- ``sparse_window_block_looped``: a persistent grid (a few blocks per SM);
  each block walks slots ``blockIdx, += gridDim, ... < n_win`` and copies
  the next window in with ``cp.async`` while it computes this one. The
  kernel updates its token tensor in place, so unkept windows are never
  touched; the wrapper clones ``y`` first and hands the clone to the
  kernel, because its callers still need ``y``.

The work list and ``n_win`` stay on the device (the kernels read ``n_win``
from memory), so neither wrapper synchronises with the host. Each wrapper
takes its plain version only for a CPU tensor; on a CUDA tensor it launches
or raises. Forward only: under grad mode with a tensor that requires grad
the wrappers raise.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from sast_tpu_torch.ops import block

# Which of the two kernels the model's sparse path calls
# (``models/sast.py``): the per-slot kernel or the looped one. Set from the
# times of both on the H100 at the gen4-base stage shapes (PERF.md, section
# 6): see there for the numbers behind the choice.
MODEL_USES_LOOPED = False


def sparse_window_block_plain(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    win_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
    save_h1: bool = False,
):
    """Plain PyTorch version of both kernels (any device): the work list,
    the block on its kept prefix, pass-through elsewhere. h1 of a skipped
    window is ``y`` in fp32, as the TPU kernel writes it. Reads the number
    of kept windows on the host to size the prefix."""
    ids, n_win = block.work_list(win_keep)
    kept = ids[: int(n_win)].long()
    out = y.clone()
    h1 = y.to(torch.float32, copy=True) if save_h1 else None
    if kept.numel():
        res = block.block_window_plain(
            y[kept], token_keep[kept], params, num_heads, dim_head, norm_eps, return_h1=save_h1
        )
        if save_h1:
            out[kept], h1[kept] = res
        else:
            out[kept] = res
    return (out, h1) if save_h1 else out


@functools.cache
def _entry():
    return block.bind("sparse_block", "sast_sparse_window_block")


def _run(wrapper, mode, y, token_keep, win_keep, params, num_heads, dim_head, norm_eps, save_h1):
    if y.device.type == "cpu":
        return sparse_window_block_plain(
            y, token_keep, win_keep, params, num_heads, dim_head, norm_eps, save_h1
        )
    block.check_no_grad(wrapper.__name__, y, params)
    M = y.shape[0]
    if win_keep.shape != (M,) or win_keep.dtype != torch.bool:
        raise ValueError(f"{wrapper.__name__}: win_keep must be (M,) bool")
    ids, n_win = block.work_list(win_keep)
    y = y.contiguous()
    looped = mode == block.MODE_LOOPED
    out = y.clone() if looped else torch.empty_like(y)
    h1 = torch.empty(y.shape, dtype=torch.float32, device=y.device) if save_h1 else None
    if M:
        block.launch(_entry(), mode, out if looped else y, token_keep, params, num_heads,
                     dim_head, norm_eps, out, h1, ids, n_win, what=wrapper.__name__)
        wrapper.launches += 1
    return (out, h1) if save_h1 else out


def sparse_window_block(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    win_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
    save_h1: bool = False,
):
    """The masked block on kept windows only, one thread block per slot.

    Args:
      y: (M, hw, C) norm1-ed window tokens, fp32 or bf16 (M = B * N).
      token_keep: (M, hw) bool; win_keep: (M,) bool.
      params: the weight dict of ``ops/block.kernel_params``.

    Returns (M, hw, C) in ``y``'s dtype, equal to ``y`` outside kept windows
    and at unkept tokens; with ``save_h1`` also h1 (M, hw, C) fp32.
    """
    return _run(sparse_window_block, block.MODE_SPARSE, y, token_keep, win_keep, params,
                num_heads, dim_head, norm_eps, save_h1)


def sparse_window_block_looped(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    win_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
) -> torch.Tensor:
    """Looped-grid variant of ``sparse_window_block`` (same function). The
    kernel writes in place; ``y`` is cloned first and left as it was."""
    return _run(sparse_window_block_looped, block.MODE_LOOPED, y, token_keep, win_keep, params,
                num_heads, dim_head, norm_eps, False)


sparse_window_block.launches = 0  # kernel launches, read by chip_smoke.py
sparse_window_block_looped.launches = 0
