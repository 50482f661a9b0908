"""Dense fused window block: the masked SAST block on every window.

Replaces the TPU kernel ``_fused_fwd`` / ``_tile_kernel`` behind
``fused_window_block`` (sast_tpu/ops/pallas/fused_block.py). The CUDA kernel
is ``csrc/fused_block.cu``: one thread block per window over the shared
device routine ``csrc/window_block.cuh``, whose note says what bounds it on
the H100. Its plain version is ``fused_block_plain``
(``ops/block.block_window_plain`` on all windows, the counterpart of
``fused_block_xla``).

``fused_window_block`` takes the plain version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises. Forward only: under grad mode
with a tensor that requires grad it raises.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from sast_tpu_torch.ops import block


def fused_block_plain(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (any device)."""
    return block.block_window_plain(y, token_keep, params, num_heads, dim_head, norm_eps)


@functools.cache
def _entry():
    return block.bind("fused_block", "sast_fused_window_block")


def fused_window_block(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
) -> torch.Tensor:
    """The masked block on every window.

    Args:
      y: (M, hw, C) norm1-ed window tokens, fp32 or bf16.
      token_keep: (M, hw) bool.
      params: the weight dict of ``ops/block.kernel_params``.

    Returns (M, hw, C) in ``y``'s dtype, equal to ``y`` at unkept tokens.
    """
    if y.device.type == "cpu":
        return fused_block_plain(y, token_keep, params, num_heads, dim_head, norm_eps)
    block.check_no_grad("fused_window_block", y, params)
    y = y.contiguous()
    out = torch.empty_like(y)
    if y.shape[0]:
        block.launch(_entry(), block.MODE_FUSED, y, token_keep, params, num_heads, dim_head,
                     norm_eps, out, what="fused_window_block")
        fused_window_block.launches += 1
    return out


fused_window_block.launches = 0  # kernel launches, read by chip_smoke.py
