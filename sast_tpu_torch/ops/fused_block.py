"""Dense fused window block: the masked SAST block on every window.

Replaces the TPU kernel ``_fused_fwd`` / ``_tile_kernel`` behind
``fused_window_block`` (sast_tpu/ops/pallas/fused_block.py). The CUDA kernel
is ``csrc/fused_block.cu``: one thread block per window over the shared
device routine ``csrc/window_block.cuh``, whose note says what bounds it on
the H100. Its plain version is ``fused_block_plain``
(``ops/block.block_window_plain`` on all windows, the counterpart of
``fused_block_xla``).

``fused_window_block`` takes the plain version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises. Under grad mode it is a
``torch.autograd.Function``: the kernel forward, and as backward
``torch.autograd`` of the plain block on the saved inputs, as the TPU
package differentiates ``fused_block_xla`` behind its kernel.
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


def _forward(y, token_keep, params, num_heads, dim_head, norm_eps):
    if y.device.type == "cpu":
        return fused_block_plain(y, token_keep, params, num_heads, dim_head, norm_eps)
    y = y.contiguous()
    out = torch.empty_like(y)
    if y.shape[0]:
        block.launch(_entry(), block.MODE_FUSED, y, token_keep, params, num_heads, dim_head,
                     norm_eps, out, what="fused_window_block")
        fused_window_block.launches += 1
    return out


class _FusedBlockFn(torch.autograd.Function):
    """Kernel forward; backward by autograd of the plain block. Differentiable
    inputs: ``y`` and the leaves behind ``params`` (port layout)."""

    @staticmethod
    def forward(ctx, y, token_keep, params, num_heads, dim_head, norm_eps, *leaves):
        with torch.no_grad():
            out = _forward(y.detach(), token_keep, params, num_heads, dim_head, norm_eps)
        ctx.save_for_backward(y, token_keep, *[t for t in leaves if t is not None])
        ctx.present = [t is not None for t in leaves]
        ctx.params, ctx.shape = params, (num_heads, dim_head, norm_eps)
        return out

    @staticmethod
    def backward(ctx, g):
        y, token_keep, *given = ctx.saved_tensors
        given = iter(given)
        leaves = [next(given) if here else None for here in ctx.present]
        with torch.enable_grad():
            y_in = y.detach().requires_grad_(ctx.needs_input_grad[0])
            fresh = [None if t is None else t.detach().requires_grad_(t.requires_grad)
                     for t in leaves]
            params = ctx.params
            if any(t is not None for t in fresh):
                params = block.params_from_leaves(fresh, ctx.params["wqkv"].dtype)
            out = fused_block_plain(y_in, token_keep, params, *ctx.shape)
            wanted = [t for t in [y_in] + fresh if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype), allow_unused=True))
        dy = next(grads) if y_in.requires_grad else None
        dleaves = [next(grads) if t is not None and t.requires_grad else None for t in fresh]
        return (dy, None, None, None, None, None, *dleaves)


def fused_window_block(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
    leaves=None,
) -> torch.Tensor:
    """The masked block on every window.

    Args:
      y: (M, hw, C) norm1-ed window tokens, fp32 or bf16.
      token_keep: (M, hw) bool.
      params: the weight dict of ``ops/block.kernel_params`` (detached).
      leaves: the parameters behind ``params`` that take the gradients
        (``ops/block.kernel_leaves``), or None when only ``y`` does.

    Returns (M, hw, C) in ``y``'s dtype, equal to ``y`` at unkept tokens.
    """
    if block.needs_grad(y, leaves):
        leaves = tuple(leaves) if leaves is not None else (None,) * len(block.PARAM_KEYS)
        return _FusedBlockFn.apply(y, token_keep, params, num_heads, dim_head, norm_eps, *leaves)
    return _forward(y, token_keep, params, num_heads, dim_head, norm_eps)


fused_window_block.launches = 0  # kernel launches, read by chip_smoke.py
