"""Dense fused window block: the masked SAST block on every window.

Replaces the TPU kernel ``_fused_fwd`` / ``_tile_kernel`` behind
``fused_window_block`` (sast_tpu/ops/pallas/fused_block.py). With every
window kept that is the function of the sparse window block (kernel E), so
the CUDA kernel is E's sequence of launches (``csrc/sparse_fwd.cu``: prep,
QKV, a core per window and head, proj, GLU, out; every product a grid of
tensor-core tiles over all tokens) with the identity work list: ``ids =
arange(M)`` and ``n_win = M``, both kept on the card per (M, device), so a
call sorts nothing and reads nothing back. It is the operator
``sast_tpu_torch::fused_block_fwd``. A window without a kept token
runs through the core with every key masked (a uniform softmax, finite)
and its output is ``y``. Its plain version is ``fused_block_plain``
(``ops/block.block_window_plain`` on all windows, the counterpart of
``fused_block_xla``).

``fused_window_block`` takes the plain version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises; under ``torch.export`` the
operator stands in the graph by its shape. Under grad mode it is a
``torch.autograd.Function``: the kernel forward, and as backward
``torch.autograd`` of the plain block on the saved inputs, as the TPU
package differentiates ``fused_block_xla`` behind its kernel.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.flop_counter import register_flop_formula

from sast_tpu_torch import build
from sast_tpu_torch.ops import block, sparse_block


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
def _every_window(M: int, device: torch.device):
    """The identity work list of M windows and ``n_win = M``, int32 on
    ``device`` (made by the CUDA implementation, never under a trace)."""
    return (torch.arange(M, dtype=torch.int32, device=device),
            torch.full((1,), M, dtype=torch.int32, device=device))


def _forward(y, token_keep, params, num_heads, dim_head, norm_eps):
    build.check_device(y, "fused_window_block")
    return torch.ops.sast_tpu_torch.fused_block_fwd(
        y.contiguous(), token_keep, [params[k] for k in block.PARAM_KEYS], num_heads, dim_head,
        float(norm_eps))


# The operator: kernel D on CUDA tensors (E's launches over the identity
# work list), the plain version on CPU tensors, the shape alone under a
# trace. ``params`` as for ``sast_tpu_torch::sparse_block_fwd``.
@torch.library.custom_op(
    "sast_tpu_torch::fused_block_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor y, Tensor token_keep, Tensor[] params, int num_heads, int dim_head, "
           "float norm_eps) -> Tensor")
def _fused_op(y, token_keep, params, num_heads, dim_head, norm_eps):
    if not y.shape[0]:
        return torch.empty_like(y)
    ids, n_win = _every_window(y.shape[0], y.device)
    out, _ = sparse_block._sparse_fwd(y, token_keep, ids, n_win,
                                      dict(zip(block.PARAM_KEYS, params)), num_heads, dim_head,
                                      norm_eps, False)
    fused_window_block.launches += 1
    return out


@_fused_op.register_kernel("cpu")
def _fused_cpu(y, token_keep, params, num_heads, dim_head, norm_eps):
    return fused_block_plain(y, token_keep, dict(zip(block.PARAM_KEYS, params)), num_heads,
                             dim_head, norm_eps)


@_fused_op.register_fake
def _fused_fake(y, token_keep, params, num_heads, dim_head, norm_eps):
    return torch.empty_like(y)


@register_flop_formula(torch.ops.sast_tpu_torch.fused_block_fwd)
def _fused_flops(y, token_keep, params, *args, out_shape=None, **kwargs):
    return block.window_block_flops(y, params)


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
