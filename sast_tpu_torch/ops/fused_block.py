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

``rvt_window_block`` is kernel D's RVT variant (no TPU kernel behind it):
the same launches over the identity work list with the wiring of RVT's
MaxViT layer (``models/maxvit.py``), every key attended and an ungated MLP
with the exact GELU, on raw (not norm1-ed) partitioned tokens::

    h1  = x + ls1 * proj(attn(LN1(x)))
    out = h1 + ls2 * W2(gelu(W1(LN2(h1))))

It is the operator ``sast_tpu_torch::rvt_block_fwd`` (the entry
``sast_rvt_block_fwd`` of ``csrc/sparse_fwd.cu``, whose kernels are named
within ``rvt_block``), with the plain version ``rvt_block_plain`` (D's
rounding points: fp32 activations, two-pass LayerNorm, the operands of
every product rounded to the weights' dtype) and D's three
implementations. It has no backward: under grad the layer runs its torch
ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F
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


# ---------------------------------------------------------------------------
# Kernel D's RVT variant.

# Order of the RVT variant's weight operands: matrices as contiguous
# ``(out, in)`` tensors in the compute dtype, vectors fp32.
RVT_KEYS = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj", "ls1",
            "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2", "ls2")
RVT_MATRICES = ("wqkv", "wproj", "w1", "w2")


def rvt_block_plain(x: torch.Tensor, params: Dict[str, torch.Tensor], num_heads: int,
                    dim_head: int, norm_eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the RVT variant (any device) on (M, hw, C)
    partitioned tokens ``x``; ``params`` by ``RVT_KEYS``, matrices ``(out,
    in)``. Returns (M, hw, C) in ``x``'s dtype."""
    M, hw, C = x.shape
    wdt = params["wqkv"].dtype

    def vec(key):
        return params[key].float()

    def ln(v, key):
        mu = v.mean(dim=-1, keepdim=True)
        var = ((v - mu) ** 2).mean(dim=-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + norm_eps) * vec(f"{key}_scale") + vec(f"{key}_bias")

    def mm(a, key):
        return a.to(wdt).float() @ params[key].float().t()

    x32 = x.float()
    qkv = (mm(ln(x32, "ln1"), "wqkv") + vec("bqkv")).to(wdt).float()
    q, k, v = qkv.reshape(M, hw, 3, num_heads, dim_head).permute(2, 0, 3, 1, 4)
    attn = torch.softmax((q @ k.transpose(-1, -2)) * dim_head ** -0.5, dim=-1)
    ao = (attn.to(wdt).float() @ v).permute(0, 2, 1, 3).reshape(M, hw, C)
    h1 = x32 + vec("ls1") * (mm(ao, "wproj") + vec("bproj"))
    m = F.gelu(mm(ln(h1, "ln2"), "w1") + vec("b1"))
    return (h1 + vec("ls2") * (mm(m, "w2") + vec("b2"))).to(x.dtype)


def rvt_block_flops(x_shape, inner: int) -> int:
    """FLOPs of ``rvt_block_plain`` on (M, hw, C) tokens with an MLP of
    ``inner``, as ``FlopCounterMode`` counts them: 2 per multiply-add of
    QKV, proj, W1 and W2 at every token and of q k^T and P v over every
    window and head."""
    M, hw, C = x_shape
    return 2 * M * hw * (4 * C * C + 2 * C * inner) + 2 * 2 * M * hw * hw * C


def rvt_params(layer) -> Dict[str, torch.Tensor]:
    """The RVT variant's weights from a ``models/maxvit.PartitionAttention``:
    each matrix the layer's own copy of its kernel in the compute dtype
    (``models/layers.cached_copy``, rewritten in place when the weights
    change, so that a captured graph that reads it stays valid; under a
    trace cast afresh), the vectors as stored, zeros for an absent bias."""
    from sast_tpu_torch.models.layers import cached_copy

    dense = {"wqkv": layer.qkv, "wproj": layer.proj, "w1": layer.mlp.Dense_0,
             "w2": layer.mlp.Dense_1}
    vectors = {"ln1_scale": layer.norm1.scale, "ln1_bias": layer.norm1.bias,
               "ls1": layer.ls1.gamma, "ln2_scale": layer.norm2.scale,
               "ln2_bias": layer.norm2.bias, "ls2": layer.ls2.gamma}
    dt = layer.qkv.dtype
    tracing = torch.compiler.is_compiling()
    params = {}
    for key, d in dense.items():
        params[key] = (d.kernel.to(dt) if tracing else cached_copy(d, "kernel", dt)).detach()
        bias = "b" + key[1:]
        params[bias] = (torch.zeros(d.kernel.shape[0], device=d.kernel.device) if d.bias is None
                        else d.bias.detach())
    params.update({k: v.detach() for k, v in vectors.items()})
    return {k: params[k] for k in RVT_KEYS}


def _rvt_operands(x, params, num_heads, dim_head, what):
    """Check what the RVT variant takes; returns ``(ops, inner, flags)`` as
    ``ops/block.operands`` does."""
    M, hw, C = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {x.device}")
    wdt = params["wqkv"].dtype
    if x.dtype not in (torch.float32, torch.bfloat16) or wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x {x.dtype} / weights {wdt} must be float32 or bfloat16")
    if x.dtype == torch.bfloat16 and wdt == torch.float32:
        raise ValueError(f"{what}: bfloat16 tokens with float32 weights are not built")
    inner = params["w1"].shape[0]
    if (hw > block.MAX_HW or C % 16 or dim_head % 16 or inner % 16
            or C != num_heads * dim_head or not x.is_contiguous()):
        raise ValueError(
            f"{what}: needs contiguous x, hw <= {block.MAX_HW}, C = heads * dim_head and C, "
            f"dim_head, inner multiples of 16; got hw {hw}, C {C}, heads {num_heads}, "
            f"dim_head {dim_head}, inner {inner}")
    shapes = {"wqkv": (3 * C, C), "bqkv": (3 * C,), "wproj": (C, C), "w1": (inner, C),
              "b1": (inner,), "w2": (C, inner)}
    ops = {}
    for key in RVT_KEYS:
        t = params[key]
        if tuple(t.shape) != shapes.get(key, (C,)) or t.device != x.device:
            raise ValueError(f"{what}: {key} is {tuple(t.shape)} on {t.device}, "
                             f"expected {shapes.get(key, (C,))} on {x.device}")
        if key in RVT_MATRICES:
            if t.dtype != wdt:
                raise ValueError(f"{what}: {key} is {t.dtype}, wqkv is {wdt}")
            ops[key] = t.detach().contiguous()
        else:
            ops[key] = t.detach().to(torch.float32).contiguous()
    return ops, inner, (int(x.dtype == torch.bfloat16), int(wdt == torch.bfloat16))


@functools.cache
def _rvt_entry(card: int):
    lib = build.load("sparse_fwd", card)
    fn = lib.sast_rvt_block_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.sast_sparse_fwd_workspace
    size.argtypes, size.restype = [ctypes.c_int] * 6, ctypes.c_longlong
    return fn, size


@build.on_its_card
def _rvt_fwd(x, params, num_heads, dim_head, norm_eps):
    """The RVT variant's launches (one ``ctypes`` call) on a CUDA tensor
    over the identity work list; its intermediates in one workspace."""
    what = "rvt_window_block"
    ops, inner, flags = _rvt_operands(x, params, num_heads, dim_head, what)
    M, hw, C = x.shape
    ids, n_win = _every_window(M, x.device)
    out = torch.empty_like(x)
    table = [x, out, ids, n_win] + [ops[k] for k in RVT_KEYS]
    sparse_block._aligned(table, what)
    fn, size = _rvt_entry(x.device.index)
    n_work = size(M, hw, C, inner, dim_head, flags[1])
    if n_work < 0:
        raise ValueError(f"{what}: a window of hw {hw}, C {C}, dim_head {dim_head} is not "
                         "built or does not fit the card's shared memory")
    workspace = torch.empty(int(n_work), dtype=torch.uint8, device=x.device)
    ptrs = (ctypes.c_void_p * len(table))(*[t.data_ptr() for t in table])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(ptrs, len(table), workspace.data_ptr(), n_work, M, hw, C, inner, num_heads,
                   dim_head, float(norm_eps), *flags, stream), what)
    return out


# The operator: the RVT variant's launches on CUDA tensors, the plain
# version on CPU tensors, the shape alone under a trace. ``params`` is the
# dict of ``rvt_params`` as a list in ``RVT_KEYS`` order.
@torch.library.custom_op(
    "sast_tpu_torch::rvt_block_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor[] params, int num_heads, int dim_head, float norm_eps) -> Tensor")
def _rvt_op(x, params, num_heads, dim_head, norm_eps):
    if not x.shape[0]:
        return torch.empty_like(x)
    out = _rvt_fwd(x, dict(zip(RVT_KEYS, params)), num_heads, dim_head, norm_eps)
    rvt_window_block.launches += 1
    return out


@_rvt_op.register_kernel("cpu")
def _rvt_cpu(x, params, num_heads, dim_head, norm_eps):
    return rvt_block_plain(x, dict(zip(RVT_KEYS, params)), num_heads, dim_head, norm_eps)


@_rvt_op.register_fake
def _rvt_fake(x, params, num_heads, dim_head, norm_eps):
    return torch.empty_like(x)


@register_flop_formula(torch.ops.sast_tpu_torch.rvt_block_fwd)
def _rvt_flops(x, params, *args, out_shape=None, **kwargs):
    return rvt_block_flops(x, params[RVT_KEYS.index("w1")][0])


def rvt_window_block(x: torch.Tensor, params: Dict[str, torch.Tensor], num_heads: int,
                     dim_head: int, norm_eps: float = 1e-5) -> torch.Tensor:
    """RVT's partition-attention layer on every window, forward only (under
    grad the layer runs its torch ops, ``models/maxvit.py``).

    Args:
      x: (M, hw, C) partitioned tokens (not normed), fp32 or bf16.
      params: the weight dict of ``rvt_params`` (detached).

    Returns (M, hw, C) in ``x``'s dtype.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("rvt_window_block has no backward: under grad the layer runs "
                         "its torch ops")
    build.check_device(x, "rvt_window_block")
    return torch.ops.sast_tpu_torch.rvt_block_fwd(
        x.contiguous(), [params[k] for k in RVT_KEYS], num_heads, dim_head, float(norm_eps))


rvt_window_block.launches = 0  # kernel launches, read by graphs.launch_counts
