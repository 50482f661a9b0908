"""Sparse window block: the masked SAST block on kept windows only.

Replaces the TPU kernels ``_sparse_window_block_impl`` / ``_block_kernel``
and ``sparse_window_block_looped`` / ``_looped_kernel``
(sast_tpu/ops/pallas/sparse_block.py). Both walk the kept-first work list
``argsort(~win_keep, stable)``: slots below ``n_win`` run the block
(``ops/block.block_window_plain`` is its plain version), the rest pass
``y`` through.

- ``sparse_window_block``: the launches of ``csrc/sparse_fwd.cu`` over the
  tokens of the kept windows (prep, QKV, a core per window and head, proj,
  GLU, out; every product a grid of tensor-core tiles, ``csrc/rows_gemm.cuh``);
  with ``save_h1`` it also returns the fp32 post-attention residual h1, the
  one tensor a backward over the same work list needs. Under grad mode it is
  a ``torch.autograd.Function`` whose backward is
  ``sparse_window_block_bwd``: over the same work list, the MLP-branch
  launches of ``csrc/mlp_bwd.cu`` (``_mlp_bwd_kernel`` of the TPU package)
  and the attention-branch launches of ``csrc/attn_bwd.cu``
  (``_attn_bwd_kernel``), with ``sparse_window_block_bwd_plain`` as their
  plain version.
- ``sparse_window_block_looped``: the same steps as phases of one
  persistent cooperative launch (the second entry point of
  ``csrc/sparse_fwd.cu``, whose note says how): the kernel builds the work
  list from ``win_keep`` itself, then runs prep, QKV, the cores, proj, GLU
  and out over the kept tokens with a grid barrier between two phases, on
  as many blocks as the card holds at once. It runs E's device routines in
  E's order, so its output equals E's bit for bit. One ``ctypes`` call, one
  workspace and a fresh output; no sort and no host read. If the card
  refuses the cooperative launch, the wrapper raises.

The work list and ``n_win`` stay on the device (the kernels read ``n_win``
from memory), so neither wrapper synchronises with the host. Each forward
wrapper calls its operator (``sast_tpu_torch::sparse_block_fwd``,
``sast_tpu_torch::sparse_block_looped``), which takes the plain version
only for a CPU tensor, launches or raises on a CUDA tensor, and stands in
a ``torch.export`` graph by its shapes. The looped wrapper is forward only
(the TPU package gives it no VJP either): under grad mode with a tensor that
requires grad it raises.

Arithmetic of the backward. The recomputation rounds exactly as the forward
routine does. Every product of the backward whose second operand is a weight
matrix (``g W^T``) takes its first operand rounded to the weights' dtype, as
the forward products do (bf16 weights: bf16 x bf16 on the tensor cores,
fp32 sums; fp32 weights: fp32 FMA). The weight-gradient products ``X^T G``
and the per-head products of the attention backward take the values the
forward's products saw (``X`` rounded to the weights' dtype, so ``dW`` is
the gradient of the product as it was computed) and an fp32 ``G``: with
bf16 weights on the tensor cores with ``G`` split into bf16 ``hi + lo``,
with fp32 weights in fp32 FMA. Accumulators are fp32; each parameter
gradient is then cast to that parameter's dtype, so with bf16 compute the
matrix gradients are rounded to bf16 on their way to the fp32 master
weights, as the TPU package's ``_sparse_block_bwd_impl`` does. On the card
both backward kernels sum per-block partials in a fixed order, without
float atomics, so ``dy`` and every parameter gradient are the same bits
from run to run.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from sast_tpu_torch import build
from sast_tpu_torch.ops import block
from sast_tpu_torch.ops.block import MASK_VALUE, _mm

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


# Blocks of kernel F's cooperative launch; 0 takes as many as the card holds
# at once (the occupancy times the SMs). A grid larger than that is refused
# by the launch, and the wrapper raises.
LOOPED_BLOCKS = 0
# Kernel F's phase clock: None, or a CUDA tensor of 8 int64 zeros into which
# the next launch writes the card's clock in ns at its start, after each of
# its six grid barriers and at its end (``csrc/sparse_fwd.cu`` looped_kernel;
# phase k took entry k + 1 - entry k). Read by chip_smoke.py.
LOOPED_STAMPS = None


@functools.cache
def _fwd_entry(card: int):
    lib = build.load("sparse_fwd", card)
    fn = lib.sast_sparse_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.sast_sparse_fwd_workspace
    size.argtypes, size.restype = [ctypes.c_int] * 6, ctypes.c_longlong
    return fn, size


def _aligned(table, what):
    """Raise unless every tensor the kernels read in 16-byte pieces is
    16-byte aligned (the work list and the keep mask are read by element)."""
    if any(t.data_ptr() % 16 for t in table
           if t is not None and t.dtype not in (torch.int32, torch.bool)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")


@functools.cache
def _looped_entry(card: int):
    lib = build.load("sparse_fwd", card)
    fn = lib.sast_looped_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.sast_looped_fwd_workspace
    size.argtypes, size.restype = [ctypes.c_int] * 6, ctypes.c_longlong
    return fn, size


@build.on_its_card
def _looped_fwd(y, token_keep, win_keep, params, num_heads, dim_head, norm_eps):
    """Kernel F (one ``ctypes`` call, one cooperative launch) on a CUDA
    tensor: the work list of ``win_keep``, built on the card, and the block
    over it; its intermediates live in one workspace allocated here."""
    what = "sparse_window_block_looped"
    keep, ops, inner, flags = block.operands(y, token_keep, params, num_heads, dim_head, what)
    if win_keep.device != y.device:
        raise ValueError(f"{what}: win_keep is on {win_keep.device}, y on {y.device}")
    M, hw, C = y.shape
    out = torch.empty_like(y)
    table = [y, keep, out, win_keep.contiguous()] + [ops[k] for k in block.PARAM_KEYS]
    table.append(LOOPED_STAMPS)
    _aligned(table, what)
    fn, size = _looped_entry(y.device.index)
    n_work = size(M, hw, C, inner, dim_head, flags[1])
    if n_work < 0:
        raise ValueError(f"{what}: a window of hw {hw}, C {C}, dim_head {dim_head} is not "
                         "built or does not fit the card's shared memory")
    workspace = torch.empty(int(n_work), dtype=torch.uint8, device=y.device)
    ptrs = (ctypes.c_void_p * len(table))(*[0 if t is None else t.data_ptr() for t in table])
    stream = torch.cuda.current_stream(y.device).cuda_stream
    build.check(fn(ptrs, len(table), workspace.data_ptr(), n_work, M, hw, C, inner, num_heads,
                   dim_head, float(norm_eps), *flags, LOOPED_BLOCKS, stream), what)
    return out


@build.on_its_card
def _sparse_fwd(y, token_keep, ids, n_win, params, num_heads, dim_head, norm_eps, save_h1):
    """Kernel E's launches (one ``ctypes`` call) on a CUDA tensor over the
    work list ``ids`` / ``n_win`` (kernel D passes the identity): their
    intermediates over the kept tokens live in one workspace allocated
    here."""
    what = "sparse_window_block"
    keep, ops, inner, flags = block.operands(y, token_keep, params, num_heads, dim_head, what)
    M, hw, C = y.shape
    out = torch.empty_like(y)
    h1 = torch.empty(y.shape, dtype=torch.float32, device=y.device) if save_h1 else None
    table = [y, keep, out, h1, ids, n_win] + [ops[k] for k in block.PARAM_KEYS]
    _aligned(table, what)
    fn, size = _fwd_entry(y.device.index)
    n_work = size(M, hw, C, inner, dim_head, flags[1])
    if n_work < 0:
        raise ValueError(f"{what}: a window of hw {hw}, C {C}, dim_head {dim_head} is not "
                         "built or does not fit the card's shared memory")
    workspace = torch.empty(int(n_work), dtype=torch.uint8, device=y.device)
    ptrs = (ctypes.c_void_p * len(table))(*[0 if t is None else t.data_ptr() for t in table])
    stream = torch.cuda.current_stream(y.device).cuda_stream
    build.check(fn(ptrs, len(table), workspace.data_ptr(), n_work, M, hw, C, inner, num_heads,
                   dim_head, float(norm_eps), *flags, stream), what)
    return out, h1


def _run(wrapper, y, token_keep, win_keep, params, num_heads, dim_head, norm_eps, save_h1):
    M = y.shape[0]
    if win_keep.shape != (M,) or win_keep.dtype != torch.bool:
        raise ValueError(f"{wrapper.__name__}: win_keep must be (M,) bool")
    build.check_device(y, wrapper.__name__)
    y = y.contiguous()
    plist = [params[k] for k in block.PARAM_KEYS]
    if wrapper is sparse_window_block_looped:
        return torch.ops.sast_tpu_torch.sparse_block_looped(
            y, token_keep, win_keep, plist, num_heads, dim_head, float(norm_eps))
    out, h1 = torch.ops.sast_tpu_torch.sparse_block_fwd(
        y, token_keep, win_keep, plist, num_heads, dim_head, float(norm_eps), save_h1)
    return (out, h1) if save_h1 else out


# The operators: ``sparse_block_fwd`` is kernel E's launches over the work
# list of ``win_keep`` (kernel D's, over every window, is
# ``ops/fused_block.py``'s operator), ``sparse_block_looped`` is kernel F.
# On CUDA tensors each launches or raises and counts its launch; on CPU
# tensors each runs the plain version; under a trace (``torch.export``) each
# stands in the graph by its shapes. ``params`` is ``ops/block.kernel_params``'
# dict as a list in ``PARAM_KEYS`` order; the h1 of a call without
# ``save_h1`` is empty.
@torch.library.custom_op(
    "sast_tpu_torch::sparse_block_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor y, Tensor token_keep, Tensor win_keep, Tensor[] params, int num_heads, "
           "int dim_head, float norm_eps, bool save_h1) -> (Tensor, Tensor)")
def _sparse_fwd_op(y, token_keep, win_keep, params, num_heads, dim_head, norm_eps, save_h1):
    if not y.shape[0]:
        return _sparse_fwd_fake(y, token_keep, win_keep, params, num_heads, dim_head, norm_eps,
                                save_h1)
    ids, n_win = block.work_list(win_keep)
    out, h1 = _sparse_fwd(y, token_keep, ids, n_win, dict(zip(block.PARAM_KEYS, params)),
                          num_heads, dim_head, norm_eps, save_h1)
    sparse_window_block.launches += 1
    return out, h1 if save_h1 else y.new_empty((0,), dtype=torch.float32)


@_sparse_fwd_op.register_kernel("cpu")
def _sparse_fwd_cpu(y, token_keep, win_keep, params, num_heads, dim_head, norm_eps, save_h1):
    out = sparse_window_block_plain(y, token_keep, win_keep, dict(zip(block.PARAM_KEYS, params)),
                                    num_heads, dim_head, norm_eps, save_h1)
    return out if save_h1 else (out, y.new_empty((0,), dtype=torch.float32))


@_sparse_fwd_op.register_fake
def _sparse_fwd_fake(y, token_keep, win_keep, params, num_heads, dim_head, norm_eps, save_h1):
    return torch.empty_like(y), y.new_empty(y.shape if save_h1 else (0,), dtype=torch.float32)


@torch.library.custom_op(
    "sast_tpu_torch::sparse_block_looped", mutates_args=(), device_types="cuda",
    schema="(Tensor y, Tensor token_keep, Tensor win_keep, Tensor[] params, int num_heads, "
           "int dim_head, float norm_eps) -> Tensor")
def _looped_op(y, token_keep, win_keep, params, num_heads, dim_head, norm_eps):
    if not y.shape[0]:
        return torch.empty_like(y)
    out = _looped_fwd(y, token_keep, win_keep, dict(zip(block.PARAM_KEYS, params)), num_heads,
                      dim_head, norm_eps)
    sparse_window_block_looped.launches += 1
    return out


@_looped_op.register_kernel("cpu")
def _looped_cpu(y, token_keep, win_keep, params, num_heads, dim_head, norm_eps):
    return sparse_window_block_plain(y, token_keep, win_keep, dict(zip(block.PARAM_KEYS, params)),
                                     num_heads, dim_head, norm_eps)


@_looped_op.register_fake
def _looped_fake(y, token_keep, win_keep, params, num_heads, dim_head, norm_eps):
    return torch.empty_like(y)


# FLOP counts (``FlopCounterMode``): the plain version's at full window
# density, whatever the kept share, so that a configuration counts the same
# on every attention path.
@register_flop_formula([torch.ops.sast_tpu_torch.sparse_block_fwd,
                        torch.ops.sast_tpu_torch.sparse_block_looped])
def _sparse_flops(y, token_keep, win_keep, params, *args, out_shape=None, **kwargs):
    return block.window_block_flops(y, params)


def sparse_window_block(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    win_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
    save_h1: bool = False,
    leaves=None,
):
    """The masked block on kept windows only, as launches over their tokens.

    Args:
      y: (M, hw, C) norm1-ed window tokens, fp32 or bf16 (M = B * N).
      token_keep: (M, hw) bool; win_keep: (M,) bool.
      params: the weight dict of ``ops/block.kernel_params`` (detached).
      leaves: the parameters behind ``params`` that take the gradients
        (``ops/block.kernel_leaves``), or None when only ``y`` does.

    Returns (M, hw, C) in ``y``'s dtype, equal to ``y`` outside kept windows
    and at unkept tokens; with ``save_h1`` also h1 (M, hw, C) fp32. Under
    grad mode, with ``y`` or a leaf requiring grad, the result carries the
    hand-written backward.
    """
    if block.needs_grad(y, leaves):
        if save_h1:
            raise ValueError("sparse_window_block: save_h1 is the backward's own residual; "
                             "it is not returned under grad mode")
        leaves = tuple(leaves) if leaves is not None else (None,) * len(block.PARAM_KEYS)
        return _SparseBlockFn.apply(y, token_keep, win_keep, params, num_heads, dim_head,
                                    norm_eps, *leaves)
    return _run(sparse_window_block, y, token_keep, win_keep, params, num_heads, dim_head,
                norm_eps, save_h1)


def sparse_window_block_looped(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    win_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
) -> torch.Tensor:
    """Looped-grid variant of ``sparse_window_block`` (same function, no
    h1): one persistent cooperative launch that builds its own work list.
    Returns a new tensor; ``y`` is left as it was."""
    block.check_no_grad("sparse_window_block_looped", y, params)
    return _run(sparse_window_block_looped, y, token_keep, win_keep, params, num_heads,
                dim_head, norm_eps, False)


# ---------------------------------------------------------------------------
# Backward over the same work list


def _gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh-form GELU."""
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x + 0.044715 * x * x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * x * x)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).to(torch.float32)


MLP_KEYS = ("wglu", "bglu", "wout", "bout", "ls2")
ATTN_KEYS = ("wqkv", "bqkv", "wproj", "bproj", "ls1", "ln2_scale", "ln2_bias")
Work = Tuple[torch.Tensor, torch.Tensor]  # ``ops/block.work_list``: (ids, n_win)


def _zeros_like_params(params, keys, device):
    return {k: torch.zeros(params[k].shape, dtype=torch.float32, device=device) for k in keys}


def sparse_block_mlp_bwd_plain(h1, token_keep, work: Work, params, g):
    """Plain PyTorch version of the MLP backward kernel (any device): its
    arithmetic step by step on the kept prefix of the work list.
    Returns ``(gh1, acc)``: the cotangent carried to the attention kernel,
    ``gh1 + (1 - keep) * g`` in kept windows and ``g`` elsewhere, fp32; and
    the fp32 gradients of ``MLP_KEYS`` (matrices ``(in, out)``). Reads the
    number of kept windows on the host to size the prefix."""
    ids, n_win = work
    kept = ids[: int(n_win)].long()
    acc = _zeros_like_params(params, MLP_KEYS, g.device)
    gh1 = g.to(torch.float32, copy=True)
    if not kept.numel():
        return gh1, acc
    p, wdt = params, params["wglu"].dtype
    h1 = h1[kept]
    k = token_keep[kept][..., None]
    g32 = gh1[kept]
    g_h2 = torch.where(k, g32, 0.0)
    u = _mm(h1, p["wglu"]) + p["bglu"].float()
    inner = u.shape[-1] // 2
    val, gate = u[..., :inner], u[..., inner:]
    act = F.gelu(gate, approximate="tanh")
    m = _rounded(val * act, wdt)
    mlp = m @ p["wout"].float() + p["bout"].float()
    acc["ls2"] += (g_h2 * mlp).sum(dim=(0, 1))
    g_mlp = g_h2 * p["ls2"].float()
    acc["wout"] += torch.einsum("mri,mrc->ic", m, g_mlp)
    acc["bout"] += g_mlp.sum(dim=(0, 1))
    g_m = _mm(g_mlp, p["wout"].t())
    g_u = torch.cat((g_m * act, _gelu_tanh_grad(gate) * (g_m * val)), dim=-1)
    acc["wglu"] += torch.einsum("mrc,mrj->cj", _rounded(h1, wdt), g_u)
    acc["bglu"] += g_u.sum(dim=(0, 1))
    g_h1 = g_h2 + _mm(g_u, p["wglu"].t())
    gh1[kept] = g_h1 + torch.where(k, 0.0, g32)
    return gh1, acc


def sparse_block_attn_bwd_plain(y, token_keep, work: Work, params, gh1, num_heads, dim_head,
                                norm_eps=1e-5):
    """Plain PyTorch version of the attention backward kernel (any device):
    its arithmetic step by step on the kept prefix of the work list.
    Returns ``(dy, acc)``: ``dy`` in ``y``'s dtype (``gh1`` itself outside
    kept windows) and the fp32 gradients of ``ATTN_KEYS``."""
    ids, n_win = work
    kept = ids[: int(n_win)].long()
    acc = _zeros_like_params(params, ATTN_KEYS, y.device)
    dy = gh1.clone()
    if not kept.numel():
        return dy.to(y.dtype), acc
    p, wdt = params, params["wqkv"].dtype
    keep = token_keep[kept]
    k = keep[..., None]
    y32 = y[kept].to(torch.float32)
    M, hw, C = y32.shape
    gh1_in = gh1[kept]
    gh1_k = torch.where(k, gh1_in, 0.0)
    dy_pass = torch.where(k, 0.0, gh1_in)

    # Recompute z, qkv and the attention as the forward routine rounds them.
    mu = y32.mean(dim=-1, keepdim=True)
    var = ((y32 - mu) ** 2).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + norm_eps)
    xhat = (y32 - mu) * r
    ln2s = p["ln2_scale"].float()
    z = torch.where(k, xhat * ln2s + p["ln2_bias"].float(), y32)
    z_r = _rounded(z, wdt)
    qkv = _rounded(z_r @ p["wqkv"].float() + p["bqkv"].float(), wdt)
    qkv = qkv.reshape(M, hw, 3, num_heads, dim_head)
    q, kk, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (M, h, hw, dh)
    scale = dim_head ** -0.5
    key_mask = keep[:, None, None, :]
    logits = torch.where(key_mask, (q @ kk.transpose(-1, -2)) * scale, MASK_VALUE)
    attn = torch.softmax(logits, dim=-1)
    attn_r = _rounded(attn, wdt)
    attn_out = _rounded((attn_r @ v).permute(0, 2, 1, 3).reshape(M, hw, C), wdt)
    proj = attn_out @ p["wproj"].float() + p["bproj"].float()

    # h1 = z + ls1 * proj
    acc["ls1"] += (gh1_k * proj).sum(dim=(0, 1))
    g_proj = gh1_k * p["ls1"].float()
    acc["wproj"] += torch.einsum("mrc,mrd->cd", attn_out, g_proj)
    acc["bproj"] += g_proj.sum(dim=(0, 1))
    g_ao = _rounded(_mm(g_proj, p["wproj"].t()), wdt)
    g_ao = g_ao.reshape(M, hw, num_heads, dim_head).permute(0, 2, 1, 3)  # (M, h, hw, dh)

    # Attention backward per head.
    g_attn = g_ao @ v.transpose(-1, -2)
    s = (g_attn * attn).sum(dim=-1, keepdim=True)
    g_logits = torch.where(key_mask, attn * (g_attn - s), 0.0)
    gq = (g_logits @ kk) * scale
    gk = (g_logits.transpose(-1, -2) @ q) * scale
    gv = attn_r.transpose(-1, -2) @ g_ao
    g_qkv = torch.stack((gq, gk, gv), dim=1)  # (M, 3, h, hw, dh)
    g_qkv = g_qkv.permute(0, 3, 1, 2, 4).reshape(M, hw, 3 * C)
    acc["wqkv"] += torch.einsum("mrc,mrj->cj", z_r, g_qkv)
    acc["bqkv"] += g_qkv.sum(dim=(0, 1))
    g_z = gh1_k + _mm(g_qkv, p["wqkv"].t())

    # z = where(keep, LN2(y), y)
    g_zln = torch.where(k, g_z, 0.0)
    g_zid = torch.where(k, 0.0, g_z)
    acc["ln2_scale"] += (g_zln * xhat).sum(dim=(0, 1))
    acc["ln2_bias"] += g_zln.sum(dim=(0, 1))
    g_xhat = g_zln * ln2s
    mean_g = g_xhat.mean(dim=-1, keepdim=True)
    mean_gx = (g_xhat * xhat).mean(dim=-1, keepdim=True)
    g_y_ln = r * (g_xhat - mean_g - xhat * mean_gx)
    dy[kept] = dy_pass + g_zid + torch.where(k, g_y_ln, 0.0)
    return dy.to(y.dtype), acc


@functools.cache
def _mlp_entry(card: int):
    lib = build.load("mlp_bwd", card)
    fn = lib.sast_mlp_bwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.sast_mlp_bwd_workspace
    size.argtypes, size.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    return fn, size


def sparse_block_mlp_bwd(h1, token_keep, work: Work, params, g, num_heads, dim_head):
    """MLP branch of the backward over the work list (the launches of
    ``csrc/mlp_bwd.cu``, counted as one): same contract as
    ``sparse_block_mlp_bwd_plain``, which a CPU tensor goes to; on a CUDA
    tensor the kernels launch or raise. ``g`` is the cotangent of the block's
    output, in its dtype. The kernels read each matrix as stored, ``(out,
    in)``, keep their intermediates over the kept tokens in one workspace
    allocated here, and write every gradient whole without atomics, so two
    calls on the same inputs give the same bits."""
    if g.device.type == "cpu":
        return sparse_block_mlp_bwd_plain(h1, token_keep, work, params, g)
    what = "sparse_block_mlp_bwd"
    g = g.contiguous()
    keep, ops, inner, flags = block.operands(g, token_keep, params, num_heads, dim_head, what)
    if h1.shape != g.shape or h1.dtype != torch.float32 or not h1.is_contiguous():
        raise ValueError(f"{what}: h1 must be contiguous (M, hw, C) float32")
    M, hw, C = g.shape
    gh1 = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    if not M:
        return gh1, _zeros_like_params(params, MLP_KEYS, g.device)
    acc = {k: torch.empty(params[k].shape, dtype=torch.float32, device=g.device)
           for k in MLP_KEYS}
    ids, n_win = work
    table = [h1, keep, g, ids, n_win, gh1, ops["wglu"], ops["bglu"], ops["wout"], ops["bout"],
             ops["ls2"]] + [acc[k] for k in MLP_KEYS]
    _aligned(table, what)
    fn, size = _mlp_entry(g.device.index)
    n_work = size(M, hw, C, inner, flags[1])
    if n_work < 0:
        raise ValueError(f"{what}: hw {hw}, C {C}, inner {inner} is not built")
    workspace = torch.empty(int(n_work), dtype=torch.uint8, device=g.device)
    ptrs = (ctypes.c_void_p * len(table))(*[t.data_ptr() for t in table])
    stream = torch.cuda.current_stream(g.device).cuda_stream
    build.check(fn(ptrs, len(table), workspace.data_ptr(), n_work, M, hw, C, inner, *flags,
                   stream), what)
    sparse_block_mlp_bwd.launches += 1
    return gh1, acc


@functools.cache
def _attn_entry(card: int):
    lib = build.load("attn_bwd", card)
    fn = lib.sast_attn_bwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.sast_attn_bwd_workspace
    size.argtypes, size.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    return fn, size


def sparse_block_attn_bwd(y, token_keep, work: Work, params, gh1, num_heads, dim_head,
                          norm_eps=1e-5):
    """Attention branch of the backward over the work list (the launches of
    ``csrc/attn_bwd.cu``, counted as one): same contract as ``sparse_block_attn_bwd_plain``,
    which a CPU tensor goes to; on a CUDA tensor the kernels launch or
    raise. ``gh1`` is what ``sparse_block_mlp_bwd`` returned. The kernels
    keep their intermediates over the kept tokens in one workspace allocated
    here, and write every gradient whole without atomics, so two calls on the
    same inputs give the same bits."""
    if y.device.type == "cpu":
        return sparse_block_attn_bwd_plain(y, token_keep, work, params, gh1, num_heads,
                                           dim_head, norm_eps)
    what = "sparse_block_attn_bwd"
    y = y.contiguous()
    keep, ops, inner, flags = block.operands(y, token_keep, params, num_heads, dim_head, what)
    if gh1.shape != y.shape or gh1.dtype != torch.float32 or not gh1.is_contiguous():
        raise ValueError(f"{what}: gh1 must be contiguous (M, hw, C) float32")
    ids, n_win = work
    M, hw, C = y.shape
    dy = torch.empty_like(y)
    if not M:
        return dy, _zeros_like_params(params, ATTN_KEYS, y.device)
    acc = {k: torch.empty(params[k].shape, dtype=torch.float32, device=y.device)
           for k in ATTN_KEYS}
    table = [y, keep, gh1, ids, n_win, dy, ops["ln2_scale"], ops["ln2_bias"], ops["wqkv"],
             ops["bqkv"], ops["wproj"], ops["bproj"], ops["ls1"],
             params["wqkv"].contiguous(), params["wproj"].contiguous()] \
        + [acc[k] for k in ATTN_KEYS]
    _aligned(table, what)
    fn, size = _attn_entry(y.device.index)
    n_work = size(M, hw, C, dim_head, flags[1])
    if n_work < 0:
        raise ValueError(f"{what}: a window of hw {hw}, C {C}, dim_head {dim_head} is not "
                         "built or does not fit the card's shared memory")
    workspace = torch.empty(int(n_work), dtype=torch.uint8, device=y.device)
    ptrs = (ctypes.c_void_p * len(table))(*[t.data_ptr() for t in table])
    stream = torch.cuda.current_stream(y.device).cuda_stream
    build.check(fn(ptrs, len(table), workspace.data_ptr(), n_work, M, hw, C, num_heads,
                   dim_head, float(norm_eps), *flags, stream), what)
    sparse_block_attn_bwd.launches += 1
    return dy, acc


def _param_grads(acc, params):
    """The fp32 accumulators by ``PARAM_KEYS``, each cast to its
    parameter's dtype."""
    return {key: acc[key].to(params[key].dtype) for key in block.PARAM_KEYS}


def sparse_window_block_bwd_plain(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    win_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    h1: torch.Tensor,
    g: torch.Tensor,
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of the whole backward (any device): the two
    kernels' plain versions one after the other, not ``torch.autograd`` of
    the forward.

    Args as ``sparse_window_block``; ``h1`` is the forward's saved residual
    (M, hw, C) fp32 and ``g`` the cotangent of its output.

    Returns ``(dy, dparams)``: ``dy`` in ``y``'s dtype; ``dparams`` by
    ``PARAM_KEYS`` in ``params``' shapes and dtypes (matrices ``(in, out)``).
    Slots at or beyond the number of kept windows pass ``g`` through to
    ``dy``; with no kept window every parameter gradient is exactly zero.
    """
    work = block.work_list(win_keep)
    gh1, acc = sparse_block_mlp_bwd_plain(h1, token_keep, work, params, g)
    dy, acc_attn = sparse_block_attn_bwd_plain(y, token_keep, work, params, gh1, num_heads,
                                               dim_head, norm_eps)
    return dy, _param_grads({**acc, **acc_attn}, params)


def sparse_window_block_bwd(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    win_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    h1: torch.Tensor,
    g: torch.Tensor,
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of ``sparse_window_block`` over the same work list: the MLP
    kernel (h1, g -> gh1 and the MLP's parameter gradients), then the
    attention kernel (y, gh1 -> dy and the rest). Same contract as
    ``sparse_window_block_bwd_plain``; each kernel's wrapper takes its plain
    version only for a CPU tensor."""
    if g.shape != y.shape or g.dtype != y.dtype:
        raise ValueError("sparse_window_block_bwd: g must match y in shape and dtype")
    work = block.work_list(win_keep)
    gh1, acc = sparse_block_mlp_bwd(h1, token_keep, work, params, g, num_heads, dim_head)
    dy, acc_attn = sparse_block_attn_bwd(y, token_keep, work, params, gh1, num_heads, dim_head,
                                         norm_eps)
    return dy, _param_grads({**acc, **acc_attn}, params)


class _SparseBlockFn(torch.autograd.Function):
    """``sparse_window_block`` with ``save_h1`` as the forward and
    ``sparse_window_block_bwd`` as the backward. Differentiable inputs: ``y``
    and the leaves behind ``params`` (port layout)."""

    @staticmethod
    def forward(ctx, y, token_keep, win_keep, params, num_heads, dim_head, norm_eps, *leaves):
        y = y.contiguous()
        out, h1 = _run(sparse_window_block, y.detach(), token_keep, win_keep, params, num_heads,
                       dim_head, norm_eps, True)
        ctx.save_for_backward(y, token_keep, win_keep, h1, *[t for t in leaves if t is not None])
        ctx.present = [t is not None for t in leaves]
        ctx.params, ctx.shape = params, (num_heads, dim_head, norm_eps)
        return out

    @staticmethod
    def backward(ctx, g):
        y, token_keep, win_keep, h1, *given = ctx.saved_tensors
        given = iter(given)
        leaves = [next(given) if here else None for here in ctx.present]
        dy, dparams = sparse_window_block_bwd(y, token_keep, win_keep, ctx.params, h1,
                                              g.to(y.dtype), *ctx.shape)
        return (dy if ctx.needs_input_grad[0] else None, None, None, None, None, None, None,
                *block.leaf_grads(dparams, leaves))


sparse_window_block.launches = 0  # kernel launches, read by chip_smoke.py
sparse_window_block_looped.launches = 0
sparse_block_mlp_bwd.launches = 0
sparse_block_attn_bwd.launches = 0
