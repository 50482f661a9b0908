"""The masked SAST block of one window: shared math of the block kernels.

Counterpart of ``_fwd_window`` (sast_tpu/ops/pallas/sparse_block.py) and
``fused_block_xla`` (sast_tpu/ops/pallas/fused_block.py): the function that
the fused, sparse and looped block kernels all compute, here as plain
PyTorch batched over windows, plus the pieces their wrappers share
(``kernel_params``, the kept-first work list, the operand checks).

Numerics of the kernels, which differ from the masked torch-op path of
``models/sast.py``: every activation is fp32; the LayerNorm variance is
two-pass over the real channels; only the operands of the matrix products
(z, q, k, v, the attention weights, attn_out, h1, the gated activation) are
rounded to the weights' dtype, and every product accumulates and returns
fp32; logits are scaled after the product; masked keys get exactly -1e4;
GELU is the tanh form.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

MASK_VALUE = -1e4
MAX_HW = 80  # rows of one window the kernels hold (5 tiles of 16)

# Order of the weight operands of the C entry points. Matrices are read as
# (out, in) rows, vectors as fp32.
MATRICES = ("wqkv", "wproj", "wglu", "wout")
PARAM_KEYS = ("ln2_scale", "ln2_bias", "wqkv", "bqkv", "wproj", "bproj", "ls1",
              "wglu", "bglu", "wout", "bout", "ls2")


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with ``a`` rounded to ``w``'s dtype, fp32 accumulation and
    an fp32 result (a product of bf16 values is exact in fp32)."""
    return a.to(w.dtype).to(torch.float32) @ w.to(torch.float32)


def block_window_plain(
    y: torch.Tensor,
    token_keep: torch.Tensor,
    params: Dict[str, torch.Tensor],
    num_heads: int,
    dim_head: int,
    norm_eps: float = 1e-5,
    return_h1: bool = False,
):
    """The masked block on every window of ``y``: plain PyTorch version of
    the block kernels' device routine.

    Args:
      y: (M, hw, C) norm1-ed window tokens.
      token_keep: (M, hw) bool.
      params: the weight dict of ``kernel_params`` (matrices ``(in, out)``).

    Returns (M, hw, C) in ``y``'s dtype, equal to ``y`` at unkept tokens;
    with ``return_h1`` also the post-attention residual h1 in fp32.
    """
    M, hw, C = y.shape
    wdt = params["wqkv"].dtype
    keep = token_keep[..., None]
    y32 = y.to(torch.float32)
    mu = y32.mean(dim=-1, keepdim=True)
    var = ((y32 - mu) ** 2).mean(dim=-1, keepdim=True)
    z_ln = (y32 - mu) * torch.rsqrt(var + norm_eps)
    z_ln = z_ln * params["ln2_scale"].float() + params["ln2_bias"].float()
    z = torch.where(keep, z_ln, y32)

    qkv = _mm(z, params["wqkv"]) + params["bqkv"].float()
    qkv = qkv.to(wdt).to(torch.float32).reshape(M, hw, 3, num_heads, dim_head)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (M, h, hw, dh)
    logits = (q @ k.transpose(-1, -2)) * dim_head ** -0.5
    logits = torch.where(token_keep[:, None, None, :], logits, MASK_VALUE)
    attn = torch.softmax(logits, dim=-1).to(wdt).to(torch.float32)
    attn_out = (attn @ v).permute(0, 2, 1, 3).reshape(M, hw, C)
    h1 = z + params["ls1"].float() * (_mm(attn_out, params["wproj"]) + params["bproj"].float())

    u = _mm(h1, params["wglu"]) + params["bglu"].float()
    inner = u.shape[-1] // 2
    m = u[..., :inner] * F.gelu(u[..., inner:], approximate="tanh")
    h2 = h1 + params["ls2"].float() * (_mm(m, params["wout"]) + params["bout"].float())
    out = torch.where(keep, h2, y32).to(y.dtype)
    return (out, h1) if return_h1 else out


def window_block_flops(y_shape, param_shapes) -> int:
    """FLOPs of ``block_window_plain`` on every window of a ``y`` of shape
    (M, hw, C), as ``FlopCounterMode`` counts them (2 per multiply-add of
    each product): the four weight products of every token, and the logits
    and weighted values of every window over all heads. ``param_shapes``:
    the shapes of ``kernel_params``' dict in ``PARAM_KEYS`` order, the
    matrices ``(in, out)``. The registered formula of the block kernels'
    operators."""
    M, hw, C = y_shape
    weights = sum(param_shapes[PARAM_KEYS.index(k)][0] * param_shapes[PARAM_KEYS.index(k)][1]
                  for k in MATRICES)
    return 2 * M * hw * weights + 2 * 2 * M * hw * hw * C


def kernel_params(attn) -> Dict[str, torch.Tensor]:
    """The weight dict the block kernels share, from a port
    ``MaskedSparseAttention``: the keys, shapes and dtypes of the JAX
    module's ``kernel_params`` (matrices ``(in, out)`` in the compute dtype,
    vectors as stored, zeros for absent biases).

    The port stores ``Dense`` kernels ``(out, in)``, which is how the CUDA
    kernels read a matrix, so each matrix here is the transposed *view* of a
    contiguous ``(out, in)`` tensor in the compute dtype: the plain version
    multiplies by the view, the launcher takes the tensor under it without a
    copy. The dict is cached on the module and rebuilt when a parameter is
    written, moved or cast. Under a trace (``torch.export``, whose
    parameters have no storage) it is built from the traced parameters and
    neither read from nor written to the cache."""
    dense = (attn.qkv, attn.proj, attn.mlp.GLU_0.Dense_0, attn.mlp.Dense_0)
    tracing = torch.compiler.is_compiling()
    if not tracing:
        vectors = (attn.norm2.scale, attn.norm2.bias, attn.ls1.gamma, attn.ls2.gamma)
        source = [d.kernel for d in dense] + [d.bias for d in dense if d.bias is not None]
        source += list(vectors)
        stamp = (attn.qkv.dtype,) + tuple((t.data_ptr(), t._version) for t in source)
        cached = getattr(attn, "_kernel_params", None)
        if cached is not None and cached[0] == stamp:
            return cached[1]
    dt = attn.qkv.dtype

    def bias(d):
        if d.bias is not None:
            return d.bias.detach()
        return torch.zeros(d.kernel.shape[0], device=d.kernel.device)

    params = {
        "ln2_scale": attn.norm2.scale.detach(),
        "ln2_bias": attn.norm2.bias.detach(),
        "ls1": attn.ls1.gamma.detach(),
        "ls2": attn.ls2.gamma.detach(),
    }
    for key, bkey, d in zip(MATRICES, ("bqkv", "bproj", "bglu", "bout"), dense):
        params[key] = d.kernel.detach().to(dt).contiguous().t()
        params[bkey] = bias(d)
    if not tracing:
        attn._kernel_params = (stamp, params)
    return params


def work_list(win_keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kept-first permutation of all window ids (int32) and the number of
    kept windows as a one-element int32 tensor; both stay on the device."""
    ids = torch.argsort(~win_keep, stable=True).to(torch.int32)
    n_win = win_keep.sum(dtype=torch.int32).reshape(1)
    return ids, n_win


def kernel_leaves(attn) -> Tuple[Optional[torch.Tensor], ...]:
    """The module's own parameters behind ``kernel_params``, in
    ``PARAM_KEYS`` order and the port's layout (``Dense`` kernels ``(out,
    in)`` fp32, ``None`` for an absent bias): the tensors on which the
    trainable block wrappers land their gradients."""
    qkv, proj, glu, out = (attn.qkv, attn.proj, attn.mlp.GLU_0.Dense_0, attn.mlp.Dense_0)
    return (attn.norm2.scale, attn.norm2.bias, qkv.kernel, qkv.bias, proj.kernel, proj.bias,
            attn.ls1.gamma, glu.kernel, glu.bias, out.kernel, out.bias, attn.ls2.gamma)


def needs_grad(y: torch.Tensor, leaves) -> bool:
    """Whether a block wrapper has to sit in the autograd graph."""
    return torch.is_grad_enabled() and (
        y.requires_grad or any(t is not None and t.requires_grad for t in leaves or ())
    )


def leaf_grads(dparams: Dict[str, torch.Tensor], leaves) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of the ``kernel_params`` dict (matrices ``(in, out)``) as
    gradients of ``kernel_leaves``: transposed to ``(out, in)`` and cast to
    each leaf's dtype; ``None`` where there is no leaf."""
    out = []
    for key, leaf in zip(PARAM_KEYS, leaves):
        if leaf is None or not leaf.requires_grad:
            out.append(None)
            continue
        grad = dparams[key].t() if key in MATRICES else dparams[key]
        out.append(grad.to(leaf.dtype))
    return tuple(out)


def params_from_leaves(leaves, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``kernel_params`` rebuilt differentiably from ``kernel_leaves``:
    matrices cast to ``dtype`` and viewed ``(in, out)``, zeros for absent
    biases."""
    by_key = dict(zip(PARAM_KEYS, leaves))
    widths = {"bqkv": "wqkv", "bproj": "wproj", "bglu": "wglu", "bout": "wout"}
    params = {}
    for key in PARAM_KEYS:
        t = by_key[key]
        if key in MATRICES:
            params[key] = t.to(dtype).t()
        elif t is None:
            w = by_key[widths[key]]
            params[key] = torch.zeros(w.shape[0], device=w.device)
        else:
            params[key] = t
    return params


def check_no_grad(name: str, y: torch.Tensor, params: Dict[str, torch.Tensor]) -> None:
    """A wrapper without a backward refuses to sit in a graph."""
    if torch.is_grad_enabled() and (
        y.requires_grad or any(p.requires_grad for p in params.values())
    ):
        raise RuntimeError(
            f"{name}: this kernel has no backward; call it under torch.no_grad()"
        )


def operands(y: torch.Tensor, token_keep: torch.Tensor, params: Dict[str, torch.Tensor],
             num_heads: int, dim_head: int, what: str):
    """Check what every block kernel takes and return ``(keep, ops, inner,
    flags)``: the contiguous keep mask, the weight operands by key (matrices
    as contiguous ``(out, in)`` tensors, vectors fp32), the MLP's inner width
    and the (y is bf16, weights are bf16) flags. Raises on anything else."""
    M, hw, C = y.shape
    if y.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {y.device}")
    wdt = params["wqkv"].dtype
    if y.dtype not in (torch.float32, torch.bfloat16) or wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: y {y.dtype} / weights {wdt} must be float32 or bfloat16")
    if y.dtype == torch.bfloat16 and wdt == torch.float32:
        raise ValueError(f"{what}: bfloat16 tokens with float32 weights are not built")
    inner = params["wglu"].shape[1] // 2
    if hw > MAX_HW or C % 16 or dim_head % 16 or inner % 16 or C != num_heads * dim_head:
        raise ValueError(
            f"{what}: needs hw <= {MAX_HW}, C = heads * dim_head and C, dim_head, inner "
            f"multiples of 16; got hw {hw}, C {C}, heads {num_heads}, dim_head {dim_head}, "
            f"inner {inner}"
        )
    if not y.is_contiguous() or token_keep.shape != (M, hw) or token_keep.dtype != torch.bool:
        raise ValueError(f"{what}: y must be contiguous and token_keep (M, hw) bool")
    keep = token_keep.contiguous()
    shapes = {"wqkv": (C, 3 * C), "wproj": (C, C), "wglu": (C, 2 * inner), "wout": (inner, C),
              "ln2_scale": (C,), "ln2_bias": (C,), "bqkv": (3 * C,), "bproj": (C,),
              "ls1": (C,), "bglu": (2 * inner,), "bout": (C,), "ls2": (C,)}
    ops = {}
    for key in PARAM_KEYS:
        t = params[key]
        if tuple(t.shape) != shapes[key] or t.device != y.device:
            raise ValueError(f"{what}: {key} is {tuple(t.shape)} on {t.device}, "
                             f"expected {shapes[key]} on {y.device}")
        if key in MATRICES:
            if t.dtype != wdt:
                raise ValueError(f"{what}: {key} is {t.dtype}, wqkv is {wdt}")
            ops[key] = t.detach().t().contiguous()  # no copy for kernel_params' views
        else:
            ops[key] = t.detach().to(torch.float32).contiguous()
    flags = (int(y.dtype == torch.bfloat16), int(wdt == torch.bfloat16))
    return keep, ops, inner, flags
