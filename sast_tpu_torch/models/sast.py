"""SAST block: scene-adaptive sparse transformer layers (port).

Port of sast_tpu/models/sast.py. Per token position:

- the whole tensor is layer-normed (norm1);
- a token that lies in a kept window and is itself selected gets norm2 +
  attention (keys are the other selected tokens of its window; the rest
  are masked with -1e4) + LayerScale residual + gated MLP + LayerScale
  residual;
- every other position passes through as norm1(x).

The attention is written out as matmul, mask, softmax, matmul: no library
attention kernel stands in for it. ``MaskedSparseAttention.forward`` picks
one of four execution paths of that same function, as the JAX module does:

- budget-gather (``attention.gather_budget`` > 0): the masked torch-op math
  on the first ``K = ceil(budget * M)`` windows of the kept-first work list,
  scattered back; exact while ``n_win <= K``, else the masked path;
- sparse block kernel (``sparse_kernel``, JAX's ``use_pallas``):
  ``ops/sparse_block.py`` on kept windows only, below the window density
  ``attention.pallas_density_threshold`` (1.0: always);
- dense fused block kernel (``attention.fused_block``):
  ``ops/fused_block.py`` on every window;
- masked torch ops otherwise, and always with Context Broadcasting
  (``enable_cb``), which needs the full layout.

Under grad mode the sparse and the fused path go through their
``torch.autograd.Function``s and land the gradients on this module's own
parameters (``ops/block.kernel_leaves``); the gather and masked paths are
plain autograd. The stochastic regularizers, as in the JAX module:
``DropPath`` per sample on ``ls1 * attention`` and on ``ls2 * mlp``
(``drop_path``), and dropout between the gated activation and the MLP's
output projection (``drop_mlp``). The kernels implement neither, so under
training (``deterministic=False``) with a non-zero rate every layer runs the
masked torch-op path, whatever the switches say (JAX's ``stochastic_off``
rule); their masks come from the step's ``DropoutKey``.

Both data-dependent choices (``n_win <= K`` when ``K < M``, the density test
when the threshold is below 1) are a 0-d bool tensor on the layer's device,
computed as JAX computes them (``branch_predicate``). Under a trace
(``torch.export``) the layer emits a cond node on it (``choose``), JAX's
``lax.cond``; the eager step reads it back, one host synchronisation per
such layer; a captured step takes it on the card, in a conditional graph
node (``graphs.Schedule``). Under grad mode the choice is differentiable as
JAX's ``cond`` is under ``linearize`` (``_Choice``): its forward records the
taken branch's autograd graph with its residuals, and its backward chooses,
on the same predicate, between the two branches' backward passes over those
graphs; no branch runs its forward in the backward.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from sast_tpu_torch import graphs
from sast_tpu_torch.config import AttentionConfig
from sast_tpu_torch.models.layers import (
    Dense,
    DropoutKey,
    compute_copy,
    DropPath,
    Dropout,
    LayerNorm,
    get_activation,
)
from sast_tpu_torch.ops import sparse_block
from sast_tpu_torch.ops.block import kernel_leaves, kernel_params
from sast_tpu_torch.ops.fused_block import fused_window_block
from sast_tpu_torch.ops.partition import (
    grid_partition,
    grid_reverse,
    window_partition,
    window_reverse,
)
from sast_tpu_torch.ops.sparse import select_windows_and_tokens

MASK_VALUE = -1e4  # the reference's key-mask constant

Masks = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _layernorm(x: torch.Tensor, norm: LayerNorm, eps: float) -> torch.Tensor:
    """flax LayerNorm(dtype=x.dtype) as the JAX package writes it for the
    attention, with ``norm``'s parameters: fp32 statistics (E[x^2] - E[x]^2,
    clamped at 0) and scale, elementwise math in the input dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    inv = (torch.rsqrt(var + eps) * norm.scale).to(x.dtype)
    return (x - mu.to(x.dtype)) * inv + compute_copy(norm, "bias", x.dtype)


class PositiveDense(nn.Module):
    """Linear layer with positive weights exp(weight); ``weight`` is
    ``(out, in)`` and starts at 1 (reference PositiveLinear)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(cout, cin))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = compute_copy(self, "weight", self.dtype, torch.exp)
        return x.to(self.dtype) @ w.t()


class Gamma(nn.Module):
    """LayerScale parameter holder (flax ``ls1/gamma``)."""

    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))


class _GLU(nn.Module):
    def __init__(self, dim: int, inner: int, bias: bool, dtype: torch.dtype):
        super().__init__()
        self.Dense_0 = Dense(dim, 2 * inner, bias, dtype)


class GatedMlpParams(nn.Module):
    """Parameter tree of GatedMLP: ``GLU_0/Dense_0`` + ``Dense_0``."""

    def __init__(self, dim: int, inner: int, bias: bool, dtype: torch.dtype):
        super().__init__()
        self.GLU_0 = _GLU(dim, inner, bias, dtype)
        self.Dense_0 = Dense(inner, dim, bias, dtype)


class MaskedSparseAttention(nn.Module):
    """MS-WSA on (B, N, hw, C) partitioned tokens with a (B, N, hw) bool
    ``token_keep`` mask and, for the paths that skip windows, the (B, N)
    bool ``win_keep``. ``sparse_kernel`` is the JAX module's ``use_pallas``.

    The block kernels always use GELU, like the TPU kernels they replace."""

    def __init__(self, dim: int, cfg: AttentionConfig, dtype: torch.dtype = torch.float32,
                 sparse_kernel: bool = False):
        super().__init__()
        if dim % cfg.dim_head:
            raise ValueError(f"attention dim {dim} must divide by dim_head {cfg.dim_head}")
        self.dim, self.dim_head, self.eps = dim, cfg.dim_head, cfg.norm_eps
        self.num_heads = dim // cfg.dim_head
        self.enable_cb = cfg.enable_cb
        self.sparse_kernel = sparse_kernel
        self.density_threshold = cfg.pallas_density_threshold
        self.gather_budget = cfg.gather_budget
        self.fused = cfg.fused_block
        self.drop_path, self.drop_mlp = cfg.drop_path, cfg.drop_mlp
        self.act = get_activation(cfg.mlp_activation)
        inner = max(32, math.floor(dim * cfg.mlp_ratio * 2 / 3 / 32) * 32)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim, cfg.attention_bias, dtype)
        self.proj = Dense(dim, dim, cfg.attention_bias, dtype)
        self.ls1 = Gamma(dim, cfg.ls_init_value)
        self.ls2 = Gamma(dim, cfg.ls_init_value)
        self.mlp = GatedMlpParams(dim, inner, cfg.mlp_bias, dtype)
        self.drop_path1 = DropPath(cfg.drop_path)
        self.drop_path2 = DropPath(cfg.drop_path)
        self.mlp_drop = Dropout(cfg.drop_mlp)

    def block_math(self, y: torch.Tensor, token_keep: torch.Tensor,
                   dropout: Optional[DropoutKey] = None) -> torch.Tensor:
        """The masked block in torch ops on any (B', N', hw, C) layout of
        norm1-ed tokens; equals ``y`` at unselected tokens. With ``dropout``
        the regularizers apply (the leading axis is then the batch)."""
        B, N, hw, C = y.shape
        heads, dh = self.num_heads, self.dim_head
        k4 = token_keep[..., None]
        z = torch.where(k4, _layernorm(y, self.norm2, self.eps), y)

        qkv = self.qkv(z).reshape(B, N, hw, 3 * heads, dh)
        q = qkv[:, :, :, :heads].permute(0, 1, 3, 2, 4)  # (B, N, h, hw, dh)
        k = qkv[:, :, :, heads : 2 * heads].permute(0, 1, 3, 2, 4)
        v = qkv[:, :, :, 2 * heads :].permute(0, 1, 3, 2, 4)
        logits = (q @ k.transpose(-1, -2)) * dh ** -0.5  # (B, N, h, q, k)
        key_mask = token_keep[:, :, None, None, :]
        # A Python scalar, not a device tensor made here: building one from
        # a Python number copies it to the card and waits for the stream.
        logits = torch.where(key_mask, logits, MASK_VALUE)
        attn = torch.softmax(logits, dim=-1)
        out = (attn @ v).permute(0, 1, 3, 2, 4).reshape(B, N, hw, C)
        out = self.proj(out)
        h = z + self.drop_path1(compute_copy(self.ls1, "gamma", z.dtype) * out, dropout)

        val, gate = self.mlp.GLU_0.Dense_0(h).chunk(2, dim=-1)
        mlp_out = self.mlp.Dense_0(self.mlp_drop(val * self.act(gate), dropout))
        if self.enable_cb:
            # Context Broadcasting: mix each selected token's MLP output with
            # the mean over all token slots (unselected ones count as zero).
            masked = torch.where(k4, mlp_out, 0.0)
            mlp_out = 0.5 * masked + 0.5 * masked.mean(dim=(1, 2), keepdim=True)
        h2 = h + self.drop_path2(compute_copy(self.ls2, "gamma", h.dtype) * mlp_out,
                                 dropout)
        return torch.where(k4, h2, y)

    def forward(self, x: torch.Tensor, token_keep: torch.Tensor,
                win_keep: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout: Optional[DropoutKey] = None) -> torch.Tensor:
        y = _layernorm(x, self.norm1, self.eps)
        if not deterministic and (self.drop_path > 0.0 or self.drop_mlp > 0.0):
            if dropout is None:
                raise ValueError(f"attention.drop_path = {self.drop_path}, drop_mlp = "
                                 f"{self.drop_mlp} under training need a DropoutKey")
            return self.block_math(y, token_keep, dropout)
        return self.run_block(y, token_keep, win_keep)

    def choice_switch(self) -> Optional[str]:
        """The switch by which this layer chooses its branch from the scene
        (``run_block``'s ``choose``), or None: a gather budget in (0, 1), or
        the sparse kernel below a density threshold of 1; never with Context
        Broadcasting (the masked path then runs)."""
        if self.enable_cb:
            return None
        if 0.0 < self.gather_budget < 1.0:
            return f"attention.gather_budget={self.gather_budget}"
        if self.gather_budget <= 0.0 and self.sparse_kernel and self.density_threshold < 1.0:
            return f"attention.pallas_density_threshold={self.density_threshold}"
        return None

    def chooses_in_training(self) -> Optional[str]:
        """``choice_switch`` of the training forward: None also with a
        regularizer on (the masked path then runs)."""
        if self.drop_path > 0.0 or self.drop_mlp > 0.0:
            return None
        return self.choice_switch()

    def run_block(self, y: torch.Tensor, token_keep: torch.Tensor,
                  win_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block on norm1-ed tokens ``y``, on the path the switches and
        the scene pick (module docstring)."""
        M = y.shape[0] * y.shape[1]
        skipping = win_keep is not None and not self.enable_cb
        operands = (y, token_keep, win_keep)

        if self.gather_budget > 0.0 and skipping:
            K = gather_size(self.gather_budget, M)
            gathered = functools.partial(self.gathered, k=K)
            if K == M:  # static: no predicate, as in JAX
                return gathered(*operands)
            return choose(self, branch_predicate(win_keep, K), gathered, self.masked,
                          operands)

        if self.sparse_kernel and skipping:
            if self.density_threshold >= 1.0:  # static: no predicate, as in JAX
                return self.kernel(*operands)
            limit = density_limit(self.density_threshold, M)
            return choose(self, branch_predicate(win_keep, limit), self.kernel, self.masked,
                          operands)

        if self.fused and not self.enable_cb:
            B, N, hw, C = y.shape
            out = fused_window_block(y.reshape(M, hw, C), token_keep.reshape(M, hw),
                                     kernel_params(self), self.num_heads, self.dim_head, self.eps,
                                     leaves=kernel_leaves(self))
            return out.reshape(B, N, hw, C)

        return self.block_math(y, token_keep)

    # The branches of the data-dependent choices. Each takes the same three
    # tensors, mutates none of them and returns a new (B, N, hw, C) tensor in
    # ``y``'s dtype: the contract of ``torch.cond``'s branches.
    def masked(self, y: torch.Tensor, token_keep: torch.Tensor,
               win_keep: torch.Tensor) -> torch.Tensor:
        """The masked torch-op block on every window."""
        return self.block_math(y, token_keep)

    def gathered(self, y: torch.Tensor, token_keep: torch.Tensor, win_keep: torch.Tensor,
                 *, k: int) -> torch.Tensor:
        """The masked torch-op block on the first ``k`` windows of the
        kept-first work list, written back out of place; exact while at most
        ``k`` windows are kept."""
        B, N, hw, C = y.shape
        M = B * N
        order = torch.argsort(~win_keep.reshape(M), stable=True)[:k]
        y_flat = y.reshape(M, hw, C)
        out_g = self.block_math(y_flat[order][None], token_keep.reshape(M, hw)[order][None])
        return y_flat.index_copy(0, order, out_g[0]).reshape(B, N, hw, C)

    def kernel(self, y: torch.Tensor, token_keep: torch.Tensor,
               win_keep: torch.Tensor) -> torch.Tensor:
        """The window-skipping block kernel (E, or F under
        ``sparse_block.MODEL_USES_LOOPED``) on the kept windows."""
        B, N, hw, C = y.shape
        M = B * N
        run = (sparse_block.sparse_window_block_looped
               if sparse_block.MODEL_USES_LOOPED else sparse_block.sparse_window_block)
        extra = {} if sparse_block.MODEL_USES_LOOPED else {"leaves": kernel_leaves(self)}
        out = run(y.reshape(M, hw, C), token_keep.reshape(M, hw), win_keep.reshape(M),
                  kernel_params(self), self.num_heads, self.dim_head, self.eps, **extra)
        return out.reshape(B, N, hw, C)


def gather_size(budget: float, M: int) -> int:
    """The gather path's static window budget ``K = ceil(budget * M)`` in
    ``[1, M]`` (JAX ``sast.py``)."""
    return max(1, min(M, int(math.ceil(budget * M))))


def density_limit(threshold: float, M: int) -> int:
    """The most kept windows out of ``M`` whose density passes JAX's test
    ``mean(win_keep.astype(f32)) <= threshold`` as XLA compiles it: the
    count ``n`` of bools sums exactly, the division by the constant ``M`` is
    a product with ``f32(1 / M)``, and the threshold is cast to float32.
    Worked out on the host in numpy float32, so the device only compares two
    integers (a CPU ``mean`` divides, which lands one ulp away from the
    product for some ``n / M``). -1 when no count passes."""
    frac = np.arange(M + 1, dtype=np.float32) * (np.float32(1) / np.float32(M))
    return int(np.count_nonzero(frac <= np.float32(threshold))) - 1


def branch_predicate(win_keep: torch.Tensor, limit: int) -> torch.Tensor:
    """Whether at most ``limit`` windows are kept: a 0-d bool tensor on
    ``win_keep``'s device, from an int32 count as JAX's ``n_win <= K``. Both
    choices use it: the gather path with ``limit = K``, the density threshold
    with ``limit = density_limit(threshold, M)``."""
    return win_keep.sum(dtype=torch.int32) <= limit


def branch_parameters(layer: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """The parameters, by name, that ``layer``'s branches read: all but the
    first norm's, which the layer applies before it chooses."""
    return [(name, p) for name, p in layer.named_parameters() if not name.startswith("norm1.")]


def choose(layer: nn.Module, pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
           operands: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """JAX's ``lax.cond(pred, true_fn, false_fn)`` on ``layer``'s branches:
    under a trace (the non-strict ``torch.export``) a cond node, so that the
    program picks the branch on its device; under grad mode ``_Choice``, the
    differentiable choice; otherwise ``graphs.choose``: eagerly one host
    read of ``pred``, and in a captured step a conditional node that takes
    the branch on the card (``graphs.Schedule``).

    The node is made by the cond operator itself, whose branches the export
    traces once: ``torch.cond`` would first trace them with dynamo as well,
    which takes most of an export's time. A branch graph may hold no tensor
    of its own, so the parameters that the branches read
    (``branch_parameters``) enter each branch as operands, bound to the
    layer by ``torch.func.functional_call``: the lifting that dynamo does
    for ``torch.cond``."""
    named = branch_parameters(layer)
    if not torch.compiler.is_compiling():
        if torch.is_grad_enabled():
            params = [p for _, p in named]
            if operands[0].requires_grad or any(p.requires_grad for p in params):
                return _Choice.apply((layer, true_fn, false_fn), pred, *operands, *params)
        return graphs.choose(pred, true_fn, false_fn, operands, layer.choice_switch())
    names, tensors = zip(*named)

    def lifted(fn: Callable) -> Callable:
        call = _Branch(layer, fn)

        def branch(y, token_keep, win_keep, *leaves):
            return torch.func.functional_call(
                call, {f"layer.{n}": t for n, t in zip(names, leaves)}, (y, token_keep, win_keep))
        return branch

    return torch.ops.higher_order.cond(pred, lifted(true_fn), lifted(false_fn),
                                       (*operands, *tensors))


class _Entry(torch.autograd.Function):
    """``y`` (detached) as the input of a branch's recorded graph: a view of
    it that requires grad through a 0-element ``anchor``, so that the graph
    reaches ``y``'s gradient at this node's output edge, holds no edge into
    the graph that made ``y``, and does not hold ``y`` (a leaf made from
    ``y`` would be held by its gradient accumulator, an activation kept
    across the scan). Its backward never runs: the choice's backward stops
    at that edge."""

    @staticmethod
    def forward(ctx, y, anchor):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a choice's branch graph was differentiated past its input")


def _slot_hooks(outer) -> Tuple[torch.autograd.graph.saved_tensors_hooks, list]:
    """Saved-tensor hooks for a branch run inside ``_Choice.forward`` under
    the hooks ``outer`` that were active around it (non-reentrant
    checkpointing's: the first forward packs a handle and keeps no tensor,
    the recomputation refills the handles in pack order). Each tensor is
    packed by ``outer`` into a slot, and the slots are returned with the
    hooks. ``_resolve`` unpacks every slot with ``outer`` in the graph task
    of the choice's own backward; the branch's graph is then differentiated
    in a nested graph task, whose unpacks read the slots. Checkpointing
    would take a nested graph task's unpack for a new backward and run the
    timestep's forward once more."""
    slots = []

    def pack(x):
        slot = [outer[0](x), None]
        slots.append(slot)
        return slot

    def unpack(slot):
        if slot[1] is None:
            raise RuntimeError("a residual of a choice's branch was read before the choice's "
                               "backward unpacked it, or twice")
        value, slot[1] = slot[1], None
        return value

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack), slots


def _resolve(outer, slots: list) -> None:
    for slot in slots:
        slot[1], slot[0] = outer[1](slot[0]), None
    slots.clear()


class _Choice(torch.autograd.Function):
    """``lax.cond`` under ``jax.grad``, as JAX linearizes it: the forward is
    ``graphs.choose`` over the two branches, each run under grad mode on
    ``y`` (``_Entry``) and on the layer's own fp32 parameters (their casts
    to the compute dtype are taken in the graph, ``models/layers.
    compute_copy``), so that the branch's autograd graph and its residuals
    are recorded; the output leaves the Function detached. The backward is
    ``graphs.choose`` on the saved predicate over the two branches' backward
    passes over those graphs (``torch.autograd.grad`` from the output's
    gradient edge to ``y``'s and to the parameters that the branches read,
    ``branch_parameters``; zeros where a branch does not read one); no
    branch runs its forward there. The sparse kernel's branch keeps its own
    residuals and takes kernels G and H in its backward
    (``ops/sparse_block._SparseBlockFn``).

    Eagerly each choice is one host read and only the taken branch's graph
    exists. In a captured train step both branches are captured, so both
    graphs exist; a replay writes the taken branch's residuals and the
    backward's conditional node reads only those: JAX's ``cond`` under
    ``linearize`` outputs the union of both branches' residuals.
    Autograd runs a card's backward on its own thread, which sees the
    capture's schedule (``graphs._active``).

    Under checkpointing (``training/steps.py``) the first forward records
    only handles (``_slot_hooks``), the recomputation fills them, and the
    backward unpacks them in its own graph task before it differentiates
    the branch: the branches run twice per timestep, as JAX's remat runs
    them, and nothing of a branch is held across the scan."""

    @staticmethod
    def forward(ctx, fns, pred, y, token_keep, win_keep, *params):
        layer, true_fn, false_fn = fns
        outer = torch._C._autograd._top_saved_tensors_default_hooks(True)
        wants_y = ctx.needs_input_grad[2]
        recorded = {}

        def record(i: int, fn: Callable) -> Callable:
            def branch(y, token_keep, win_keep):
                hooks, slots = _slot_hooks(outer) if outer is not None else (None, [])
                with torch.enable_grad(), hooks or contextlib.nullcontext():
                    y_in = y
                    if wants_y:
                        anchor = torch.empty(0, device=y.device, requires_grad=True)
                        y_in = _Entry.apply(y.detach(), anchor)
                    out = fn(y_in, token_keep, win_keep)
                recorded[i] = (torch.autograd.graph.get_gradient_edge(out),
                               torch.autograd.graph.get_gradient_edge(y_in) if wants_y else None,
                               slots)
                return out.detach()
            return branch

        out = graphs.choose(pred, record(0, true_fn), record(1, false_fn),
                            (y, token_keep, win_keep), layer.choice_switch())
        ctx.layer, ctx.recorded, ctx.outer = layer, recorded, outer
        ctx.save_for_backward(pred)
        return out

    @staticmethod
    def backward(ctx, g):
        layer, recorded, outer = ctx.layer, ctx.recorded, ctx.outer
        ctx.recorded = ctx.outer = None
        (pred,) = ctx.saved_tensors
        if outer is not None:
            for _, _, slots in recorded.values():
                _resolve(outer, slots)
        params = [p for _, p in branch_parameters(layer)]
        wants_y = ctx.needs_input_grad[2]
        wrt = [i for i, p in enumerate(params) if ctx.needs_input_grad[5 + i]]
        switch = layer.choice_switch()

        def backward_of(i: int) -> Callable:
            def branch(g):
                if i not in recorded:
                    raise RuntimeError(f"the backward of {switch} takes a branch whose forward "
                                       "recorded no graph")
                out_edge, y_edge, _ = recorded[i]
                leaves = ([y_edge] if wants_y else []) + [params[j] for j in wrt]
                grads = torch.autograd.grad(out_edge, leaves, g, allow_unused=True)
                like = ([g] if wants_y else []) + [params[j] for j in wrt]
                return tuple(torch.zeros_like(t) if d is None else d for d, t in zip(grads, like))
            return branch

        grads = list(graphs.choose(pred, backward_of(0), backward_of(1), (g.contiguous(),),
                                   f"the backward of {switch}"))
        dy = grads.pop(0) if wants_y else None
        dparams = [None] * len(params)
        for i, d in zip(wrt, grads):
            dparams[i] = d
        return (None, None, dy, None, None, *dparams)


class _Branch(nn.Module):
    """One branch of ``choose`` as a module whose only child is the layer,
    so that ``functional_call`` can swap the layer's tensors for a branch's
    operands."""

    def __init__(self, layer: nn.Module, fn: Callable):
        super().__init__()
        self.layer, self.fn = layer, fn

    def forward(self, y: torch.Tensor, token_keep: torch.Tensor,
                win_keep: torch.Tensor) -> torch.Tensor:
        return self.fn(y, token_keep, win_keep)


def _selection_stats(win_keep: torch.Tensor, tok_keep: torch.Tensor) -> torch.Tensor:
    """(B, 3) int32 ``[M, Kmax, T_eff]`` of one layer's selection: kept
    windows, selected tokens of the fullest kept window, selected tokens."""
    counts = tok_keep.sum(dim=-1, dtype=torch.int32)  # (B, N)
    m = win_keep.sum(dim=-1, dtype=torch.int32)
    kmax = torch.where(win_keep, counts, 0).amax(dim=-1)
    return torch.stack([m, kmax, counts.sum(dim=-1, dtype=torch.int32)], dim=-1)


class SASTBlock(nn.Module):
    """One SAST block = window-attention layer + grid-attention layer.

    The first block of a stage runs the scoring module (STP weighting) and
    the window/token selection; later blocks reuse its masks. ``forward``
    returns (x, p_count, masks), where p_count is the number of selected
    tokens per batch element over both layers (the reference's
    ``index_count`` telemetry). Given a ``telemetry`` dict, ``forward`` also
    records the selection shapes of each layer in it, as JAX's block sows
    them into its ``telemetry`` collection: ``sel_win`` and ``sel_grid``,
    each a one-element tuple of a (B, 3) int32 tensor ``[M kept windows,
    Kmax tokens of the fullest kept window, T_eff selected tokens]``
    (``utils/benchmark.transformer_macs_from_telemetry`` reads them).
    Without it nothing is computed for them.
    """

    def __init__(self, dim: int, in_channels: int, cfg: AttentionConfig,
                 first_block: bool, dtype: torch.dtype = torch.float32,
                 sparse_kernel: bool = False):
        super().__init__()
        self.cfg, self.first_block = cfg, first_block
        if first_block:
            self.to_controls = PositiveDense(in_channels, dim, dtype)
            self.to_scores = Dense(dim, dim, dtype=dtype)
        self.win_attn = MaskedSparseAttention(dim, cfg, dtype, sparse_kernel)
        self.grid_attn = MaskedSparseAttention(dim, cfg, dtype, sparse_kernel)

    def forward(
        self,
        x: torch.Tensor,
        pos_emb: torch.Tensor,
        r: Optional[torch.Tensor],
        masks: Optional[Masks] = None,
        deterministic: bool = True,
        dropout: Optional[DropoutKey] = None,
        telemetry: Optional[dict] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Masks]:
        cfg = self.cfg
        B, H, W, C = x.shape
        p = tuple(cfg.partition_size)
        x = x + pos_emb.to(x.dtype)
        xw = window_partition(x, p)  # (B, N, hw, C)

        if self.first_block:
            scale = self.to_controls(r + 1e-6)  # (B, C), strictly positive
            scores = torch.relu(self.to_scores(xw))  # (B, N, hw, C)
            weight = torch.sigmoid(scale)[:, None, None, :] * torch.sigmoid(scores)
            xw = weight * xw
            # Amplification: scores *= AMP / scale (inf -> 0), in fp32.
            scale32 = scale.to(torch.float32)
            inv_scale = torch.full_like(scale32, cfg.amp) / scale32
            inv_scale = torch.where(torch.isinf(inv_scale), torch.zeros_like(inv_scale), inv_scale)
            scores_amp = inv_scale[:, None, None, :] * scores.to(torch.float32)
            win_keep_w, tok_keep_w = select_windows_and_tokens(scores_amp, cfg.bounce)
            scores_g = grid_partition(window_reverse(scores_amp, p, (H, W)), p)
            win_keep_g, tok_keep_g = select_windows_and_tokens(scores_g, cfg.bounce)
            masks = (win_keep_w, tok_keep_w, win_keep_g, tok_keep_g)
        elif masks is None:
            raise ValueError("non-first blocks must reuse the selection masks")
        win_keep_w, tok_keep_w, win_keep_g, tok_keep_g = masks
        if telemetry is not None:
            telemetry["sel_win"] = (_selection_stats(win_keep_w, tok_keep_w),)
            telemetry["sel_grid"] = (_selection_stats(win_keep_g, tok_keep_g),)

        x = window_reverse(self.win_attn(xw, tok_keep_w, win_keep_w, deterministic, dropout),
                           p, (H, W))
        xg = self.grid_attn(grid_partition(x, p), tok_keep_g, win_keep_g, deterministic, dropout)
        x = grid_reverse(xg, p, (H, W))

        p_count = (
            tok_keep_w.to(torch.float32).sum() + tok_keep_g.to(torch.float32).sum()
        ) / B
        return x, p_count, masks
