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
when the threshold is below 1) read one number back from the device: a host
synchronisation per attention layer, where JAX has a ``lax.cond``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from sast_tpu_torch.config import AttentionConfig
from sast_tpu_torch.models.layers import (
    Dense,
    DropoutKey,
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


def _layernorm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """flax LayerNorm(dtype=x.dtype) as the JAX package writes it for the
    attention: fp32 statistics (E[x^2] - E[x]^2, clamped at 0), elementwise
    math in the input dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    inv = (torch.rsqrt(var + eps) * scale).to(x.dtype)
    return (x - mu.to(x.dtype)) * inv + bias.to(x.dtype)


class PositiveDense(nn.Module):
    """Linear layer with positive weights exp(weight); ``weight`` is
    ``(out, in)`` and starts at 1 (reference PositiveLinear)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(cout, cin))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.exp(self.weight).to(self.dtype)
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
        z = torch.where(k4, _layernorm(y, self.norm2.scale, self.norm2.bias, self.eps), y)

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
        h = z + self.drop_path1(self.ls1.gamma.to(z.dtype) * out, dropout)

        val, gate = self.mlp.GLU_0.Dense_0(h).chunk(2, dim=-1)
        mlp_out = self.mlp.Dense_0(self.mlp_drop(val * self.act(gate), dropout))
        if self.enable_cb:
            # Context Broadcasting: mix each selected token's MLP output with
            # the mean over all token slots (unselected ones count as zero).
            masked = torch.where(k4, mlp_out, 0.0)
            mlp_out = 0.5 * masked + 0.5 * masked.mean(dim=(1, 2), keepdim=True)
        h2 = h + self.drop_path2(self.ls2.gamma.to(h.dtype) * mlp_out, dropout)
        return torch.where(k4, h2, y)

    def forward(self, x: torch.Tensor, token_keep: torch.Tensor,
                win_keep: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout: Optional[DropoutKey] = None) -> torch.Tensor:
        y = _layernorm(x, self.norm1.scale, self.norm1.bias, self.eps)
        if not deterministic and (self.drop_path > 0.0 or self.drop_mlp > 0.0):
            if dropout is None:
                raise ValueError(f"attention.drop_path = {self.drop_path}, drop_mlp = "
                                 f"{self.drop_mlp} under training need a DropoutKey")
            return self.block_math(y, token_keep, dropout)
        return self.run_block(y, token_keep, win_keep)

    def run_block(self, y: torch.Tensor, token_keep: torch.Tensor,
                  win_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block on norm1-ed tokens ``y``, on the path the switches and
        the scene pick (module docstring)."""
        B, N, hw, C = y.shape
        M = B * N
        skipping = win_keep is not None and not self.enable_cb

        if self.gather_budget > 0.0 and skipping:
            K = max(1, min(M, int(math.ceil(self.gather_budget * M))))
            wk = win_keep.reshape(M)
            # One host read where JAX has a lax.cond; none when K == M.
            if K == M or int(wk.sum()) <= K:
                order = torch.argsort(~wk, stable=True)[:K]
                y_flat = y.reshape(M, hw, C)
                out_g = self.block_math(y_flat[order][None], token_keep.reshape(M, hw)[order][None])
                return y_flat.index_copy(0, order, out_g[0]).reshape(B, N, hw, C)
            return self.block_math(y, token_keep)

        if self.sparse_kernel and skipping:
            # One host read below a threshold of 1; none at the default 1.0.
            if self.density_threshold >= 1.0 or (
                float(win_keep.float().mean()) <= self.density_threshold
            ):
                run = (sparse_block.sparse_window_block_looped
                       if sparse_block.MODEL_USES_LOOPED else sparse_block.sparse_window_block)
                extra = {} if sparse_block.MODEL_USES_LOOPED else {"leaves": kernel_leaves(self)}
                out = run(y.reshape(M, hw, C), token_keep.reshape(M, hw), win_keep.reshape(M),
                          kernel_params(self), self.num_heads, self.dim_head, self.eps, **extra)
                return out.reshape(B, N, hw, C)
            return self.block_math(y, token_keep)

        if self.fused and not self.enable_cb:
            out = fused_window_block(y.reshape(M, hw, C), token_keep.reshape(M, hw),
                                     kernel_params(self), self.num_heads, self.dim_head, self.eps,
                                     leaves=kernel_leaves(self))
            return out.reshape(B, N, hw, C)

        return self.block_math(y, token_keep)


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
