"""SAST block: scene-adaptive sparse transformer layers (port).

Port of sast_tpu/models/sast.py, masked path only. Per token position:

- the whole tensor is layer-normed (norm1);
- a token that lies in a kept window and is itself selected gets norm2 +
  attention (keys are the other selected tokens of its window; the rest
  are masked with -1e4) + LayerScale residual + gated MLP + LayerScale
  residual;
- every other position passes through as norm1(x).

The attention is written out as matmul, mask, softmax, matmul: no library
attention kernel stands in for it. Not ported yet: the budget-gather path,
the fused and sparse block kernels (``fused_block``, ``use_pallas``) and
Context Broadcasting (``enable_cb``); the last raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from sast_tpu_torch.config import AttentionConfig
from sast_tpu_torch.models.layers import Dense, LayerNorm, get_activation
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
    ``token_keep`` mask."""

    def __init__(self, dim: int, cfg: AttentionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % cfg.dim_head:
            raise ValueError(f"attention dim {dim} must divide by dim_head {cfg.dim_head}")
        if cfg.enable_cb:
            raise NotImplementedError("Context Broadcasting is not ported yet")
        self.dim, self.dim_head, self.eps = dim, cfg.dim_head, cfg.norm_eps
        self.num_heads = dim // cfg.dim_head
        self.act = get_activation(cfg.mlp_activation)
        inner = max(32, math.floor(dim * cfg.mlp_ratio * 2 / 3 / 32) * 32)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim, cfg.attention_bias, dtype)
        self.proj = Dense(dim, dim, cfg.attention_bias, dtype)
        self.ls1 = Gamma(dim, cfg.ls_init_value)
        self.ls2 = Gamma(dim, cfg.ls_init_value)
        self.mlp = GatedMlpParams(dim, inner, cfg.mlp_bias, dtype)

    def forward(self, x: torch.Tensor, token_keep: torch.Tensor) -> torch.Tensor:
        B, N, hw, C = x.shape
        heads, dh = self.num_heads, self.dim_head
        y = _layernorm(x, self.norm1.scale, self.norm1.bias, self.eps)
        k4 = token_keep[..., None]
        z = torch.where(k4, _layernorm(y, self.norm2.scale, self.norm2.bias, self.eps), y)

        qkv = self.qkv(z).reshape(B, N, hw, 3 * heads, dh)
        q = qkv[:, :, :, :heads].permute(0, 1, 3, 2, 4)  # (B, N, h, hw, dh)
        k = qkv[:, :, :, heads : 2 * heads].permute(0, 1, 3, 2, 4)
        v = qkv[:, :, :, 2 * heads :].permute(0, 1, 3, 2, 4)
        logits = (q @ k.transpose(-1, -2)) * dh ** -0.5  # (B, N, h, q, k)
        key_mask = token_keep[:, :, None, None, :]
        logits = torch.where(key_mask, logits, torch.tensor(MASK_VALUE, dtype=logits.dtype,
                                                              device=logits.device))
        attn = torch.softmax(logits, dim=-1)
        out = (attn @ v).permute(0, 1, 3, 2, 4).reshape(B, N, hw, C)
        out = self.proj(out)
        h = z + self.ls1.gamma.to(z.dtype) * out

        val, gate = self.mlp.GLU_0.Dense_0(h).chunk(2, dim=-1)
        mlp_out = self.mlp.Dense_0(val * self.act(gate))
        h2 = h + self.ls2.gamma.to(h.dtype) * mlp_out
        return torch.where(k4, h2, y)


class SASTBlock(nn.Module):
    """One SAST block = window-attention layer + grid-attention layer.

    The first block of a stage runs the scoring module (STP weighting) and
    the window/token selection; later blocks reuse its masks. ``forward``
    returns (x, p_count, masks), where p_count is the number of selected
    tokens per batch element over both layers (the reference's
    ``index_count`` telemetry).
    """

    def __init__(self, dim: int, in_channels: int, cfg: AttentionConfig,
                 first_block: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.first_block = cfg, first_block
        if first_block:
            self.to_controls = PositiveDense(in_channels, dim, dtype)
            self.to_scores = Dense(dim, dim, dtype=dtype)
        self.win_attn = MaskedSparseAttention(dim, cfg, dtype)
        self.grid_attn = MaskedSparseAttention(dim, cfg, dtype)

    def forward(
        self,
        x: torch.Tensor,
        pos_emb: torch.Tensor,
        r: Optional[torch.Tensor],
        masks: Optional[Masks] = None,
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
        _, tok_keep_w, _, tok_keep_g = masks

        x = window_reverse(self.win_attn(xw, tok_keep_w), p, (H, W))
        xg = self.grid_attn(grid_partition(x, p), tok_keep_g)
        x = grid_reverse(xg, p, (H, W))

        p_count = (
            tok_keep_w.to(torch.float32).sum() + tok_keep_g.to(torch.float32).sum()
        ) / B
        return x, p_count, masks
