"""RVT's recurrent MaxViT backbone (``MaxViTRNN``): 4 stages of (downsample,
a window-and-grid attention pair over every token, ConvLSTM).

Gehrig & Scaramuzza, "Recurrent Vision Transformers for Object Detection
with Event Cameras", CVPR 2023 (arXiv 2212.05598; github.com/uzh-rpg/RVT).
It is SAST's backbone (``models/backbone.py``) without the scene-adaptive
parts: no density ratio, no scoring module, no window or token selection,
no position embedding. Per stage, on NHWC ``x``::

    x = ConvDownsample(x)              # as SAST's: kernel A at stage 1
    for P in (window_partition, grid_partition):
        x = P^-1(PartitionAttention(P(x)))
    h, c = DWSConvLSTM2d(x, state)

``PartitionAttention`` on (B, N, hw, C) partitioned tokens ``t``::

    t = t + ls1 * proj(attn(LN1(t)))   # heads C / dim_head, every key attended
    t = t + ls2 * Dense_1(gelu(Dense_0(LN2(t))))   # inner mlp_ratio * C, exact GELU

with ``qkv`` laid out ``[q | k | v]`` x heads, as SAST's layer lays it out
(RVT's own code lays each head's q, k and v side by side: its checkpoints
map onto this layer by a permutation of ``qkv``'s output rows).

Paths: on a card without grad (the serving step, eager and captured, and an
export for the card) each layer is kernel D's RVT variant
(``ops/fused_block.rvt_window_block``) on every window or grid cell, with
no host read; on the CPU and under grad (``Trainer.fit``) it is torch ops in
the compute dtype, LayerNorm statistics in fp32.

What RVT-B does not use is refused when the model is built: Context
Broadcasting, stage-0 masking, ``drop_path`` and ``drop_mlp``. Each
stage reports every token slot of both layers as attended (the serving
step's ``selected_tokens`` reads ``2 H W`` a lane and stage); a
``telemetry`` dict receives nothing.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sast_tpu_torch.config import AttentionConfig, BackboneConfig
from sast_tpu_torch.models.backbone import LstmState
from sast_tpu_torch.models.layers import (
    ConvDownsample,
    Dense,
    Dropout,
    DropoutKey,
    DWSConvLSTM2d,
    LayerNorm,
    compute_copy,
)
from sast_tpu_torch.models.sast import Gamma, _layernorm
from sast_tpu_torch.ops.fused_block import rvt_params, rvt_window_block
from sast_tpu_torch.ops.partition import (
    grid_partition,
    grid_reverse,
    window_partition,
    window_reverse,
)


class Mlp(nn.Module):
    """Parameter tree of RVT's ungated MLP: ``Dense_0`` (C -> inner) and
    ``Dense_1`` (inner -> C)."""

    def __init__(self, dim: int, inner: int, bias: bool, dtype: torch.dtype):
        super().__init__()
        self.Dense_0 = Dense(dim, inner, bias, dtype)
        self.Dense_1 = Dense(inner, dim, bias, dtype)


class PartitionAttention(nn.Module):
    """RVT's pre-norm attention layer on (B, N, hw, C) window or grid
    tokens (module docstring)."""

    def __init__(self, dim: int, cfg: AttentionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % cfg.dim_head:
            raise ValueError(f"attention dim {dim} must divide by dim_head {cfg.dim_head}")
        if cfg.mlp_activation != "gelu" or cfg.enable_cb or cfg.drop_path or cfg.drop_mlp:
            raise ValueError("MaxViTRNN's layer has the exact GELU, no Context Broadcasting "
                             "and no dropout: set attention.mlp_activation 'gelu', enable_cb "
                             "False, drop_path and drop_mlp 0")
        self.dim_head, self.eps = cfg.dim_head, cfg.norm_eps
        self.num_heads = dim // cfg.dim_head
        self.norm1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim, cfg.attention_bias, dtype)
        self.proj = Dense(dim, dim, cfg.attention_bias, dtype)
        self.ls1 = Gamma(dim, cfg.ls_init_value)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, dim * cfg.mlp_ratio, cfg.mlp_bias, dtype)
        self.ls2 = Gamma(dim, cfg.ls_init_value)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda and not torch.is_grad_enabled():
            return self.kernel(t)
        return self.block_math(t)

    def block_math(self, t: torch.Tensor) -> torch.Tensor:
        """The layer in torch ops."""
        B, N, hw, C = t.shape
        heads, dh = self.num_heads, self.dim_head
        qkv = self.qkv(_layernorm(t, self.norm1, self.eps)).reshape(B, N, hw, 3 * heads, dh)
        q, k, v = (qkv[:, :, :, i * heads:(i + 1) * heads].permute(0, 1, 3, 2, 4)
                   for i in range(3))
        attn = torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
        out = self.proj((attn @ v).permute(0, 1, 3, 2, 4).reshape(B, N, hw, C))
        t = t + compute_copy(self.ls1, "gamma", t.dtype) * out
        m = self.mlp.Dense_1(F.gelu(self.mlp.Dense_0(_layernorm(t, self.norm2, self.eps))))
        return t + compute_copy(self.ls2, "gamma", t.dtype) * m

    def kernel(self, t: torch.Tensor) -> torch.Tensor:
        """Kernel D's RVT variant on every window (``ops/fused_block``)."""
        B, N, hw, C = t.shape
        out = rvt_window_block(t.reshape(B * N, hw, C), rvt_params(self), self.num_heads,
                               self.dim_head, self.eps)
        return out.reshape(B, N, hw, C)


class MaxViTBlock(nn.Module):
    """One window-attention layer and one grid-attention layer over every
    token, both of ``partition_size``."""

    def __init__(self, dim: int, cfg: AttentionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.partition = tuple(cfg.partition_size)
        self.win_attn = PartitionAttention(dim, cfg, dtype)
        self.grid_attn = PartitionAttention(dim, cfg, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.partition
        x = window_reverse(self.win_attn(window_partition(x, p)), p, (H, W))
        return grid_reverse(self.grid_attn(grid_partition(x, p)), p, (H, W))


class MaxViTStage(nn.Module):
    """One backbone stage: strided-conv downsample -> MaxViT blocks ->
    ConvLSTM."""

    def __init__(self, cfg: BackboneConfig, idx: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        dim = cfg.stage_dims[idx]
        cin = cfg.input_channels if idx == 0 else cfg.stage_dims[idx - 1]
        self.num_blocks = cfg.num_blocks[idx]
        self.downsample = ConvDownsample(
            cin, dim, cfg.stem_patch_size if idx == 0 else 2,
            overlap=cfg.downsample_overlap, norm_affine=cfg.downsample_norm_affine,
            dtype=dtype, use_stem_kernel=cfg.stem_pallas,
        )
        for i in range(self.num_blocks):
            self.add_module(f"block{i}", MaxViTBlock(dim, cfg.attention, dtype))
        self.lstm = DWSConvLSTM2d(
            dim, cfg.lstm.dws_conv, cfg.lstm.dws_conv_only_hidden,
            cfg.lstm.dws_conv_kernel_size, dtype, cfg.lstm.drop_cell_update,
        )

    def forward(self, x, lstm_state: Optional[LstmState], deterministic: bool = True,
                dropout: Optional[DropoutKey] = None):
        """-> (h, (h, c), attended token slots per lane over both layers);
        ``dropout`` serves the ConvLSTM's ``drop_cell_update``."""
        x = self.downsample(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        h, c = self.lstm(x, lstm_state, deterministic, dropout)
        slots = torch.full((), 2.0 * self.num_blocks * x.shape[1] * x.shape[2],
                           dtype=torch.float32, device=x.device)
        return h, (h, c), slots


class MaxViTBackbone(nn.Module):
    """``SASTBackbone``'s interface for RVT's backbone: forward(x,
    prev_states, token_mask, deterministic, dropout, telemetry) ->
    (features {stage: (B,h,w,c)}, new_states, P), with ``P`` the
    (num_stages,) attended token slots per lane; ``token_mask`` must be
    None and ``telemetry`` receives nothing (module docstring)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.enable_masking:
            raise ValueError("MaxViTRNN has no stage-0 masking: set enable_masking False")
        self.cfg, self.dtype = cfg, dtype
        for idx in range(cfg.num_stages):
            self.add_module(f"stage{idx}", MaxViTStage(cfg, idx, dtype))
        for i, m in enumerate(m for m in self.modules() if isinstance(m, Dropout)):
            m.layer_id = i

    def forward(self, x: torch.Tensor, prev_states: Optional[List[Optional[LstmState]]] = None,
                token_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                dropout: Optional[DropoutKey] = None, telemetry: Optional[dict] = None):
        if token_mask is not None:
            raise ValueError("MaxViTRNN has no stage-0 masking")
        n = self.cfg.num_stages
        if prev_states is None:
            prev_states = [None] * n
        if len(prev_states) != n:
            raise ValueError(f"{len(prev_states)} states for {n} stages")
        if x.dtype.is_floating_point:
            x = x.to(self.dtype)
        # else: uint8 histograms enter the stage-0 stem raw.
        features, states, slots = {}, [], []
        for idx in range(n):
            x, state, p = getattr(self, f"stage{idx}")(x, prev_states[idx], deterministic, dropout)
            states.append(state)
            features[idx + 1] = state[0]
            slots.append(p)
        return features, states, torch.stack(slots)
