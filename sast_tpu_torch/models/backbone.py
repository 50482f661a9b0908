"""Recurrent SAST backbone: 4 stages of (downsample, SAST blocks, ConvLSTM).

Port of sast_tpu/models/backbone.py: NHWC throughout, per-stage sinusoidal
position embeddings as constants, event-density ratios from the raw input,
recurrent state as a list of (hidden, cell) per stage.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from sast_tpu_torch.config import BackboneConfig
from sast_tpu_torch.models.layers import ConvDownsample, Dropout, DropoutKey, DWSConvLSTM2d
from sast_tpu_torch.models.sast import SASTBlock
from sast_tpu_torch.ops.posemb import position_embedding_sine
from sast_tpu_torch.ops.sparse import non_zero_ratio
from sast_tpu_torch.ops.stem_conv import stem_supported

LstmState = Tuple[torch.Tensor, torch.Tensor]


def fused_stem_density(cfg: BackboneConfig, x: torch.Tensor) -> bool:
    """Static gate for computing the density ratio inside the stem kernel
    (one input read serves both): the three kernel switches are on, the
    backbone has 4 stages, and the input passes the stem kernel's gate
    (uint8, H and W divisible by 32, C <= 32 and C % 4 == 0, stage-0 width a
    multiple of 16 up to 128). Otherwise the standalone ratio runs
    (``ops/sparse.non_zero_ratio``). The gate does not look at the device:
    on the CPU both branches run the plain versions."""
    return (
        cfg.fuse_stem_density
        and cfg.stem_pallas
        and cfg.ratio_pallas
        and cfg.num_stages == 4
        and stem_supported(x.shape, x.dtype, cfg.stage_dims[0])
    )


class SASTStage(nn.Module):
    """One backbone stage: strided-conv downsample -> SAST blocks -> ConvLSTM."""

    def __init__(self, cfg: BackboneConfig, idx: int, dtype: torch.dtype = torch.float32,
                 sparse_kernel: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        dim = cfg.stage_dims[idx]
        cin = cfg.input_channels if idx == 0 else cfg.stage_dims[idx - 1]
        self.dim = dim
        self.num_blocks = cfg.num_blocks[idx]
        self.downsample = ConvDownsample(
            cin, dim, cfg.stem_patch_size if idx == 0 else 2,
            overlap=cfg.downsample_overlap, norm_affine=cfg.downsample_norm_affine,
            dtype=dtype, use_stem_kernel=cfg.stem_pallas,
        )
        if cfg.enable_masking and idx == 0:
            self.mask_token = nn.Parameter(torch.zeros(1, 1, 1, dim))
        for i in range(self.num_blocks):
            self.add_module(
                f"block{i}",
                SASTBlock(dim, cfg.input_channels, cfg.attention, i == 0, dtype, sparse_kernel),
            )
        self.lstm = DWSConvLSTM2d(
            dim, cfg.lstm.dws_conv, cfg.lstm.dws_conv_only_hidden,
            cfg.lstm.dws_conv_kernel_size, dtype, cfg.lstm.drop_cell_update,
        )
        self._pos: Dict[tuple, torch.Tensor] = {}

    def pos_emb(self, H: int, W: int, device) -> torch.Tensor:
        """The (H, W) sine embedding on ``device``, kept per shape and device;
        under a trace (``torch.export``) made afresh and not kept, so that no
        traced value is left behind in the live module."""
        key = (H, W, str(device))
        pos = self._pos.get(key)
        if pos is None:
            pos = torch.from_numpy(
                position_embedding_sine(H, W, num_pos_feats=self.dim // 2)
            ).to(device)
            if not torch.compiler.is_compiling():
                self._pos[key] = pos
        return pos

    def forward(
        self,
        x: torch.Tensor,
        lstm_state: Optional[LstmState],
        token_mask: Optional[torch.Tensor],
        r: Optional[torch.Tensor],
        deterministic: bool = True,
        dropout: Optional[DropoutKey] = None,
        telemetry: Optional[dict] = None,
    ):
        """``r=None`` asks the stem kernel for the density ratio; the stage
        then returns the full (B, 4, C_in) ratio as its last output. With
        ``telemetry`` each block records its selection shapes under
        ``block{i}``."""
        ratio = None
        if r is None:
            x, ratio = self.downsample(x, with_density=True)
            r = ratio[:, 0].to(self.dtype)
        else:
            x = self.downsample(x)
        if token_mask is not None:
            x = torch.where(token_mask[..., None], self.mask_token.to(x.dtype), x)
        H, W = x.shape[1], x.shape[2]
        pos = self.pos_emb(H, W, x.device)
        p_total = torch.zeros((), dtype=torch.float32, device=x.device)
        masks = None
        for i in range(self.num_blocks):
            x, p_count, masks = getattr(self, f"block{i}")(
                x, pos, r, masks, deterministic, dropout,
                None if telemetry is None else telemetry.setdefault(f"block{i}", {}))
            p_total = p_total + p_count
        h, c = self.lstm(x, lstm_state, deterministic, dropout)
        return h, (h, c), p_total, ratio


class SASTBackbone(nn.Module):
    """forward(x, prev_states, token_mask) -> (features {stage: (B,h,w,c)},
    new_states, P), with ``P`` the (num_stages,) selected-token telemetry.
    x is NHWC (B, H, W, input_channels), uint8 or float. ``sparse_kernel``
    (the JAX package's ``use_pallas``) sends every attention layer through
    the window-skipping block kernel. ``deterministic=False`` is training:
    it changes nothing while every stochastic rate is 0; otherwise the
    regularizers draw their masks from ``dropout`` (a ``DropoutKey``), each
    layer by its own ``layer_id``, numbered here in module order.
    ``telemetry``, a dict, opts in to the per-block selection shapes, nested
    as JAX's ``telemetry`` collection: ``stage{i}/block{j}/sel_win`` and
    ``sel_grid`` (``models/sast.SASTBlock``)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype = torch.float32,
                 sparse_kernel: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        for idx in range(cfg.num_stages):
            self.add_module(f"stage{idx}", SASTStage(cfg, idx, dtype, sparse_kernel))
        for i, m in enumerate(m for m in self.modules() if isinstance(m, Dropout)):
            m.layer_id = i

    def forward(
        self,
        x: torch.Tensor,
        prev_states: Optional[List[Optional[LstmState]]] = None,
        token_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        dropout: Optional[DropoutKey] = None,
        telemetry: Optional[dict] = None,
    ) -> Tuple[Dict[int, torch.Tensor], List[LstmState], torch.Tensor]:
        cfg = self.cfg
        n = cfg.num_stages
        if prev_states is None:
            prev_states = [None] * n
        if len(prev_states) != n:
            raise ValueError(f"{len(prev_states)} states for {n} stages")
        fused = fused_stem_density(cfg, x)
        r = None if fused else non_zero_ratio(x, n, use_kernel=cfg.ratio_pallas)
        if x.dtype.is_floating_point:
            x = x.to(self.dtype)
        # else: uint8 histograms enter the stage-0 stem raw.
        features: Dict[int, torch.Tensor] = {}
        states: List[LstmState] = []
        p_stages = []
        for idx in range(n):
            stage_r = None if fused and idx == 0 else r[:, idx].to(self.dtype)
            x, state, p, ratio = getattr(self, f"stage{idx}")(
                x, prev_states[idx], token_mask if idx == 0 else None, stage_r, deterministic,
                dropout, None if telemetry is None else telemetry.setdefault(f"stage{idx}", {}),
            )
            if ratio is not None:
                r = ratio
            states.append(state)
            features[idx + 1] = state[0]
            p_stages.append(p)
        return features, states, torch.stack(p_stages)


def zero_states(cfg: BackboneConfig, batch_size: int, dtype=torch.float32,
                device=None) -> List[LstmState]:
    """Zero recurrent states: hidden in ``dtype``, cell in fp32."""
    h0, w0 = cfg.in_res_hw
    states = []
    for idx, stride in enumerate(cfg.stage_strides):
        shape = (batch_size, h0 // stride, w0 // stride, cfg.stage_dims[idx])
        states.append((
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
        ))
    return states
