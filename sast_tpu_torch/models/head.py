"""YOLOX decoupled anchor-free detection head (port of
sast_tpu/models/head.py): per-scale stem + cls/reg towers + 1x1 prediction
convs, grid decoding (xy = (pred + grid) * stride, wh = exp(pred) * stride).
Returns one flattened (B, A, 5 + num_classes) tensor of decoded boxes and
logit obj/cls."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from sast_tpu_torch.models.layers import BaseConv, Conv, conv_block


def build_grids(
    hw_per_level: Sequence[Tuple[int, int]], strides: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-anchor (x, y) cell coords (A, 2) and stride vector (A,), fp32,
    level-major and row-major within a level."""
    grids, stride_list = [], []
    for (h, w), s in zip(hw_per_level, strides):
        yv, xv = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grids.append(np.stack((xv, yv), axis=-1).reshape(-1, 2))
        stride_list.append(np.full((h * w,), s))
    return (
        np.concatenate(grids, axis=0).astype(np.float32),
        np.concatenate(stride_list, axis=0).astype(np.float32),
    )


class YoloXHead(nn.Module):
    def __init__(self, num_classes: int, strides: Tuple[int, ...] = (8, 16, 32),
                 in_channels: Tuple[int, ...] = (256, 512, 1024), act: str = "silu",
                 depthwise: bool = False, prior_prob: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.strides = num_classes, tuple(strides)
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)
        hidden = int(256 * in_channels[-1] / 1024)
        _, Tower = conv_block(depthwise)
        kw = dict(act=act, dtype=dtype)
        for k, cin in enumerate(in_channels):
            self.add_module(f"stem{k}", BaseConv(cin, hidden, 1, 1, **kw))
            for t in ("cls", "reg"):
                self.add_module(f"{t}_conv{k}_0", Tower(hidden, hidden, 3, 1, **kw))
                self.add_module(f"{t}_conv{k}_1", Tower(hidden, hidden, 3, 1, **kw))
            self.add_module(f"cls_pred{k}", Conv(hidden, num_classes, 1, dtype=dtype))
            self.add_module(f"reg_pred{k}", Conv(hidden, 4, 1, dtype=dtype))
            self.add_module(f"obj_pred{k}", Conv(hidden, 1, 1, dtype=dtype))
        self._grids: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def init_prior_bias(self) -> None:
        """Focal-style bias init of the cls/obj predictors (flax bias_init)."""
        with torch.no_grad():
            for k in range(len(self.strides)):
                getattr(self, f"cls_pred{k}").bias.fill_(self.prior_bias)
                getattr(self, f"obj_pred{k}").bias.fill_(self.prior_bias)

    def grids(self, hw_per_level, device):
        """Anchor cells and strides on ``device``, kept per shape and device;
        under a trace (``torch.export``) made afresh and not kept."""
        key = (tuple(hw_per_level), str(device))
        grids = self._grids.get(key)
        if grids is None:
            g, s = build_grids(hw_per_level, self.strides)
            grids = (torch.from_numpy(g).to(device), torch.from_numpy(s).to(device))
            if not torch.compiler.is_compiling():
                self._grids[key] = grids
        return grids

    def forward(self, features) -> Dict[str, torch.Tensor]:
        outputs, hw_per_level = [], []
        for k, x in enumerate(features):
            hw_per_level.append((x.shape[1], x.shape[2]))
            x = getattr(self, f"stem{k}")(x)
            cls_feat = getattr(self, f"cls_conv{k}_1")(getattr(self, f"cls_conv{k}_0")(x))
            reg_feat = getattr(self, f"reg_conv{k}_1")(getattr(self, f"reg_conv{k}_0")(x))
            out = torch.cat([
                getattr(self, f"reg_pred{k}")(reg_feat),
                getattr(self, f"obj_pred{k}")(reg_feat),
                getattr(self, f"cls_pred{k}")(cls_feat),
            ], dim=-1)
            outputs.append(out.reshape(out.shape[0], -1, out.shape[-1]))
        raw = torch.cat(outputs, dim=1).to(torch.float32)  # (B, A, 5 + n_cls)
        grids, strides = self.grids(hw_per_level, raw.device)
        xy = (raw[..., 0:2] + grids) * strides[:, None]
        wh = torch.exp(raw[..., 2:4]) * strides[:, None]
        decoded = torch.cat([xy, wh, raw[..., 4:]], dim=-1)
        return {"preds": decoded, "grids": grids, "strides": strides}


def inference_outputs(preds: torch.Tensor) -> torch.Tensor:
    """Decoded predictions with sigmoid obj/cls for postprocessing/NMS."""
    return torch.cat([preds[..., :4], torch.sigmoid(preds[..., 4:])], dim=-1)
