"""YOLO PAFPN neck over backbone stages (2, 3, 4) (port of
sast_tpu/models/pafpn.py): top-down upsample + CSP fusion, then bottom-up
stride-2 conv + CSP fusion. NHWC."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from sast_tpu_torch.models.layers import BaseConv, CSPLayer, conv_block


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NHWC)."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


class YoloPAFPN(nn.Module):
    def __init__(self, depth: float = 1.0, in_channels: Tuple[int, ...] = (256, 512, 1024),
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c0, c1, c2 = in_channels
        n = round(3 * depth)
        _, Conv = conv_block(depthwise)
        kw = dict(act=act, dtype=dtype)
        csp = dict(n=n, shortcut=False, depthwise=depthwise, act=act, dtype=dtype)
        self.lateral_conv0 = BaseConv(c2, c1, 1, 1, **kw)
        self.C3_p4 = CSPLayer(2 * c1, c1, **csp)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1, **kw)
        self.C3_p3 = CSPLayer(2 * c0, c0, **csp)
        self.bu_conv2 = Conv(c0, c0, 3, 2, **kw)
        self.C3_n3 = CSPLayer(2 * c0, c1, **csp)
        self.bu_conv1 = Conv(c1, c1, 3, 2, **kw)
        self.C3_n4 = CSPLayer(2 * c1, c2, **csp)

    def forward(self, features):
        """features: (x2, x1, x0) at strides (8, 16, 32), shallowest first."""
        x2, x1, x0 = features
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = self.C3_p4(torch.cat([_upsample2x(fpn_out0), x1], dim=-1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([_upsample2x(fpn_out1), x2], dim=-1))
        p_out1 = torch.cat([self.bu_conv2(pan_out2), fpn_out1], dim=-1)
        pan_out1 = self.C3_n3(p_out1)
        p_out0 = torch.cat([self.bu_conv1(pan_out1), fpn_out0], dim=-1)
        pan_out0 = self.C3_n4(p_out0)
        return pan_out2, pan_out1, pan_out0
