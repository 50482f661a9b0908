"""Detector composition root: SAST backbone + PAFPN + YOLOX head.

Port of sast_tpu/models/detector.py with the same forward_backbone /
forward_detect split, plus ``build_detector``, which makes a detector with
random weights drawn from a seeded ``torch.Generator`` on the requested
device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from sast_tpu_torch.config import ModelConfig
from sast_tpu_torch.models.backbone import LstmState, SASTBackbone
from sast_tpu_torch.models.head import YoloXHead
from sast_tpu_torch.models.layers import BatchNorm, Conv, Dense, DropoutKey, lecun_normal_
from sast_tpu_torch.models.pafpn import YoloPAFPN
from sast_tpu_torch.models.sast import MaskedSparseAttention
from sast_tpu_torch.parallel.mesh import Mesh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default; where it is
    absent the caller must ask for the CPU: nothing moves there on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's plain "
            "versions on the CPU"
        )
    return device


class YoloXDetector(nn.Module):
    """``sparse_kernel`` is the JAX detector's ``use_pallas``: the attention
    layers run the window-skipping block kernel (``ops/sparse_block.py``)."""

    def __init__(self, config: ModelConfig, sparse_kernel: bool = False):
        super().__init__()
        self.config = config
        dtype = DTYPES[config.compute_dtype]
        bb = config.backbone
        in_channels = tuple(bb.stage_dims[s - 1] for s in config.fpn.in_stages)
        strides = tuple(bb.stage_strides[s - 1] for s in config.fpn.in_stages)
        self.backbone = SASTBackbone(bb, dtype, sparse_kernel)
        self.fpn = YoloPAFPN(config.fpn.depth, in_channels, config.fpn.depthwise,
                             config.fpn.act, dtype)
        self.head = YoloXHead(config.head.num_classes, strides, in_channels,
                              config.head.act, config.head.depthwise, dtype=dtype)

    def forward_backbone(
        self,
        x: torch.Tensor,
        previous_states: Optional[List[Optional[LstmState]]] = None,
        token_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        dropout: Optional[DropoutKey] = None,
    ) -> Tuple[Dict[int, torch.Tensor], List[LstmState], torch.Tensor]:
        """x: (B, H, W, C_in) NHWC event representation. Under training
        (``deterministic=False``) with a non-zero stochastic rate,
        ``dropout`` gives the masks (``models/layers.DropoutKey``)."""
        return self.backbone(x, previous_states, token_mask, deterministic, dropout)

    def forward_detect(self, backbone_features: Dict[int, torch.Tensor],
                       train: bool = False, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """Neck and head. With ``train`` every BatchNorm of both normalises
        with the batch's statistics and updates its running ones in place
        (flax's ``mutable=["batch_stats"]``); with ``mesh`` too, the
        statistics are those of the global batch."""
        feats = tuple(backbone_features[s] for s in self.config.fpn.in_stages)
        norms = [m for part in (self.fpn, self.head) for m in part.modules()
                 if isinstance(m, BatchNorm)]
        for m in norms:
            m.use_batch_stats, m.mesh = train, mesh if train else None
        try:
            return self.head(self.fpn(feats))
        finally:
            for m in norms:
                m.use_batch_stats, m.mesh = False, None

    def forward(self, x, previous_states=None, token_mask=None):
        features, states, p = self.forward_backbone(x, previous_states, token_mask)
        return self.forward_detect(features), states, p


def set_sparse_kernel(model: nn.Module, on: bool) -> None:
    """Switch every attention layer of ``model`` to (or off) the
    window-skipping block kernel; the weights are shared by all paths."""
    for module in model.modules():
        if isinstance(module, MaskedSparseAttention):
            module.sparse_kernel = on


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers: lecun-normal conv and dense kernels from
    ``generator``; the constants (zero biases, unit norms, LayerScale,
    PositiveDense ones, BN running stats) are set by the modules; mask
    tokens are normal(0.02); the head's cls/obj biases get the prior."""
    for module in model.modules():
        if isinstance(module, Conv):
            o, i, kh, kw = module.kernel.shape
            lecun_normal_(module.kernel, i * kh * kw, generator)
        elif isinstance(module, Dense):
            lecun_normal_(module.kernel, module.kernel.shape[1], generator)
        elif isinstance(module, YoloXHead):
            module.init_prior_bias()
    for name, p in model.named_parameters():
        if name.endswith("mask_token"):
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)


@torch.no_grad()
def build_detector(config: ModelConfig, seed: int = 0, device="cuda",
                   sparse_kernel: bool = False) -> YoloXDetector:
    """A detector with random weights from ``torch.Generator().manual_seed(seed)``,
    in inference mode on ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    model = YoloXDetector(config, sparse_kernel)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
