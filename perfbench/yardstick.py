"""The yardstick's arithmetic: the card's published peaks, the model's FLOPs
counted over the reference, and kernel A's bytes and operations.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W: 989.4 TFLOP/s
in bfloat16 and 3.35 TB/s of HBM.

FLOPs: ``FlopCounterMode`` (2 per multiply-add) over the reference's
forward at one frame on the meta device: every window attended, whatever
the scene keeps ("full window density"), so that every implementation is
credited the same work for the same frame.

Kernel A (``stem_conv``): the 7x7 stride-4 convolution of the (B, H, W, C)
uint8 histogram into (B, H/4, W/4, Cout) bfloat16, with the density
pyramid's (B, 4, C) int32 counts: its bytes read each input byte once and
write each output byte once; its operations are 2 per multiply-add.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from perfbench.reference import detector as R

PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12
# Kernel A's kernels by the names of their sources (the port's ``stem_conv.cu``).
KERNEL_A = r"stem_\w*kernel|arrange_kernel"


@functools.lru_cache(maxsize=None)
def _flops(sizes_key: tuple) -> Tuple[int, int]:
    from torch.utils.flop_counter import FlopCounterMode

    sz = R.Sizes(dict(sizes_key))
    P = {k: torch.empty(s, device="meta") for k, s in R.param_shapes(sz).items()}
    x = torch.empty((1, *sz.model_hw, sz.in_ch), dtype=torch.uint8, device="meta")
    state = R.zero_state(sz, 1, "meta")
    with torch.no_grad():
        with FlopCounterMode(display=False) as bb:
            feats, _, _ = R.backbone(P, sz, x, state, R.identity, {})
        with FlopCounterMode(display=False) as dh:
            R.head(P, sz, R.neck(P, sz, feats, R.identity), R.identity)
    return bb.get_total_flops(), dh.get_total_flops()


def model_flops(config: Dict) -> Tuple[int, int]:
    """(backbone, neck and head) FLOPs of one frame."""
    key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in config.items()
                       if not isinstance(v, dict)))
    return _flops(key)


def frame_flops(config: Dict) -> int:
    return sum(model_flops(config))


def sequence_flops(config: Dict, seq_len: int, labeled: int) -> int:
    """Forward FLOPs of one training sequence: the backbone over every
    frame, the neck and head over every labeled-frame slot."""
    bb, dh = model_flops(config)
    return seq_len * bb + labeled * dh


def stem_bytes_and_flops(lanes: int, config: Dict) -> Tuple[int, int]:
    sz = R.Sizes(config)
    H, W = sz.model_hw
    C, cout = sz.in_ch, sz.dims[0]
    out_px = lanes * (H // 4) * (W // 4)
    n_bytes = lanes * H * W * C + cout * C * 49 * 2 + out_px * cout * 2 + lanes * 4 * C * 4
    return n_bytes, 2 * out_px * cout * C * 49


def least_seconds(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
