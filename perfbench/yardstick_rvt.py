"""The RVT cells' arithmetic: the model's FLOPs counted over the RVT
reference, and the bytes and operations of kernel D's RVT variant.

FLOPs: ``FlopCounterMode`` (2 per multiply-add) over the reference's
forward at one frame on the meta device (``reference/rvt.py``); every token
is attended, so this is the work the frame needs.

The variant (``rvt_block_fwd``, one launch sequence per attention layer, two
layers a stage): at a stage of C channels, T = lanes x H x W tokens in
windows of hw and an MLP of I = mlp_ratio x C, its operations are 2 per
multiply-add of QKV, q k^T, P v, proj, Lin1 and Lin2, ``2 T (3C^2 + hw C +
hw C + C^2 + 2 C I)``; its bytes read each activation and weight once and
write each activation once: the tokens in and out in bfloat16 (``4 T C``),
the four matrices in bfloat16 and the vectors (two LayerNorms, four biases,
two LayerScales) in float32. The least time of a layer is the larger of its
bytes over 3.35 TB/s and its operations over 989.4 TFLOP/s; the variant's
least time per call of the serving step is the sum over its eight layers
(the launches of one layer cannot overlap the next's).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from perfbench import yardstick
from perfbench.reference import detector as R
from perfbench.reference import rvt

# The variant's kernels, by the namespace their names carry (``csrc/sparse_fwd.cu``).
KERNEL = r"rvt_block"


def _key(config: Dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in config.items()
                        if not isinstance(v, dict)))


@functools.lru_cache(maxsize=None)
def _flops(sizes_key: tuple) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    sz = R.Sizes(dict(sizes_key))
    P = {k: torch.empty(s, device="meta") for k, s in rvt.param_shapes(sz).items()}
    x = torch.empty((1, *sz.model_hw, sz.in_ch), dtype=torch.uint8, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as count:
        feats, _ = rvt.backbone(P, sz, x, R.zero_state(sz, 1, "meta"), R.identity)
        R.head(P, sz, R.neck(P, sz, feats, R.identity), R.identity)
    return count.get_total_flops()


def frame_flops(config: Dict) -> int:
    """FLOPs of one RVT frame, backbone, neck and head."""
    return _flops(_key(config))


def block_layers(lanes: int, config: Dict) -> List[Tuple[int, int, int, int]]:
    """(T tokens, hw, C, I) of each of the variant's calls in one serving
    step of ``lanes`` lanes, in order."""
    sz = R.Sizes(config)
    hw = sz.partition[0] * sz.partition[1]
    out = []
    for i, dim in enumerate(sz.dims):
        H, W = sz.stage_hw(i)
        out += [(lanes * H * W, hw, dim, dim * sz.mlp_ratio)] * 2
    return out


def layer_bytes_and_flops(T: int, hw: int, C: int, I: int) -> Tuple[int, int]:
    tokens = 2 * T * C * 2  # in and out, bfloat16
    matrices = (4 * C * C + 2 * C * I) * 2  # qkv, proj, Lin1, Lin2, bfloat16
    vectors = (11 * C + I) * 4  # LN1, LN2 2C each; biases 3C, C, I, C; LayerScales 2C
    n_bytes = tokens + matrices + vectors
    flops = 2 * T * (4 * C * C + 2 * hw * C + 2 * C * I)
    return n_bytes, flops


def block_least_seconds(lanes: int, config: Dict) -> float:
    """The variant's least time per serving step (module docstring)."""
    return sum(yardstick.least_seconds(*layer_bytes_and_flops(*layer))
               for layer in block_layers(lanes, config))
