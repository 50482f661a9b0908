"""The detector's weights, made on the card from the run's seed.

Stand-ins for trained weights, by the parameter's name: every convolution
and dense kernel normal with variance 1 / fan-in, clipped at two standard
deviations; biases, means 0; norm scales, variances and the positive
controls' weights 1; LayerScale 0.05 (at its 1e-5 init the attention
barely moves its input); the prediction convolutions' kernels scaled so
that the objectness and class logits spread over a few units and the box
sizes over a factor of a few (``HEAD_GAIN``), so that hundreds of
candidates pass the confidence threshold of 0.01 and NMS does real work.
Training takes no such gain (``head_gain={}``): there the neck's and head's
BatchNorm normalise with the batch's statistics, under which the gains
would put the logits in the thousands and the box sizes past float32.
All kernels come from one draw of one generator on the card; the program
and the reference each get a copy of the same values."""

from __future__ import annotations

import math
from typing import Dict

import torch

HEAD_GAIN = {"obj_pred": 2000.0, "cls_pred": 2000.0, "reg_pred": 400.0}
LAYER_SCALE = 0.05


def _constant(name: str) -> float:
    leaf = name.rsplit(".", 1)[1]
    if leaf in ("bias", "mean"):
        return 0.0
    if leaf in ("scale", "var", "weight"):
        return 1.0
    if leaf == "gamma":
        return LAYER_SCALE
    raise ValueError(f"no rule for the parameter {name}")


@torch.no_grad()
def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 head_gain: Dict[str, float] = HEAD_GAIN) -> Dict[str, torch.Tensor]:
    """Every tensor of ``shapes`` (name -> shape), float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    kernels = [n for n in shapes if n.endswith(".kernel")]
    sizes = [math.prod(shapes[n]) for n in kernels]
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, size in zip(kernels, sizes):
        shape = shapes[name]
        gain = next((g for k, g in head_gain.items() if f".{k}" in name), 1.0)
        std = gain / math.sqrt(math.prod(shape[1:]))
        out[name] = flat[at:at + size].view(shape).mul_(std)
        at += size
    for name, shape in shapes.items():
        if name not in out:
            out[name] = torch.full(shape, _constant(name), device=device)
    return out
