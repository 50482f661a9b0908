"""Load the JAX package's variables into the port.

``load_jax_variables(model, variables)`` takes the ``{"params",
"batch_stats"}`` tree of a ``sast_tpu`` ``YoloXDetector`` as nested dicts of
numpy arrays (what ``jax.device_get(variables)`` gives) and sets the port's
parameters and BatchNorm statistics from it. The port's modules carry the
flax names, so a leaf ``params/backbone/stage0/downsample/Conv_0/kernel``
is the port's ``backbone.stage0.downsample.Conv_0.kernel`` and
``batch_stats/.../BatchNorm_0/mean`` its buffer of that name. Layouts:

- ``Conv.kernel``: flax HWIO -> OIHW (depthwise HW1C -> C1HW);
- ``Dense.kernel`` and ``PositiveDense.weight``: ``(in, out)`` -> ``(out, in)``;
- every other leaf keeps its shape.

Every JAX leaf is consumed exactly once and every port parameter and
buffer is set exactly once; anything left over on either side raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from sast_tpu_torch.models.layers import Conv, Dense
from sast_tpu_torch.models.sast import PositiveDense

COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _to_port(module: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if isinstance(module, Conv) and leaf == "kernel":
        return value.transpose(3, 2, 0, 1)
    if (isinstance(module, Dense) and leaf == "kernel") or (
        isinstance(module, PositiveDense) and leaf == "weight"
    ):
        return value.T
    return value


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Set ``model``'s parameters and buffers from a flax variables tree."""
    extra = set(variables) - set(COLLECTIONS)
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    jax_leaves = {}
    for col in COLLECTIONS:
        for path, value in _flatten(variables.get(col, {})).items():
            jax_leaves[(col,) + path] = value
    modules = dict(model.named_modules())
    targets = [("params", n, t) for n, t in model.named_parameters()]
    targets += [("batch_stats", n, t) for n, t in model.named_buffers()]
    unset = []
    for col, name, tensor in targets:
        key = (col,) + tuple(name.split("."))
        if key not in jax_leaves:
            unset.append(name)
            continue
        owner, _, leaf = name.rpartition(".")
        value = _to_port(modules[owner], leaf, jax_leaves.pop(key))
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: JAX shape {value.shape} vs port {tuple(tensor.shape)}")
        tensor.copy_(torch.from_numpy(np.array(value)).to(tensor.dtype))
    if unset or jax_leaves:
        raise ValueError(
            f"weight bridge mismatch: port tensors without a JAX leaf {unset}; "
            f"JAX leaves not consumed {['/'.join(k) for k in jax_leaves]}"
        )
    return model
