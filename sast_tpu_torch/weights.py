"""The JAX package's variables into the port, and back.

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

``to_jax_variables(model)`` is the inverse: the port's parameters and
buffers (or, with ``grads=True``, the parameters' ``.grad``) as a
flax-shaped tree of numpy arrays in flax layout, so that gradients, updated
parameters, EMA copies and ``batch_stats`` compare leaf by leaf with the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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


def _to_flax(module: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if isinstance(module, Conv) and leaf == "kernel":
        return value.transpose(2, 3, 1, 0)
    if (isinstance(module, Dense) and leaf == "kernel") or (
        isinstance(module, PositiveDense) and leaf == "weight"
    ):
        return value.T
    return value


def _insert(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


@torch.no_grad()
def to_jax_variables(model: nn.Module, grads: bool = False,
                     tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, dict]:
    """``model``'s state as the flax variables tree ``load_jax_variables``
    reads: ``{"params": ..., "batch_stats": ...}`` of fp32 numpy arrays in
    flax layout (copies: a later in-place update of the model does not
    reach them).

    With ``grads`` the tree holds each parameter's ``.grad`` (zeros where it
    is None) and no ``batch_stats``. With ``tensors`` (parameter name ->
    tensor, e.g. an EMA copy) it holds those in place of the parameters.
    """
    modules = dict(model.named_modules())
    out: Dict[str, dict] = {"params": {}}
    for name, p in model.named_parameters():
        value = p
        if tensors is not None:
            value = tensors[name]
        elif grads:
            value = p.grad if p.grad is not None else torch.zeros_like(p)
        owner, _, leaf = name.rpartition(".")
        arr = value.detach().to(torch.float32).cpu().numpy()
        _insert(out["params"], name.split("."), np.array(_to_flax(modules[owner], leaf, arr)))
    if not grads and tensors is None:
        out["batch_stats"] = {}
        for name, b in model.named_buffers():
            _insert(out["batch_stats"], name.split("."),
                    np.array(b.detach().to(torch.float32).cpu().numpy()))
    return out
