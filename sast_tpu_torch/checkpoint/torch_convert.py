"""The reference implementation's PyTorch checkpoint -> the port's detector
(the port's own copy of sast_tpu/checkpoint/torch_convert.py, with a loader
that sets the port's tensors).

``convert_state_dict`` turns a Lightning checkpoint's state_dict ('mdl.'
prefix, head under 'yolox_head.') into the flax-layout parameter and
batch-statistics trees of the JAX package's ``YoloXDetector``;
``load_torch_checkpoint`` sets the port's parameters AND BatchNorm running
statistics from them through ``weights.load_jax_variables``.

Layout transforms:
- Conv2d (O, I, kH, kW)        -> (kH, kW, I, O)
- Linear (O, I)                -> (I, O)
- LayerNorm weight/bias        -> scale/bias
- BatchNorm                    -> scale/bias + batch_stats mean/var
- qkv Linear: the reference packs output channels head-major with q/k/v
  interleaved per head (view(M,-1,heads,dh*3).transpose(1,2).chunk(3,dim=3));
  the JAX package and the port pack (q|k|v) blocks of (heads*dh). Channels
  are permuted accordingly.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from sast_tpu_torch.config import ModelConfig
from sast_tpu_torch.weights import load_jax_variables


def _conv(w) -> np.ndarray:
    return np.transpose(np.asarray(w, np.float32), (2, 3, 1, 0))


def _dense(w) -> np.ndarray:
    return np.transpose(np.asarray(w, np.float32), (1, 0))


def _qkv_permutation(dim: int, dim_head: int) -> np.ndarray:
    """Map our output channel (g, h, d) -> reference channel (h, g, d)."""
    heads = dim // dim_head
    perm = np.zeros((3 * dim,), np.int64)
    i = 0
    for g in range(3):
        for h in range(heads):
            for d in range(dim_head):
                perm[i] = h * 3 * dim_head + g * dim_head + d
                i += 1
    return perm


def _base_conv(sd, prefix: str) -> Tuple[Dict, Dict]:
    params = {
        "Conv_0": {"kernel": _conv(sd[f"{prefix}.conv.weight"])},
        "BatchNorm_0": {
            "scale": np.asarray(sd[f"{prefix}.bn.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.bn.bias"], np.float32),
        },
    }
    stats = {
        "BatchNorm_0": {
            "mean": np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32),
            "var": np.asarray(sd[f"{prefix}.bn.running_var"], np.float32),
        }
    }
    return params, stats


def _dw_conv(sd, prefix: str) -> Tuple[Dict, Dict]:
    p0, s0 = _base_conv(sd, f"{prefix}.dconv")
    p1, s1 = _base_conv(sd, f"{prefix}.pconv")
    return (
        {"BaseConv_0": p0, "BaseConv_1": p1},
        {"BaseConv_0": s0, "BaseConv_1": s1},
    )


def _bottleneck(sd, prefix: str, depthwise: bool) -> Tuple[Dict, Dict]:
    p1, s1 = _base_conv(sd, f"{prefix}.conv1")
    if depthwise:
        p2, s2 = _dw_conv(sd, f"{prefix}.conv2")
        return {"BaseConv_0": p1, "DWConv_0": p2}, {"BaseConv_0": s1, "DWConv_0": s2}
    p2, s2 = _base_conv(sd, f"{prefix}.conv2")
    return {"BaseConv_0": p1, "BaseConv_1": p2}, {"BaseConv_0": s1, "BaseConv_1": s2}


def _csp(sd, prefix: str, n: int, depthwise: bool) -> Tuple[Dict, Dict]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i, name in enumerate(("conv1", "conv2")):
        p, s = _base_conv(sd, f"{prefix}.{name}")
        params[f"BaseConv_{i}"] = p
        stats[f"BaseConv_{i}"] = s
    for j in range(n):
        p, s = _bottleneck(sd, f"{prefix}.m.{j}", depthwise)
        params[f"Bottleneck_{j}"] = p
        stats[f"Bottleneck_{j}"] = s
    p, s = _base_conv(sd, f"{prefix}.conv3")
    params["BaseConv_2"] = p
    stats["BaseConv_2"] = s
    return params, stats


def _ms_wsa(sd, prefix: str, dim: int, dim_head: int) -> Dict:
    perm = _qkv_permutation(dim, dim_head)
    qkv_w = _dense(sd[f"{prefix}.qkv.weight"])[:, perm]
    out = {
        "norm1": {
            "scale": np.asarray(sd[f"{prefix}.norm1.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.norm1.bias"], np.float32),
        },
        "norm2": {
            "scale": np.asarray(sd[f"{prefix}.norm2.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.norm2.bias"], np.float32),
        },
        "qkv": {"kernel": qkv_w},
        "proj": {
            "kernel": _dense(sd[f"{prefix}.proj.weight"]),
            "bias": np.asarray(sd[f"{prefix}.proj.bias"], np.float32),
        },
        "ls1": {"gamma": np.asarray(sd[f"{prefix}.ls1.gamma"], np.float32)},
        "ls2": {"gamma": np.asarray(sd[f"{prefix}.ls2.gamma"], np.float32)},
        "mlp": {
            "GLU_0": {
                "Dense_0": {
                    "kernel": _dense(sd[f"{prefix}.mlp.net.0.proj.weight"]),
                    "bias": np.asarray(sd[f"{prefix}.mlp.net.0.proj.bias"], np.float32),
                }
            },
            "Dense_0": {
                "kernel": _dense(sd[f"{prefix}.mlp.net.2.weight"]),
                "bias": np.asarray(sd[f"{prefix}.mlp.net.2.bias"], np.float32),
            },
        },
    }
    if f"{prefix}.qkv.bias" in sd:
        out["qkv"]["bias"] = np.asarray(sd[f"{prefix}.qkv.bias"], np.float32)[perm]
    return out


def convert_state_dict(sd: Dict[str, Any], cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """Reference 'mdl.*' state_dict -> (params, batch_stats) pytrees."""
    sd = {k[len("mdl."):] if k.startswith("mdl.") else k: v for k, v in sd.items()}
    # The reference detector's head attribute is ``yolox_head``: normalize
    # to ``head.``.
    sd = {
        ("head." + k[len("yolox_head."):]) if k.startswith("yolox_head.") else k: v
        for k, v in sd.items()
    }
    sd = {k: np.asarray(v.cpu().numpy() if hasattr(v, "cpu") else v) for k, v in sd.items()}

    bb = cfg.backbone
    dim_head = bb.attention.dim_head
    params: Dict[str, Any] = {"backbone": {}, "fpn": {}, "head": {}}
    stats: Dict[str, Any] = {"fpn": {}, "head": {}}

    # ---- backbone ----
    for i in range(bb.num_stages):
        dim = bb.stage_dims[i]
        sp = f"backbone.stages.{i}"
        stage: Dict[str, Any] = {
            "downsample": {
                "Conv_0": {"kernel": _conv(sd[f"{sp}.downsample_cf2cl.conv.weight"])},
                "LayerNorm_0": {
                    "scale": np.asarray(sd[f"{sp}.downsample_cf2cl.norm.weight"], np.float32),
                    "bias": np.asarray(sd[f"{sp}.downsample_cf2cl.norm.bias"], np.float32),
                },
            },
            "lstm": {
                "Conv_0": {
                    "kernel": _conv(sd[f"{sp}.lstm.conv1x1.weight"]),
                    "bias": np.asarray(sd[f"{sp}.lstm.conv1x1.bias"], np.float32),
                }
            },
        }
        if f"{sp}.mask_token" in sd:
            stage["mask_token"] = np.asarray(sd[f"{sp}.mask_token"], np.float32)
        for j in range(bb.num_blocks[i]):
            bp = f"{sp}.att_blocks.{j}.att"
            block: Dict[str, Any] = {
                "win_attn": _ms_wsa(sd, f"{bp}.win_attn", dim, dim_head),
                "grid_attn": _ms_wsa(sd, f"{bp}.grid_attn", dim, dim_head),
            }
            if j == 0:
                block["to_scores"] = {
                    "kernel": _dense(sd[f"{bp}.to_scores.weight"]),
                    "bias": np.asarray(sd[f"{bp}.to_scores.bias"], np.float32),
                }
                block["to_controls"] = {
                    "weight": _dense(sd[f"{bp}.to_controls.weight"])
                }
            stage[f"block{j}"] = block
        params["backbone"][f"stage{i}"] = stage

    # ---- fpn ----
    n_csp = round(3 * cfg.fpn.depth)
    dw = cfg.fpn.depthwise
    fpn_p: Dict[str, Any] = {}
    fpn_s: Dict[str, Any] = {}
    for name in ("lateral_conv0", "reduce_conv1", "bu_conv2", "bu_conv1"):
        fpn_p[name], fpn_s[name] = _base_conv(sd, f"fpn.{name}")
    for name in ("C3_p4", "C3_p3", "C3_n3", "C3_n4"):
        fpn_p[name], fpn_s[name] = _csp(sd, f"fpn.{name}", n_csp, dw)
    params["fpn"], stats["fpn"] = fpn_p, fpn_s

    # ---- head ----
    head_p: Dict[str, Any] = {}
    head_s: Dict[str, Any] = {}
    n_levels = len(cfg.fpn.in_stages)
    for k in range(n_levels):
        head_p[f"stem{k}"], head_s[f"stem{k}"] = _base_conv(sd, f"head.stems.{k}")
        for c in range(2):
            head_p[f"cls_conv{k}_{c}"], head_s[f"cls_conv{k}_{c}"] = _base_conv(
                sd, f"head.cls_convs.{k}.{c}"
            )
            head_p[f"reg_conv{k}_{c}"], head_s[f"reg_conv{k}_{c}"] = _base_conv(
                sd, f"head.reg_convs.{k}.{c}"
            )
        for name, tname in (
            (f"cls_pred{k}", f"head.cls_preds.{k}"),
            (f"reg_pred{k}", f"head.reg_preds.{k}"),
            (f"obj_pred{k}", f"head.obj_preds.{k}"),
        ):
            head_p[name] = {
                "kernel": _conv(sd[f"{tname}.weight"]),
                "bias": np.asarray(sd[f"{tname}.bias"], np.float32),
            }
    params["head"], stats["head"] = head_p, head_s
    return params, stats


def load_torch_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.ckpt``/``.pth`` into ``model`` (the port's
    ``YoloXDetector``): its parameters and its BatchNorm running statistics.
    A Lightning file pickles more than tensors, hence ``weights_only=False``:
    load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    params, stats = convert_state_dict(sd, model.config)
    return load_jax_variables(model, {"params": params, "batch_stats": stats})
