"""RVT-B's mathematics in plain PyTorch: the reference of the RVT cells.

A frozen, independent copy of what a streaming RVT detector computes for one
frame per lane, written from the published model (Gehrig & Scaramuzza,
"Recurrent Vision Transformers for Object Detection with Event Cameras",
CVPR 2023, arXiv 2212.05598, code github.com/uzh-rpg/RVT): the stacked
histogram of the events, the pad to the model's resolution, four backbone
stages and the PAFPN neck, YOLOX head, decoding and NMS of
``reference/detector.py`` (imported, unchanged). Per stage, on NHWC x::

    x = ConvDownsample(x)           # conv k 7 s 4 (stage 1) / k 3 s 2, no bias; LayerNorm
    for P in (window_partition, grid_partition):     # partition (6, 10) at gen4
        t = P(x)                                      # (B, N, 60, C)
        t = t + ls1 * proj(softmax(q k^T / sqrt(32)) v),  q, k, v from qkv(LN1(t))
        t = t + ls2 * Dense_1(gelu(Dense_0(LN2(t))))      # C -> 4C -> C, exact GELU
        x = P^-1(t)
    h, c = ConvLSTM(x, state)       # a 1x1 conv of [x, h] to 4C gates, as SAST's

with ``heads = C / 32``; every token attends every token of its window or
grid cell: no density ratio, no scoring, no selection, no position
embedding. Float32 throughout; every matrix product and convolution takes
its operands through ``q`` (the identity here, a rounding for the control).

Departures from the equations above: none. Departures from RVT's own code,
each a re-parametrisation or an assumption of the benchmark's, not a change
of the function: ``qkv``'s output rows are laid out ``[q | k | v]`` x heads
(RVT's code lays each head's q, k and v side by side; a checkpoint maps by a
permutation of those rows); the stage-1 convolution pads by replicating the
border and the LayerNorm computes its variance as E[x^2] - E[x]^2, as
``reference/detector.py`` does for SAST; the weights are the benchmark's
stand-ins (``perfbench/weights.py``), named by its rules (``kernel``,
``bias``, ``scale``, ``gamma``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import detector as R


def param_shapes(sz: R.Sizes) -> Dict[str, tuple]:
    """Every parameter and statistic of RVT-B by name, with its shape (conv
    kernels OIHW, dense kernels (out, in)); the neck's and head's are
    ``reference/detector.py``'s."""
    out: Dict[str, tuple] = {}
    for i, dim in enumerate(sz.dims):
        st = f"backbone.stage{i}"
        cin = sz.in_ch if i == 0 else sz.dims[i - 1]
        out[f"{st}.downsample.Conv_0.kernel"] = (dim, cin, 7 if i == 0 else 3,
                                                 7 if i == 0 else 3)
        out[f"{st}.downsample.LayerNorm_0.scale"] = (dim,)
        out[f"{st}.downsample.LayerNorm_0.bias"] = (dim,)
        inner = dim * sz.mlp_ratio
        for a in ("win_attn", "grid_attn"):
            at = f"{st}.block0.{a}"
            for n in ("norm1", "norm2"):
                out[f"{at}.{n}.scale"] = (dim,)
                out[f"{at}.{n}.bias"] = (dim,)
            out[f"{at}.qkv.kernel"] = (3 * dim, dim)
            out[f"{at}.qkv.bias"] = (3 * dim,)
            out[f"{at}.proj.kernel"] = (dim, dim)
            out[f"{at}.proj.bias"] = (dim,)
            out[f"{at}.ls1.gamma"] = (dim,)
            out[f"{at}.ls2.gamma"] = (dim,)
            out[f"{at}.mlp.Dense_0.kernel"] = (inner, dim)
            out[f"{at}.mlp.Dense_0.bias"] = (inner,)
            out[f"{at}.mlp.Dense_1.kernel"] = (dim, inner)
            out[f"{at}.mlp.Dense_1.bias"] = (dim,)
        out[f"{st}.lstm.Conv_0.kernel"] = (4 * dim, 2 * dim, 1, 1)
        out[f"{st}.lstm.Conv_0.bias"] = (4 * dim,)
    out.update({k: v for k, v in R.param_shapes(sz).items() if not k.startswith("backbone.")})
    return out


def attention_layer(P, name: str, t: torch.Tensor, heads: int, q: R.Q) -> torch.Tensor:
    """One partition attention layer on (B, N, hw, C): pre-norm attention
    over the whole window or grid cell and an ungated MLP, each with a
    LayerScale residual."""
    B, N, hw, C = t.shape
    dh = C // heads
    y = R.layer_norm(t, P[f"{name}.norm1.scale"], P[f"{name}.norm1.bias"])
    qkv = R.dense(P, f"{name}.qkv", y, q).reshape(B, N, hw, 3 * heads, dh)
    qh, kh, vh = (qkv[:, :, :, i * heads:(i + 1) * heads].permute(0, 1, 3, 2, 4)
                  for i in range(3))
    attn = torch.softmax((q(qh) @ q(kh).transpose(-1, -2)) * dh ** -0.5, dim=-1)
    out = (q(attn) @ q(vh)).permute(0, 1, 3, 2, 4).reshape(B, N, hw, C)
    t = t + P[f"{name}.ls1.gamma"] * R.dense(P, f"{name}.proj", out, q)
    z = R.layer_norm(t, P[f"{name}.norm2.scale"], P[f"{name}.norm2.bias"])
    m = F.gelu(R.dense(P, f"{name}.mlp.Dense_0", z, q))
    return t + P[f"{name}.ls2.gamma"] * R.dense(P, f"{name}.mlp.Dense_1", m, q)


def backbone(P, sz: R.Sizes, x: torch.Tensor, state: R.State, q: R.Q):
    """x: (B, H, W, C) uint8 at the model's resolution -> (features by stage
    number 1-4, new state)."""
    h = x.to(torch.float32)
    feats, new_state = {}, []
    for i, dim in enumerate(sz.dims):
        st = f"backbone.stage{i}"
        w = P[f"{st}.downsample.Conv_0.kernel"]
        h = R.conv(h, w, q, 4 if i == 0 else 2, w.shape[-1] // 2, mode="replicate")
        h = R.layer_norm(h, P[f"{st}.downsample.LayerNorm_0.scale"],
                         P[f"{st}.downsample.LayerNorm_0.bias"])
        H, W = h.shape[1:3]
        p, heads = sz.partition, dim // sz.dim_head
        h = R.window_reverse(attention_layer(P, f"{st}.block0.win_attn",
                                             R.window_partition(h, p), heads, q), p, (H, W))
        h = R.grid_reverse(attention_layer(P, f"{st}.block0.grid_attn",
                                           R.grid_partition(h, p), heads, q), p, (H, W))
        h_prev, c_prev = state[i]
        mix = R.conv(torch.cat((h, h_prev), dim=-1), P[f"{st}.lstm.Conv_0.kernel"], q,
                     bias=P[f"{st}.lstm.Conv_0.bias"])
        f_g, i_g, o_g = torch.sigmoid(mix[..., :3 * dim]).chunk(3, dim=-1)
        c = f_g * c_prev + i_g * torch.tanh(mix[..., 3 * dim:])
        h = o_g * torch.tanh(c)
        new_state.append((h, c))
        feats[i + 1] = h
    return feats, new_state


def serve_frame(P, sz: R.Sizes, packed: torch.Tensor, n_events: torch.Tensor, state: R.State,
                q: R.Q = R.identity, pos_cache: Optional[dict] = None):
    """One frame per lane from raw events and the carried state -> (slate,
    new state, decoded predictions with logits). ``pos_cache`` is taken as
    ``reference/detector.serve_frame`` takes it, and unused: RVT has no
    position embedding."""
    rep = R.stacked_histogram(packed, n_events, sz.bins, *sz.sensor_hw, sz.count_cutoff)
    feats, new_state = backbone(P, sz, R.pad_to(rep, sz.model_hw), state, q)
    preds, _, _ = R.head(P, sz, R.neck(P, sz, feats, q), q)
    return R.slate(sz, preds), new_state, preds
