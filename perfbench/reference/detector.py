"""The detector's mathematics in plain PyTorch: the yardstick's reference.

A frozen, independent copy of what a streaming SAST detector computes for
one frame per lane, written from the published model (SAST, Peng et al. 2024,
arXiv 2404.01882) and the YOLOX head: the stacked histogram of the events,
the bottom/right pad to the model's resolution, four backbone stages (an
overlapping strided convolution with a LayerNorm, one SAST block of a
window and a grid attention layer over the tokens that the scene-adaptive
selection keeps, and a ConvLSTM cell with carried state), the PAFPN neck,
the decoupled head, the grid decoding and class-aware greedy NMS into a
fixed slate. Tensors are NHWC, as the program keeps them, so that states
and features compare element for element.

Parameters come as a dict of tensors by name (``param_shapes`` lists the
names and shapes); every matrix product and convolution takes its two
operands through ``q``, which is the identity for the reference and a
rounding to a lower precision for the control (``perfbench/reference/
precision.py``). Everything else is float32. Call ``fp32_only()`` first on a
card, so that no matrix product runs in TF32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]
MASK_VALUE = -1e4  # key-mask constant of the attention
AMP, BOUNCE = 2e-4, 1e-3  # selection amplification and threshold slack


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp32_only() -> None:
    """Full float32 matrix products and convolutions on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# Sizes


class Sizes:
    """The sizes of one configuration file (``perfbench/configs/*.json``)."""

    def __init__(self, cfg: dict):
        self.sensor_hw = tuple(cfg["sensor_hw"])
        self.model_hw = tuple(cfg["model_hw"])
        self.in_ch = cfg["input_channels"]
        self.bins = self.in_ch // 2
        self.dims = tuple(cfg["embed_dim"] * m for m in cfg["dim_multiplier"])
        self.dim_head = cfg["dim_head"]
        self.mlp_ratio = cfg["mlp_ratio"]
        self.partition = tuple(cfg["partition_size"])
        self.num_classes = cfg["num_classes"]
        self.fpn_depth = cfg["fpn_depth"]
        self.count_cutoff = cfg["count_cutoff"]
        self.conf_threshold = cfg["confidence_threshold"]
        self.nms_threshold = cfg["nms_threshold"]
        self.pre_nms_topk = cfg["pre_nms_topk"]
        self.max_detections = cfg["max_detections"]
        self.strides = (4, 8, 16, 32)
        self.in_stages = (2, 3, 4)

    def stage_hw(self, i: int) -> Tuple[int, int]:
        s = self.strides[i]
        return self.model_hw[0] // s, self.model_hw[1] // s

    def mlp_inner(self, dim: int) -> int:
        return max(32, math.floor(dim * self.mlp_ratio * 2 / 3 / 32) * 32)

    @property
    def fpn_channels(self) -> Tuple[int, int, int]:
        return tuple(self.dims[s - 1] for s in self.in_stages)

    @property
    def head_hidden(self) -> int:
        return int(256 * self.fpn_channels[-1] / 1024)


def _base_conv(out: dict, name: str, cin: int, cout: int, k: int) -> None:
    out[f"{name}.Conv_0.kernel"] = (cout, cin, k, k)
    for p in ("scale", "bias", "mean", "var"):
        out[f"{name}.BatchNorm_0.{p}"] = (cout,)


def _csp(out: dict, name: str, cin: int, cout: int, n: int) -> None:
    hidden = int(cout * 0.5)
    _base_conv(out, f"{name}.BaseConv_0", cin, hidden, 1)
    _base_conv(out, f"{name}.BaseConv_1", cin, hidden, 1)
    for i in range(n):
        _base_conv(out, f"{name}.Bottleneck_{i}.BaseConv_0", hidden, hidden, 1)
        _base_conv(out, f"{name}.Bottleneck_{i}.BaseConv_1", hidden, hidden, 3)
    _base_conv(out, f"{name}.BaseConv_2", 2 * hidden, cout, 1)


def param_shapes(sz: Sizes) -> Dict[str, tuple]:
    """Every parameter and statistic of the detector by name, with its shape
    (conv kernels OIHW, dense kernels (out, in))."""
    out: Dict[str, tuple] = {}
    for i, dim in enumerate(sz.dims):
        st = f"backbone.stage{i}"
        cin = sz.in_ch if i == 0 else sz.dims[i - 1]
        k = 7 if i == 0 else 3
        out[f"{st}.downsample.Conv_0.kernel"] = (dim, cin, k, k)
        out[f"{st}.downsample.LayerNorm_0.scale"] = (dim,)
        out[f"{st}.downsample.LayerNorm_0.bias"] = (dim,)
        out[f"{st}.block0.to_controls.weight"] = (dim, sz.in_ch)
        out[f"{st}.block0.to_scores.kernel"] = (dim, dim)
        out[f"{st}.block0.to_scores.bias"] = (dim,)
        inner = sz.mlp_inner(dim)
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
            out[f"{at}.mlp.GLU_0.Dense_0.kernel"] = (2 * inner, dim)
            out[f"{at}.mlp.GLU_0.Dense_0.bias"] = (2 * inner,)
            out[f"{at}.mlp.Dense_0.kernel"] = (dim, inner)
            out[f"{at}.mlp.Dense_0.bias"] = (dim,)
        out[f"{st}.lstm.Conv_0.kernel"] = (4 * dim, 2 * dim, 1, 1)
        out[f"{st}.lstm.Conv_0.bias"] = (4 * dim,)
    c0, c1, c2 = sz.fpn_channels
    n = round(3 * sz.fpn_depth)
    _base_conv(out, "fpn.lateral_conv0", c2, c1, 1)
    _csp(out, "fpn.C3_p4", 2 * c1, c1, n)
    _base_conv(out, "fpn.reduce_conv1", c1, c0, 1)
    _csp(out, "fpn.C3_p3", 2 * c0, c0, n)
    _base_conv(out, "fpn.bu_conv2", c0, c0, 3)
    _csp(out, "fpn.C3_n3", 2 * c0, c1, n)
    _base_conv(out, "fpn.bu_conv1", c1, c1, 3)
    _csp(out, "fpn.C3_n4", 2 * c1, c2, n)
    hid = sz.head_hidden
    for k, cin in enumerate(sz.fpn_channels):
        _base_conv(out, f"head.stem{k}", cin, hid, 1)
        for t in ("cls", "reg"):
            for j in range(2):
                _base_conv(out, f"head.{t}_conv{k}_{j}", hid, hid, 3)
        for p, c in (("cls_pred", sz.num_classes), ("reg_pred", 4), ("obj_pred", 1)):
            out[f"head.{p}{k}.kernel"] = (c, hid, 1, 1)
            out[f"head.{p}{k}.bias"] = (c,)
    return out


# ---------------------------------------------------------------------------
# Input


def stacked_histogram(packed: torch.Tensor, n_events: torch.Tensor, bins: int, height: int,
                      width: int, cutoff: int) -> torch.Tensor:
    """(S, E, 4) int32 events ``[x, y, p, t]`` and (S,) counts -> (S, H, W,
    2 * bins) uint8: time bin ``floor((t - t_first) / max(t_last - t_first,
    1) * bins)`` in float32, clipped to the last bin; counts clipped at
    ``cutoff``; rows past the count and events off the frame dropped."""
    S, E, _ = packed.shape
    dev = packed.device
    x, y, pol, t = packed.long().unbind(-1)
    valid = torch.arange(E, device=dev)[None, :] < n_events[:, None].long()
    t0 = t[:, :1]
    last = (n_events.long() - 1).clamp_min(0)[:, None]
    denom = (torch.gather(t, 1, last) - t0).clamp_min(1).to(torch.float32)
    t_idx = torch.floor((t - t0).to(torch.float32) / denom * bins).clamp(0, bins - 1).long()
    size = 2 * bins * height * width
    flat = x + width * y + height * width * t_idx + bins * height * width * pol
    inside = valid & (x >= 0) & (x < width) & (y >= 0) & (y < height) & (pol >= 0) & (pol < 2)
    flat = torch.where(inside, flat, size) + (size + 1) * torch.arange(S, device=dev)[:, None]
    counts = torch.bincount(flat.reshape(-1), minlength=S * (size + 1))
    rep = counts.reshape(S, size + 1)[:, :size].clamp(0, cutoff).to(torch.uint8)
    return rep.reshape(S, 2 * bins, height, width).permute(0, 2, 3, 1).contiguous()


def pad_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad NHWC ``x`` at the bottom and the right to ``hw``."""
    return F.pad(x, (0, 0, 0, hw[1] - x.shape[2], 0, hw[0] - x.shape[1]))


def density_ratio(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4, C): the share of non-zero cells per channel
    after max-pooling by 4, 8, 16 and 32."""
    out, pooled = [], x
    for k in (4, 2, 2, 2):
        B, H, W, C = pooled.shape
        pooled = pooled[:, : H // k * k, : W // k * k]
        pooled = pooled.reshape(B, H // k, k, W // k, k, C).amax(dim=(2, 4))
        n = float(pooled.shape[1] * pooled.shape[2] * C)
        out.append((pooled != 0).to(torch.float32).sum(dim=(1, 2)) / n)
    return torch.stack(out, dim=1)


def position_embedding(h: int, w: int, dim: int) -> np.ndarray:
    """(h, w, dim) sine embedding, channels [y | x], normalised positions
    times 2 pi, temperature 10000, sin on even and cos on odd features."""
    feats = dim // 2
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x = np.ones((h, 1)) * np.arange(1, w + 1, dtype=np.float64)[None, :]
    y = (y - 0.5) / (y[-1:, :] + 1e-6) * 2 * np.pi
    x = (x - 0.5) / (x[:, -1:] + 1e-6) * 2 * np.pi
    d = 10000.0 ** (2 * (np.arange(feats) // 2) / feats)

    def enc(v):
        v = v[:, :, None] / d
        return np.stack((np.sin(v[:, :, 0::2]), np.cos(v[:, :, 1::2])), axis=3).reshape(h, w, -1)

    return np.concatenate((enc(y), enc(x)), axis=2).astype(np.float32)


# ---------------------------------------------------------------------------
# Primitives


def dense(P, name: str, x: torch.Tensor, q: Q) -> torch.Tensor:
    y = q(x) @ q(P[f"{name}.kernel"]).t()
    b = P.get(f"{name}.bias")
    return y if b is None else y + b


def conv(x: torch.Tensor, w: torch.Tensor, q: Q, stride: int = 1, pad: int = 0,
         mode: str = "zeros", bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC convolution with an OIHW kernel."""
    xc = q(x).permute(0, 3, 1, 2)
    if pad and mode == "replicate":
        xc = F.pad(xc, (pad,) * 4, mode="replicate")
        pad = 0
    return F.conv2d(xc, q(w), bias, stride, pad).permute(0, 2, 3, 1)


def layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * scale) + bias


def batch_norm(P, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Running statistics, or (``train``) the batch's biased ones over every
    axis but the channels."""
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = ((x * x).mean(dim=axes) - mean * mean).clamp_min(0.0)
    else:
        mean, var = P[f"{name}.mean"], P[f"{name}.var"]
    return (x - mean) * (torch.rsqrt(var + 1e-5) * P[f"{name}.scale"]) + P[f"{name}.bias"]


def base_conv(P, name: str, x: torch.Tensor, q: Q, stride: int = 1, train: bool = False):
    w = P[f"{name}.Conv_0.kernel"]
    y = conv(x, w, q, stride, (w.shape[-1] - 1) // 2)
    return F.silu(batch_norm(P, f"{name}.BatchNorm_0", y, train))


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Partitions and selection


def window_partition(x, p):
    B, H, W, C = x.shape
    x = x.reshape(B, H // p[0], p[0], W // p[1], p[1], C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, -1, p[0] * p[1], C)


def window_reverse(w, p, hw):
    H, W = hw
    B, C = w.shape[0], w.shape[-1]
    x = w.reshape(B, H // p[0], W // p[1], p[0], p[1], C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def grid_partition(x, g):
    B, H, W, C = x.shape
    x = x.reshape(B, g[0], H // g[0], g[1], W // g[1], C).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, -1, g[0] * g[1], C)


def grid_reverse(w, g, hw):
    H, W = hw
    B, C = w.shape[0], w.shape[-1]
    x = w.reshape(B, H // g[0], W // g[1], g[0], g[1], C).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, H, W, C)


def select(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, hw, C) amplified scores -> window keep (B, N), token keep (B,
    N, hw): a window whose softmax-normalised mean L1 score reaches (1/N) /
    (1 + BOUNCE), and in it a token whose softmax-normalised L1 score
    reaches (1/hw) / (1 + BOUNCE)."""
    B, N, hw, C = scores.shape
    a = scores.abs()
    win = torch.softmax(a.sum(dim=(2, 3)) / torch.full((), float(hw), device=a.device), dim=-1)
    win_keep = win >= (1.0 / N) / (1.0 + BOUNCE)
    tok = torch.softmax(a.sum(dim=3), dim=-1)
    return win_keep, (tok >= (1.0 / hw) / (1.0 + BOUNCE)) & win_keep[..., None]


def attention_layer(P, name: str, x: torch.Tensor, keep: torch.Tensor, heads: int, q: Q):
    """One masked window attention layer on (B, N, hw, C): selected tokens
    get pre-norm attention over the selected tokens of their window and a
    gated MLP, each with a LayerScale residual; every other token leaves as
    ``norm1(x)``."""
    B, N, hw, C = x.shape
    dh = C // heads
    y = layer_norm(x, P[f"{name}.norm1.scale"], P[f"{name}.norm1.bias"])
    k4 = keep[..., None]
    z = torch.where(k4, layer_norm(y, P[f"{name}.norm2.scale"], P[f"{name}.norm2.bias"]), y)
    qkv = dense(P, f"{name}.qkv", z, q).reshape(B, N, hw, 3 * heads, dh)
    qh, kh, vh = (qkv[:, :, :, i * heads:(i + 1) * heads].permute(0, 1, 3, 2, 4)
                  for i in range(3))
    logits = (q(qh) @ q(kh).transpose(-1, -2)) * dh ** -0.5
    logits = torch.where(keep[:, :, None, None, :], logits, MASK_VALUE)
    attn = torch.softmax(logits, dim=-1)
    out = (q(attn) @ q(vh)).permute(0, 1, 3, 2, 4).reshape(B, N, hw, C)
    h = z + P[f"{name}.ls1.gamma"] * dense(P, f"{name}.proj", out, q)
    val, gate = dense(P, f"{name}.mlp.GLU_0.Dense_0", h, q).chunk(2, dim=-1)
    h2 = h + P[f"{name}.ls2.gamma"] * dense(P, f"{name}.mlp.Dense_0", val * gelu(gate), q)
    return torch.where(k4, h2, y)


# ---------------------------------------------------------------------------
# Backbone, neck, head


State = List[Tuple[torch.Tensor, torch.Tensor]]


def zero_state(sz: Sizes, lanes: int, device) -> State:
    return [tuple(torch.zeros((lanes, *sz.stage_hw(i), d), device=device) for _ in range(2))
            for i, d in enumerate(sz.dims)]


def backbone(P, sz: Sizes, x: torch.Tensor, state: State, q: Q, pos_cache: dict):
    """x: (B, H, W, C) uint8 at the model's resolution -> (features by stage
    number 1-4, new state, selected tokens per stage summed over the batch)."""
    r = density_ratio(x)
    h = x.to(torch.float32)
    feats, new_state, tokens = {}, [], []
    for i, dim in enumerate(sz.dims):
        st = f"backbone.stage{i}"
        w = P[f"{st}.downsample.Conv_0.kernel"]
        h = conv(h, w, q, 4 if i == 0 else 2, w.shape[-1] // 2, mode="replicate")
        h = layer_norm(h, P[f"{st}.downsample.LayerNorm_0.scale"],
                       P[f"{st}.downsample.LayerNorm_0.bias"])
        H, W = h.shape[1:3]
        key = (H, W, dim, str(h.device))
        if key not in pos_cache:
            pos_cache[key] = torch.from_numpy(position_embedding(H, W, dim)).to(h.device)
        h = h + pos_cache[key]
        p = sz.partition
        xw = window_partition(h, p)
        bl = f"{st}.block0"
        scale = (r[:, i] + 1e-6) @ torch.exp(P[f"{bl}.to_controls.weight"]).t()  # (B, C)
        scores = torch.relu(dense(P, f"{bl}.to_scores", xw, q))
        xw = torch.sigmoid(scale)[:, None, None, :] * torch.sigmoid(scores) * xw
        inv = torch.full_like(scale, AMP) / scale
        inv = torch.where(torch.isinf(inv), torch.zeros_like(inv), inv)
        amp = inv[:, None, None, :] * scores
        win_keep_w, tok_w = select(amp)
        _, tok_g = select(grid_partition(window_reverse(amp, p, (H, W)), p))
        heads = dim // sz.dim_head
        h = window_reverse(attention_layer(P, f"{bl}.win_attn", xw, tok_w, heads, q), p, (H, W))
        h = grid_reverse(attention_layer(P, f"{bl}.grid_attn", grid_partition(h, p), tok_g,
                                         heads, q), p, (H, W))
        tokens.append(tok_w.sum() + tok_g.sum())
        h_prev, c_prev = state[i]
        mix = conv(torch.cat((h, h_prev), dim=-1), P[f"{st}.lstm.Conv_0.kernel"], q,
                   bias=P[f"{st}.lstm.Conv_0.bias"])
        f_g, i_g, o_g = torch.sigmoid(mix[..., :3 * dim]).chunk(3, dim=-1)
        c = f_g * c_prev + i_g * torch.tanh(mix[..., 3 * dim:])
        h = o_g * torch.tanh(c)
        new_state.append((h, c))
        feats[i + 1] = h
    return feats, new_state, torch.stack(tokens)


def csp(P, name: str, x, n: int, q: Q, train: bool):
    x1 = base_conv(P, f"{name}.BaseConv_0", x, q, train=train)
    x2 = base_conv(P, f"{name}.BaseConv_1", x, q, train=train)
    for i in range(n):
        b = f"{name}.Bottleneck_{i}"
        x1 = base_conv(P, f"{b}.BaseConv_1", base_conv(P, f"{b}.BaseConv_0", x1, q, train=train),
                       q, train=train)
    return base_conv(P, f"{name}.BaseConv_2", torch.cat((x1, x2), dim=-1), q, train=train)


def up2(x):
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


def neck(P, sz: Sizes, feats, q: Q, train: bool = False):
    x2, x1, x0 = (feats[s] for s in sz.in_stages)
    n = round(3 * sz.fpn_depth)
    bc = lambda name, x, s=1: base_conv(P, f"fpn.{name}", x, q, s, train)  # noqa: E731
    fpn0 = bc("lateral_conv0", x0)
    f0 = csp(P, "fpn.C3_p4", torch.cat([up2(fpn0), x1], dim=-1), n, q, train)
    fpn1 = bc("reduce_conv1", f0)
    pan2 = csp(P, "fpn.C3_p3", torch.cat([up2(fpn1), x2], dim=-1), n, q, train)
    pan1 = csp(P, "fpn.C3_n3", torch.cat([bc("bu_conv2", pan2, 2), fpn1], dim=-1), n, q, train)
    pan0 = csp(P, "fpn.C3_n4", torch.cat([bc("bu_conv1", pan1, 2), fpn0], dim=-1), n, q, train)
    return pan2, pan1, pan0


def grids(sz: Sizes, device):
    g, s = [], []
    for i in range(1, 4):
        h, w = sz.stage_hw(i)
        yv, xv = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        g.append(torch.stack((xv, yv), dim=-1).reshape(-1, 2))
        s.append(torch.full((h * w,), float(sz.strides[i])))
    return torch.cat(g).float().to(device), torch.cat(s).to(device)


def head(P, sz: Sizes, levels, q: Q, train: bool = False):
    """-> (B, A, 5 + classes): decoded cxcywh boxes, then obj and class logits."""
    outs = []
    for k, x in enumerate(levels):
        x = base_conv(P, f"head.stem{k}", x, q, train=train)
        c, r = x, x
        for j in range(2):
            c = base_conv(P, f"head.cls_conv{k}_{j}", c, q, train=train)
            r = base_conv(P, f"head.reg_conv{k}_{j}", r, q, train=train)

        def pred(name, t):
            return conv(t, P[f"head.{name}{k}.kernel"], q, bias=P[f"head.{name}{k}.bias"])

        o = torch.cat([pred("reg_pred", r), pred("obj_pred", r), pred("cls_pred", c)], dim=-1)
        outs.append(o.reshape(o.shape[0], -1, o.shape[-1]))
    raw = torch.cat(outs, dim=1)
    g, s = grids(sz, raw.device)
    xy = (raw[..., :2] + g) * s[:, None]
    wh = torch.exp(raw[..., 2:4]) * s[:, None]
    return torch.cat([xy, wh, raw[..., 4:]], dim=-1), g, s


# ---------------------------------------------------------------------------
# NMS


def greedy_keep(boxes: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    """(N, K, 4) xyxy boxes in score order -> (N, K) keep: a candidate with a
    positive score is kept unless an earlier kept one overlaps it by IoU
    above ``thr``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp_min(0.0)
    inter = iw * ih
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-12)
    K = boxes.shape[1]
    ar = torch.arange(K, device=boxes.device)
    sup = (iou > thr) & (ar[:, None] > ar[None, :])
    keep = torch.zeros(scores.shape, dtype=torch.bool, device=boxes.device)
    valid = scores > 0
    for i in range(K):
        keep[:, i] = valid[:, i] & ~(keep & sup[:, i]).any(dim=-1)
    return keep


def slate(sz: Sizes, preds: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Decoded predictions -> fixed slate per frame: score = sigmoid(obj) *
    best sigmoid(class); scores below the threshold are 0; the
    ``pre_nms_topk`` best in a stable descending order; class-aware NMS by
    moving each class's boxes apart; the first ``max_detections`` kept."""
    xy, wh = preds[..., :2], preds[..., 2:4]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
    probs = torch.sigmoid(preds[..., 4:])
    cls_conf, cls_id = probs[..., 1:].max(dim=-1)
    score = probs[..., 0] * cls_conf
    score = torch.where(score >= sz.conf_threshold, score, torch.zeros_like(score))
    k = min(sz.pre_nms_topk, score.shape[1])
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    tb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    tc = torch.gather(cls_id, 1, idx)
    span = tb.amax(dim=(1, 2)) + 1.0
    keep = greedy_keep(tb + (tc.to(tb.dtype) * span[:, None])[..., None], top, sz.nms_threshold)
    N = keep.shape[0]
    rank = torch.cumsum(keep.long(), dim=1) - 1
    m = sz.max_detections
    slot = torch.where(keep & (rank < m), rank, torch.full_like(rank, m))
    out = torch.full((N, m + 1), k, dtype=torch.long, device=keep.device)
    out.scatter_(1, slot, torch.arange(k, device=keep.device).expand(N, k))
    out = out[:, :m]
    valid = out < k
    safe = torch.where(valid, out, torch.zeros_like(out))
    vf = valid.to(torch.float32)
    return {"boxes": torch.gather(tb, 1, safe[..., None].expand(-1, -1, 4)) * vf[..., None],
            "scores": torch.gather(top, 1, safe) * vf,
            "classes": torch.where(valid, torch.gather(tc, 1, safe), torch.full_like(safe, -1)),
            "valid": valid}


# ---------------------------------------------------------------------------
# One serving frame


def serve_frame(P, sz: Sizes, packed: torch.Tensor, n_events: torch.Tensor, state: State,
                q: Q = identity, pos_cache: Optional[dict] = None):
    """One frame per lane from raw events and the carried state -> (slate,
    new state, decoded predictions with logits)."""
    rep = stacked_histogram(packed, n_events, sz.bins, *sz.sensor_hw, sz.count_cutoff)
    x = pad_to(rep, sz.model_hw)
    feats, new_state, _ = backbone(P, sz, x, state, q, {} if pos_cache is None else pos_cache)
    preds, _, _ = head(P, sz, neck(P, sz, feats, q), q)
    return slate(sz, preds), new_state, preds
