"""Shared layers of the port (NHWC tensors, flax-named parameters).

Port of sast_tpu/models/layers.py. Every module names its submodules and
parameters as the JAX package's flax modules do (``Conv_0/kernel``,
``BatchNorm_0/mean``, ...), so ``weights.load_jax_variables`` maps a flax
tree onto the port by name; only the layouts differ (conv kernels are OIHW,
dense kernels ``(out, in)``). Parameters stay fp32; each module casts them
to its compute ``dtype`` at use, as flax's ``dtype=`` does.

- ``Conv`` / ``Dense`` / ``LayerNorm`` / ``BatchNorm``: the flax primitives
  (LayerNorm and BatchNorm compute in fp32 and cast at the end; BatchNorm
  has flax's training mode: batch statistics, momentum-0.9 running ones).
- ``ConvDownsample``: overlapping strided conv + LayerNorm; the 7x7/stride-4
  stem goes through the stem kernel (ops/stem_conv.py).
- ``DWSConvLSTM2d``: ConvLSTM cell, gates and cell state in fp32.
- ``BaseConv`` / ``DWConv`` / ``Bottleneck`` / ``CSPLayer``: YOLOX blocks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sast_tpu_torch.ops.stem_conv import stem_conv7x4, stem_conv7x4_plain, stem_supported


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "silu": F.silu,
    "relu": F.relu,
    "gelu": gelu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
}


def get_activation(name: str):
    return _ACTIVATIONS[name]


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC tensors; ``kernel`` is OIHW."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups, self.dtype = stride, padding, groups, dtype
        self.kernel = nn.Parameter(torch.empty(cout, cin // groups, ksize, ksize))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.kernel.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        x = x.to(dt)
        if w.shape[-1] == 1 and self.stride == 1 and self.groups == 1:
            return F.linear(x, w.flatten(1), b)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``; ``kernel`` is ``(out, in)``."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype).t()
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: fp32 statistics (E[x^2] - E[x]^2, clamped at
    0) and fp32 normalisation, cast to ``dtype`` at the end."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim)) if affine else None
        self.bias = nn.Parameter(torch.zeros(dim)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x32 - mu) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (eps 1e-5, momentum 0.9), computed in fp32 and
    cast to ``dtype``.

    With ``use_batch_stats`` off (the default, flax's
    ``use_running_average=True``) it normalises with the running ``mean`` and
    ``var``. With it on (training; ``YoloXDetector.forward_detect(train=True)``
    sets it for the call) it normalises with the statistics of the batch,
    taken in fp32 over every axis but the last as flax takes them
    (``E[x^2] - E[x]^2`` clamped at 0, the *biased* variance), and moves the
    running statistics towards them in place: ``ra = 0.9 * ra + 0.1 * batch``.
    flax stores the biased batch variance there, ``torch.nn.BatchNorm2d`` the
    unbiased one."""

    momentum = 0.9

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.use_batch_stats = False
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if self.use_batch_stats:
            axes = tuple(range(x32.dim() - 1))
            mean = x32.mean(dim=axes)
            var = ((x32 * x32).mean(dim=axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


def replicate_pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate ('edge') padding of an NHWC tensor on H and W."""
    return F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="replicate").permute(0, 2, 3, 1)


class ConvDownsample(nn.Module):
    """Overlapping strided conv + LayerNorm. NHWC in, NHWC out.

    kernel = (factor-1)*2 + 1, stride = factor, replicate padding, no bias,
    then LayerNorm over channels. The 7x7/stride-4 stem of a uint8 input
    goes through the stem kernel (ops/stem_conv.py) when ``use_stem_kernel``
    is set and its static gate holds; otherwise, and for float inputs, the
    plain formulation runs. ``forward(x, with_density=True)`` also returns
    the (B, 4, C_in) density ratio from the kernel's own input read; the
    caller (SASTBackbone) checks the gate first.
    """

    def __init__(self, cin: int, cout: int, factor: int, overlap: bool = True,
                 norm_affine: bool = True, norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, use_stem_kernel: bool = False):
        super().__init__()
        self.factor, self.overlap, self.dtype = factor, overlap, dtype
        self.use_stem_kernel = use_stem_kernel
        k = (factor - 1) * 2 + 1 if overlap else factor
        self.Conv_0 = Conv(cin, cout, k, stride=factor, bias=False, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(cout, norm_eps, norm_affine, dtype)

    @property
    def is_stem(self) -> bool:
        return self.overlap and self.factor == 4

    def stem_kernel_applies(self, x: torch.Tensor) -> bool:
        return (
            self.is_stem
            and self.use_stem_kernel
            and stem_supported(x.shape, x.dtype, self.Conv_0.kernel.shape[0])
        )

    def forward(self, x: torch.Tensor, with_density: bool = False):
        ratio = None
        if self.is_stem:
            w = self.Conv_0.kernel.to(self.dtype)
            if with_density:
                if not self.stem_kernel_applies(x):
                    raise ValueError("with_density needs the stem kernel's gate")
                x, ratio = stem_conv7x4(x, w, with_density=True)
            elif self.stem_kernel_applies(x):
                x = stem_conv7x4(x, w)
            else:
                x = stem_conv7x4_plain(x, w)
        else:
            if self.overlap:
                x = replicate_pad_hw(x, self.Conv_0.kernel.shape[-1] // 2)
            x = self.Conv_0(x)
        x = self.LayerNorm_0(x)
        return (x, ratio) if with_density else x


class DWSConvLSTM2d(nn.Module):
    """Convolutional LSTM cell with optional depthwise conv on the hidden
    state. NHWC. Gates and the cell state are fp32; ``h`` is cast back to
    the input dtype. A non-zero ``cell_update_dropout`` raises under
    training (``deterministic=False``) rather than being ignored."""

    def __init__(self, dim: int, dws_conv: bool = False, dws_conv_only_hidden: bool = True,
                 dws_conv_kernel_size: int = 3, dtype: torch.dtype = torch.float32,
                 cell_update_dropout: float = 0.0):
        super().__init__()
        self.dim = dim
        self.cell_update_dropout = cell_update_dropout
        self.dws_conv, self.only_hidden = dws_conv, dws_conv_only_hidden
        k = dws_conv_kernel_size
        mix = 0
        if dws_conv:
            ch = dim if dws_conv_only_hidden else 2 * dim
            self.Conv_0 = Conv(ch, ch, k, padding=k // 2, groups=ch, dtype=dtype)
            mix = 1
        self.mix_name = f"Conv_{mix}"
        self.add_module(self.mix_name, Conv(2 * dim, 4 * dim, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, h_and_c: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                deterministic: bool = True):
        if not deterministic and self.cell_update_dropout > 0.0:
            raise NotImplementedError(
                f"lstm.drop_cell_update = {self.cell_update_dropout}: the cell-update dropout "
                "is not ported yet; train with a rate of 0"
            )
        if h_and_c is None:
            h_tm1 = torch.zeros_like(x)
            c_tm1 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        else:
            h_tm1, c_tm1 = h_and_c
        h_tm1 = h_tm1.to(x.dtype)
        if self.dws_conv and self.only_hidden:
            h_tm1 = self.Conv_0(h_tm1)
        xh = torch.cat((x, h_tm1), dim=-1)
        if self.dws_conv and not self.only_hidden:
            xh = self.Conv_0(xh)
        mix = getattr(self, self.mix_name)(xh)
        gates = torch.sigmoid(mix[..., : 3 * self.dim].to(torch.float32))
        forget_gate, input_gate, output_gate = gates.chunk(3, dim=-1)
        cell_input = torch.tanh(mix[..., 3 * self.dim :].to(torch.float32))
        c_t = forget_gate * c_tm1.to(torch.float32) + input_gate * cell_input
        h_t = output_gate * torch.tanh(c_t)
        return h_t.to(x.dtype), c_t


# ---------------------------------------------------------------------------
# YOLOX blocks


class BaseConv(nn.Module):
    """Conv -> BatchNorm -> activation ('same' padding)."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1, groups: int = 1,
                 act: str = "silu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, ksize, stride, (ksize - 1) // 2, groups,
                           bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(cout, dtype=dtype)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.BatchNorm_0(self.Conv_0(x)))


class DWConv(nn.Module):
    """Depthwise conv followed by pointwise conv, each with BN + act."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 act: str = "silu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.BaseConv_0 = BaseConv(cin, cin, ksize, stride, groups=cin, act=act, dtype=dtype)
        self.BaseConv_1 = BaseConv(cin, cout, 1, 1, act=act, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BaseConv_1(self.BaseConv_0(x))


def conv_block(depthwise: bool):
    """(flax auto-name prefix, class) of a YOLOX 3x3 conv block."""
    return ("DWConv", DWConv) if depthwise else ("BaseConv", BaseConv)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(cout * expansion)
        self.BaseConv_0 = BaseConv(cin, hidden, 1, 1, act=act, dtype=dtype)
        prefix, cls = conv_block(depthwise)
        # flax numbers auto-named submodules per class: BaseConv_1 or DWConv_0.
        self.conv_name = f"{prefix}_{1 if prefix == 'BaseConv' else 0}"
        self.add_module(self.conv_name, cls(hidden, cout, 3, 1, act=act, dtype=dtype))
        self.use_add = shortcut and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, self.conv_name)(self.BaseConv_0(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """C3: CSP bottleneck with 3 convolutions."""

    def __init__(self, cin: int, cout: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(cout * expansion)
        self.BaseConv_0 = BaseConv(cin, hidden, 1, 1, act=act, dtype=dtype)
        self.BaseConv_1 = BaseConv(cin, hidden, 1, 1, act=act, dtype=dtype)
        self.n = n
        for i in range(n):
            self.add_module(
                f"Bottleneck_{i}",
                Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act, dtype),
            )
        self.BaseConv_2 = BaseConv(2 * hidden, cout, 1, 1, act=act, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.BaseConv_0(x)
        x2 = self.BaseConv_1(x)
        for i in range(self.n):
            x1 = getattr(self, f"Bottleneck_{i}")(x1)
        return self.BaseConv_2(torch.cat((x1, x2), dim=-1))


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (+-2 std) with variance
    1 / fan_in, drawn from ``generator``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        t.copy_(nn.init.trunc_normal_(
            torch.empty(t.shape), 0.0, std, -2 * std, 2 * std, generator=generator
        ))
