"""Shared layers of the port (NHWC tensors, flax-named parameters).

Port of sast_tpu/models/layers.py. Every module names its submodules and
parameters as the JAX package's flax modules do (``Conv_0/kernel``,
``BatchNorm_0/mean``, ...), so ``weights.load_jax_variables`` maps a flax
tree onto the port by name; only the layouts differ (conv kernels are OIHW,
dense kernels ``(out, in)``). Parameters stay fp32; each module uses them
in its compute ``dtype``, as flax's ``dtype=`` does: under grad mode (and
under a trace) cast at each use, so that gradients reach the fp32
parameters; otherwise through ``compute_copy``, one copy per parameter kept
in the compute dtype (JAX's jitted step folds the casts of its constant
weights once).

- ``Conv`` / ``Dense`` / ``LayerNorm`` / ``BatchNorm``: the flax primitives
  (LayerNorm and BatchNorm compute in fp32 and cast at the end; BatchNorm
  has flax's training mode: batch statistics, momentum-0.9 running ones).
- ``ConvDownsample``: overlapping strided conv + LayerNorm; the 7x7/stride-4
  stem goes through the stem kernel (ops/stem_conv.py).
- ``DWSConvLSTM2d``: ConvLSTM cell, gates and cell state in fp32.
- ``Dropout`` / ``DropPath`` with ``DropoutKey``: the stochastic
  regularizers, their masks a counter-based hash, computed with tensor
  operations on the device, of (seed, optimizer step, timestep, layer,
  element of the global batch), this rank's rows kept. They cannot draw
  JAX's threefry bits: the port's masks follow the same distribution, not
  the same values.
- ``BaseConv`` / ``DWConv`` / ``Bottleneck`` / ``CSPLayer``: YOLOX blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sast_tpu_torch.ops.stem_conv import stem_conv7x4, stem_conv7x4_plain, stem_supported
from sast_tpu_torch.parallel.mesh import Mesh


def compute_copy(module: nn.Module, name: str, dtype: torch.dtype, fn=None):
    """Parameter ``name`` of ``module`` (``fn`` of it, where given) in
    ``dtype``, or None where the module has no such parameter.

    Under grad mode or a trace, cast at this call (differentiable). Otherwise
    ``cached_copy``: the parameter itself where it already has ``dtype`` and
    there is no ``fn``, else one copy kept on the module."""
    p = getattr(module, name)
    if p is None:
        return None
    if torch.is_grad_enabled() or torch.compiler.is_compiling():
        return (p if fn is None else fn(p)).to(dtype)
    return cached_copy(module, name, dtype, fn)


def cached_copy(module: nn.Module, name: str, dtype: torch.dtype, fn=None) -> torch.Tensor:
    """``compute_copy`` without grad: detached, kept on the module and
    stamped with the parameter's dtype, device, ``data_ptr`` and
    ``_version``. When the stamp changes (the parameter was written, moved
    or cast) the copy is rebuilt in place, in the same storage where the
    shape and device allow, so that a captured CUDA graph that reads it
    stays valid after new weights are loaded (``graphs.py``)."""
    p = getattr(module, name)
    if fn is None and p.dtype == dtype:
        return p.detach()
    copies = module.__dict__.setdefault("_compute_copies", {})
    stamp = (dtype, p.device, p.data_ptr(), p._version)
    entry = copies.get(name)
    if entry is not None and entry[0] == stamp:
        return entry[1]
    # The copy is an ordinary tensor even when first asked for under
    # ``torch.inference_mode``, so that it can be rewritten outside it.
    with torch.inference_mode(False), torch.no_grad():
        value = (p if fn is None else fn(p)).to(dtype)
        held = None if entry is None else entry[1]
        if held is not None and (held.shape, held.dtype, held.device) == (
                value.shape, value.dtype, value.device):
            held.copy_(value)
        else:
            held = value
    copies[name] = (stamp, held, fn)
    return held


def refresh_compute_copies(model: nn.Module) -> None:
    """Bring every copy that ``cached_copy`` keeps in ``model`` up to date
    with its parameter, in place where it can."""
    for m in model.modules():
        for name, (_, held, fn) in list(m.__dict__.get("_compute_copies", {}).items()):
            cached_copy(m, name, held.dtype, fn)


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
        w = compute_copy(self, "kernel", dt)
        b = compute_copy(self, "bias", dt)
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
        y = x.to(self.dtype) @ compute_copy(self, "kernel", self.dtype).t()
        return y if self.bias is None else y + compute_copy(self, "bias", self.dtype)


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
    unbiased one.

    With ``mesh`` set to a world of more than one process (training under
    data parallelism) the batch is the global one: the per-channel sum, sum
    of squares and count are all-reduced, differentiably, before the
    moments are taken, so the running statistics move alike on every rank
    and the backward carries the cross-rank terms (the reference's
    sync-BN, GSPMD's global reduction in the JAX package)."""

    momentum = 0.9

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.use_batch_stats = False
        self.mesh: Optional[Mesh] = None
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if self.use_batch_stats:
            axes = tuple(range(x32.dim() - 1))
            if self.mesh is None or self.mesh.size == 1:
                mean = x32.mean(dim=axes)
                var = ((x32 * x32).mean(dim=axes) - mean * mean).clamp_min(0.0)
            else:
                # Differentiable: the backward sums the incoming gradients
                # over the ranks, so each rank's input gradient carries every
                # rank's use of the global statistics.
                from torch.distributed.nn.functional import all_reduce

                C = x32.shape[-1]
                count = x32.new_full((1,), x32.numel() // C)
                sums = all_reduce(torch.cat((x32.sum(dim=axes), (x32 * x32).sum(dim=axes), count)))
                mean = sums[:C] / sums[2 * C]
                var = (sums[C:2 * C] / sums[2 * C] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


_U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32) and a constant ``c``
    below 2**32, in two 16-bit halves of ``c`` so that no product leaves
    int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32s: a
    bijection whose every output bit depends on every input bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """Where one timestep's dropout masks come from in a training step: the
    run's seed, the optimizer step and the timestep (JAX folds the step into
    ``PRNGKey(seed)`` and splits one key per timestep), and this process's
    place in the data-parallel world.

    Each element's keep draw is a hash of (seed, step, t, layer, its index
    in the global batch), computed with tensor operations on the mask's
    device: a world of two draws what a world of one draws on the same
    global batch, a recomputation (``checkpoint``) draws the same masks
    again, and a resumed run (the same step) the same stream. ``counter``,
    where given, is the step as a 0-d tensor on the card (the optimizer's
    count, ``OptaxAdamW.adamw.count``), read there at each draw, so that a
    captured train step draws each replay's masks from that replay's step;
    ``step`` (the host's count, equal to it) then only names the key."""

    seed: int
    step: int
    t: int
    rank: int = 0
    world: int = 1
    counter: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)

    def keep_mask(self, layer: int, shape, keep: float, device) -> torch.Tensor:
        """Bool mask of ``shape`` (this rank's rows), True with probability
        ``keep``."""
        def const(v):
            return torch.full((), v & _U32, dtype=torch.int64, device=device)

        step = (self.counter.to(device=device, dtype=torch.int64) & _U32
                if self.counter is not None else const(self.step))
        key = _fmix32(const(self.seed) ^ 0x9E3779B9)
        key = _fmix32(key ^ step)
        key = _fmix32(key ^ const(self.t))
        key = _fmix32(key ^ const(layer))
        second = _fmix32(key ^ 0x7F4A7C15)
        rows, per_row = shape[0], math.prod(shape[1:])
        first = self.rank * rows * per_row
        index = torch.arange(first, first + rows * per_row, dtype=torch.int64, device=device)
        u = _fmix32(_fmix32((index & _U32) ^ key) ^ second)
        return (u < int(keep * 2 ** 32)).reshape(shape)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: with a ``DropoutKey`` and a non-zero rate, keep
    each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)``; without a key (deterministic) the identity.
    ``layer_id`` (set by the backbone) tells its masks from the other
    layers'."""

    per_sample = False

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.layer_id = 0

    def forward(self, x: torch.Tensor, key: Optional[DropoutKey]) -> torch.Tensor:
        if self.rate == 0.0 or key is None:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1) if self.per_sample else x.shape
        mask = key.keep_mask(self.layer_id, shape, keep, x.device)
        return torch.where(mask, x / keep, 0.0)


class DropPath(Dropout):
    """Stochastic depth: one keep draw per sample of the leading axis."""

    per_sample = True


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
            w = compute_copy(self.Conv_0, "kernel", self.dtype)
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
    the input dtype. Under training (``deterministic=False``) a non-zero
    ``cell_update_dropout`` drops elements of the cell input with the
    masks of ``dropout`` (a ``DropoutKey``)."""

    def __init__(self, dim: int, dws_conv: bool = False, dws_conv_only_hidden: bool = True,
                 dws_conv_kernel_size: int = 3, dtype: torch.dtype = torch.float32,
                 cell_update_dropout: float = 0.0):
        super().__init__()
        self.dim = dim
        self.cell_update_dropout = cell_update_dropout
        self.drop_cell = Dropout(cell_update_dropout)
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
                deterministic: bool = True, dropout: Optional[DropoutKey] = None):
        if not deterministic and self.cell_update_dropout > 0.0 and dropout is None:
            raise ValueError(f"lstm.drop_cell_update = {self.cell_update_dropout} under "
                             "training needs a DropoutKey")
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
        if not deterministic:
            cell_input = self.drop_cell(cell_input, dropout)
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
