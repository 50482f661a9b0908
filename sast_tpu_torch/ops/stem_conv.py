"""Stem convolution (7x7, stride 4), optionally fused with the density
pyramid: hand-written CUDA kernel and its plain version.

Replaces the TPU kernels ``stem_conv_density_raw_7x4`` / ``stem_conv_raw_7x4``
(sast_tpu/ops/pallas/stem_conv.py, ``_stem_fwd_raw``) and, as the same
function, ``stem_conv_density_7x4`` / ``stem_conv_7x4`` (``_stem_fwd_pallas``).
The kernel is ``csrc/stem_conv.cu``; its note says what bounds it on the H100
and how it is laid out. It reads the native uint8 NHWC tensor and does the
replicate pad by clamping coordinates, so no padded or widened copy of the
input is ever written. With bf16 weights it is an implicit GEMM on the
tensor cores; ``stem_weight_index`` states the layout of its weights, and
its C entry gathers them into it (a small launch) and zeroes the density
counts, so that one call here issues no tensor operation but the ratio's
division; with fp32 weights it runs on the fp32 CUDA cores.

``stem_conv7x4`` calls the operator ``sast_tpu_torch::stem_conv7x4`` (with
the density, ``stem_conv_density7x4``), which dispatches on the tensor's
device: a CPU tensor goes to ``stem_conv7x4_plain``, a CUDA tensor launches
the kernel or raises; under ``torch.export`` the operator stands in the
graph by its shapes. Under
grad mode with a weight that requires grad it is a ``torch.autograd.Function``
whose backward is the TPU package's ``_bwd``: for the uint8 input only the
weight gradient, by torch's own convolution ops on the replicate-padded
input (outside any kernel, as there); the density ratio has no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from sast_tpu_torch import build
from sast_tpu_torch.ops.density import cell_counts, density_ratio_plain

KSIZE, STRIDE, PAD = 7, 4, 3


def stem_supported(shape, dtype, cout: int) -> bool:
    """Static gate of the kernel: uint8 input (widened in registers), H and W
    divisible by 32 (whole 32x32 pool-32 density cells per tile), C <= 32
    and C % 4 == 0 (4-byte loads), and Cout % 16 == 0 with Cout <= 128
    (output channels in slices of 16 to 64; the fp32 kernel's 16 per
    thread)."""
    if len(shape) != 4 or dtype != torch.uint8:
        return False
    _, H, W, C = shape
    return (
        H % 32 == 0 and W % 32 == 0 and C <= 32 and C % 4 == 0
        and cout % 16 == 0 and cout <= 128
    )


def stem_conv7x4_plain(x: torch.Tensor, w: torch.Tensor, with_density: bool = False):
    """Plain PyTorch version of ``stem_conv7x4`` (any device): the JAX
    package's ``stem_conv_xla`` — replicate pad 3, VALID 7x7/stride-4 conv,
    no bias, in ``w.dtype`` — plus the plain density ratio."""
    xc = x.to(w.dtype).permute(0, 3, 1, 2)
    xp = F.pad(xc, (PAD, PAD, PAD, PAD), mode="replicate")
    y = F.conv2d(xp, w, stride=STRIDE).permute(0, 2, 3, 1)
    return (y, density_ratio_plain(x)) if with_density else y


def stem_weight_index(c: int, cout: int) -> torch.Tensor:
    """Where each entry of the bf16 kernel's B operand comes from: the flat
    index into the (Cout, C, 7, 7) weight, or -1 for a zero. K is ordered
    (kh, kw, c), so that one kernel row's slice of an output pixel's K is
    7 C contiguous bytes of one input row; each kernel row's 7 C is padded
    with zeros to S * 16; the operand is stored (7, S, Cout, 16), the 16
    consecutive K of one output channel together, as the tensor-core
    fragments read them. Returned flat, int32."""
    kp = -(-KSIZE * c // 16) * 16
    flat = torch.arange(cout * c * KSIZE * KSIZE, dtype=torch.int32)
    m = flat.reshape(cout, c, KSIZE, KSIZE).permute(2, 3, 1, 0).reshape(KSIZE, KSIZE * c, cout)
    m = F.pad(m, (0, 0, 0, kp - KSIZE * c), value=-1)
    return m.reshape(KSIZE, kp // 16, 16, cout).permute(0, 1, 3, 2).reshape(-1).contiguous()


@functools.lru_cache(maxsize=16)
def _weight_index(c: int, cout: int, device) -> torch.Tensor:
    """``stem_weight_index`` on the card, kept per shape and device."""
    return stem_weight_index(c, cout).to(device)


@functools.cache
def _kernels(card: int):
    lib = build.load("stem_conv", card)
    fp32, mma, work = (lib.sast_stem_conv7x4, lib.sast_stem_conv7x4_mma,
                       lib.sast_stem_conv7x4_mma_workspace)
    for fn, n_ptr in ((fp32, 4), (mma, 6)):
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    work.argtypes = [ctypes.c_int] * 2
    work.restype = ctypes.c_longlong
    return fp32, mma, work


class _StemFn(torch.autograd.Function):
    """Kernel forward; backward: the weight gradient of the plain conv."""

    @staticmethod
    def forward(ctx, x, w, with_density):
        out = _forward(x, w.detach(), with_density)
        ctx.save_for_backward(x)
        ctx.w_shape = w.shape
        if with_density:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, g, *_g_ratio):
        (x,) = ctx.saved_tensors
        xp = F.pad(x.to(g.dtype).permute(0, 3, 1, 2), (PAD, PAD, PAD, PAD), mode="replicate")
        gw = torch.nn.grad.conv2d_weight(xp, ctx.w_shape, g.permute(0, 3, 1, 2), stride=STRIDE)
        return None, gw, None


def stem_conv7x4(x: torch.Tensor, w: torch.Tensor, with_density: bool = False):
    """7x7/stride-4 replicate-padded conv of a uint8 NHWC input; see
    ``_forward`` for the arguments. Under grad mode with ``w`` requiring grad
    the result carries the weight gradient."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _StemFn.apply(x, w, with_density)
    return _forward(x, w, with_density)


def _forward(x: torch.Tensor, w: torch.Tensor, with_density: bool = False):
    """7x7/stride-4 replicate-padded conv of a uint8 NHWC input, through the
    operator ``sast_tpu_torch::stem_conv7x4`` (or ``stem_conv_density7x4``).

    Args:
      x: (B, H, W, C) uint8 event histogram.
      w: (Cout, C, 7, 7) OIHW weight in the compute dtype (fp32 or bf16).
      with_density: also return the (B, 4, C) fp32 density ratio.

    Returns y (B, H/4, W/4, Cout) in ``w.dtype`` (accumulated in fp32), and
    the ratio when ``with_density``.
    """
    cout = w.shape[0]
    if not stem_supported(x.shape, x.dtype, cout) or w.shape[1:] != (
        x.shape[-1], KSIZE, KSIZE
    ):
        raise ValueError(
            f"stem kernel gate fails for x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}"
        )
    build.check_device(x, "stem_conv7x4")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem kernel computes in fp32 or bf16, not {w.dtype}")
    if with_density:
        return torch.ops.sast_tpu_torch.stem_conv_density7x4(x, w)
    return torch.ops.sast_tpu_torch.stem_conv7x4(x, w)


@build.on_its_card
def _launch(x: torch.Tensor, w: torch.Tensor, with_density: bool):
    """The kernel on CUDA tensors (the operators' CUDA implementation)."""
    if not x.is_contiguous() or x.data_ptr() % 4:
        raise ValueError("stem kernel needs a contiguous, 4-byte aligned input")
    B, H, W, C = x.shape
    cout = w.shape[0]
    fp32, mma, work = _kernels(x.device.index)
    y = torch.empty((B, H // 4, W // 4, cout), dtype=w.dtype, device=x.device)
    # Zeroed by the C entry.
    counts = torch.empty((B, 4, C), dtype=torch.int32, device=x.device) if with_density else None
    args = (y.data_ptr(), counts.data_ptr() if with_density else None, B, H, W, C, cout,
            torch.cuda.current_stream(x.device).cuda_stream)
    if w.dtype == torch.bfloat16:
        w = w.contiguous()
        idx = _weight_index(C, cout, x.device)
        wt = torch.empty(work(C, cout), dtype=torch.bfloat16, device=x.device)
        rc = mma(x.data_ptr(), w.data_ptr(), idx.data_ptr(), wt.data_ptr(), *args)
    else:
        wk = w.permute(2, 3, 1, 0).contiguous()  # (kh, kw, cin, cout)
        rc = fp32(x.data_ptr(), wk.data_ptr(), *args)
    build.check(rc, "stem kernel")
    stem_conv7x4.launches += 1
    if not with_density:
        return y
    return y, counts / cell_counts(H, W, C, x.device)[None, :, None]


# The operators: the kernel on CUDA tensors, the plain version on CPU
# tensors (made contiguous, as the kernel writes), shapes alone under a
# trace (``torch.export``), where nothing launches and nothing is counted.
@torch.library.custom_op("sast_tpu_torch::stem_conv7x4", mutates_args=(), device_types="cuda",
                         schema="(Tensor x, Tensor w) -> Tensor")
def _stem_op(x, w):
    return _launch(x, w, False)


@torch.library.custom_op("sast_tpu_torch::stem_conv_density7x4", mutates_args=(),
                         device_types="cuda", schema="(Tensor x, Tensor w) -> (Tensor, Tensor)")
def _stem_density_op(x, w):
    return _launch(x, w, True)


@_stem_op.register_kernel("cpu")
def _stem_cpu(x, w):
    return stem_conv7x4_plain(x, w).contiguous()


@_stem_density_op.register_kernel("cpu")
def _stem_density_cpu(x, w):
    y, ratio = stem_conv7x4_plain(x, w, with_density=True)
    return y.contiguous(), ratio


@_stem_op.register_fake
def _stem_fake(x, w):
    B, H, W, _ = x.shape
    return x.new_empty((B, H // 4, W // 4, w.shape[0]), dtype=w.dtype)


@_stem_density_op.register_fake
def _stem_density_fake(x, w):
    return _stem_fake(x, w), x.new_empty((x.shape[0], 4, x.shape[3]), dtype=torch.float32)


@register_flop_formula([torch.ops.sast_tpu_torch.stem_conv7x4,
                        torch.ops.sast_tpu_torch.stem_conv_density7x4])
def _stem_flops(x, w, *, out_shape=None, **kwargs):
    """FLOPs of the plain version's convolution, as ``FlopCounterMode``
    counts ``F.conv2d``: 2 per multiply-add; the density ratio counts 0."""
    B, H, W, C = x
    cout, _, kh, kw = w
    return 2 * B * (H // STRIDE) * (W // STRIDE) * cout * C * kh * kw


stem_conv7x4.launches = 0  # kernel launches, read by chip_smoke.py
