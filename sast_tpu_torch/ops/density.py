"""Event-density pyramid: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``density_ratio_tpu`` (sast_tpu/ops/pallas/density.py,
``_counts_pallas`` / ``_slab_kernel``): the per-stage, per-channel share of
non-zero cells of the input max-pooled by 4, 8, 16 and 32, normalised by
``C * Hp * Wp`` as in the reference. The kernel is ``csrc/density.cu``, one
launch from the input to the ratio; its note says what bounds it on the H100
and how it is laid out.

``density_ratio`` calls the operator ``sast_tpu_torch::density_ratio``,
which dispatches on the tensor's device: a CPU tensor goes to
``density_ratio_plain``, a CUDA tensor launches the kernel or raises; under
``torch.export`` the operator stands in the graph by its shape. The
ratio carries no gradient (the reference computes it under no_grad).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from sast_tpu_torch import build

POOLS = (4, 8, 16, 32)


def density_supported(shape, dtype) -> bool:
    """Static gate of the kernel: uint8 values (the kernel's any-non-zero
    test is max-non-zero only for non-negative values), H and W divisible by
    32 (a warp's tile holds whole cells of every level), C <= 32 and
    C % 4 == 0 (a 4-pixel cell row is whole 16-byte loads, four channels to
    a word; one instantiation per C)."""
    if len(shape) != 4 or dtype != torch.uint8:
        return False
    _, H, W, C = shape
    return H % 32 == 0 and W % 32 == 0 and C <= 32 and C % 4 == 0


@functools.lru_cache(maxsize=16)
def cell_counts(H: int, W: int, C: int, device) -> torch.Tensor:
    """(4,) fp32 normaliser ``(H/k) * (W/k) * C`` of each pyramid level
    (kept per shape and device: building it copies from the host, so a
    captured step finds it made by its eager warm-up)."""
    return torch.tensor(
        [float((H // k) * (W // k) * C) for k in POOLS], device=device
    )


def non_zero_ratio_plain(x: torch.Tensor, num_stages: int = 4) -> torch.Tensor:
    """(B, H, W, C) any dtype -> (B, num_stages, C) fp32, plain PyTorch.

    The JAX package's reference formulation (sast_tpu/ops/sparse.py): pool
    VALUES (so a signed {-1, 0} window counts as zero), floor odd extents,
    divide the count by ``C * Hp * Wp``."""
    x = x.detach()
    ratios = []
    pooled = x
    for stage in range(num_stages):
        k = 4 if stage == 0 else 2
        B, H, W, C = pooled.shape
        if H < k or W < k:
            raise ValueError(
                f"input {tuple(x.shape)} too small for the stage-{stage} pool "
                f"factor {k} (needs H, W >= {4 * 2 ** (num_stages - 1)})"
            )
        pooled = pooled[:, : H // k * k, : W // k * k]
        pooled = pooled.reshape(B, H // k, k, W // k, k, C).amax(dim=(2, 4))
        nz = (pooled != 0).to(torch.float32).sum(dim=(1, 2))  # (B, C)
        n = float(pooled.shape[1] * pooled.shape[2] * C)
        # A true division by a tensor (a Python number would be a product
        # with its reciprocal on a card), filled on the device: a tensor
        # copied from the host would wait for the stream, which a captured
        # step cannot do.
        ratios.append(nz / torch.full((), n, device=x.device))
    return torch.stack(ratios, dim=1)


@functools.cache
def _kernel(card: int):
    lib = build.load("density", card)
    fn = lib.sast_density_ratio
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.sast_density_partials_bytes
    size.argtypes, size.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    return fn, size


@functools.cache
def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's per-image tickets: n int32 zeros on ``device``, made once
    and kept. The last block of each image sets its ticket back to 0, so
    calls that follow one another on a stream share them without a zeroing
    launch (calls on two streams of one device at once would not)."""
    return torch.zeros(n, dtype=torch.int32, device=device)


def density_ratio_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``density_ratio`` (any device)."""
    return non_zero_ratio_plain(x, num_stages=4)


def density_ratio(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, 4, C) fp32 density ratio, through the
    operator ``sast_tpu_torch::density_ratio``.

    CPU tensors take the plain version; CUDA tensors launch the kernel: one
    allocation (the ratio and the kernel's per-block counts behind it) and
    one launch, bit-equal to the plain version."""
    if not density_supported(x.shape, x.dtype):
        raise ValueError(f"density kernel gate fails for {tuple(x.shape)} {x.dtype}")
    build.check_device(x, "density_ratio")
    return torch.ops.sast_tpu_torch.density_ratio(x)


# The operator: the kernel on CUDA tensors, the plain version on CPU
# tensors, the shape alone under a trace. The tickets are the CUDA
# implementation's own (``_tickets``), never an input.
@torch.library.custom_op("sast_tpu_torch::density_ratio", mutates_args=(), device_types="cuda",
                         schema="(Tensor x) -> Tensor")
@build.on_its_card
def _density_op(x):
    B, H, W, C = x.shape
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("density kernel needs a contiguous, 16-byte aligned input")
    fn, size = _kernel(x.device.index)
    n_out = B * 4 * C
    buf = torch.empty(n_out + size(B, H, W, C) // 4, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(
        fn(x.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * n_out,
           _tickets(x.device, max(64, 1 << (B - 1).bit_length())).data_ptr(), B, H, W, C,
           stream),
        "density kernel",
    )
    density_ratio.launches += 1
    return buf[:n_out].view(B, 4, C)


_density_op.register_kernel("cpu")(density_ratio_plain)


@_density_op.register_fake
def _density_fake(x):
    return x.new_empty((x.shape[0], 4, x.shape[3]), dtype=torch.float32)


@register_flop_formula(torch.ops.sast_tpu_torch.density_ratio)
def _density_flops(*args, out_shape=None, **kwargs):
    """0, as ``FlopCounterMode`` counts the plain version (pools and
    comparisons: no product)."""
    return 0


density_ratio.launches = 0  # kernel launches, read by chip_smoke.py
