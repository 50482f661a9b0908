"""Event-density pyramid: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``density_ratio_tpu`` (sast_tpu/ops/pallas/density.py,
``_counts_pallas`` / ``_slab_kernel``): the per-stage, per-channel share of
non-zero cells of the input max-pooled by 4, 8, 16 and 32, normalised by
``C * Hp * Wp`` as in the reference. The kernel is ``csrc/density.cu``; its
note says what bounds it on the H100 and how it is laid out.

``density_ratio`` dispatches on the tensor's device: a CPU tensor goes to
``density_ratio_plain``, a CUDA tensor launches the kernel or raises. The
ratio carries no gradient (the reference computes it under no_grad).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sast_tpu_torch import build

POOLS = (4, 8, 16, 32)


def density_supported(shape, dtype) -> bool:
    """Static gate of the kernel: uint8 values (the kernel's any-non-zero
    test is max-non-zero only for non-negative values), H and W divisible by
    32 (a block's tile holds whole cells of every level), C <= 32 and
    C % 4 == 0 (4-byte loads; shared memory)."""
    if len(shape) != 4 or dtype != torch.uint8:
        return False
    _, H, W, C = shape
    return H % 32 == 0 and W % 32 == 0 and C <= 32 and C % 4 == 0


def cell_counts(H: int, W: int, C: int, device) -> torch.Tensor:
    """(4,) fp32 normaliser ``(H/k) * (W/k) * C`` of each pyramid level."""
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
        ratios.append(nz / torch.tensor(n, device=x.device))
    return torch.stack(ratios, dim=1)


@functools.cache
def _kernel():
    fn = build.load("density").sast_density_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def density_ratio_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``density_ratio`` (any device)."""
    return non_zero_ratio_plain(x, num_stages=4)


def density_ratio(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, 4, C) fp32 density ratio.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not density_supported(x.shape, x.dtype):
        raise ValueError(f"density kernel gate fails for {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return density_ratio_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"density_ratio: unsupported device {x.device}")
    B, H, W, C = x.shape
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("density kernel needs a contiguous, 16-byte aligned input")
    counts = torch.zeros((B, 4, C), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(
        _kernel()(x.data_ptr(), counts.data_ptr(), B, H, W, C, stream),
        "density kernel",
    )
    density_ratio.launches += 1
    return counts.to(torch.float32) / cell_counts(H, W, C, x.device)[None, :, None]


density_ratio.launches = 0  # kernel launches, read by chip_smoke.py
