"""Window / grid partitioning for block-local and dilated attention.

Port of sast_tpu/ops/partition.py. Both partitions map
``(B, H, W, C) -> (B, N, hw, C)`` with ``N`` windows of ``hw = p0 * p1``
tokens:

- ``window``: contiguous p0 x p1 tiles (local attention).
- ``grid``: strided sampling — token (i, j) of window (u, v) is pixel
  (i * (H//p0) + u, j * (W//p1) + v), i.e. dilated attention.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _check(H: int, W: int, p: Tuple[int, int]) -> None:
    if H % p[0] or W % p[1]:
        raise ValueError(f"partition {p} does not divide the map {(H, W)}")


def window_partition(x: torch.Tensor, partition_size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, p0*p1, C) with contiguous windows."""
    B, H, W, C = x.shape
    p0, p1 = partition_size
    _check(H, W, partition_size)
    x = x.reshape(B, H // p0, p0, W // p1, p1, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p0) * (W // p1), p0 * p1, C)


def window_reverse(
    windows: torch.Tensor, partition_size: Tuple[int, int], img_size: Tuple[int, int]
) -> torch.Tensor:
    """(B, N, p0*p1, C) -> (B, H, W, C)."""
    H, W = img_size
    p0, p1 = partition_size
    B, C = windows.shape[0], windows.shape[-1]
    x = windows.reshape(B, H // p0, W // p1, p0, p1, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def grid_partition(x: torch.Tensor, grid_size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, g0*g1, C) with dilated (strided) windows."""
    B, H, W, C = x.shape
    g0, g1 = grid_size
    _check(H, W, grid_size)
    x = x.reshape(B, g0, H // g0, g1, W // g1, C).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // g0) * (W // g1), g0 * g1, C)


def grid_reverse(
    windows: torch.Tensor, grid_size: Tuple[int, int], img_size: Tuple[int, int]
) -> torch.Tensor:
    """(B, N, g0*g1, C) -> (B, H, W, C)."""
    H, W = img_size
    g0, g1 = grid_size
    B, C = windows.shape[0], windows.shape[-1]
    x = windows.reshape(B, H // g0, W // g1, g0, g1, C).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, H, W, C)
