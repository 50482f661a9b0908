"""Scene-adaptive scoring and selection as static-shape boolean masks.

Port of sast_tpu/ops/sparse.py:

- ``window_keep (B, N)``: windows whose softmax-normalised L1 score is
  >= (1/N) / (1 + bounce);
- ``token_keep (B, N, hw)``: tokens (within kept windows) whose softmax
  score is >= (1/hw) / (1 + bounce).

The masked attention consuming these masks (models/sast.py) is the
reference's gather/pad/scatter pipeline written over the full window set.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sast_tpu_torch.ops.density import (
    density_ratio,
    density_supported,
    non_zero_ratio_plain,
)


def non_zero_ratio(
    x: torch.Tensor, num_stages: int = 4, use_kernel: bool = True
) -> torch.Tensor:
    """Per-stage channel-wise event-density ratio, (B, num_stages, C) fp32.

    Where ``use_kernel`` is set and the density kernel's static gate holds
    (uint8, 4 stages, H and W divisible by 32, C <= 32 and C % 4 == 0), this
    is ``ops/density.density_ratio`` (the kernel on CUDA tensors, its plain
    version on CPU tensors); otherwise the plain pooling, which also covers
    signed inputs and odd extents."""
    if use_kernel and num_stages == 4 and density_supported(x.shape, x.dtype):
        return density_ratio(x)
    return non_zero_ratio_plain(x, num_stages)


def select_windows_and_tokens(
    scores: torch.Tensor, bounce: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window + token co-selection from amplified scores.

    Args:
      scores: (B, N, hw, C) non-negative amplified scores.
      bounce: BOUNCE slack constant.

    Returns window_keep (B, N) bool and token_keep (B, N, hw) bool (a token
    is kept only if its window is kept).
    """
    B, N, hw, C = scores.shape
    # Always fp32: with near-uniform scores the softmax sits exactly at the
    # 1/N threshold, and a bf16 softmax can flip the comparison. Divide by
    # tensors, not Python numbers: on CUDA, division by a Python number is
    # a multiplication by its reciprocal, which rounds differently from the
    # true division of the JAX package.
    scores = scores.to(torch.float32)
    absval = scores.abs()
    # torch.full fills on the device; torch.tensor would copy from the host
    # and wait for the stream.
    hw_t = torch.full((), float(hw), dtype=torch.float32, device=scores.device)
    win_l1 = absval.sum(dim=(2, 3)) / hw_t  # (B, N)
    win_soft = torch.softmax(win_l1, dim=-1)
    window_keep = win_soft >= (1.0 / N) / (1.0 + bounce)

    tok_l1 = absval.sum(dim=3)  # (B, N, hw)
    tok_soft = torch.softmax(tok_l1, dim=-1)
    token_keep = (tok_soft >= (1.0 / hw) / (1.0 + bounce)) & window_keep[..., None]
    return window_keep, token_keep
