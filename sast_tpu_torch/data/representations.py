"""On-device event tensorization: the stacked histogram as a scatter-add.

Port of ``stacked_histogram_jax`` (sast_tpu/data/representations.py), batched
over stream lanes. Channels are ``2 (polarity) x bins (time)``; counts are
clipped to ``count_cutoff`` and stored as uint8, NHWC. The time bin uses the
same fp32 operations in the same order as the JAX version, and the counts
are integer additions, so the result is identical bit for bit and does not
depend on the order of the atomic adds.
"""

from __future__ import annotations

import torch


def stacked_histogram(
    packed: torch.Tensor,
    n_events: torch.Tensor,
    bins: int,
    height: int,
    width: int,
    count_cutoff: int = 255,
) -> torch.Tensor:
    """(S, E, 4) int32 events ``[x, y, p, t]`` + (S,) valid counts ->
    (S, H, W, 2 * bins) uint8.

    Rows at or past a lane's ``n_events``, and events outside the frame, go
    to a drop slot, as with the JAX version's ``mode="drop"`` scatter.
    """
    S, E, _ = packed.shape
    dev = packed.device
    x, y, pol, t = packed.unbind(-1)
    valid = torch.arange(E, device=dev)[None, :] < n_events[:, None]
    t0 = t[:, :1]
    last = (n_events.long() - 1).clamp_min(0)[:, None]
    t1 = torch.gather(t, 1, last)
    denom = (t1 - t0).clamp_min(1).to(torch.float32)
    t_norm = (t - t0).to(torch.float32) / denom
    t_idx = torch.floor(t_norm * bins).clamp(0, bins - 1).to(torch.int32)

    size = 2 * bins * height * width
    flat = x + width * y + height * width * t_idx + bins * height * width * pol
    flat = torch.where(valid & (flat >= 0) & (flat < size), flat, size)
    flat = flat.long() + (size + 1) * torch.arange(S, device=dev)[:, None]
    rep = torch.zeros(S * (size + 1), dtype=torch.int32, device=dev)
    rep.index_add_(0, flat.reshape(-1), torch.ones_like(flat, dtype=torch.int32).reshape(-1))
    rep = rep.reshape(S, size + 1)[:, :size].clamp(0, count_cutoff).to(torch.uint8)
    return rep.reshape(S, 2 * bins, height, width).permute(0, 2, 3, 1).contiguous()
