"""Event tensorization: the stacked histogram and the mixed-density stack
(port of sast_tpu/data/representations.py and of the host helpers of
sast_tpu/native/).

``stacked_histogram`` is the serving step's scatter-add, batched over stream
lanes (JAX ``stacked_histogram_jax``). Channels are ``2 (polarity) x bins
(time)``; counts are clipped to ``count_cutoff`` and stored as uint8, NHWC.
The time bin uses the same fp32 operations in the same order as the JAX
version, and the counts are integer additions, so the result is identical
bit for bit and does not depend on the order of the atomic adds.

``StackedHistogram`` and ``MixedDensityEventStack`` are the preprocessing
representations (JAX's numpy classes, channel-first). Their scatter-add runs
in torch on ``device``, the card unless the caller asks for the CPU, and
they return numpy arrays equal to JAX's bit for bit: the histogram's time
bin in float64 on the device (IEEE division and product, as numpy rounds
them), the mixed stack's bin on the host in numpy, as JAX computes it
(``log`` may round differently on the card, and at a power-of-two time the
floor would flip), and integer sums. They replace JAX's optional C++ fast
path (``sast_tpu/native``), as do ``monotonize_time``,
``downsample2x_nearest_u8`` and ``transpose_tchw_to_thwc`` here, which take
and return tensors on their device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sast_tpu_torch.models.detector import resolve_device

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


class StackedHistogram:
    """Counting histogram: channels = 2 (polarity) * bins (time)."""

    def __init__(self, bins: int, height: int, width: int,
                 count_cutoff: Optional[int] = None, device="cuda"):
        if bins < 1 or height < 1 or width < 1:
            raise ValueError(f"bins, height, width must be >= 1: {(bins, height, width)}")
        self.bins, self.height, self.width = bins, height, width
        self.count_cutoff = 255 if count_cutoff is None else min(count_cutoff, 255)
        if self.count_cutoff < 1:
            raise ValueError(f"count_cutoff must be >= 1, got {count_cutoff}")
        self.channels = 2
        self.device = resolve_device(device)

    @staticmethod
    def get_numpy_dtype() -> np.dtype:
        return np.dtype("uint8")

    def get_shape(self) -> Tuple[int, int, int]:
        """(C, H, W) channel-first shape, matching the on-disk layout."""
        return 2 * self.bins, self.height, self.width

    def construct_tensor(self, x: np.ndarray, y: np.ndarray, pol: np.ndarray,
                         time: np.ndarray) -> torch.Tensor:
        """(2*bins, H, W) uint8 histogram on ``device`` from time-sorted
        event arrays."""
        bn, ht, wd = self.bins, self.height, self.width
        size = self.channels * bn * ht * wd
        if x.size == 0:
            return torch.zeros((2 * bn, ht, wd), dtype=torch.uint8, device=self.device)
        _check_events(x, y, pol, time)
        dev = self.device
        t = torch.from_numpy(np.ascontiguousarray(time, np.int64)).to(dev)
        t0, t1 = int(time[0]), int(time[-1])
        t_norm = (t.to(torch.float64) - float(t0)) / float(max(t1 - t0, 1))
        t_idx = torch.floor(t_norm * bn).clamp(max=bn - 1).to(torch.int64)
        flat = (_long(x, dev) + wd * _long(y, dev) + ht * wd * t_idx
                + bn * ht * wd * _long(pol, dev))
        rep = torch.bincount(flat, minlength=size).clamp(0, self.count_cutoff)
        return rep.to(torch.uint8).reshape(-1, ht, wd)

    def construct(self, x, y, pol, time) -> np.ndarray:
        """``construct_tensor`` as a numpy array on the host."""
        return self.construct_tensor(x, y, pol, time).cpu().numpy()


class MixedDensityEventStack:
    """Signed polarity stack with logarithmic (power-of-two) time bins: bin
    ``bins - log2(1 / t_norm)``, so recent events land in high bins, then a
    cumulative sum over the bins (channel i holds bins <= i), clipped to
    ``count_cutoff`` and to int8."""

    def __init__(self, bins: int, height: int, width: int,
                 count_cutoff: Optional[int] = None, device="cuda"):
        if bins < 1 or height < 1 or width < 1:
            raise ValueError(f"bins, height, width must be >= 1: {(bins, height, width)}")
        if count_cutoff is not None and not 0 <= count_cutoff <= 127:
            raise ValueError(f"count_cutoff must lie in [0, 127], got {count_cutoff}")
        self.bins, self.height, self.width = bins, height, width
        self.count_cutoff = count_cutoff
        self.device = resolve_device(device)

    @staticmethod
    def get_numpy_dtype() -> np.dtype:
        return np.dtype("int8")

    def get_shape(self) -> Tuple[int, int, int]:
        return self.bins, self.height, self.width

    def construct_tensor(self, x: np.ndarray, y: np.ndarray, pol: np.ndarray,
                         time: np.ndarray) -> torch.Tensor:
        bn, ht, wd = self.bins, self.height, self.width
        if x.size == 0:
            return torch.zeros((bn, ht, wd), dtype=torch.int8, device=self.device)
        _check_events(x, y, pol, time)
        # The bin on the host, in numpy's float64 log, as JAX computes it.
        t0, t1 = int(time[0]), int(time[-1])
        t_norm = (time.astype(np.float64) - t0) / max(t1 - t0, 1)
        t_norm = np.clip(t_norm, 1e-6, 1 - 1e-6)
        bin_float = bn - np.log(t_norm) / np.log(0.5)
        t_idx = np.floor(np.clip(bin_float, 0, None)).astype(np.int64)

        dev = self.device
        flat = _long(x, dev) + wd * _long(y, dev) + ht * wd * torch.from_numpy(t_idx).to(dev)
        signed = _long(pol, dev) * 2 - 1
        rep = torch.zeros(bn * ht * wd, dtype=torch.int64, device=dev)
        rep.index_add_(0, flat, signed)
        rep = rep.reshape(bn, ht, wd).cumsum(dim=0)
        if self.count_cutoff is not None:
            rep = rep.clamp(-self.count_cutoff, self.count_cutoff)
        return rep.clamp(-128, 127).to(torch.int8)  # saturate, no int8 wraparound

    def construct(self, x, y, pol, time) -> np.ndarray:
        """``construct_tensor`` as a numpy array on the host."""
        return self.construct_tensor(x, y, pol, time).cpu().numpy()


def _check_events(x, y, pol, time) -> None:
    if not x.size == y.size == pol.size == time.size:
        raise ValueError(f"event arrays differ in length: {(x.size, y.size, pol.size, time.size)}")
    if pol.min() < 0 or pol.max() > 1:
        raise ValueError("polarities must be 0 or 1")
    if int(time[-1]) < int(time[0]):
        raise ValueError("events must be sorted by time")


def _long(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def monotonize_time(t: torch.Tensor) -> torch.Tensor:
    """Non-decreasing timestamps: each the running maximum (JAX's
    ``np.maximum.accumulate``, the reference's numba loop)."""
    return torch.cummax(t, dim=0).values


def downsample2x_nearest_u8(x: torch.Tensor) -> torch.Tensor:
    """(C, H, W) uint8 -> (C, H // 2, W // 2), nearest-exact: source row
    ``min(2 i + 1, H - 1)``, the same for columns."""
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (C, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    _, h, w = x.shape
    rows = (2 * torch.arange(h // 2, device=x.device) + 1).clamp(max=h - 1)
    cols = (2 * torch.arange(w // 2, device=x.device) + 1).clamp(max=w - 1)
    return x.index_select(1, rows).index_select(2, cols)


def transpose_tchw_to_thwc(x: torch.Tensor) -> torch.Tensor:
    """(T, C, H, W) -> contiguous (T, H, W, C): the disk layout to the
    model's."""
    if x.dim() != 4:
        raise ValueError(f"expected (T, C, H, W), got {tuple(x.shape)}")
    return x.permute(0, 2, 3, 1).contiguous()
