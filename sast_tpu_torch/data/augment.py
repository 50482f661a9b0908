"""Spatial data augmentation on (T, H, W, C) event clips + labels (numpy;
the port's own copy of sast_tpu/data/augment.py).

- horizontal flip, rotation (nearest), label-anchored zoom-in, zoom-out;
- stream mode: augmentation state sampled ONCE per stream and reused for all
  clips (zoom-out only); random mode: resampled per item, zoom-in (weight 8)
  vs zoom-out (weight 2);
- image resizing uses nearest-exact index maps (torch
  ``interpolate(mode='nearest-exact')``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from sast_tpu_torch.config import AugmentConfig
from sast_tpu_torch.data.labels import FrameLabels


def _nearest_exact_indices(out_size: int, in_size: int) -> np.ndarray:
    # torch 'nearest-exact': src = floor((dst + 0.5) * in/out)
    return np.clip(
        np.floor((np.arange(out_size) + 0.5) * in_size / out_size).astype(np.int64),
        0,
        in_size - 1,
    )


def resize_nearest(x: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(T, H, W, C) nearest-exact resize to (T, out_h, out_w, C)."""
    iy = _nearest_exact_indices(out_hw[0], x.shape[1])
    ix = _nearest_exact_indices(out_hw[1], x.shape[2])
    # One advanced-index gather (broadcasted iy/ix), not two chained ones —
    # chaining materializes a full (T, out_h, W, C) intermediate.
    return x[:, iy[:, None], ix[None, :], :]


def rotate_nearest(x: np.ndarray, angle_deg: float) -> np.ndarray:
    """Counter-clockwise rotation about the center, nearest sampling,
    zero fill (matches torchvision rotate semantics for our use)."""
    T, H, W, C = x.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    rad = np.deg2rad(angle_deg)
    cos, sin = np.cos(rad), np.sin(rad)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # inverse mapping: output (y, x) samples input rotated by -angle
    xs = cos * (xx - cx) - sin * (yy - cy) + cx
    ys = sin * (xx - cx) + cos * (yy - cy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xi = np.clip(xi, 0, W - 1)
    yi = np.clip(yi, 0, H - 1)
    out = x[:, yi, xi, :]
    out[:, ~valid, :] = 0
    return out


def sample_zoom_window_from_labels(
    rng: np.random.RandomState,
    labels: FrameLabels,
    zoom_window_hw: Tuple[float, float],
) -> Tuple[int, int]:
    """Top-left of a zoom window guaranteed to contain one (random) label."""
    in_h, in_w = labels.input_size_hw
    zh, zw = zoom_window_hw
    idx = 0 if len(labels) == 1 else rng.randint(0, max(len(labels) - 1, 1))
    x0l, y0l = float(labels.x[idx]), float(labels.y[idx])
    wl, hl = float(labels.w[idx]), float(labels.h[idx])
    x1l, y1l = x0l + wl, y0l + hl

    x0v = max(x1l - max(zw, wl), 0)
    y0v = max(y1l - max(zh, hl), 0)
    x1v = min(x0l + max(zw, wl), in_w - 1)
    y1v = min(y0l + max(zh, hl), in_h - 1)
    x1v = max(x1v - zw, x0v)
    y1v = max(y1v - zh, y0v)
    return int(rng.uniform(x0v, x1v)), int(rng.uniform(y0v, y1v))


@dataclass
class AugmentState:
    apply_hflip: bool = False
    rotate_angle_deg: Optional[float] = None
    zoom_out: Optional[Tuple[int, int, float]] = None  # (x0, y0, factor)
    zoom_in_factor: Optional[float] = None  # window sampled per item from labels


class SpatialAugmentor:
    """Applies one sampled AugmentState to a clip (events + labels)."""

    def __init__(
        self,
        cfg: AugmentConfig,
        stream_mode: bool,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.cfg = cfg
        self.stream_mode = stream_mode
        self.rng = rng or np.random.RandomState()

    def sample_state(self, hw: Tuple[int, int]) -> AugmentState:
        cfg = self.cfg
        rng = self.rng
        state = AugmentState()
        state.apply_hflip = rng.rand() < cfg.prob_hflip
        if rng.rand() < cfg.rotate_prob:
            sign = 1 if rng.rand() < 0.5 else -1
            state.rotate_angle_deg = sign * rng.uniform(
                cfg.rotate_min_angle_deg, cfg.rotate_max_angle_deg
            )
        if rng.rand() < cfg.zoom.prob:
            total_w = cfg.zoom.zoom_in_weight + cfg.zoom.zoom_out_weight
            zoom_in = (
                not self.stream_mode
                and not cfg.zoom_out_only
                and rng.rand() < cfg.zoom.zoom_in_weight / max(total_w, 1e-9)
            )
            if zoom_in:
                state.zoom_in_factor = rng.uniform(
                    cfg.zoom.zoom_in_min, cfg.zoom.zoom_in_max
                )
            else:
                factor = rng.uniform(cfg.zoom.zoom_out_min, cfg.zoom.zoom_out_max)
                h, w = hw
                zh, zw = int(h / factor), int(w / factor)
                x0 = int(rng.uniform(0, w - zw))
                y0 = int(rng.uniform(0, h - zh))
                state.zoom_out = (x0, y0, factor)
        return state

    def apply(
        self,
        state: AugmentState,
        ev: np.ndarray,
        labels: List[Optional[FrameLabels]],
        rng: Optional[np.random.RandomState] = None,
    ) -> Tuple[np.ndarray, List[Optional[FrameLabels]]]:
        """ev: (T, H, W, C). Labels are copied, never mutated in place.

        ``rng`` (zoom-in window sampling) defaults to the augmentor's own
        RandomState; pass a private one when calling from worker threads.
        """
        rng = rng or self.rng
        T, H, W, C = ev.shape
        labels = [fl.copy() if fl is not None else None for fl in labels]

        if state.apply_hflip:
            ev = ev[:, :, ::-1]
            for fl in labels:
                if fl is not None:
                    fl.flip_lr_()

        if state.rotate_angle_deg is not None:
            ev = rotate_nearest(np.ascontiguousarray(ev), state.rotate_angle_deg)
            for fl in labels:
                if fl is not None:
                    fl.rotate_(state.rotate_angle_deg)

        if state.zoom_out is not None:
            x0, y0, factor = state.zoom_out
            zh, zw = int(H / factor), int(W / factor)
            small = resize_nearest(np.ascontiguousarray(ev), (zh, zw))
            out = np.zeros_like(ev)
            out[:, y0 : y0 + zh, x0 : x0 + zw] = small
            ev = out
            for fl in labels:
                if fl is not None:
                    fl.zoom_out_and_rescale_((x0, y0), factor)

        if state.zoom_in_factor is not None and state.zoom_in_factor > 1:
            factor = state.zoom_in_factor
            zh, zw = int(H / factor), int(W / factor)
            # Window anchored to the latest non-empty objframe; no labels ->
            # no zoom-in (reference skips it then).
            anchor = None
            for fl in reversed(labels):
                if fl is not None and len(fl) > 0:
                    anchor = fl
                    break
            if anchor is not None:
                x0, y0 = sample_zoom_window_from_labels(rng, anchor, (zh, zw))
                crop = np.ascontiguousarray(ev[:, y0 : y0 + zh, x0 : x0 + zw])
                ev = resize_nearest(crop, (H, W))
                new_labels: List[Optional[FrameLabels]] = []
                for fl in labels:
                    if fl is not None:
                        fl.zoom_in_and_rescale_((x0, y0), factor)
                        fl = fl if len(fl) > 0 else None
                    new_labels.append(fl)
                labels = new_labels

        # Drop labels that became empty.
        labels = [fl if (fl is not None and len(fl) > 0) else None for fl in labels]
        return np.ascontiguousarray(ev), labels

    def __call__(self, ev, labels, state: Optional[AugmentState] = None):
        if state is None:
            state = self.sample_state((ev.shape[1], ev.shape[2]))
        return self.apply(state, ev, labels)
