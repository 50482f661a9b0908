"""Visualisation of event representations, detections and gradient flow
(port of sast_tpu/utils/viz.py; numpy and the standard library only).

``ev_repr_to_img``, ``draw_bboxes``, ``render_detection_frame`` and
``save_png`` are the JAX package's, array for array and byte for byte.
``render_gradflow`` draws the gradient-flow figure with numpy where JAX
uses matplotlib (absent where the port runs): a white canvas, a framed
axis with a log-scale grid, and one polyline per component in a colour of
a fixed palette, with a colour key beside the axis. Its pixels are its own.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

# distinct colors per class id (RGB)
_CLASS_COLORS = np.array(
    [
        (255, 80, 80),
        (80, 160, 255),
        (120, 255, 120),
        (255, 200, 60),
        (220, 120, 255),
        (90, 230, 230),
    ],
    np.uint8,
)


def ev_repr_to_img(ev_repr: np.ndarray) -> np.ndarray:
    """(H, W, 2*bins) stacked histogram -> (H, W, 3) uint8 RGB: where the
    positive polarity has more events, red; the negative, blue; grey
    elsewhere. The first ``bins`` channels are the negative polarity."""
    if ev_repr.ndim != 3 or ev_repr.shape[-1] % 2:
        raise ValueError(f"expected (H, W, 2 * bins), got {ev_repr.shape}")
    bins = ev_repr.shape[-1] // 2
    neg = ev_repr[..., :bins].astype(np.int32).sum(-1)
    pos = ev_repr[..., bins:].astype(np.int32).sum(-1)
    img = np.full((*ev_repr.shape[:2], 3), 114, np.uint8)
    img[pos > neg] = (255, 0, 0)
    img[pos < neg] = (0, 0, 255)
    return img


def draw_bboxes(
    img: np.ndarray,
    boxes: np.ndarray,
    labels: Optional[Sequence[int]] = None,
    scores: Optional[Sequence[float]] = None,
    thickness: int = 1,
) -> np.ndarray:
    """Draw (x, y, w, h) boxes onto an RGB image (in place; also returned)."""
    H, W = img.shape[:2]
    boxes = np.asarray(boxes)
    for i, (x, y, w, h) in enumerate(boxes.reshape(-1, 4)):
        cls = int(labels[i]) if labels is not None else 0
        color = _CLASS_COLORS[cls % len(_CLASS_COLORS)]
        x0, y0 = int(max(x, 0)), int(max(y, 0))
        x1, y1 = int(min(x + w, W - 1)), int(min(y + h, H - 1))
        if x1 <= x0 or y1 <= y0:
            continue
        for t in range(thickness):
            xa, ya = min(x0 + t, W - 1), min(y0 + t, H - 1)
            xb, yb = max(x1 - t, 0), max(y1 - t, 0)
            img[ya, xa : xb + 1] = color
            img[yb, xa : xb + 1] = color
            img[ya : yb + 1, xa] = color
            img[ya : yb + 1, xb] = color
    return img


def render_detection_frame(
    ev_repr: np.ndarray,
    gt_boxes: Optional[np.ndarray] = None,
    pred_boxes: Optional[np.ndarray] = None,
    pred_classes: Optional[np.ndarray] = None,
    gt_classes: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Side-by-side (predictions | labels) panel."""
    left = ev_repr_to_img(ev_repr)
    right = left.copy()
    if pred_boxes is not None and len(pred_boxes):
        draw_bboxes(left, pred_boxes, pred_classes)
    if gt_boxes is not None and len(gt_boxes):
        draw_bboxes(right, gt_boxes, gt_classes)
    return np.concatenate([left, right], axis=1)


def save_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer: 8-bit RGB, one zlib stream at level 6."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


# Line colours of the gradient-flow figure, by sorted component name.
_PALETTE = np.array([(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
                     (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127)], np.uint8)
_FIG_HW = (450, 800)
_AXIS = (30, 60, 410, 620)  # top, left, bottom, right of the plot area


def _segment(img: np.ndarray, p0, p1, color, width: int = 2) -> None:
    """A straight line from ``p0`` to ``p1`` ((row, col) floats), ``width``
    pixels thick, sampled at every pixel of its longer extent."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    rows = np.rint(np.linspace(p0[0], p1[0], n)).astype(int)
    cols = np.rint(np.linspace(p0[1], p1[1], n)).astype(int)
    for d in range(width):
        img[np.clip(rows + d, 0, img.shape[0] - 1), np.clip(cols, 0, img.shape[1] - 1)] = color


def render_gradflow(steps: List[int], series: Dict[str, List[float]]) -> np.ndarray:
    """Gradient-flow figure: per-component gradient-norm curves over
    training (the reference's gradflow callback), on a log-scale y axis.
    ``series`` maps a component name to its norm history, aligned with
    ``steps``. Returns an (H, W, 3) uint8 image."""
    img = np.full((*_FIG_HW, 3), 255, np.uint8)
    top, left, bottom, right = _AXIS
    curves = []
    for name, values in sorted(series.items()):
        n = min(len(steps), len(values))
        x = np.asarray(steps[:n], np.float64)
        y = np.asarray(values[:n], np.float64)
        ok = np.isfinite(y) & (y > 0)
        curves.append((x[ok], np.log10(y[ok])))
    xs = np.concatenate([c[0] for c in curves] or [np.zeros(1)])
    ys = np.concatenate([c[1] for c in curves] or [np.zeros(1)])
    x_lo, x_hi = (xs.min(), xs.max()) if xs.size else (0.0, 1.0)
    y_lo, y_hi = (np.floor(ys.min()), np.ceil(ys.max())) if ys.size else (0.0, 1.0)
    x_hi, y_hi = max(x_hi, x_lo + 1), max(y_hi, y_lo + 1)

    def at(x, y):
        return (bottom - (y - y_lo) / (y_hi - y_lo) * (bottom - top),
                left + (x - x_lo) / (x_hi - x_lo) * (right - left))

    for decade in range(int(y_lo), int(y_hi) + 1):  # grid: one line per decade
        r = int(round(at(x_lo, decade)[0]))
        img[r, left:right + 1] = (225, 225, 225)
    img[top:bottom + 1, [left, right]] = 0  # the frame
    img[[top, bottom], left:right + 1] = 0
    for k, (x, y) in enumerate(curves):
        color = _PALETTE[k % len(_PALETTE)]
        pts = [at(a, b) for a, b in zip(x, y)]
        for p0, p1 in zip(pts, pts[1:] or pts):
            _segment(img, p0, p1, color)
        # The key: a swatch per component, in sorted-name order.
        r0 = top + 12 + 18 * k
        img[r0:r0 + 8, right + 20:right + 50] = color
    return img
