"""Object-label containers and geometry ops (numpy, host-side; the port's
own copy of sast_tpu/data/labels.py).

Rows of (t, x, y, w, h, class_id, class_confidence) with x/y the top-left
corner in pixels; clamp/scale/rotate/zoom/flip geometry; conversion to the
padded (class_id, cx, cy, w, h) format the detection loss consumes. Labels
live on the host until the padded batch is assembled (data/batch.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

FIELDS = ("t", "x", "y", "w", "h", "class_id", "class_confidence")
_IDX = {name: i for i, name in enumerate(FIELDS)}


class FrameLabels:
    """Labels of one object-frame: float32 array (N, 7) + canvas size."""

    def __init__(self, arr: np.ndarray, input_size_hw: Tuple[float, float]):
        arr = np.asarray(arr, np.float32)
        assert arr.ndim == 2 and arr.shape[1] == len(FIELDS), arr.shape
        self.arr = arr
        self.input_size_hw = tuple(input_size_hw)

    # -- field accessors -------------------------------------------------
    def __len__(self) -> int:
        return self.arr.shape[0]

    def get(self, name: str) -> np.ndarray:
        return self.arr[:, _IDX[name]]

    t = property(lambda self: self.arr[:, 0])
    x = property(lambda self: self.arr[:, 1])
    y = property(lambda self: self.arr[:, 2])
    w = property(lambda self: self.arr[:, 3])
    h = property(lambda self: self.arr[:, 4])
    class_id = property(lambda self: self.arr[:, 5])
    class_confidence = property(lambda self: self.arr[:, 6])

    def copy(self) -> "FrameLabels":
        return FrameLabels(self.arr.copy(), self.input_size_hw)

    # -- geometry (all in place, mirroring the reference ops) -------------
    def clamp_to_frame_(self) -> None:
        ht, wd = self.input_size_hw
        x0 = np.clip(self.x, 0, wd - 1)
        y0 = np.clip(self.y, 0, ht - 1)
        x1 = np.clip(self.x + self.w, 0, wd - 1)
        y1 = np.clip(self.y + self.h, 0, ht - 1)
        self.arr[:, 1], self.arr[:, 2] = x0, y0
        self.arr[:, 3], self.arr[:, 4] = x1 - x0, y1 - y0

    def remove_flat_labels_(self) -> None:
        keep = (self.w > 0) & (self.h > 0)
        self.arr = self.arr[keep]

    def scale_(self, scaling_multiplier: float) -> None:
        if len(self) == 0 or scaling_multiplier == 1:
            if scaling_multiplier != 1:
                ht, wd = self.input_size_hw
                self.input_size_hw = (
                    scaling_multiplier * ht,
                    scaling_multiplier * wd,
                )
            return
        assert scaling_multiplier > 0
        ht, wd = self.input_size_hw
        new_ht, new_wd = scaling_multiplier * ht, scaling_multiplier * wd
        self.input_size_hw = (new_ht, new_wd)
        x1 = np.minimum((self.x + self.w) * scaling_multiplier, new_wd - 1)
        y1 = np.minimum((self.y + self.h) * scaling_multiplier, new_ht - 1)
        self.arr[:, 1] *= scaling_multiplier
        self.arr[:, 2] *= scaling_multiplier
        self.arr[:, 3] = x1 - self.x
        self.arr[:, 4] = y1 - self.y
        self.remove_flat_labels_()

    def flip_lr_(self) -> None:
        if len(self) == 0:
            return
        self.arr[:, 1] = self.input_size_hw[1] - 1 - self.x - self.w

    def rotate_(self, angle_deg: float) -> None:
        """Axis-aligned bounding box of the rotated box corners (about the
        canvas center, counter-clockwise)."""
        if len(self) == 0:
            return
        ht, wd = self.input_size_hw
        cx, cy = wd // 2, ht // 2
        rad = np.deg2rad(angle_deg)
        rot = np.array(
            [[np.cos(rad), np.sin(rad)], [-np.sin(rad), np.cos(rad)]], np.float32
        )
        corners = np.stack(
            [
                np.stack((self.x, self.y), 1),
                np.stack((self.x + self.w, self.y), 1),
                np.stack((self.x, self.y + self.h), 1),
                np.stack((self.x + self.w, self.y + self.h), 1),
            ]
        )  # (4, N, 2)
        pts = (corners - (cx, cy)) @ rot.T + (cx, cy)
        x0 = np.clip(pts[..., 0].min(0), 0, wd - 1)
        y0 = np.clip(pts[..., 1].min(0), 0, ht - 1)
        x1 = np.clip(pts[..., 0].max(0), 0, wd - 1)
        y1 = np.clip(pts[..., 1].max(0), 0, ht - 1)
        self.arr[:, 1], self.arr[:, 2] = x0, y0
        self.arr[:, 3], self.arr[:, 4] = x1 - x0, y1 - y0
        self.remove_flat_labels_()

    def zoom_in_and_rescale_(
        self, zoom_coordinates_x0y0: Tuple[int, int], zoom_in_factor: float
    ) -> None:
        """Crop the zoom window and rescale it back to the full canvas."""
        if len(self) == 0 or zoom_in_factor == 1:
            return
        assert zoom_in_factor >= 1
        z_x0, z_y0 = zoom_coordinates_x0y0
        h_orig, w_orig = self.input_size_hw
        zh, zw = h_orig / zoom_in_factor, w_orig / zoom_in_factor
        z_x1 = min(z_x0 + zw, w_orig - 1)
        z_y1 = min(z_y0 + zh, h_orig - 1)

        x0 = np.clip(self.x, z_x0, z_x1 - 1)
        y0 = np.clip(self.y, z_y0, z_y1 - 1)
        x1 = np.clip(self.x + self.w, z_x0, z_x1 - 1)
        y1 = np.clip(self.y + self.h, z_y0, z_y1 - 1)
        self.arr[:, 1], self.arr[:, 2] = x0 - z_x0, y0 - z_y0
        self.arr[:, 3], self.arr[:, 4] = x1 - x0, y1 - y0
        self.input_size_hw = (zh, zw)
        self.remove_flat_labels_()
        self.scale_(zoom_in_factor)

    def zoom_out_and_rescale_(
        self, zoom_coordinates_x0y0: Tuple[int, int], zoom_out_factor: float
    ) -> None:
        """Shrink the canvas and paste it at the given top-left offset."""
        if len(self) == 0 or zoom_out_factor == 1:
            return
        assert zoom_out_factor >= 1
        h_orig, w_orig = self.input_size_hw
        self.scale_(1 / zoom_out_factor)
        self.input_size_hw = (h_orig, w_orig)
        z_x0, z_y0 = zoom_coordinates_x0y0
        self.arr[:, 1] += z_x0
        self.arr[:, 2] += z_y0

    # -- export ------------------------------------------------------------
    def to_yolox(self) -> np.ndarray:
        """(N, 5): class_id, cx, cy, w, h."""
        out = np.zeros((len(self), 5), np.float32)
        if len(self):
            out[:, 0] = self.class_id
            out[:, 1] = self.x + 0.5 * self.w
            out[:, 2] = self.y + 0.5 * self.h
            out[:, 3] = self.w
            out[:, 4] = self.h
        return out

    def to_structured(self) -> np.ndarray:
        """Prophesee-style structured array (see eval/prophesee.py)."""
        from sast_tpu_torch.eval.prophesee import BBOX_DTYPE

        out = np.zeros((len(self),), BBOX_DTYPE)
        out["t"] = self.t
        out["x"] = self.x
        out["y"] = self.y
        out["w"] = self.w
        out["h"] = self.h
        out["class_id"] = self.class_id.astype(np.uint32)
        out["class_confidence"] = self.class_confidence
        return out


class LabelStore:
    """Per-sequence label factory: structured labels.npz -> FrameLabels.

    Object-frame i spans rows
    [objframe_idx_2_label_idx[i], objframe_idx_2_label_idx[i+1]); labels are
    clamped to the frame and optionally pre-scaled by 1/downsample_factor.
    """

    def __init__(
        self,
        labels: np.ndarray,
        objframe_idx_2_label_idx: np.ndarray,
        input_size_hw: Tuple[int, int],
        downsample_factor: Optional[float] = None,
    ):
        if labels.dtype.names is not None:
            labels = np.stack(
                [labels[k].astype(np.float32) for k in FIELDS], axis=1
            )
        self._all = FrameLabels(labels, input_size_hw)
        self._all.clamp_to_frame_()
        self.start_idx = np.asarray(objframe_idx_2_label_idx, np.int64)
        self.downsample_factor = downsample_factor
        if downsample_factor is not None:
            assert downsample_factor > 1

    def __len__(self) -> int:
        return len(self.start_idx)

    def __getitem__(self, i: int) -> FrameLabels:
        assert 0 <= i < len(self)
        lo = self.start_idx[i]
        hi = (
            self._all.arr.shape[0]
            if i == len(self) - 1
            else self.start_idx[i + 1]
        )
        fl = FrameLabels(self._all.arr[lo:hi].copy(), self._all.input_size_hw)
        if self.downsample_factor is not None:
            fl.scale_(1 / self.downsample_factor)
        return fl


def pad_labels_yolox(
    labels: List[Optional[FrameLabels]], max_gt: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """List of per-frame labels -> (boxes (F,G,4) cxcywh, classes (F,G), valid (F,G))."""
    F = len(labels)
    boxes = np.zeros((F, max_gt, 4), np.float32)
    classes = np.zeros((F, max_gt), np.int32)
    valid = np.zeros((F, max_gt), bool)
    for f, fl in enumerate(labels):
        if fl is None or len(fl) == 0:
            continue
        y = fl.to_yolox()[:max_gt]
        n = y.shape[0]
        boxes[f, :n] = y[:, 1:5]
        classes[f, :n] = y[:, 0].astype(np.int32)
        valid[f, :n] = True
    return boxes, classes, valid
