"""Prophesee-protocol detection evaluation (the port's own copy of
sast_tpu/eval/prophesee.py).

Structured BBOX arrays, the psee box filters (skip < 0.5 s, min
diagonal/side), +-50 ms time-window matching of detections to GT
timestamps, and COCO AP through eval/coco.py. Device detections arrive as
fixed-budget arrays with validity masks (from ops/nms.postprocess) and are
turned into structured arrays here, on the host, once per evaluation step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sast_tpu_torch.config import DATASET_CLASSES
from sast_tpu_torch.eval.coco import evaluate_coco_ap

BBOX_DTYPE = np.dtype(
    {
        "names": ["t", "x", "y", "w", "h", "class_id", "track_id", "class_confidence"],
        "formats": ["<i8", "<f4", "<f4", "<f4", "<f4", "<u4", "<u4", "<f4"],
        "offsets": [0, 8, 12, 16, 20, 24, 28, 32],
        "itemsize": 40,
    }
)


def filter_boxes(
    boxes: np.ndarray,
    skip_ts: int = int(5e5),
    min_box_diag: int = 60,
    min_box_side: int = 20,
) -> np.ndarray:
    """psee filter: drop boxes before skip_ts, tiny diagonals, thin sides
    (io/box_filtering.py:18-36)."""
    ts = boxes["t"]
    w, h = boxes["w"], boxes["h"]
    mask = (
        (ts > skip_ts)
        & (w ** 2 + h ** 2 >= min_box_diag ** 2)
        & (w >= min_box_side)
        & (h >= min_box_side)
    )
    return boxes[mask]


def detections_to_prophesee(
    dets: Dict[str, np.ndarray], frame_times_us: Sequence[int]
) -> List[np.ndarray]:
    """Fixed-budget device detections -> list of structured arrays per frame.

    dets: dict of (F, K, ...) arrays from ops/nms.postprocess (already on
    host); frame_times_us: per-frame label timestamp stamped onto the
    predictions (io/box_loading.py:91 semantics).
    """
    out = []
    F = dets["valid"].shape[0]
    assert len(frame_times_us) == F
    for f in range(F):
        valid = np.asarray(dets["valid"][f], bool)
        n = int(valid.sum())
        arr = np.zeros((n,), BBOX_DTYPE)
        if n:
            boxes = np.asarray(dets["boxes"][f][valid], np.float32)  # xyxy
            arr["t"] = int(frame_times_us[f])
            arr["x"] = boxes[:, 0]
            arr["y"] = boxes[:, 1]
            arr["w"] = boxes[:, 2] - boxes[:, 0]
            arr["h"] = boxes[:, 3] - boxes[:, 1]
            arr["class_id"] = np.asarray(dets["classes"][f][valid], np.uint32)
            arr["class_confidence"] = np.asarray(dets["cls_conf"][f][valid], np.float32)
        out.append(arr)
    return out


def match_times(
    all_ts: np.ndarray,
    gt_boxes: np.ndarray,
    dt_boxes: np.ndarray,
    time_tol: int,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Window GT (exact timestamp) and detections (+- time_tol) around each
    GT timestamp (metrics/coco_eval.py:55-90). Both inputs time-sorted."""
    gt_t = gt_boxes["t"]
    dt_t = dt_boxes["t"]
    windowed_gt, windowed_dt = [], []
    for ts in all_ts:
        g_lo = np.searchsorted(gt_t, ts, side="left")
        g_hi = np.searchsorted(gt_t, ts, side="right")
        d_lo = np.searchsorted(dt_t, ts - time_tol, side="left")
        d_hi = np.searchsorted(dt_t, ts + time_tol, side="right")
        windowed_gt.append(gt_boxes[g_lo:g_hi])
        windowed_dt.append(dt_boxes[d_lo:d_hi])
    return windowed_gt, windowed_dt


def _structured_to_plain(boxes: np.ndarray, with_scores: bool):
    entry = {
        "boxes": np.stack(
            [boxes["x"], boxes["y"], boxes["w"], boxes["h"]], axis=-1
        ).astype(np.float64)
        if len(boxes)
        else np.zeros((0, 4)),
        "classes": boxes["class_id"].astype(np.int64),
    }
    if with_scores:
        entry["scores"] = boxes["class_confidence"].astype(np.float64)
    return entry


def evaluate_detection(
    gt_boxes_list: Sequence[np.ndarray],
    dt_boxes_list: Sequence[np.ndarray],
    classes: Sequence[str],
    time_tol: int = 50_000,
) -> Dict[str, float]:
    """Time-window match + COCO AP (metrics/coco_eval.py:25-52)."""
    flat_gt: List[np.ndarray] = []
    flat_dt: List[np.ndarray] = []
    for gt, dt in zip(gt_boxes_list, dt_boxes_list):
        gt = np.sort(gt, order="t") if len(gt) else gt
        dt = np.sort(dt, order="t") if len(dt) else dt
        all_ts = np.unique(gt["t"])
        g, d = match_times(all_ts, gt, dt, time_tol)
        flat_gt += g
        flat_dt += d

    if sum(len(d) for d in flat_dt) == 0:
        return {k: 0.0 for k in ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L")}

    gt_imgs = [_structured_to_plain(g, with_scores=False) for g in flat_gt]
    dt_imgs = [_structured_to_plain(d, with_scores=True) for d in flat_dt]
    return evaluate_coco_ap(gt_imgs, dt_imgs, num_classes=len(classes))


class PropheseeEvaluator:
    """Buffered label/prediction accumulator ."""

    LABELS = "lab"
    PREDICTIONS = "pred"

    def __init__(self, dataset: str, downsample_by_2: bool = False):
        assert dataset in DATASET_CLASSES, dataset
        self.dataset = dataset
        self.downsample_by_2 = downsample_by_2
        self._buffer: Dict[str, List[np.ndarray]] = {
            self.LABELS: [],
            self.PREDICTIONS: [],
        }

    def add_labels(self, labels: List[np.ndarray]) -> None:
        self._buffer[self.LABELS].extend(labels)

    def add_predictions(self, preds: List[np.ndarray]) -> None:
        self._buffer[self.PREDICTIONS].extend(preds)

    def has_data(self) -> bool:
        return bool(self._buffer[self.LABELS])

    def reset_buffer(self) -> None:
        self._buffer = {self.LABELS: [], self.PREDICTIONS: []}

    def gather_across_processes(self, allgather_fn=None) -> None:
        """Merge every process's label/prediction buffers into this one, so
        ``evaluate_buffer`` computes the GLOBAL metric on every rank:
        evaluating the union of all ranks' clips equals the single-process
        metric, where averaging per-rank APs only approximates it.

        ``allgather_fn`` maps ``buffer -> [buffer_rank0, buffer_rank1, ...]``;
        the default is ``parallel.mesh.allgather_host_objects`` over the
        default process group (a single process keeps its own buffer).
        """
        if allgather_fn is None:
            from sast_tpu_torch.parallel.mesh import allgather_host_objects as allgather_fn
        buffers = allgather_fn(self._buffer)
        self._buffer = {
            k: [item for b in buffers for item in b[k]]
            for k in (self.LABELS, self.PREDICTIONS)
        }

    def evaluate_buffer(self, img_height: int, img_width: int) -> Optional[Dict[str, float]]:
        """Run the Prophesee COCO protocol over the buffered GT/predictions.

        ``img_height``/``img_width`` are accepted for the JAX evaluator's
        signature and unused: the numpy COCO evaluator (eval/coco.py) needs
        no image dimensions (no box clipping, areas from box wh)."""
        labels = self._buffer[self.LABELS]
        preds = self._buffer[self.PREDICTIONS]
        if not labels:
            return None
        assert len(labels) == len(preds), (len(labels), len(preds))

        min_box_diag = 60 if self.dataset == "gen4" else 30
        min_box_side = 20 if self.dataset == "gen4" else 10
        if self.downsample_by_2:
            min_box_diag //= 2
            min_box_side //= 2

        gt_list = [
            filter_boxes(b, int(5e5), min_box_diag, min_box_side) for b in labels
        ]
        dt_list = [
            filter_boxes(b, int(5e5), min_box_diag, min_box_side) for b in preds
        ]
        return evaluate_detection(
            gt_list, dt_list, classes=DATASET_CLASSES[self.dataset]
        )
