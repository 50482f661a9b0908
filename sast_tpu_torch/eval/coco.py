"""COCO-protocol detection AP in pure numpy (the port's own copy of
sast_tpu/eval/coco.py).

The COCOeval bbox protocol: greedy per-image score-ordered matching at IoU
thresholds 0.50:0.05:0.95, area-range ignore handling, 101-point
interpolated precision, giving AP, AP_50, AP_75, AP_S, AP_M and AP_L.
Inputs are per-image lists of plain arrays; no JSON/COCO-dataset detour.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def iou_xywh(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """IoU between det boxes (D, 4) and gt boxes (G, 4), xywh format."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    ix = np.clip(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]),
        0,
        None,
    )
    iy = np.clip(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]),
        0,
        None,
    )
    inter = ix * iy
    area_d = (d[:, 2] * d[:, 3])[:, None]
    area_g = (g[:, 2] * g[:, 3])[None]
    return inter / np.maximum(area_d + area_g - inter, 1e-12)


def _evaluate_img(dt_boxes, dt_scores, gt_boxes, area_rng):
    """Greedy matching for one (image, category, area-range).

    Returns dict with per-threshold det matches/ignores and gt ignore flags,
    dets pre-sorted by score (mirrors pycocotools evaluateImg).
    """
    T = len(IOU_THRS)
    g_area = gt_boxes[:, 2] * gt_boxes[:, 3] if len(gt_boxes) else np.zeros((0,))
    gt_ig = (g_area < area_rng[0]) | (g_area > area_rng[1])

    # gts sorted: non-ignored first (stable)
    g_order = np.argsort(gt_ig, kind="stable")
    gt_boxes = gt_boxes[g_order]
    gt_ig = gt_ig[g_order]

    d_order = np.argsort(-dt_scores, kind="stable")[:MAX_DETS]
    dt_boxes = dt_boxes[d_order]
    dt_scores = dt_scores[d_order]

    ious = iou_xywh(dt_boxes, gt_boxes)
    D, G = len(dt_boxes), len(gt_boxes)
    dtm = np.zeros((T, D), np.int64)  # matched gt index + 1 (0 = unmatched)
    dt_ig = np.zeros((T, D), bool)
    gtm = np.zeros((T, G), bool)

    for ti, t in enumerate(IOU_THRS):
        for di in range(D):
            best_iou = min(t, 1 - 1e-10)
            m = -1
            for gi in range(G):
                if gtm[ti, gi]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[gi]:
                    break  # remaining gts are all ignored; keep current match
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = m + 1
            dt_ig[ti, di] = gt_ig[m]
            gtm[ti, m] = True

    d_area = dt_boxes[:, 2] * dt_boxes[:, 3]
    d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
    dt_ig = dt_ig | ((dtm == 0) & d_out[None, :])

    return {
        "dtm": dtm,
        "dt_ig": dt_ig,
        "scores": dt_scores,
        "num_gt": int((~gt_ig).sum()),
    }


def evaluate_coco_ap(
    gt_per_image: List[Dict[str, np.ndarray]],
    dt_per_image: List[Dict[str, np.ndarray]],
    num_classes: int,
) -> Dict[str, float]:
    """COCO bbox AP over per-image box dicts.

    Each image entry: {'boxes': (N, 4) xywh, 'classes': (N,), and for dets
    'scores': (N,)}.

    Returns {'AP', 'AP_50', 'AP_75', 'AP_S', 'AP_M', 'AP_L'}.
    """
    assert len(gt_per_image) == len(dt_per_image)
    T = len(IOU_THRS)
    results = {}
    ap_per_area: Dict[str, np.ndarray] = {}

    for area_name, area_rng in AREA_RNG.items():
        # precision[t, r, k] per category k
        precisions = -np.ones((T, len(REC_THRS), num_classes))
        for k in range(num_classes):
            per_img = []
            for gt, dt in zip(gt_per_image, dt_per_image):
                g_sel = gt["classes"] == k
                d_sel = dt["classes"] == k
                per_img.append(
                    _evaluate_img(
                        dt["boxes"][d_sel],
                        dt["scores"][d_sel],
                        gt["boxes"][g_sel],
                        area_rng,
                    )
                )
            npig = sum(e["num_gt"] for e in per_img)
            if npig == 0:
                continue
            scores = np.concatenate([e["scores"] for e in per_img])
            order = np.argsort(-scores, kind="mergesort")
            dtm = np.concatenate([e["dtm"] for e in per_img], axis=1)[:, order]
            dt_ig = np.concatenate([e["dt_ig"] for e in per_img], axis=1)[:, order]

            tps = (dtm > 0) & ~dt_ig
            fps = (dtm == 0) & ~dt_ig
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti in range(T):
                tp, fp = tp_sum[ti], fp_sum[ti]
                rc = tp / npig
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                q = np.zeros(len(REC_THRS))
                # monotone decreasing envelope
                for i in range(len(pr) - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                inds = np.searchsorted(rc, REC_THRS, side="left")
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precisions[ti, :, k] = q
        ap_per_area[area_name] = precisions

    def _mean_ap(precisions, thr_idx=None):
        p = precisions if thr_idx is None else precisions[thr_idx : thr_idx + 1]
        valid = p[p > -1]
        return float(valid.mean()) if valid.size else 0.0

    p_all = ap_per_area["all"]
    results["AP"] = _mean_ap(p_all)
    results["AP_50"] = _mean_ap(p_all, 0)
    results["AP_75"] = _mean_ap(p_all, 5)
    results["AP_S"] = _mean_ap(ap_per_area["small"])
    results["AP_M"] = _mean_ap(ap_per_area["medium"])
    results["AP_L"] = _mean_ap(ap_per_area["large"])
    return results
