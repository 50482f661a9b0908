"""Batched fixed-budget NMS (port of sast_tpu/ops/nms.py ``postprocess``).

Per image: best class per anchor, confidence obj * cls, the ``pre_nms_topk``
best candidates in score order, class-aware greedy NMS through the
coordinate-offset trick (boxes of different classes are moved far apart,
so one class-agnostic pass is exact per-class NMS), and a fixed
``max_detections`` slate with a validity mask. The keep mask is the greedy
keep kernel (ops/nms_keep.py), batched across images.
"""

from __future__ import annotations

from typing import Dict

import torch

from sast_tpu_torch.ops.nms_keep import greedy_keep


def select_sorted(keep: torch.Tensor, max_out: int):
    """(N, K) keep mask -> the first ``max_out`` kept positions per row
    (N, max_out) and their validity; empty slots are index 0, invalid."""
    N, K = keep.shape
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot = torch.where(keep & (rank < max_out), rank, torch.full_like(rank, max_out))
    out = torch.full((N, max_out + 1), K, dtype=torch.int64, device=keep.device)
    src = torch.arange(K, device=keep.device).expand(N, K)
    # Only the overflow column max_out receives several writes; it is dropped.
    out.scatter_(1, slot, src)
    out = out[:, :max_out]
    valid = out < K
    return torch.where(valid, out, torch.zeros_like(out)), valid


def postprocess(
    preds: torch.Tensor,
    num_classes: int,
    conf_threshold: float,
    nms_threshold: float,
    pre_nms_topk: int = 1000,
    max_detections: int = 300,
    class_agnostic: bool = False,
) -> Dict[str, torch.Tensor]:
    """(B, A, 5 + n_cls) decoded preds with sigmoid obj/cls -> dict of
    (B, max_detections, ...): boxes (xyxy), scores, obj_conf, cls_conf,
    classes (-1 where invalid), valid."""
    xy, wh = preds[..., :2], preds[..., 2:4]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
    obj = preds[..., 4]
    cls_conf, cls_id = preds[..., 5 : 5 + num_classes].max(dim=-1)
    score = obj * cls_conf
    score = torch.where(score >= conf_threshold, score, torch.zeros_like(score))

    # Top-k as a stable descending sort: ties keep the lower index first,
    # like jax.lax.top_k (torch.topk promises no order among ties).
    k = min(pre_nms_topk, score.shape[1])
    top_scores, top_idx = torch.sort(score, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls_id, 1, top_idx)
    if class_agnostic:
        nms_boxes = top_boxes
    else:
        span = top_boxes.amax(dim=(1, 2)) + 1.0  # (B,)
        nms_boxes = top_boxes + (top_cls.to(top_boxes.dtype) * span[:, None])[..., None]
    keep = greedy_keep(nms_boxes, top_scores, nms_threshold)

    safe, valid = select_sorted(keep, max_detections)
    vf = valid.to(preds.dtype)

    def take(v: torch.Tensor) -> torch.Tensor:
        return torch.gather(v, 1, safe)

    return {
        "boxes": torch.gather(top_boxes, 1, safe[..., None].expand(-1, -1, 4)) * vf[..., None],
        "scores": take(top_scores) * vf,
        "obj_conf": take(torch.gather(obj, 1, top_idx)) * vf,
        "cls_conf": take(torch.gather(cls_conf, 1, top_idx)) * vf,
        "classes": torch.where(valid, take(top_cls), torch.full_like(safe, -1)),
        "valid": valid,
    }
