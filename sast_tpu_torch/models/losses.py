"""YOLOX losses with a batched, static-shape SimOTA assignment (port of
sast_tpu/models/losses.py).

The JAX package writes ``simota_assign`` for one frame and ``vmap``s it; here
every function carries the frame axis itself: ``(F, G, ...)`` ground truth
padded to ``max_gt`` with validity masks against ``(F, A, ...)`` anchors.

- geometry constraint: anchor centre within 1.5 strides of the box centre;
- dynamic k from the sum of the top-k IoUs per ground-truth box, truncated
  to an integer, at least 1;
- per box the ``dynamic_k`` cheapest anchors (ties: lowest anchor index, as
  ``lax.top_k`` breaks them; ``torch.topk`` has no tie order, so the cost is
  sorted stably);
- an anchor matched to several boxes keeps the cheapest (ties: lowest box
  index, as ``argmin``).

Losses: IoU (1 - iou^2), BCE-with-logits objectness over all anchors,
BCE-with-logits class over foreground, reg_weight 5. The assignment carries
no gradient.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from sast_tpu_torch.parallel.mesh import Mesh


def bboxes_iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a: (..., G, 4), b: (..., A, 4), cxcywh. Returns (..., G, A)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    tl = torch.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    br = torch.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    valid = (tl < br).all(dim=-1)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * valid
    return area_i / (area_a + area_b - area_i + 1e-12)


def iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise 1 - iou^2 on cxcywh boxes. pred/target: (..., 4)."""
    tl = torch.maximum(pred[..., :2] - pred[..., 2:] / 2, target[..., :2] - target[..., 2:] / 2)
    br = torch.minimum(pred[..., :2] + pred[..., 2:] / 2, target[..., :2] + target[..., 2:] / 2)
    area_p = pred[..., 2] * pred[..., 3]
    area_g = target[..., 2] * target[..., 3]
    valid = (tl < br).all(dim=-1)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * valid
    iou = area_i / (area_p + area_g - area_i + 1e-16)
    return 1.0 - iou ** 2


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross-entropy with logits."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _bce_probs(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    p = p.clamp(eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _first_index_of(hit: torch.Tensor, dim: int) -> torch.Tensor:
    """Lowest index along ``dim`` where ``hit`` is true (0 where none is)."""
    n = hit.shape[dim]
    shape = [1] * hit.dim()
    shape[dim] = n
    idx = torch.arange(n, device=hit.device).reshape(shape)
    first = torch.where(hit, idx, n).amin(dim=dim)
    return torch.where(first == n, 0, first)


@torch.no_grad()
def simota_assign(
    bbox_preds: torch.Tensor,   # (F, A, 4) cxcywh, input pixels
    obj_logits: torch.Tensor,   # (F, A)
    cls_logits: torch.Tensor,   # (F, A, n_cls)
    gt_boxes: torch.Tensor,     # (F, G, 4) cxcywh
    gt_classes: torch.Tensor,   # (F, G) integer
    gt_valid: torch.Tensor,     # (F, G) bool
    grids: torch.Tensor,        # (A, 2)
    strides: torch.Tensor,      # (A,)
    num_classes: int,
    topk: int = 10,
) -> Dict[str, torch.Tensor]:
    """SimOTA over F frames at once. Returns per-anchor targets:
    ``fg_mask`` (F, A) bool, ``cls_target`` (F, A, n_cls), ``reg_target``
    (F, A, 4), ``num_fg`` and ``num_gt`` (F,)."""
    A = bbox_preds.shape[1]
    G = gt_boxes.shape[1]
    gt_classes = gt_classes.long()

    # Geometry constraint (centre radius 1.5 strides).
    centers = (grids + 0.5) * strides[:, None]  # (A, 2)
    center_dist = 1.5 * strides
    delta = (gt_boxes[:, :, None, :2] - centers[None, None]).abs()  # (F, G, A, 2)
    is_in_center = (delta < center_dist[None, None, :, None]).all(dim=-1)
    is_in_center = is_in_center & gt_valid[:, :, None]
    anchor_in_union = is_in_center.any(dim=1)  # (F, A)

    # Pairwise IoU and dynamic k.
    pair_iou = bboxes_iou_cxcywh(gt_boxes, bbox_preds) * gt_valid[:, :, None]  # (F, G, A)
    iou_for_k = pair_iou * anchor_in_union[:, None, :]
    topk_ious = torch.topk(iou_for_k, min(topk, A), dim=-1).values
    dynamic_k = topk_ious.sum(dim=-1).to(torch.int32).clamp_min(1)  # (F, G)

    # Cost matrix.
    cls_prob = torch.sqrt(
        torch.sigmoid(cls_logits.float()) * torch.sigmoid(obj_logits.float())[..., None]
    )  # (F, A, n)
    gt_onehot = F.one_hot(gt_classes, num_classes).to(torch.float32)  # (F, G, n)
    cls_cost = _bce_probs(cls_prob[:, None], gt_onehot[:, :, None]).sum(dim=-1)  # (F, G, A)
    iou_cost = -torch.log(pair_iou + 1e-8)
    cost = (
        cls_cost
        + 3.0 * iou_cost
        + 1e6 * (~is_in_center)
        + 1e6 * (~anchor_in_union)[:, None, :]
        + 1e9 * (~gt_valid)[:, :, None]
    )

    # Per box: the dynamic_k cheapest anchors, ties to the lowest index.
    k_cap = min(topk, A)
    cand_idx = torch.sort(cost, dim=-1, stable=True).indices[..., :k_cap]  # (F, G, k)
    rank_ok = (
        torch.arange(k_cap, device=cost.device)[None, None] < dynamic_k.clamp_max(k_cap)[..., None]
    ) & gt_valid[:, :, None]
    matching = torch.zeros_like(cost).scatter_(2, cand_idx, rank_ok.to(cost.dtype))

    # An anchor matched to several boxes keeps its cheapest box.
    col_sum = matching.sum(dim=1)  # (F, A)
    best_gt = _first_index_of(cost == cost.amin(dim=1, keepdim=True), dim=1)  # (F, A)
    single = F.one_hot(best_gt, G).to(cost.dtype).transpose(1, 2)  # (F, G, A)
    matching = torch.where(col_sum[:, None, :] > 1, single, matching)

    fg_mask = matching.sum(dim=1) > 0
    matched_gt = _first_index_of(matching == matching.amax(dim=1, keepdim=True), dim=1)
    pred_iou = (matching * pair_iou).sum(dim=1)  # (F, A)

    cls_target = (
        F.one_hot(gt_classes.gather(1, matched_gt), num_classes).to(torch.float32)
        * pred_iou[..., None]
    )
    cls_target = torch.where(fg_mask[..., None], cls_target, 0.0)
    reg_target = gt_boxes.gather(1, matched_gt[..., None].expand(-1, -1, 4))
    return {
        "fg_mask": fg_mask,
        "cls_target": cls_target,
        "reg_target": reg_target,
        "num_fg": fg_mask.to(torch.float32).sum(dim=1),
        "num_gt": gt_valid.to(torch.float32).sum(dim=1),
    }


def yolox_loss(
    preds: torch.Tensor,        # (F, A, 5 + n_cls): decoded cxcywh + logit obj/cls
    grids: torch.Tensor,        # (A, 2)
    strides: torch.Tensor,      # (A,)
    gt_boxes: torch.Tensor,     # (F, G, 4) cxcywh
    gt_classes: torch.Tensor,   # (F, G) integer
    gt_valid: torch.Tensor,     # (F, G) bool
    frame_valid: torch.Tensor,  # (F,) bool: padding frames contribute nothing
    num_classes: int,
    topk: int = 10,
    mesh: Optional[Mesh] = None,
) -> Dict[str, torch.Tensor]:
    """Batched YOLOX detection loss over F frames with padded GT/frames.

    With ``mesh`` (a world of more than one process) the normalisers are
    global: the foreground and GT counts are summed over the ranks before
    the division, so each rank's loss is its own sum over the global
    ``num_fg``, and the ranks' losses and gradients sum to the global
    batch's (JAX's GSPMD sums)."""
    preds = preds.to(torch.float32)
    bbox_preds = preds[..., :4]
    obj_logits = preds[..., 4]
    cls_logits = preds[..., 5:]
    gt_valid = gt_valid & frame_valid[:, None]

    assign = simota_assign(
        bbox_preds.detach(), obj_logits.detach(), cls_logits.detach(), gt_boxes, gt_classes,
        gt_valid, grids, strides, num_classes, topk,
    )
    fv = frame_valid.to(torch.float32)
    fg = assign["fg_mask"] & frame_valid[:, None]  # (F, A)
    fg_f = fg.to(torch.float32)
    num_fg_sum = (assign["num_fg"] * fv).sum()
    num_gt_sum = assign["num_gt"].sum()
    if mesh is not None and mesh.size > 1:
        counts = torch.stack((num_fg_sum, num_gt_sum))
        dist.all_reduce(counts)
        num_fg_sum, num_gt_sum = counts[0], counts[1]
    num_fg = num_fg_sum.clamp_min(1.0)
    num_gts = num_gt_sum.clamp_min(1.0)

    loss_iou = (iou_loss(bbox_preds, assign["reg_target"]) * fg_f).sum() / num_fg
    loss_obj = (bce_with_logits(obj_logits, fg_f) * fv[:, None]).sum() / num_fg
    loss_cls = (bce_with_logits(cls_logits, assign["cls_target"]) * fg_f[..., None]).sum() / num_fg

    reg_weight = 5.0
    return {
        "loss": reg_weight * loss_iou + loss_obj + loss_cls,
        "iou_loss": reg_weight * loss_iou,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "num_fg": num_fg_sum / num_gts,
    }
