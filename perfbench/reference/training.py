"""The detector's training step in plain PyTorch: the yardstick's reference.

One step of truncated backpropagation through time, as the published
recipe trains (YOLOX head, SimOTA assignment, AdamW): lanes flagged
``is_first`` start from a zero state; the backbone runs over the clip's T
frames with the carried state; the neck and head run on each lane's
labeled-frame slots (``frame_tidx``, padding slots included, as the static
budget has them) with BatchNorm on the batch's statistics; the YOLOX loss
(IoU 1 - iou^2 weighted 5, objectness and class BCE over the foreground
count) under a static SimOTA over ``max_gt`` padded boxes; autograd's
gradients, clipped by value at ``clip``; AdamW (b1 0.9, b2 0.999, eps 1e-8,
the rate of the count before the update, bias corrections at the count
after it) under the one-cycle schedule (a linear warm-up from peak / 20
over ``pct_start`` of the steps, then linear decay to peak / 1e4).
The EMA copy and BatchNorm's running statistics play no part in a
training step's loss and are not kept here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import detector as R

B1, B2, EPS = 0.9, 0.999, 1e-8


def box_iou(a, b):
    """(F, G, 4) x (F, A, 4) cxcywh -> (F, G, A)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    tl = torch.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    br = torch.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    inter = (br - tl).prod(dim=-1) * (tl < br).all(dim=-1)
    return inter / (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter + 1e-12)


def iou_loss(p, t):
    tl = torch.maximum(p[..., :2] - p[..., 2:] / 2, t[..., :2] - t[..., 2:] / 2)
    br = torch.minimum(p[..., :2] + p[..., 2:] / 2, t[..., :2] + t[..., 2:] / 2)
    inter = (br - tl).prod(dim=-1) * (tl < br).all(dim=-1)
    iou = inter / (p[..., 2] * p[..., 3] + t[..., 2] * t[..., 3] - inter + 1e-16)
    return 1.0 - iou ** 2


def bce_logits(x, t):
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _first(hit, dim):
    n = hit.shape[dim]
    shape = [1] * hit.dim()
    shape[dim] = n
    idx = torch.arange(n, device=hit.device).reshape(shape)
    first = torch.where(hit, idx, n).amin(dim=dim)
    return torch.where(first == n, 0, first)


@torch.no_grad()
def simota(boxes, obj, cls, gt, gcls, gvalid, grids, strides, num_classes, topk=10):
    """Static SimOTA over F frames: anchors whose centre lies within 1.5
    strides of a box's centre are its candidates; dynamic k is the sum of a
    box's 10 best IoUs, truncated, at least 1; the cost is the class BCE of
    sqrt(class x objectness) plus 3 x -log IoU; each box takes its k
    cheapest anchors (stable order), and an anchor claimed twice keeps its
    cheapest box."""
    A, G = boxes.shape[1], gt.shape[1]
    gcls = gcls.long()
    centres = (grids + 0.5) * strides[:, None]
    inside = ((gt[:, :, None, :2] - centres[None, None]).abs()
              < (1.5 * strides)[None, None, :, None]).all(dim=-1) & gvalid[:, :, None]
    union = inside.any(dim=1)
    iou = box_iou(gt, boxes) * gvalid[:, :, None]
    k_cap = min(topk, A)
    dyn = torch.topk(iou * union[:, None, :], k_cap, dim=-1).values.sum(-1).to(torch.int32)
    dyn = dyn.clamp_min(1)
    p = torch.sqrt(torch.sigmoid(cls) * torch.sigmoid(obj)[..., None])[:, None]
    onehot = F.one_hot(gcls, num_classes).to(torch.float32)[:, :, None]
    pc = p.clamp(1e-12, 1.0 - 1e-12)
    cls_cost = -(onehot * torch.log(pc) + (1.0 - onehot) * torch.log(1.0 - pc)).sum(-1)
    cost = (cls_cost + 3.0 * -torch.log(iou + 1e-8) + 1e6 * (~inside)
            + 1e6 * (~union)[:, None, :] + 1e9 * (~gvalid)[:, :, None])
    cand = torch.sort(cost, dim=-1, stable=True).indices[..., :k_cap]
    ok = (torch.arange(k_cap, device=cost.device)[None, None] < dyn.clamp_max(k_cap)[..., None])
    ok = ok & gvalid[:, :, None]
    match = torch.zeros_like(cost).scatter_(2, cand, ok.to(cost.dtype))
    best = _first(cost == cost.amin(dim=1, keepdim=True), dim=1)
    single = F.one_hot(best, G).to(cost.dtype).transpose(1, 2)
    match = torch.where(match.sum(dim=1)[:, None, :] > 1, single, match)
    fg = match.sum(dim=1) > 0
    mgt = _first(match == match.amax(dim=1, keepdim=True), dim=1)
    piou = (match * iou).sum(dim=1)
    cls_t = F.one_hot(gcls.gather(1, mgt), num_classes).to(torch.float32) * piou[..., None]
    return dict(fg=fg, cls_t=torch.where(fg[..., None], cls_t, 0.0),
                reg_t=gt.gather(1, mgt[..., None].expand(-1, -1, 4)),
                num_fg=fg.to(torch.float32).sum(1), num_gt=gvalid.to(torch.float32).sum(1))


def yolox_loss(preds, grids, strides, gt, gcls, gvalid, fvalid, num_classes, topk=10):
    boxes, obj, cls = preds[..., :4], preds[..., 4], preds[..., 5:]
    gvalid = gvalid & fvalid[:, None]
    a = simota(boxes.detach(), obj.detach(), cls.detach(), gt, gcls, gvalid, grids, strides,
               num_classes, topk)
    fv = fvalid.to(torch.float32)
    fg = (a["fg"] & fvalid[:, None]).to(torch.float32)
    num_fg = (a["num_fg"] * fv).sum().clamp_min(1.0)
    l_iou = (iou_loss(boxes, a["reg_t"]) * fg).sum() / num_fg
    l_obj = (bce_logits(obj, fg) * fv[:, None]).sum() / num_fg
    l_cls = (bce_logits(cls, a["cls_t"]) * fg[..., None]).sum() / num_fg
    return 5.0 * l_iou + l_obj + l_cls, l_obj.detach() * num_fg


def one_cycle(count: int, peak: float, total: int, pct_start: float, div: float,
              final_div: float) -> float:
    warm = max(int(total * pct_start), 1)
    lo, hi = peak / div, peak / final_div
    if count < warm:
        return lo + (peak - lo) * count / warm
    return peak + (hi - peak) * min(count - warm, total - warm) / (total - warm)


def forward_loss(P, sz: R.Sizes, batch: Dict[str, torch.Tensor], state: R.State, q: R.Q,
                 topk: int = 10):
    """(loss, the objectness term summed over every anchor before its
    division by the foreground count, carried-out state) of one batch on
    the card, from ``state``."""
    ev = batch["ev_repr"]
    T, B = ev.shape[:2]
    h, w = sz.sensor_hw
    first = batch["is_first"].view(-1, 1, 1, 1)
    state = [tuple(torch.where(first, 0.0, t) for t in hc) for hc in state]
    feats = {s: [] for s in sz.in_stages}
    pos = {}

    def frame(x, *flat):
        f, new, _ = R.backbone(P, sz, x, list(zip(flat[0::2], flat[1::2])), q, pos)
        return tuple(f[s] for s in sz.in_stages) + tuple(t for hc in new for t in hc)

    n = len(sz.in_stages)
    for t in range(T):
        x = R.pad_to(ev[t].reshape(B, h, w, sz.in_ch), sz.model_hw)
        # Each frame's activations are recomputed in the backward, so that a
        # float32 step of the published batch fits beside nothing else.
        out = checkpoint(frame, x, *(s for hc in state for s in hc), use_reentrant=False)
        state = list(zip(out[n::2], out[n + 1::2]))
        for s, f in zip(sz.in_stages, out[:n]):
            feats[s].append(f)
    tidx = batch["frame_tidx"].long()
    L = tidx.shape[1]
    lane = torch.arange(B, device=ev.device)[:, None]
    sel = {s: torch.stack(v)[tidx, lane].reshape(B * L, *v[0].shape[1:]) for s, v in feats.items()}
    preds, grids, strides = R.head(P, sz, R.neck(P, sz, sel, q, train=True), q, train=True)
    loss, obj_sum = yolox_loss(preds, grids, strides, batch["gt_boxes"].reshape(B * L, -1, 4),
                               batch["gt_classes"].reshape(B * L, -1),
                               batch["gt_valid"].reshape(B * L, -1),
                               batch["frame_valid"].reshape(B * L), sz.num_classes, topk)
    return loss, obj_sum, [tuple(t.detach() for t in hc) for hc in state]


class AdamW:
    """optax's clip-by-value then AdamW over a dict of float32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule, clip: float,
                 weight_decay: float = 0.0):
        self.schedule, self.clip, self.wd = schedule, clip, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for k, p in params.items():
            g = grads[k].clamp(-self.clip, self.clip)
            self.m[k].mul_(B1).add_(g, alpha=1.0 - B1)
            self.v[k].mul_(B2).add_(g * g, alpha=1.0 - B2)
            u = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + EPS)
            if self.wd:
                u = u + self.wd * p
            p.sub_(lr * u)


def train_steps(P: Dict[str, torch.Tensor], sz: R.Sizes, batches: List[Dict[str, torch.Tensor]],
                trainable: List[str], opt: AdamW, q: R.Q = R.identity,
                state: Optional[R.State] = None):
    """Run ``batches`` in turn from ``state`` (zero where None), updating the
    leaves named ``trainable`` of ``P`` in place. Returns the losses, the
    objectness sums and the first step's gradients (clipped)."""
    lanes = batches[0]["ev_repr"].shape[1]
    state = state or R.zero_state(sz, lanes, batches[0]["ev_repr"].device)
    losses, obj_sums, first = [], [], None
    for batch in batches:
        leaves = {k: P[k].detach().requires_grad_(True) for k in trainable}
        loss, obj_sum, state = forward_loss({**P, **leaves}, sz, batch, state, q)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(P[k]) if g is None else g for k, g in zip(leaves, grads)}
        if first is None:
            first = {k: g.clamp(-opt.clip, opt.clip) for k, g in grads.items()}
        opt.step({k: P[k] for k in trainable}, grads)
        losses.append(float(loss.detach()))
        obj_sums.append(float(obj_sum))
    return losses, obj_sums, first
