"""Whether a serve cell's window served right: the program's slates and
carried state against the reference, frame by frame from the program's own
state.

The plan (drawn from the seed): ``check_triples`` runs of three consecutive
batches, each centred on a batch at which one lane's stream starts anew
(its reset), among the first ``check_horizon`` batches of the window; in
each, that lane and ``check_lanes - 1`` others drawn from the seed. Around
those batches the run copies the lanes' carried state (before each batch,
and after the last), and keeps their slates and events.

After the window, with the program gone from the card, the reference
serves each of those frames from the state that the program carried into
it (zero where the lane was reset) and the same events, in float32. Two
readings of the whole check, each against its limit in
``limits/<cell>.json`` where that file compares it (a reading it leaves
out is printed and not compared):

- ``state_gap``: the worst over lanes, frames, stages and the two halves of
  the LSTM state of ||program - reference|| / ||reference||, the state that
  the program carried out of the frame against the reference's: the
  backbone, its window selection, attention and ConvLSTM, and the carry;
- ``slate_miss``: of the score of every detection on either slate, the
  share that has no partner on the other (same class, IoU >= 0.5 with each
  box taken at least ``MIN_BOX_PX`` wide and high about its centre,
  matched greedily by score): the head, the decoding and the NMS.

The reference follows the program frame by frame and does not replay the
whole stream: over hundreds of recurrent frames the window selection's
choices at its threshold part the two streams, and the reading would be of
that parting. The start from a zero state is checked at the reset lane, and
the carry by the state that the program handed to the next frame.

Departures from plain IoU matching, each with its reason:

- A box narrower or lower than one pixel of the model's input is compared
  as if it were one pixel in that direction, about its own centre. The
  input is a histogram of pixels, so a detection has no extent below one
  of them; with the stand-in weights a slate can be made of boxes 0.1-0.5
  pixels wide, where the bfloat16 rounding of the head's box logits moves
  an edge by up to 0.4 pixels and IoU >= 0.5 then demands agreement below
  the configuration's precision. Measured on an H100 (gen4-base, seed
  2600000045, PERF.md §6): such slates read 0.31 under plain IoU and 0.012
  with the floor, the fp8 control 0.90 and 0.82. A box of a pixel or more
  is matched as before, and one under a pixel moved by a pixel or more
  still has no partner.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import detector as R
from perfbench.reference.precision import PRECISIONS
from perfbench.weights import make_weights

MATCH_IOU = 0.5
MIN_BOX_PX = 1.0


class Plan:
    def __init__(self, mix: dict, gen, seed: int, first: int):
        rng = np.random.Generator(np.random.PCG64([seed, 7]))
        lanes = mix["lanes"]
        horizon = range(first + 1, first + mix["check_horizon"])
        at = [k for k in horizon if gen.resets(mix, k).any()]
        chosen = sorted(rng.choice(at, size=min(mix["check_triples"], len(at)), replace=False))
        self.triples = []
        for r in chosen:
            lane = int(np.flatnonzero(gen.resets(mix, r))[0])
            others = rng.choice([i for i in range(lanes) if i != lane],
                                size=mix["check_lanes"] - 1, replace=False)
            self.triples.append((int(r) - 1, [lane] + sorted(int(i) for i in others)))


class Seen:
    """What the run kept of the checked batches."""

    def __init__(self, plan: Plan):
        self.want = {}
        for first, lanes in plan.triples:
            for j in range(3):
                self.want[first + j] = (first, j, lanes)
        self.before_state: Dict[int, list] = {}
        self.after_state: Dict[int, list] = {}
        self.kept: Dict[int, dict] = {}

    def done(self) -> bool:
        return all(k in self.kept for k in self.want)

    @staticmethod
    def _states(det, lanes):
        idx = torch.tensor(lanes, device=det.states[0][0].device)
        return [tuple(t.index_select(0, idx).float() for t in hc) for hc in det.states]

    def before(self, k: int, det) -> None:
        if k in self.want:
            self.before_state[k] = self._states(det, self.want[k][2])

    def after(self, k: int, det, out: dict, frames: list, reset: np.ndarray) -> None:
        if k not in self.want:
            return
        lanes = self.want[k][2]
        self.after_state[k] = self._states(det, lanes)
        self.kept[k] = dict(
            slate={n: np.asarray(out[n])[lanes].copy()
                   for n in ("boxes", "scores", "classes", "valid")},
            frames=[frames[i] for i in lanes], reset=np.asarray(reset, bool)[lanes].copy())

    def compare(self, cell, sizes: R.Sizes, seed: int, device,
                precision: str = "fp32") -> Dict[str, float]:
        """The readings, the reference computed in ``precision``."""
        R.fp32_only()
        P = make_weights(R.param_shapes(sizes), seed, device)
        q = PRECISIONS[precision]
        state_gap, miss, total, pos = 0.0, 0.0, 0.0, {}
        E = cell.mix["max_events"]
        with torch.no_grad():
            for k in sorted(self.want):
                got = self.kept[k]
                packed, n = pack(got["frames"], E, device)
                state = [tuple(torch.where(torch.from_numpy(got["reset"]).to(device)
                                           .view(-1, 1, 1, 1), 0.0, t) for t in hc)
                         for hc in self.before_state[k]]
                ref_slate, ref_state, _ = R.serve_frame(P, sizes, packed, n, state, q, pos)
                for (hp, cp), (hr, cr) in zip(self.after_state[k], ref_state):
                    for a, b in ((hp, hr), (cp, cr)):
                        gap = (a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)
                        state_gap = max(state_gap, float(gap.max()))
                ref = {n: v.cpu().numpy() for n, v in ref_slate.items()}
                for i in range(len(got["frames"])):
                    m, t = unmatched({n: v[i] for n, v in got["slate"].items()},
                                     {n: v[i] for n, v in ref.items()})
                    miss, total = miss + m, total + t
        return {"state_gap": state_gap, "slate_miss": miss / max(total, 1e-12)}


def pack(frames: List[dict], max_events: int, device):
    """Frames of raw events -> (S, E, 4) int32 [x, y, p, t] and (S,) counts."""
    packed = np.zeros((len(frames), max_events, 4), np.int32)
    n = np.zeros((len(frames),), np.int32)
    for i, f in enumerate(frames):
        c = len(f["x"])
        for j, key in enumerate("xypt"):
            packed[i, :c, j] = f[key]
        n[i] = c
    return torch.from_numpy(packed).to(device), torch.from_numpy(n).to(device)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 4) x (m, 4) xyxy -> (n, m)."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), axis=-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-12)


def _at_least(boxes: np.ndarray, px: float) -> np.ndarray:
    """(n, 4) xyxy boxes with each side at least ``px``, about their centres."""
    centre = (boxes[:, :2] + boxes[:, 2:]) / 2
    half = np.maximum((boxes[:, 2:] - boxes[:, :2]) / 2, px / 2)
    return np.concatenate([centre - half, centre + half], axis=1)


def unmatched(got: dict, ref: dict, min_px: float = MIN_BOX_PX):
    """Over both slates of one frame: (score without a partner, all score),
    every box taken at least ``min_px`` wide and high."""
    gv, rv = got["valid"].astype(bool), ref["valid"].astype(bool)
    gb, gs, gc = got["boxes"][gv], got["scores"][gv], got["classes"][gv]
    rb, rs, rc = ref["boxes"][rv], ref["scores"][rv], ref["classes"][rv]
    total = float(gs.sum() + rs.sum())
    if len(gb) == 0 or len(rb) == 0:
        return total, total
    iou = _iou(_at_least(rb, min_px), _at_least(gb, min_px))
    iou[rc[:, None] != gc[None, :]] = 0.0
    used = np.zeros(len(gb), bool)
    matched = 0.0
    for i in np.argsort(-rs, kind="stable"):
        cand = np.where(used, 0.0, iou[i])
        j = int(np.argmax(cand))
        if cand[j] >= MATCH_IOU:
            used[j] = True
            matched += float(rs[i] + gs[j])
    return total - matched, total
