"""Per-frame readout of a serve cell's check: where its readings come from.

    python3 perfbench/diagnose.py --workload <serve cell> --seeds <n> [<n> ...]
        [--control fp8] [--save <dir>]

For each seed, serves the cell's lanes through its checked batches as a run
does (the same set-up, warm-up and batches, no timed window), then, frame
by frame of ``Plan.triples``:

- the check's readings of each lane of that frame alone (its unmatched
  score, its share of the seed's, ``state_gap``), with the check's
  comparison and with plain IoU (no box taken at least one pixel), and the
  slate's narrower side of its boxes (10th and 50th percentile);
- the program's side again, from an eager run of its model on the same
  carried state and events (``--control``: the reference in that precision
  in the program's place), with each stage's kept windows and selected
  tokens, against the reference's; for each choice that differs, its
  softmax value against its threshold, ``(1/N)/(1+BOUNCE)`` for a window,
  ``(1/hw)/(1+BOUNCE)`` for a token, as a relative margin;
- the reference with the program's choices of windows and tokens forced
  (its slate against the program's), and the reference's NMS on the
  program's own predictions (against the program's slate, and against the
  reference's);
- on both sides: the candidates at or above the confidence threshold
  against ``pre_nms_topk``, the boxes NMS keeps against
  ``max_detections``, and the suppressions decided within 0.01 of the NMS
  threshold.

Prints one JSON line per seed. ``--save`` also writes each seed's slates,
the program's and the reference's (``<dir>/<cell>.<seed>.npz``). The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check_serve  # noqa: E402
from perfbench.common import Cell, card_or_refuse, free, log  # noqa: E402
from perfbench.reference import detector as R  # noqa: E402
from perfbench.reference.precision import PRECISIONS  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402

NEAR_IOU = 0.01


def _softmaxes(scores: torch.Tensor):
    """(B, N, hw, C) amplified scores -> the window and token softmax values
    that the selection compares, and their thresholds."""
    B, N, hw, C = scores.shape
    a = scores.to(torch.float32).abs()
    win = torch.softmax(a.sum(dim=(2, 3)) / torch.full((), float(hw), device=a.device), dim=-1)
    tok = torch.softmax(a.sum(dim=3), dim=-1)
    return win, tok, (1.0 / N) / (1.0 + R.BOUNCE), (1.0 / hw) / (1.0 + R.BOUNCE)


@contextlib.contextmanager
def recording(module, name: str, forced: List = None):
    """``module.name`` (a selection ``scores -> (win_keep, tok_keep)``)
    wrapped: each call's scores and choices appended to the list yielded;
    with ``forced``, the choices of the same call in ``forced`` returned in
    place of its own."""
    plain = getattr(module, name)
    seen = []

    def wrapped(scores, *args, **kwargs):
        win, tok = plain(scores, *args, **kwargs)
        if forced is not None:
            win, tok = forced[len(seen)][1], forced[len(seen)][2]
        seen.append((scores.detach().to(torch.float32).clone(), win.clone(), tok.clone()))
        return win, tok

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, plain)


def program_seen(cell, seed: int, device):
    """The program's checked batches, served as a run serves them, and
    every lane's carried state, events and resets before each of them."""
    from perfbench.program import program_config, program_model
    from sast_tpu_torch.serving import StreamingDetector

    mix, gen, sizes = cell.mix, cell.generator(), R.Sizes(cell.config)
    cfg = program_config(cell)
    weights = make_weights(R.param_shapes(sizes), seed, device)
    pool = gen.serve_pool(mix, sizes.sensor_hw, seed, device)
    det = StreamingDetector(cfg, program_model(cfg, weights, device), max_events=mix["max_events"],
                            num_streams=mix["lanes"], device=device)
    seen = check_serve.Seen(check_serve.Plan(mix, gen, seed, first=mix["warmup_batches"]))
    batches = {}
    for k in range(max(seen.want) + 1):
        frames = [pool[i][gen.pool_index(mix, i, k)] for i in range(mix["lanes"])]
        reset = gen.resets(mix, k)
        if k in seen.want:
            batches[k] = ([tuple(t.clone() for t in hc) for hc in det.states], frames, reset)
        seen.before(k, det)
        seen.after(k, det, det.process_batch(frames, reset), frames, reset)
    del det, weights
    free(device)
    return seen, batches


class ProgramFrame:
    """The program's eager step on one checked batch, all its lanes as the
    run served them: the checked lanes' slate, decoded predictions (logits)
    and selection choices."""

    def __init__(self, cell, seed: int, device, batches):
        from perfbench.program import program_config, program_model
        from sast_tpu_torch.serving import StreamingStep

        cfg = program_config(cell)
        weights = make_weights(R.param_shapes(R.Sizes(cell.config)), seed, device)
        model = program_model(cfg, weights, device)
        self.step = StreamingStep(cfg, model, cell.config["input_channels"] // 2,
                                  cell.config["count_cutoff"], torch.device(device))
        self.batches, self.E, self.device = batches, cell.mix["max_events"], device

    @torch.no_grad()
    def __call__(self, k: int, lanes: List[int]):
        from sast_tpu_torch import serving
        from sast_tpu_torch.models import sast

        states, frames, reset = self.batches[k]
        packed, n = check_serve.pack(frames, self.E, self.device)
        plain = serving.inference_outputs
        preds = []

        def keep_preds(p):
            preds.append(p.detach().to(torch.float32).clone())
            return plain(p)

        serving.inference_outputs = keep_preds
        try:
            with recording(sast, "select_windows_and_tokens") as sel:
                dets, _, _ = self.step(states, packed, n,
                                       torch.from_numpy(np.asarray(reset, bool)).to(self.device))
        finally:
            serving.inference_outputs = plain
        idx = torch.tensor(lanes, device=self.device)
        slate = {key: dets[key].cpu().numpy()[lanes] for key in ("boxes", "scores", "classes",
                                                                 "valid")}
        sel = [tuple(t.index_select(0, idx) for t in call) for call in sel]
        return slate, preds[0].index_select(0, idx), sel


class ControlFrame:
    """The control on one checked batch: the reference in a lower precision
    in the program's place, from the state it carried (its batches are the
    checked lanes alone)."""

    def __init__(self, cell, seed: int, precision: str, device, seen):
        self.sizes = R.Sizes(cell.config)
        self.P = make_weights(R.param_shapes(self.sizes), seed, device)
        self.q, self.pos, self.seen = PRECISIONS[precision], {}, seen
        self.E, self.device = cell.mix["max_events"], device

    @torch.no_grad()
    def __call__(self, k: int, lanes: List[int]):
        got = self.seen.kept[k]
        packed, n = check_serve.pack(got["frames"], self.E, self.device)
        keep = ~torch.from_numpy(got["reset"]).to(self.device).view(-1, 1, 1, 1)
        state = [tuple(torch.where(keep, t, 0.0) for t in hc) for hc in self.seen.before_state[k]]
        with recording(R, "select") as sel:
            slate, _, preds = R.serve_frame(self.P, self.sizes, packed, n, state, self.q, self.pos)
        return {key: v.cpu().numpy() for key, v in slate.items()}, preds, sel


def _lane(slate: dict, i: int) -> dict:
    return {k: v[i] for k, v in slate.items()}


def _nms_detail(sz: R.Sizes, preds: torch.Tensor):
    """Per lane: candidates at or above the confidence threshold, boxes NMS
    keeps among the top ``pre_nms_topk`` (before the ``max_detections``
    cut), suppressions decided within NEAR_IOU of the threshold (a
    candidate whose largest IoU with an earlier kept box lies there), and
    top candidates that share their score with another."""
    xy, wh = preds[..., :2], preds[..., 2:4]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
    probs = torch.sigmoid(preds[..., 4:])
    cls_conf, cls_id = probs[..., 1:].max(dim=-1)
    score = probs[..., 0] * cls_conf
    cand = (score >= sz.conf_threshold).sum(dim=1)
    score = torch.where(score >= sz.conf_threshold, score, torch.zeros_like(score))
    k = min(sz.pre_nms_topk, score.shape[1])
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    tb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    tc = torch.gather(cls_id, 1, idx)
    span = tb.amax(dim=(1, 2)) + 1.0
    nb = tb + (tc.to(tb.dtype) * span[:, None])[..., None]
    keep = R.greedy_keep(nb, top, sz.nms_threshold)
    x1, y1, x2, y2 = nb.unbind(-1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp_min(0.0)
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    iou = iw * ih / (area[:, :, None] + area[:, None, :] - iw * ih + 1e-12)
    earlier = torch.arange(k, device=preds.device)
    earlier = earlier[None, :] < earlier[:, None]  # [j, i]: i before j
    worst = torch.where(earlier[None] & keep[:, None, :], iou, 0.0).amax(dim=-1)
    valid = top > 0
    near = (valid & ((worst - sz.nms_threshold).abs() < NEAR_IOU)).sum(dim=1)
    ties = torch.zeros_like(cand)
    for b in range(top.shape[0]):
        v = top[b][valid[b]]
        _, inv, cnt = torch.unique(v, return_inverse=True, return_counts=True)
        ties[b] = int((cnt[inv] > 1).sum())
    return dict(candidates=cand.tolist(), kept=keep.sum(dim=1).tolist(), near_nms=near.tolist(),
                tied_scores=ties.tolist())


def _choices(prog_sel, ref_sel, lane: int) -> dict:
    """Over every stage and layer (window, grid): the windows and tokens
    whose choice differs (a token's where both sides keep its window), and
    the largest relative margin to its threshold of such a choice, on each
    side; and the selected tokens of each side."""
    out = dict(windows_differ=0, tokens_differ=0, tokens_ref=0, tokens_prog=0,
               window_margin_ref=0.0, window_margin_prog=0.0, token_margin_ref=0.0,
               token_margin_prog=0.0)
    for (sp, wp, tp), (sr, wr, tr) in zip(prog_sel, ref_sel):
        winp, tokp, tw, tt = _softmaxes(sp[lane:lane + 1])
        winr, tokr, _, _ = _softmaxes(sr[lane:lane + 1])
        dw = wp[lane] != wr[lane]
        dt = (tp[lane] != tr[lane]) & (wp[lane] & wr[lane])[:, None]
        out["windows_differ"] += int(dw.sum())
        out["tokens_differ"] += int(dt.sum())
        out["tokens_ref"] += int(tr[lane].sum())
        out["tokens_prog"] += int(tp[lane].sum())
        for key, value, thr, diff in (("window_margin_ref", winr, tw, dw),
                                      ("window_margin_prog", winp, tw, dw),
                                      ("token_margin_ref", tokr, tt, dt),
                                      ("token_margin_prog", tokp, tt, dt)):
            if diff.any():
                out[key] = max(out[key], float((value[0] / thr - 1)[diff].abs().max()))
    return out


def readout(cell, seen: check_serve.Seen, seed: int, device, side) -> Dict:
    """Frame by frame: the check's readings, the choices of both sides and
    the reference with the program's choices forced."""
    sz = R.Sizes(cell.config)
    P = make_weights(R.param_shapes(sz), seed, device)
    E = cell.mix["max_events"]
    frames, saved, pos = [], {}, {}
    sums = {v: [0.0, 0.0] for v in ("check", "plain_iou", "forced", "nms_on_prog",
                                      "prog_preds_vs_ref")}
    for k in sorted(seen.want):
        got = seen.kept[k]
        packed, n = check_serve.pack(got["frames"], E, device)
        reset = torch.from_numpy(got["reset"]).to(device)
        state = [tuple(torch.where(reset.view(-1, 1, 1, 1), 0.0, t) for t in hc)
                 for hc in seen.before_state[k]]
        with torch.no_grad():
            with recording(R, "select") as ref_sel:
                ref_slate, ref_state, ref_preds = R.serve_frame(P, sz, packed, n, state,
                                                                R.identity, pos)
            eager, prog_preds, prog_sel = side(k, seen.want[k][2])
            with recording(R, "select", forced=prog_sel):
                forced_slate, _, _ = R.serve_frame(
                    P, sz, packed, n, state, R.identity, pos)
            nms_on_prog = R.slate(sz, prog_preds)
        ref = {n_: v.cpu().numpy() for n_, v in ref_slate.items()}
        forced = {n_: v.cpu().numpy() for n_, v in forced_slate.items()}
        on_prog = {n_: v.cpu().numpy() for n_, v in nms_on_prog.items()}
        det_ref, det_prog = _nms_detail(sz, ref_preds), _nms_detail(sz, prog_preds)
        lanes = []
        for i, lane in enumerate(seen.want[k][2]):
            slate = _lane(got["slate"], i)
            boxes = slate["boxes"][slate["valid"].astype(bool)]
            w = np.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]) if len(boxes) \
                else np.zeros(1)
            m, t = check_serve.unmatched(slate, _lane(ref, i))
            mo, to = check_serve.unmatched(slate, _lane(ref, i), min_px=0.0)
            mf, tf = check_serve.unmatched(slate, _lane(forced, i))
            mn, tn = check_serve.unmatched(slate, _lane(on_prog, i))
            mp, tp = check_serve.unmatched(_lane(on_prog, i), _lane(ref, i))
            gaps = []
            for (hp, cp), (hr, cr) in zip(seen.after_state[k], ref_state):
                for a, b in ((hp, hr), (cp, cr)):
                    gaps.append(float((a[i] - b[i]).norm() / b[i].norm()))
            for v, (a, b) in zip(sums, ((m, t), (mo, to), (mf, tf), (mn, tn), (mp, tp))):
                sums[v][0] += a
                sums[v][1] += b
            lanes.append(dict(
                lane=lane, reset=bool(got["reset"][i]), miss=m, total=t, miss_plain_iou=mo,
                miss_forced=mf / max(tf, 1e-12), miss_nms_on_prog=mn / max(tn, 1e-12),
                miss_prog_preds_vs_ref=mp / max(tp, 1e-12), state_gap=max(gaps),
                eager_is_captured=all(np.array_equal(eager[n_][i], slate[n_])
                                      for n_ in slate),
                ref=dict((key, v[i]) for key, v in det_ref.items()),
                prog=dict((key, v[i]) for key, v in det_prog.items()),
                widths=[float(np.quantile(w, q)) for q in (0.1, 0.5)],
                choices=_choices(prog_sel, ref_sel, i)))
        frames.append(dict(batch=k, lanes=lanes))
        for name, s in (("prog", got["slate"]), ("ref", ref)):
            for n_, v in s.items():
                saved[f"{k}.{name}.{n_}"] = np.asarray(v)
    for f in frames:
        for lane in f["lanes"]:
            lane["share"] = lane["miss"] / max(sums["check"][0], 1e-12)
            lane["share_plain_iou"] = lane["miss_plain_iou"] / max(sums["plain_iou"][0], 1e-12)
    return dict(slate_miss={v: a / max(b, 1e-12) for v, (a, b) in sums.items()},
                frames=frames), saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="", choices=("",) + tuple(sorted(PRECISIONS)))
    ap.add_argument("--save", default="")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    device = card_or_refuse(cell.chips)
    R.fp32_only()
    for seed in args.seeds:
        if args.control:
            from perfbench import control

            seen = control.serve_seen(cell, seed, args.control, device)
            side = ControlFrame(cell, seed, args.control, device, seen)
        else:
            seen, batches = program_seen(cell, seed, device)
            side = ProgramFrame(cell, seed, device, batches)
        checks = seen.compare(cell, R.Sizes(cell.config), seed, device)
        out, saved = readout(cell, seen, seed, device, side)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "checks": checks} | out), flush=True)
        if args.save:
            Path(args.save).mkdir(parents=True, exist_ok=True)
            name = ".".join([args.workload, str(seed)] + [args.control] * bool(args.control))
            np.savez_compressed(Path(args.save) / f"{name}.npz", **saved)
        log(f"seed {seed}: {checks}")
        del side, seen
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
