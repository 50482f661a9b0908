"""The controls of the check: the reference, in the program's place, in a
precision below the configuration's, judged as the program is judged.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...] [--precision fp8]

prints one JSON line per seed with the check's readings; ``--fault
half_batch --precision fp32`` plants a training fault in the reference
instead. A serve cell's
control serves the checked lanes through every batch up to the last checked
one, carrying its own state; a train cell's control takes the reference's
three steps. The benchmark's own runs never run this; it sets the upper
readings of ``limits/<cell>.json`` (the configurations state bfloat16, so
the control computes every matrix product's operands in float8 e4m3).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check_serve, check_train  # noqa: E402
from perfbench.common import Cell, card_or_refuse, log  # noqa: E402
from perfbench.reference import detector as R  # noqa: E402
from perfbench.reference.precision import PRECISIONS  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402


class ReferenceDetector:
    """The reference serving ``lanes`` of the mix in ``precision``, with the
    interface of the program's detector that the check reads: ``states``
    and ``process_batch`` over those lanes alone."""

    def __init__(self, sizes: R.Sizes, seed: int, lanes, max_events: int, precision: str,
                 device):
        R.fp32_only()
        self.sizes, self.lanes, self.E, self.device = sizes, list(lanes), max_events, device
        self.P = make_weights(R.param_shapes(sizes), seed, device)
        self.q = PRECISIONS[precision]
        self.state = R.zero_state(sizes, len(self.lanes), device)
        self.pos = {}

    @property
    def states(self):
        return self.state

    @torch.no_grad()
    def process_batch(self, frames, reset) -> Dict[str, np.ndarray]:
        packed, n = check_serve.pack(frames, self.E, self.device)
        keep = ~torch.from_numpy(np.asarray(reset, bool)).to(self.device).view(-1, 1, 1, 1)
        state = [tuple(torch.where(keep, t, 0.0) for t in hc) for hc in self.state]
        slate, self.state, _ = R.serve_frame(self.P, self.sizes, packed, n, state, self.q,
                                             self.pos)
        return {k: v.cpu().numpy() for k, v in slate.items()}


def serve_seen(cell, seed: int, precision: str, device) -> check_serve.Seen:
    """The checked batches as the reference in ``precision`` serves them in
    the program's place."""
    mix, gen = cell.mix, cell.generator()
    sizes = R.Sizes(cell.config)
    pool = gen.serve_pool(mix, sizes.sensor_hw, seed, device)
    plan = check_serve.Plan(mix, gen, seed, first=mix["warmup_batches"])
    seen = check_serve.Seen(plan)
    last = max(seen.want)
    # Every checked batch reads the same lanes in one triple; serve each
    # triple's lanes from the start of the stream.
    for first, lanes in plan.triples:
        det = ReferenceDetector(sizes, seed, lanes, mix["max_events"], precision, device)
        for k in range(first + 3):
            frames = [pool[i][gen.pool_index(mix, i, k)] for i in lanes]
            reset = gen.resets(mix, k)[lanes]
            if k >= first:
                seen.before_state[k] = [tuple(t.clone() for t in hc) for hc in det.states]
            out = det.process_batch(frames, reset)
            if k >= first:
                seen.after_state[k] = [tuple(t.clone() for t in hc) for hc in det.states]
                seen.kept[k] = dict(slate=out, frames=frames, reset=np.asarray(reset, bool))
        log(f"control: lanes {lanes} served through batch {first + 2} of {last}")
    return seen


def serve_control(cell, seed: int, precision: str, device) -> Dict[str, float]:
    return serve_seen(cell, seed, precision, device).compare(cell, R.Sizes(cell.config), seed,
                                                             device)


def half_batch(loss_fn):
    """A training fault: the loss over the first half of the batch's frames,
    the mean taken over the rest."""
    def half(preds, grids, strides, gt, gcls, gvalid, fvalid, *args, **kwargs):
        keep = torch.arange(fvalid.shape[0], device=fvalid.device) < fvalid.shape[0] // 2
        return loss_fn(preds, grids, strides, gt, gcls, gvalid, fvalid & keep, *args, **kwargs)
    return half


def train_control(cell, seed: int, precision: str, device, fault: str = "") -> Dict[str, float]:
    from perfbench.reference import training as RT

    mix, gen = cell.mix, cell.generator()
    sizes = R.Sizes(cell.config)
    pool = gen.train_pool(mix, sizes, seed, device)
    batches = [pool[j % len(pool)] for j in range(3)]
    plain = RT.yolox_loss
    if fault == "half_batch":
        RT.yolox_loss = half_batch(plain)
    try:
        losses, obj_sums, first, _, after = check_train.reference_run(
            cell, sizes, seed, device, batches, precision)
    finally:
        RT.yolox_loss = plain
    got = dict(losses=losses, obj_sums=obj_sums, m1={k: g * (1.0 - 0.9) for k, g in first.items()},
               params=after)
    return check_train.compare(cell, sizes, seed, device, batches, got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default="fp8", choices=sorted(PRECISIONS))
    ap.add_argument("--fault", default="", choices=("", "half_batch"),
                    help="a train cell's fault, planted in the reference in the program's place")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    device = card_or_refuse(cell.chips)
    for seed in args.seeds:
        if cell.mix["loop"] == "train":
            readings = train_control(cell, seed, args.precision, device, args.fault)
        else:
            readings = serve_control(cell, seed, args.precision, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                          "fault": args.fault, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
