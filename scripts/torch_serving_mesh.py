#!/usr/bin/env python3
"""The serving lanes over every card of the machine (``StreamingDetector(mesh=...)``).

    python3 scripts/torch_serving_mesh.py [--lanes-per-card 4] [--frames 6] \\
        [--out chiprun_out/serving_mesh.json]
    python3 scripts/torch_serving_mesh.py --eager

At gen4-base (bf16, seeded random weights, chip_smoke.py's clustered
frames of 200k events a lane, one lane reset midway), on the sparse-kernel
path (kernels A, E, C) and on the default path (A, C): a detector whose
lanes are split over all N visible cards, ``--lanes-per-card`` each, against
N detectors of that many lanes each, all on card 0 and run one after the
other: the slates and the carried states must be the same bits (each card
runs its block of lanes as a detector of those lanes would). Then, on
the default path, ms/step on the host clock, from a synchronise of every
card to a synchronise of every card, of the mesh, of one detector of
``--lanes-per-card`` lanes, and of one detector of all N x lanes lanes on
card 0, in turns; frames/s of each. Every detector runs its step as the
detector does by default, captured as CUDA graphs per card and replayed
(``--eager``: ``graph=False``). Prints one JSON line (also written to
``--out``) with the cards' names and power limits. Exits non-zero if a
check fails or fewer than two cards are visible.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes-per-card", type=int, default=4)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--steps", type=int, default=10, help="timed steps per turn")
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "serving_mesh.json"))
    ap.add_argument("--eager", action="store_true", help="run the eager step (graph=False)")
    args = ap.parse_args()
    import numpy as np
    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        sys.exit(f"torch_serving_mesh: needs two or more cards, {cards} visible")
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sast_tpu_torch import build
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.packing import pack_event_batch
    from sast_tpu_torch.serving import StreamingDetector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    build.build()
    cfg = get_config("gen4", "base")
    h, w = cfg.dataset.resolution_hw
    L, E = args.lanes_per_card, smoke.EVENTS_PER_FRAME
    S = cards * L
    rng = np.random.RandomState(9)
    frames = [[smoke.clustered_events(np, rng, E - 1000 * (s % 8), h, w, f, s) for s in range(S)]
              for f in range(args.frames)]
    resets = [np.array([f == args.frames // 2 and s == L for s in range(S)])
              for f in range(args.frames)]
    model = build_detector(cfg.model, seed=0, device="cpu")

    def detector(lanes, sparse_kernel=False, **kw):
        import copy

        return StreamingDetector(cfg, copy.deepcopy(model), max_events=E, num_streams=lanes,
                                 sparse_kernel=sparse_kernel, graph=not args.eager, **kw)

    # The default path (kernels A and C) and the sparse-kernel path (A, E, C).
    for sparse_kernel in (True, False):
        mesh = detector(S, sparse_kernel, mesh=[f"cuda:{c}" for c in range(cards)])
        outs = [mesh.process_batch(frames[f], reset=resets[f]) for f in range(args.frames)]
        bad = []
        for c in range(cards):
            lanes = slice(c * L, (c + 1) * L)
            single = detector(L, sparse_kernel, device="cuda:0")
            for f in range(args.frames):
                o = single.process_batch(frames[f][lanes], reset=resets[f][lanes])
                bad += [f"card {c} frame {f} {k}" for k in o
                        if k != "selected_tokens" and not np.array_equal(o[k], outs[f][k][lanes])]
            ours = [t.cpu() for hc in mesh.states[c] for t in hc]
            theirs = [t.cpu() for hc in single.states for t in hc]
            bad += [f"card {c} state leaf {i}" for i, (a, b) in enumerate(zip(ours, theirs))
                    if not torch.equal(a, b)]
            del single
        if bad:
            sys.exit(f"torch_serving_mesh: the mesh (sparse_kernel={sparse_kernel}) differs "
                     f"from detectors of its blocks: {bad[:6]}")

    packed, n = pack_event_batch(frames[0], S, E)
    no_reset = np.zeros(S, bool)

    def inputs(lanes, device):
        return tuple(torch.from_numpy(a[:lanes]).to(device) for a in (packed, n, no_reset))

    def sync():
        for c in range(cards):
            torch.cuda.synchronize(c)

    def step_ms(det, args_):
        for _ in range(3):
            det.step(*args_)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            det.step(*args_)
        sync()
        return (time.perf_counter() - t0) / args.steps * 1e3

    # ``mesh`` is the default path's (the loop's last).
    one = detector(L, device="cuda:0")
    wide = detector(S, device="cuda:0")
    runs = dict(mesh=(mesh, inputs(S, "cuda:0")), one_card=(one, inputs(L, "cuda:0")),
                all_lanes_one_card=(wide, inputs(S, "cuda:0")))
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(step_ms(*runs[k]))
    lanes = dict(mesh=S, one_card=L, all_lanes_one_card=S)
    record = dict(cards=smi, count=cards, lanes_per_card=L, frames=args.frames,
                  graph=not args.eager,
                  bit_equal_to_blocks=True, torch=torch.__version__,
                  **{k: dict(lanes=lanes[k], ms_turns=v, ms=sum(v) / len(v),
                             frames_per_s=lanes[k] * 1e3 / (sum(v) / len(v)))
                     for k, v in times.items()})
    line = json.dumps(record)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
