#!/usr/bin/env python3
"""A ``torch.profiler`` trace of the serving chunk and the card's time in it
by kernel (port of scripts/profile_inference.py).

The chunk is ``utils/benchmark.streaming_chunk(model, length, detect=True)``
as the serving detector runs its step by default: on a card each frame a
replay of the frame captured as CUDA graphs (``--eager``: the eager frame),
at gen4-base: ``--length`` frames of backbone (state carried), PAFPN, head,
decode and NMS on a (B, H, W, 20) uint8 input at ``--sparsity``
(``data/synthetic.sparse_event_input``, seed 0), seeded weights, on the
attention path of ``--path``. After one untimed chunk, one chunk is timed on
the host clock to the card's end (the wall time), then one is profiled. The
table: the top ``--top-k`` CUDA kernels by self time per frame, each in its
group (``utils/profiling.kernel_table``: the hand-written kernels A-F by
name, GEMMs and convolutions, elementwise ops, copies and casts, scatter and
index ops, the rest), the time by group, and the idle share, 1 - kernel
time / wall time. The trace is written to ``--out`` as a Chrome trace
(``trace.json``; Perfetto reads it).

    python scripts/profile_inference_torch.py [--out runs/profile_inference]
        [--length 50] [--batch 4] [--sparsity 0.9] [--top-k 40]
        [--path default|sparse|looped|fused|masked] [--device cuda|cpu] [--eager]

The JAX script's flags keep their defaults, but ``--out`` defaults to a
directory of the checkout (``runs/``, which git ignores). ``--report-only``
has no counterpart: the table is read from the run itself, not from a saved
trace; nor has ``sync_dispatch``. On the CPU the rows are the operators'
self time on the host. Prints the card's name and power limit, the table,
then one JSON line per kernel row and a summary line. Runs on the card;
``--device cpu`` runs the plain versions on the CPU. Without a card it
refuses by name.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sast_tpu_torch.utils import profiling  # noqa: E402
from sast_tpu_torch.utils.benchmark import PATHS  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "runs" / "profile_inference"))
    ap.add_argument("--length", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--dataset", default="gen4")
    ap.add_argument("--size", default="base")
    ap.add_argument("--path", choices=PATHS, default="default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager frame instead of the captured one")
    ap.add_argument("--set", dest="overrides", action="append", metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    try:
        device = profiling.card(args.device)
    except profiling.CardError as e:
        raise SystemExit(f"profile_inference_torch.py: {e}") from None

    from torch.profiler import ProfilerActivity, profile

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.utils.benchmark import (
        _build_model_and_inputs,
        looped_kernel,
        path_config,
        streaming_chunk,
    )
    from train_torch import parse_overrides

    cfg = get_config(args.dataset, args.size, **parse_overrides(args.overrides))
    cfg, sparse_kernel, looped = path_config(cfg, args.path)
    model, x, states = _build_model_and_inputs(cfg, args.batch, args.sparsity, args.seed,
                                               device, sparse_kernel)
    graph = device.type == "cuda" and not args.eager
    run = streaming_chunk(model, args.length, detect=True, graph=graph)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    info = profiling.card_info(device)
    print(f"# card: {info['smi'] or info['kind']}")
    with looped_kernel(looped):
        run(x, states)
        profiling.sync(device)
        t0 = time.perf_counter()
        run(x, states)
        profiling.sync(device)
        wall_ms = (time.perf_counter() - t0) / args.length * 1e3
        with profile(activities=activities) as prof:
            run(x, states)
            profiling.sync(device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    table = profiling.kernel_table(prof, args.length, device.type)
    print(f"# serving chunk, {args.dataset}-{args.size}, B={args.batch}, {args.length} frames, "
          f"sparsity {args.sparsity}, path {args.path}, {'captured' if graph else 'eager'}; "
          f"trace in {out / 'trace.json'}")
    for line in profiling.format_table(table, args.top_k, wall_ms):
        print(line)
    for r in table["rows"][:args.top_k]:
        print(json.dumps(dict(metric="profile_inference_kernel", **r)))
    print(json.dumps(dict(
        metric="profile_inference", dataset=args.dataset, size=args.size, path=args.path,
        graph=graph, batch=args.batch, length=args.length, sparsity=args.sparsity,
        kernel_ms_per_frame=table["kernel_ms"], wall_ms_per_frame=wall_ms,
        idle_share=1 - table["kernel_ms"] / wall_ms, groups=table["groups"],
        hand_written=table["hand_written"], trace=str(out / "trace.json"),
        device_kind=info["kind"], card=info["smi"])))


if __name__ == "__main__":
    main()
