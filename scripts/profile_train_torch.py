#!/usr/bin/env python3
"""Time the train step per remat policy, with its FLOPs and peak memory,
and optionally a per-kernel table of one step (port of
scripts/profile_train.py).

A train step of ``training/steps.make_train_step`` (seeded weights, the
configuration's attention path, ``data/synthetic.synthetic_train_batch`` at
sparsity 0.9, seed 0) per ``--policies`` entry of ``training.remat_policy``
(``full``, ``dots``, ``none``), captured as CUDA graphs on static buffers
(``training/steps.CapturedTrainStep``, the trainer's default, as the JAX
script times the jitted step; its first, untimed step is the warm-up and
the capture); ``--eager`` times the same step run eagerly. Timing on the
host clock to the card's end:
after one untimed step, loops of ``--L1`` and ``--L2`` steps, each the best
of ``--repeats``, and the slope ``(best L2 - best L1) / (L2 - L1)`` per
step, as the JAX script takes it. FLOPs of one eager step by
``FlopCounterMode`` (forward, backward and the recomputation that the
policy adds), TFLOP/s and MFU against the card's dense bf16 peak
(``utils/profiling.CARDS``; null for another device), and the peak of
``torch.cuda.max_memory_allocated`` over the policy's steps. ``--trace DIR``
profiles one more step and prints the per-kernel table of
``profile_inference_torch.py``, writing the Chrome trace to
``DIR/<policy>.json``.

    python scripts/profile_train_torch.py [--dataset gen1] [--size base]
        [--policies full,dots,none] [--trace DIR] [--eager] [--device cuda|cpu]

The JAX script's flags keep their defaults; ``--pin`` (a TPU layout switch)
has no counterpart, nor has ``sync_dispatch``; XLA's temporary-buffer size
becomes the allocator's peak. Prints the card's name and power limit, a
table, then one JSON line per policy. Runs on the card; ``--device cpu``
runs the plain versions on the CPU. Without a card it refuses by name.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sast_tpu_torch.utils import profiling  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", choices=("gen1", "gen4"), default="gen1")
    ap.add_argument("--size", default="base")
    ap.add_argument("--policies", default="dots")
    ap.add_argument("--trace", default=None, help="profile one step; Chrome traces here")
    ap.add_argument("--batch", type=int, default=None, help="the preset's batch by default")
    ap.add_argument("--seq", type=int, default=None, help="the preset's length by default")
    ap.add_argument("--L1", type=int, default=4)
    ap.add_argument("--L2", type=int, default=12)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--top-k", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eager", action="store_true",
                    help="time the step run eagerly instead of its captured graph")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", dest="overrides", action="append", metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    try:
        device = profiling.card(args.device)
    except profiling.CardError as e:
        raise SystemExit(f"profile_train_torch.py: {e}") from None

    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import to_device
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.models.backbone import zero_states
    from sast_tpu_torch.models.detector import DTYPES
    from sast_tpu_torch.training.steps import (
        CapturedTrainStep,
        create_train_state,
        make_train_step,
    )
    from train_torch import parse_overrides

    overrides = parse_overrides(args.overrides)
    if args.batch:
        overrides["training.batch_size_train"] = args.batch
    if args.seq:
        overrides["dataset.sequence_length"] = args.seq
    base = get_config(args.dataset, args.size, **overrides)
    B, T = base.training.batch_size_train, base.dataset.sequence_length
    batch = to_device(synthetic_train_batch(base, np.random.RandomState(0), batch_size=B,
                                            seq_len=T), device)
    info = profiling.card_info(device)
    peak = profiling.CARDS.get(info["kind"], {}).get("bf16_tflops")
    print(f"# card: {info['smi'] or info['kind']}")
    rows = []
    for policy in args.policies.split(","):
        cfg = dataclasses.replace(base, training=dataclasses.replace(base.training,
                                                                     remat_policy=policy))
        state, model = create_train_state(cfg, seed=args.seed, device=device)
        fns = {"train": make_train_step(model, cfg)}
        step = CapturedTrainStep(fns, state, cfg, device, graph=not args.eager)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        m = step(batch)
        profiling.sync(device)
        best = {}
        for L in (args.L1, args.L2):
            best[L] = float("inf")
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                for _ in range(L):
                    m = step(batch)
                profiling.sync(device)
                best[L] = min(best[L], time.perf_counter() - t0)
        dt = (best[args.L2] - best[args.L1]) / (args.L2 - args.L1)
        counter = FlopCounterMode(display=False)  # a replay runs no operator: count one eagerly
        lstm = zero_states(cfg.model.backbone, B, DTYPES[cfg.model.compute_dtype], device)
        with counter:
            fns["train"](state, batch, lstm)
        flops = counter.get_total_flops()
        peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        row = dict(metric="train_step_policy", dataset=args.dataset, size=args.size,
                   policy=policy, batch=B, seq=T, captured=step.run.graph, ms_per_step=dt * 1e3,
                   tflop_per_step=flops / 1e12, tflops=flops / dt / 1e12,
                   mfu_pct=100 * flops / dt / 1e12 / peak if peak else None,
                   peak_gib=peak_bytes / 2 ** 30 if peak_bytes is not None else None,
                   loss=float(m["loss"]), L1=args.L1, L2=args.L2, device_kind=info["kind"],
                   card=info["smi"])
        if args.trace:
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=activities) as prof:
                m = step(batch)
                profiling.sync(device)
            Path(args.trace).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(args.trace) / f"{policy}.json"))
            table = profiling.kernel_table(prof, 1, device.type)
            print(f"# remat {policy}: one step; trace in {Path(args.trace) / f'{policy}.json'}")
            for line in profiling.format_table(table, args.top_k, dt * 1e3):
                print(line)
            row.update(kernel_ms=table["kernel_ms"], idle_share=1 - table["kernel_ms"] / (dt * 1e3),
                       groups=table["groups"], hand_written=table["hand_written"])
        rows.append(row)
        del state, model, step, fns, lstm, m
        if device.type == "cuda":
            torch.cuda.empty_cache()
    mode = "eager" if args.eager or device.type != "cuda" else "captured"
    profiling.emit(f"# {args.dataset}-{args.size} train step ({mode}), B={B} T={T}, slope of "
                   f"loops of {args.L1}/{args.L2} steps, best of {args.repeats}", rows,
                   ("policy", "ms_per_step", "tflop_per_step", "tflops", "peak_gib"))


if __name__ == "__main__":
    main()
