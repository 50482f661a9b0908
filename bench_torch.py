#!/usr/bin/env python3
"""Benchmark of the PyTorch port: streaming per-frame inference frames/s on
one NVIDIA card.

The shape of ``bench.py``: gen4-base (384x640 model resolution, 20
channels, bf16), a (4, 384, 640, 20) uint8 input at sparsity 0.9 from
``data/synthetic.sparse_event_input`` (seed 0), weights from a seeded
``torch.Generator``, the recurrent state carried from frame to frame. The
timed frame is the serving frame: backbone, PAFPN, head, decode and
fixed-budget NMS (``utils/benchmark.streaming_chunk(detect=True)``), as the
serving step runs by default on a card: captured once as CUDA graphs and
replayed frame after frame, the state and the feedback carried in place
(``graph=True``; JAX times one jitted ``lax.scan`` over the chunk).

Protocol (``utils/benchmark.chunk_times``): chunks of L 100 and L 600
chained frames, each run once untimed, then 4 timed blocks of both in turns,
each ended by ``torch.cuda.synchronize``. The slope ``(best L600 - best
L100) / 500`` cancels what a chunk pays once. ``value`` and the keys beside
it are the captured frame's; the same protocol on the eager frame (one op
at a time from Python, which the host's dispatch paces) gives
``eager_value``, ``eager_latency_per_frame_ms`` and
``eager_slope_spread_pct``. ``value_second_best`` and ``slope_spread_pct``
come from the second-best times. ``fps_host_dispatch`` is the plain eager
loop of 50 frames after 10 of warm-up, with one synchronise at its end.

MFU: ``compute_flops``' GFLOP/frame (``FlopCounterMode``, batch 1, the same
path; the kernels count as their plain versions at full window density)
times frames/s over the card's dense bf16 peak, from a table keyed by
``torch.cuda.get_device_name`` or the environment's
``SAST_TORCH_PEAK_TFLOPS``; otherwise ``peak_tflops`` and ``mfu_pct`` are
null.

    python3 bench_torch.py [--path default|sparse|looped|fused|masked]

``--path`` picks the configuration's switches (``utils/benchmark.PATHS``);
the default is the configuration's own. Prints ONE JSON line on stdout.
Without a card it prints why on stderr and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from sast_tpu_torch.utils.profiling import CARDS  # noqa: E402
from sast_tpu_torch.utils.benchmark import (  # noqa: E402
    PATHS,
    _build_model_and_inputs,
    chunk_times,
    compute_flops,
    looped_kernel,
    path_config,
    streaming_chunk,
)

BATCH, SPARSITY, SEED = 4, 0.9, 0
L_SMALL, L_BIG, BLOCKS = 100, 600, 4
HOST_WARMUP, HOST_ITERS = 10, 50


def card_peak_tflops(name: str):
    env = os.environ.get("SAST_TORCH_PEAK_TFLOPS")
    if env:
        return float(env)
    return CARDS[name]["bf16_tflops"] if name in CARDS else None


def power_limit_w():
    """The first card's power limit in W, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--path", choices=PATHS, default="default")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch.py times the card: torch.cuda.is_available() is false",
              file=sys.stderr)
        sys.exit(1)

    from sast_tpu_torch.config import get_config

    cfg = get_config("gen4", "base")
    run_cfg, sparse_kernel, looped = path_config(cfg, args.path)
    model, x, states = _build_model_and_inputs(run_cfg, BATCH, SPARSITY, SEED, "cuda",
                                               sparse_kernel)
    carried = [states]

    def chunks(graph):
        def make_fn(length):
            run = streaming_chunk(model, length, detect=True, graph=graph)

            def chunk():
                carried[0], _ = run(x, carried[0])
            return chunk
        return make_fn

    with looped_kernel(looped):
        # The plain host loop: frames issued one after another, one wait.
        chunks(False)(HOST_WARMUP)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks(False)(HOST_ITERS)()
        torch.cuda.synchronize()
        dt_host = (time.perf_counter() - t0) / HOST_ITERS
        e_small, e_big = chunk_times(chunks(False), L_SMALL, L_BIG, BLOCKS)
        t_small, t_big = chunk_times(chunks(True), L_SMALL, L_BIG, BLOCKS)

    dt = (min(t_big) - min(t_small)) / (L_BIG - L_SMALL)
    dt_2 = (sorted(t_big)[1] - sorted(t_small)[1]) / (L_BIG - L_SMALL)
    dt_eager = (min(e_big) - min(e_small)) / (L_BIG - L_SMALL)
    dt_eager_2 = (sorted(e_big)[1] - sorted(e_small)[1]) / (L_BIG - L_SMALL)
    overhead_ms = 1e3 * (min(t_small) - L_SMALL * dt)
    fps = BATCH / dt
    gflops = compute_flops(cfg, batch_size=1, sparsity=SPARSITY, seed=SEED, path=args.path)[
        "gflops_total"]
    kind = torch.cuda.get_device_name(0)
    peak = card_peak_tflops(kind)
    achieved = gflops * fps / 1e3
    mfu = achieved / peak if peak else None
    print(f"path {args.path}: per-frame {dt * 1e3:.3f} ms captured (slope of L={L_SMALL}/{L_BIG} "
          f"chunks over {BLOCKS} blocks; second-best {dt_2 * 1e3:.3f} ms, per-chunk overhead "
          f"{overhead_ms:.1f} ms), eager {dt_eager * 1e3:.3f} ms, eager host loop "
          f"{dt_host * 1e3:.3f} ms; {gflops:.2f} GFLOP/frame "
          f"x {fps:.1f} frames/s = {achieved:.2f} TFLOP/s"
          + (f" = {100 * mfu:.2f}% of {peak} TFLOP/s ({kind})" if mfu is not None
             else f" (no peak known for {kind!r}; set SAST_TORCH_PEAK_TFLOPS)"),
          file=sys.stderr)
    print(json.dumps({
        "metric": "gen4_1mpx_streaming_inference_fps_b4",
        "value": round(fps, 3),
        "unit": "frames/s/card",
        "latency_per_frame_ms": round(dt * 1e3, 4),
        "value_second_best": round(BATCH / dt_2, 3),
        "slope_spread_pct": round(100.0 * abs(dt_2 - dt) / dt, 2),
        "per_dispatch_overhead_ms": round(overhead_ms, 3),
        "fps_host_dispatch": round(BATCH / dt_host, 3),
        "graph": True,
        "eager_value": round(BATCH / dt_eager, 3),
        "eager_latency_per_frame_ms": round(dt_eager * 1e3, 4),
        "eager_slope_spread_pct": round(100.0 * abs(dt_eager_2 - dt_eager) / dt_eager, 2),
        "gflop_per_frame": round(gflops, 4),
        "achieved_tflops": round(achieved, 4),
        "peak_tflops": peak,
        "mfu_pct": round(100 * mfu, 4) if mfu is not None else None,
        "device_kind": kind,
        "power_limit_w": power_limit_w(),
        "path": args.path,
        "batch_size": BATCH,
        "input_shape": list(x.shape),
    }))


if __name__ == "__main__":
    main()
