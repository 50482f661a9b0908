"""Serve cells: a closed loop of ``StreamingDetector.process_batch`` calls.

Set-up makes the weights on the card, the traffic pool, the detector as it
runs by default (its step captured at the first batch), and serves
``warmup_batches`` batches. The window then calls ``process_batch`` with one
frame of every lane, waits for its slate and calls again, for ``--seconds``:
``serve_frames_per_s`` is lanes x calls over the window's seconds, and
``serve_latency_p95_ms`` the 95th percentile of every call's time from
call to returned slate. With ``--trace 1`` the window is followed by a
profiled stretch of ``trace_batches`` calls, which the per-layer readers
read. The carried state of a few lanes is copied around the batches that
the check follows (``perfbench/check_serve.py``): the copies are taken
between calls, not inside one.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from perfbench import check_serve, trace
from perfbench.common import free, log, p95, peak_memory, sync
from perfbench.program import program_config, program_model
from perfbench.reference.detector import Sizes, param_shapes
from perfbench.weights import make_weights


def run(cell, args, clock, device) -> Dict:
    from sast_tpu_torch.serving import StreamingDetector

    mix = cell.mix
    sizes = Sizes(cell.config)
    cfg = program_config(cell)
    weights = make_weights(param_shapes(sizes), args.seed, device)
    gen = cell.generator()
    pool = gen.serve_pool(mix, sizes.sensor_hw, args.seed, device)
    log(f"set-up: weights and traffic pool made at {clock():.3f} s")
    det = StreamingDetector(cfg, program_model(cfg, weights, device),
                            max_events=mix["max_events"], num_streams=mix["lanes"],
                            device=device)
    del weights
    log(f"set-up: detector built at {clock():.3f} s")
    lanes = mix["lanes"]

    def batch(k: int):
        return ([pool[i][gen.pool_index(mix, i, k)] for i in range(lanes)], gen.resets(mix, k))

    k = 0
    for _ in range(mix["warmup_batches"]):
        det.process_batch(*batch(k))
        log(f"set-up: warm-up call {k} (the first captures the step) done at {clock():.3f} s")
        k += 1
    sync(device)
    setup_s = clock()
    log(f"set-up {setup_s:.3f} s")

    seen = check_serve.Seen(check_serve.Plan(mix, gen, args.seed, first=k))
    lat, kept = [], 0.0
    t0 = time.perf_counter()
    end = t0 + args.seconds
    while True:
        frames, reset = batch(k)
        seen.before(k, det)
        t = time.perf_counter()
        out = det.process_batch(frames, reset)
        now = time.perf_counter()
        lat.append(now - t)
        kept = kept + out["selected_tokens"]
        seen.after(k, det, out, frames, reset)
        k += 1
        if now >= end:
            break
    window_s = time.perf_counter() - t0
    calls = len(lat)
    slots = [2 * h * w for h, w in map(sizes.stage_hw, range(len(sizes.dims)))]
    share = [round(float(t) / calls / n, 4) for t, n in zip(kept, slots)]
    log(f"window {window_s:.3f} s, {calls} calls; kept share of the token slots by stage "
        f"(the program's selected_tokens): {share}")
    while not seen.done():  # checked batches the window did not reach: served untimed
        frames, reset = batch(k)
        seen.before(k, det)
        seen.after(k, det, det.process_batch(frames, reset), frames, reset)
        k += 1

    readings = dict(frames_per_s=lanes * calls / window_s, calls=calls, lanes=lanes)
    if args.trace:
        def one():
            nonlocal k
            det.process_batch(*batch(k))
            k += 1
        readings["trace"] = trace.profile(one, mix["trace_batches"], device)
    memory = peak_memory(device)
    del det
    free(device)
    checks = seen.compare(cell, sizes, args.seed, device)
    return dict(
        setup_s=setup_s,
        end_to_end=dict(serve_frames_per_s=lanes * calls / window_s,
                        serve_latency_p95_ms=p95(lat) * 1e3),
        attempted=calls * lanes, failed=0, readings=readings, memory=memory, checks=checks)
