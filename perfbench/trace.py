"""The traced stretch of a run: ``torch.profiler`` over a few calls of the
window's own entry, reduced to what the per-layer readers read.

``profile(call, n)`` runs ``call()`` ``n`` times under the profiler (CPU and
CUDA activity), each call an annotation ``perfbench.call``, waits for the
card, writes the trace as Chrome JSON into ``TMPDIR`` and reduces it:

- ``window_s``: from the first call's start to the last call's end;
- ``busy_s``: the union of the card's kernels, copies and sets within it;
- ``kernels``: card seconds by kernel name, and the launches of each;
- ``gaps``: the card's idle intervals, each named at its middle by the
  innermost of the program's spans then open (a ``record_function`` range
  on the host, such as ``serve.pack``; the harness's own ``perfbench.call``
  is not one), else by the innermost host operation under way (a
  ``cpu_op`` or a ``cuda_*`` runtime call), else ``python``;
- ``calls``: ``n``.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION = "perfbench.call"


class Tracer:
    """``torch.profiler`` over a stretch of calls: ``with tracer.call():``
    around each, then ``finish()`` waits for the card and reduces."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity

        self.device = torch.device(device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.calls = 0

    def call(self):
        self.calls += 1
        return torch.profiler.record_function(ANNOTATION)

    def finish(self) -> Dict:
        with torch.profiler.record_function(ANNOTATION):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce(events, self.calls)


def profile(call: Callable[[], None], n: int, device) -> Dict:
    """``call()`` ``n`` times under the profiler, reduced."""
    tracer = Tracer(device)
    for _ in range(n):
        with tracer.call():
            call()
    return tracer.finish()


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(rows, t: float):
    """The name of the row (start, end, name) under way at ``t`` that
    started last (of two that started together, the one that ends first),
    or None."""
    under = [r for r in rows if r[0] <= t <= r[1]]
    return max(under, key=lambda r: (r[0], -r[1]))[2] if under else None


def reduce(events, n: int) -> Dict:
    """Chrome trace events (times in microseconds) -> the stretch's readings."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name") == ANNOTATION and e.get("cat") != "gpu_user_annotation"]
    if not spans:
        return {}
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in device:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        intervals.append((a, b))
        row = kernels[e["name"]]
        row[0] += (b - a) * 1e-6
        row[1] += 1
    busy = _union(intervals)

    def host(kind):
        return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if e.get("ph") == "X" and kind(str(e.get("cat")), e.get("name"))]

    program = host(lambda cat, name: cat == "user_annotation" and name != ANNOTATION)
    ops = host(lambda cat, name: cat == "cpu_op" or cat.startswith("cuda_"))
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = _innermost(program, mid) or _innermost(ops, mid) or "python"
        gaps[name] += (b - a) * 1e-6
    return {"window_s": (hi - lo) * 1e-6, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": {k: (v[0], v[1]) for k, v in kernels.items()}, "gaps": dict(gaps),
            "calls": n}


def breakdown(red: Dict) -> Dict:
    """The ten card operations that took most time and the ten largest sums
    of idle time by what the host was doing, in seconds."""
    ops = sorted(((k[:160], v[0]) for k, v in red.get("kernels", {}).items()),
                 key=lambda r: -r[1])[:10]
    gaps = sorted(((k[:160], v) for k, v in red.get("gaps", {}).items()), key=lambda r: -r[1])[:10]
    return {"device_ops": [list(r) for r in ops], "idle_gaps": [list(r) for r in gaps]}
