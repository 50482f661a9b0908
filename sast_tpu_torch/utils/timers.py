"""Wall-clock timer registry and profiler helpers (port of
sast_tpu/utils/timers.py).

``Timer`` measures host spans; ``DeviceTimer`` also waits, on exit, for the
card of every CUDA tensor in ``block_on`` (the counterpart of JAX's
``block_until_ready`` on a pytree), so its span holds that work. Both record
into one registry per process, which ``timer_stats`` summarises and which is
printed to stdout when the process exits, unless it is empty. A program
whose last line of stdout means something (``chip_smoke.py``) empties it
with ``reset`` first. ``trace`` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import atexit
import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch
import torch.utils._pytree as pytree

_CUMULATIVE: Dict[str, List[float]] = defaultdict(list)
_ENABLED = True


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = flag


def reset() -> None:
    """Empty the registry: nothing is printed at exit until a timer records
    again."""
    _CUMULATIVE.clear()


class Timer:
    """Host wall-clock span timer: ``with Timer('name'): ...``."""

    def __init__(self, timer_name: str = ""):
        self.name = timer_name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _ENABLED:
            _CUMULATIVE[self.name].append(time.perf_counter() - self._t0)


class DeviceTimer(Timer):
    """On exit, waits for the card of each CUDA tensor in ``block_on`` (any
    nesting of lists, tuples and dicts) before the span ends. Only those
    cards are synchronised; CPU tensors need no wait."""

    def __init__(self, timer_name: str = "", block_on=None):
        super().__init__(timer_name)
        self._block_on = block_on

    def __exit__(self, *exc):
        devices = {t.device for t in pytree.tree_leaves(self._block_on)
                   if isinstance(t, torch.Tensor) and t.is_cuda}
        for device in devices:
            torch.cuda.synchronize(device)
        super().__exit__(*exc)


class TimerDummy:
    """No-op stand-in (the reference default on the hot path)."""

    def __init__(self, *a, **k):
        ...

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        ...


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the body into ``log_dir`` (the CPU, and
    the card where CUDA is available), written when the body ends; the
    profiler is the context's value."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()


def timer_stats() -> Dict[str, Dict[str, float]]:
    out = {}
    for name, spans in _CUMULATIVE.items():
        if not spans:
            continue
        out[name] = {
            "count": len(spans),
            "total_s": sum(spans),
            "mean_ms": 1000.0 * sum(spans) / len(spans),
            "max_ms": 1000.0 * max(spans),
        }
    return out


@atexit.register
def _print_timing_info() -> None:
    stats = timer_stats()
    if not stats:
        return
    print("== Timing statistics ==")
    for name, s in sorted(stats.items()):
        print(
            f"  {name:32s} n={s['count']:<6d} mean={s['mean_ms']:.2f}ms "
            f"total={s['total_s']:.2f}s"
        )
