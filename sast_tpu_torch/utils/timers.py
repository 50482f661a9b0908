"""The port's tracing: spans and counters inside its serving and training
loops, and wall-clock timers (port of sast_tpu/utils/timers.py).

``span(name)`` and ``count(name, n)`` sit at the host runtime's boundaries
(``serve.*``: ``process_batch`` of the live detector and of a loaded
artifact, through ``graphs.Staging.batch``) and at the trainer's (``fit.*``:
``training/loop.Trainer.fit`` and ``training/steps.CapturedTrainStep``).
They record only while tracing is on: while a ``torch.profiler`` records,
or after ``set_spans(True)``. Off, a span is one test of a flag that
returns a shared no-op context, and a counter is the same test: neither
calls ``torch.profiler.record_function``, which costs microseconds a call
even with no profiler running. On, a span adds its ``time.perf_counter``
duration to the registry and, while a profiler records, opens a
``record_function`` range of its name: the span then sits on the
profiler's timeline, on the clock of the card's kernels and copies, inside
the range that encloses it. A counter adds ``n``.

``Timer`` measures a host span whatever the switch says; ``DeviceTimer``
also waits, on exit, for the card of every CUDA tensor in ``block_on`` (the
counterpart of JAX's ``block_until_ready`` on a pytree), so its span holds
that work. Everything records into one registry per process that keeps,
by name, running aggregates (count, total, max); ``timer_stats`` reads it
and ``reset`` empties it. Nothing is printed. Spans are recorded from the
host thread that drives the loop: the registry takes no lock.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler
import torch.utils._pytree as pytree

_ON = False
# name -> [count, total, max]: seconds for spans and timers, units for counters.
_SPANS: Dict[str, List[float]] = {}
_COUNTS: Dict[str, List[float]] = {}


def set_spans(flag: bool) -> None:
    """Record spans and counters without a profiler (True), or only while
    one records (False, the default)."""
    global _ON
    _ON = bool(flag)


def tracing() -> bool:
    """Whether spans and counters record now."""
    return _ON or _profiler._is_profiler_enabled


def reset() -> None:
    """Empty the registry."""
    _SPANS.clear()
    _COUNTS.clear()


def _add(table: Dict[str, List[float]], name: str, value) -> None:
    row = table.get(name)
    if row is None:
        table[name] = [1, value, value]
        return
    row[0] += 1
    row[1] += value
    if value > row[2]:
        row[2] = value


class _Off:
    """The span with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _add(_SPANS, self.name, seconds)
        return False


def span(name: str):
    """``with span(name):`` records the body's host time under ``name``
    while tracing is on (module docstring)."""
    if not (_ON or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _ON or _profiler._is_profiler_enabled:
        _add(_COUNTS, name, n)


class Timer:
    """Host wall-clock span timer: ``with Timer('name'): ...``; records
    whether or not tracing is on."""

    def __init__(self, timer_name: str = ""):
        self.name = timer_name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _add(_SPANS, self.name, time.perf_counter() - self._t0)


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


def timer_stats() -> Dict[str, Dict[str, float]]:
    """By name: a span's or timer's ``count``, ``total_s``, ``mean_ms`` and
    ``max_ms``; a counter's ``count`` (of additions), ``total`` and
    ``max``."""
    out = {name: {"count": n, "total_s": total, "mean_ms": 1e3 * total / n, "max_ms": 1e3 * top}
           for name, (n, total, top) in _SPANS.items()}
    out.update({name: {"count": n, "total": total, "max": top}
                for name, (n, total, top) in _COUNTS.items()})
    return out
