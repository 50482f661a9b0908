"""The port's spans and counters (``utils/timers.py``) inside its serving
and training loops, on the CPU at the tiny test config.

With tracing off a span or counter records nothing and opens no profiler
range; under ``torch.profiler`` each ``process_batch`` call (the live
detector's and a loaded artifact's) is a ``serve.batch`` range holding
``serve.pack``, ``serve.launch`` and ``serve.wait`` in that order, and
``fit(profile_steps=...)`` lays ``fit.wait``, ``fit.stage`` and
``fit.launch`` inside each ``train_step <n>`` range. The card test that the
spans share the card's clock is in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sast_tpu_torch import export
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data.synthetic import synthetic_train_batch
from sast_tpu_torch.models.detector import build_detector
from sast_tpu_torch.serving import StreamingDetector
from sast_tpu_torch.training.loop import Trainer
from sast_tpu_torch.utils import timers
from tests.test_torch_serving import _frame, _serving_config

EVENTS = 2000
CALLS = 3
SERVE = ("serve.pack", "serve.launch", "serve.wait")


@pytest.fixture(autouse=True)
def _clean_registry():
    """One intra-op thread, an empty registry and spans switched off around
    each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    timers.reset()
    yield
    timers.set_spans(False)
    timers.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def detectors():
    """The live detector of the tiny serving geometry and its artifact."""
    cfg = _serving_config(get_test_config)
    live = StreamingDetector(cfg, build_detector(cfg.model, seed=0, device="cpu"),
                             max_events=EVENTS, num_streams=2, device="cpu")
    return {"live": live,
            "artifact": export.ExportedStreamingDetector(export.export_streaming_detector(live))}


def _frames(seed=3):
    rng = np.random.RandomState(seed)
    return [[_frame(rng, i), _frame(rng, i)] for i in range(CALLS)]


def _annotations(prof, tmp_path, prefix):
    """The profiler's ``record_function`` ranges whose names start with
    ``prefix``, as (name, start, end) in microseconds, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _ranges(json.loads(path.read_text())["traceEvents"], prefix)


def _ranges(events, prefix):
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda r: r[1])


def test_tracing_off_records_nothing_and_opens_no_range(detectors, monkeypatch):
    """Off (no profiler, no switch) a span is the shared no-op and a
    counter adds nothing; ``record_function`` is never called, not even by
    ``process_batch``."""
    def refused(*args, **kwargs):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not timers.tracing()
    assert timers.span("a") is timers.span("b")
    with timers.span("a"):
        timers.count("c", 5)
    for frames in _frames():
        detectors["live"].process_batch(frames)
    assert timers.timer_stats() == {}


@pytest.mark.parametrize("kind", ["live", "artifact"])
def test_process_batch_spans_nest_on_the_profiler_timeline(detectors, tmp_path, kind):
    """Under the profiler every call is one ``serve.batch`` range with
    ``serve.pack``, ``serve.launch`` and ``serve.wait`` inside it in that
    order; each span counts the calls, ``serve.events`` the frames' events
    and ``serve.upload_bytes`` the bytes uploaded: 16 an event, and every
    call's lane starts, counts and resets."""
    det = detectors[kind]
    frames = _frames()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert timers.tracing()
        for f in frames:
            det.process_batch(f)
    assert not timers.tracing()
    ranges = _annotations(prof, tmp_path, "serve.")
    batches = [r for r in ranges if r[0] == "serve.batch"]
    assert len(batches) == CALLS
    for _, lo, hi in batches:
        inside = [r for r in ranges if r[0] != "serve.batch" and lo <= r[1] and r[2] <= hi]
        assert [r[0] for r in inside] == list(SERVE)
        assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))
    stats = timers.timer_stats()
    for name in ("serve.batch",) + SERVE:
        assert stats[name]["count"] == CALLS
    events = sum(d["x"].size for f in frames for d in f)
    assert stats["serve.events"]["total"] == events
    assert stats["serve.upload_bytes"]["total"] == 16 * events + CALLS * 2 * (4 + 4 + 1)
    assert stats["serve.batch"]["total_s"] >= sum(stats[n]["total_s"] for n in SERVE)


def test_the_switch_records_without_a_profiler_and_reset_empties(detectors):
    """``set_spans(True)`` records the spans and counters with no profiler
    running (and opens no range: none records); ``reset`` empties the
    registry, and switched off again nothing records."""
    timers.set_spans(True)
    frames = _frames()
    for f in frames:
        detectors["live"].process_batch(f)
    stats = timers.timer_stats()
    assert {n: stats[n]["count"] for n in ("serve.batch",) + SERVE} == dict.fromkeys(
        ("serve.batch",) + SERVE, CALLS)
    assert stats["serve.events"]["count"] == CALLS
    assert stats["serve.batch"]["max_ms"] <= 1e3 * stats["serve.batch"]["total_s"]
    timers.reset()
    assert timers.timer_stats() == {}
    timers.set_spans(False)
    detectors["live"].process_batch(frames[0])
    assert timers.timer_stats() == {}


def test_fit_spans_sit_inside_each_train_step(tmp_path):
    """``fit(profile_steps=(2, 3))`` with a log point at every step: each
    traced ``train_step <n>`` range holds, in order, the wait for the
    previous batch's copies, the staging, the launch and the log point's
    read, and every ``fit.*`` span of the trace lies inside one."""
    cfg = get_test_config()
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, seed=0))
    rng = np.random.RandomState(0)
    batches = [synthetic_train_batch(cfg, rng) for _ in range(3)]
    trainer = Trainer(cfg, str(tmp_path / "run"), log_every=1, device="cpu")
    trainer.fit(batches, max_steps=3, profile_steps=(2, 3))
    (path,) = (tmp_path / "run" / "trace").glob("rank0.*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    steps = _ranges(events, "train_step ")
    spans = _ranges(events, "fit.")
    assert [r[0] for r in steps] == ["train_step 2", "train_step 3"]
    for _, lo, hi in steps:
        inside = [r[0] for r in spans if lo <= r[1] and r[2] <= hi]
        assert inside == ["fit.wait", "fit.stage", "fit.launch", "fit.wait"]
    assert sum(len([s for s in spans if lo <= s[1] and s[2] <= hi]) for _, lo, hi in steps) \
        == len(spans)
    stats = timers.timer_stats()
    assert stats["fit.launch"]["count"] == 2 and stats["fit.wait"]["count"] == 4
