"""The readers of the program's own spans and counters
(``perfbench/spans.py``, ``metrics/host_*``, ``metrics/upload_useful_share``):
None where the registry holds nothing, the expected ms and % from a
registry planted with known spans and counters, and a traced run whose
last line of standard output is still the result once spans have
recorded (nothing is printed at exit). The card's idle gaps named by the
program's spans in a hand-built trace (``perfbench/trace.reduce``)."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from perfbench.common import BENCH_DIR, ROOT, load_module

SERVE = ["host_pack_ms.serve", "host_launch_ms.serve", "host_wait_ms.serve",
         "upload_useful_share.serve"]
TRAIN = ["host_stage_ms.train", "host_wait_ms.train"]


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


@pytest.fixture
def registry(monkeypatch):
    """The program's registry, empty, on a clock the test moves."""
    from sast_tpu_torch.utils import timers

    clock = SimpleNamespace(now=0.0)
    monkeypatch.setattr(timers, "time", SimpleNamespace(perf_counter=lambda: clock.now))
    timers.reset()
    yield timers, clock
    timers.set_spans(False)
    timers.reset()


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_finds_nothing_in_an_empty_registry(registry, name):
    assert reader(name).read({}, None) is None


def _span(timers, clock, name, ms):
    with timers.span(name):
        clock.now += ms / 1e3


def test_serve_readers_read_planted_spans(registry):
    """Two calls: pack 8 and 10 ms, launch 0.5 and 0.7, wait 20 and 22;
    20,000 and 60,000 events into 2 lanes of 100,000 (an upload of
    3,200,000 + 8 + 2 bytes each)."""
    timers, clock = registry
    timers.set_spans(True)
    upload = 2 * 100_000 * 16 + 2 * 4 + 2
    for pack, launch, wait, events in [(8, 0.5, 20, 20_000), (10, 0.7, 22, 60_000)]:
        with timers.span("serve.batch"):
            _span(timers, clock, "serve.pack", pack)
            timers.count("serve.events", events)
            timers.count("serve.upload_bytes", upload)
            _span(timers, clock, "serve.launch", launch)
            _span(timers, clock, "serve.wait", wait)
    got = {name: reader(name).read({}, None) for name in SERVE}
    assert got == pytest.approx({"host_pack_ms.serve": 9.0, "host_launch_ms.serve": 0.6,
                                 "host_wait_ms.serve": 21.0,
                                 "upload_useful_share.serve": 100 * 16 * 80_000 / (2 * upload)})


@pytest.mark.parametrize("lanes, counts", [
    (16, [200_000] * 16), (16, [20_000 + 12_000 * i for i in range(16)]), (32, [5_000] * 32),
    (4, [0, 0, 0, 1]), (4, [0, 0, 0, 0])])
def test_upload_share_of_the_compact_layout(registry, lanes, counts):
    """The upload as it is enqueued: 16 bytes a filled event and 9 a lane
    (its first column, count and reset): the share is 16 E / (16 E + 9 S),
    under 100% on any batch, and 0 on one with no event."""
    timers, _ = registry
    timers.set_spans(True)
    for _ in range(3):
        with timers.span("serve.batch"):
            timers.count("serve.events", sum(counts))
            timers.count("serve.upload_bytes", 16 * sum(counts) + 9 * lanes)
    share = reader("upload_useful_share.serve").read({}, None)
    assert share == pytest.approx(100 * 16 * sum(counts) / (16 * sum(counts) + 9 * lanes))
    assert 0 <= share < 100


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_gaps_are_named_by_the_programs_spans():
    """Two calls of 100 us (the harness's ``perfbench.call``). Call one:
    kernels at 40-90 and 95-100 us, ``serve.batch`` over all of it and
    ``serve.pack`` inside it at 0-40 (a ``cpu_op`` inside that), so its
    first gap is ``serve.pack``, the innermost span, and its second
    ``serve.batch``. Call two: a kernel at 140-190 and no span; its first
    gap lies under a ``cudaMemcpyAsync`` and its last under nothing
    (``python``). The card's busy time, the stretch and the kernels read
    as before."""
    from perfbench import trace

    call = trace.ANNOTATION
    events = [
        _x(call, "user_annotation", 0, 100), _x(call, "user_annotation", 100, 100),
        _x(call, "gpu_user_annotation", 0, 200),
        _x("serve.batch", "user_annotation", 0, 100),
        _x("serve.pack", "user_annotation", 0, 40),
        _x("aten::copy_", "cpu_op", 10, 25),
        _x("step", "kernel", 40, 50), _x("step", "kernel", 95, 5), _x("step", "kernel", 140, 50),
        _x("cudaMemcpyAsync", "cuda_runtime", 100, 40),
        _x("aten::copy_", "cpu_op", 150, 10),
    ]
    red = trace.reduce(events, 2)
    assert red["window_s"] == pytest.approx(200e-6)
    assert red["busy_s"] == pytest.approx(105e-6)
    assert red["kernels"] == {"step": (pytest.approx(105e-6), 3)}
    assert red["gaps"] == pytest.approx({"serve.pack": 40e-6, "serve.batch": 5e-6,
                                         "cudaMemcpyAsync": 40e-6, "python": 10e-6})
    assert sum(red["gaps"].values()) == pytest.approx(red["window_s"] - red["busy_s"])
    assert trace.breakdown(red)["idle_gaps"][0] == ["serve.pack", pytest.approx(40e-6)]


def test_train_readers_read_planted_spans(registry):
    """Four steps, staging 20 ms each, waiting 250 ms each for the previous
    batch's copies and 270 ms more at one log point."""
    timers, clock = registry
    timers.set_spans(True)
    for step in range(4):
        _span(timers, clock, "fit.wait", 250)
        _span(timers, clock, "fit.stage", 20)
        _span(timers, clock, "fit.launch", 1)
        if step == 2:
            _span(timers, clock, "fit.wait", 270)
    got = {name: reader(name).read({}, None) for name in TRAIN}
    assert got == pytest.approx({"host_stage_ms.train": 20.0,
                                 "host_wait_ms.train": (4 * 250 + 270) / 4})


RUN = """
import json, sys
import torch
torch.set_num_threads(2)
sys.path.insert(0, {root!r})
from pathlib import Path
from perfbench import run
from perfbench.common import Cell

spec, bench = Path({spec!r}), Path({bench!r})
run.card_or_refuse = lambda chips: torch.device("cpu")
run.Cell = lambda name: Cell(name, spec, bench)
run.device_info = lambda chips, peak: {{"platform": "cpu", "count": chips,
                                        "memory_peak_bytes": peak}}
sys.exit(run.main(["--workload", {name!r}, "--seed", "2147483777", "--seconds", "3",
                   "--trace", "1"]))
"""


@pytest.mark.parametrize("name, metrics", [("tiny.serve", SERVE), ("tiny.train", TRAIN)])
def test_traced_run_ends_with_its_result_line(tiny_bench, name, metrics):
    """``run.main`` of a tiny cell with ``--trace 1`` (the look for a card
    replaced), the new metrics in its entry: the last line of standard
    output is the result, with every new metric the program recorded."""
    spec, bench = tiny_bench
    entry = json.loads(spec.read_text())
    kept = [m for m in entry["per_layer"] if m["name"] not in SERVE + TRAIN]
    entry["per_layer"] = kept + [
        {"name": m, "unit": "ms", "better": "lower", "source": "program_span", "layer": "test",
         "moves": "serve_frames_per_s" if m in SERVE else "train_seqs_per_s",
         "workloads": [name]} for m in metrics]
    spec = spec.with_name(f"{name}.BENCHMARK.json")
    spec.write_text(json.dumps(entry))
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), spec=str(spec), bench=str(bench),
                                          name=name)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(metrics) <= set(line["metrics"]), line["metrics"]
    assert all(line["metrics"][m]["value"] >= 0 for m in metrics)
