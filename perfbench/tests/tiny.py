"""A tiny cell of each loop for the CPU tests: a benchmark folder of its
own in ``tmp`` with a configuration, mixes, limits and a metric reader, the
loops, generator and readers of the real one beside them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.common import BENCH_DIR

CONFIG = {
    "name": "tiny", "source": "a test size of the gen1 experiment",
    "experiment": {"dataset": "gen1", "size": "tiny",
                   "overrides": {"dataset.resolution_hw_override": [60, 90],
                                 "model.compute_dtype": "float32",
                                 "model.postprocess.pre_nms_topk": 64,
                                 "model.postprocess.max_detections": 16,
                                 "model.head.max_gt": 8,
                                 "training.batch_size_train": 2,
                                 "training.max_labeled_frames_per_lane": 2,
                                 "dataset.sequence_length": 2}},
    "sensor_hw": [60, 90], "model_hw": [64, 96], "input_channels": 20, "embed_dim": 32,
    "dim_multiplier": [1, 2, 4, 8], "num_blocks": [1, 1, 1, 1], "dim_head": 32,
    "mlp_ratio": 4, "partition_size": [2, 3], "num_classes": 2, "fpn_depth": 0.33,
    "count_cutoff": 10, "confidence_threshold": 0.01, "nms_threshold": 0.45,
    "pre_nms_topk": 64, "max_detections": 16, "compute_dtype": "float32",
    "batch_size_train": 2, "sequence_length": 2, "max_labeled_frames_per_lane": 2, "max_gt": 8,
    "learning_rate": 2e-4, "lr_total_steps": 600000, "lr_pct_start": 0.005,
    "lr_div_factor": 20.0, "lr_final_div_factor": 10000.0, "gradient_clip_val": 1.0,
    "weight_decay": 0.0, "ema_decay": 0.0, "remat_policy": "full", "precision": "bfloat16",
    "reduced": []}
SERVE = {"loop": "serve", "generator": "clustered", "lanes": 4, "max_events": 3000,
         "events_min": 500, "events_max": 3000, "sigma_px": 6.0, "drift_px": 1.0,
         "reset_frames": 16, "pool_frames": 4, "warmup_batches": 1, "check_triples": 1,
         "check_lanes": 2, "check_horizon": 8, "trace_batches": 2}
TRAIN = {"loop": "train", "generator": "clustered", "lanes": 2, "seq_len": 2,
         "labeled_frames": 2, "max_gt": 8, "events_min": 3000, "events_max": 3000,
         "sigma_px": 6.0, "drift_px": 1.0, "pool_batches": 2, "trace_steps": 1}
# float32 on both sides here: the program's plain path and the reference
# agree to rounding, and Adam's first updates move elements whose gradient
# sits at rounding level either way (a leaf's change by ~1%).
LIMITS = {"serve": {"state_gap": 1e-4, "slate_miss": 1e-3},
          "train": {"obj_gap": 1e-4, "change_gap": 0.05}}
READER = '''"""Calls in the traced stretch (a test's reader)."""


def read(readings, cell):
    red = readings.get("trace") or {}
    return red.get("calls")
'''


def make(tmp: Path) -> Path:
    """The tiny benchmark in ``tmp``: returns its ``BENCHMARK.json``."""
    bench = tmp / "bench"
    for sub in ("loops", "traffic", "metrics"):
        shutil.copytree(BENCH_DIR / sub, bench / sub)
    (bench / "configs").mkdir()
    (bench / "limits").mkdir()
    (bench / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (bench / "traffic" / "tiny.serve.json").write_text(json.dumps(SERVE))
    (bench / "traffic" / "tiny.train.json").write_text(json.dumps(TRAIN))
    (bench / "metrics" / "traced_calls.py").write_text(READER)
    for kind, lim in LIMITS.items():
        (bench / "limits" / f"tiny.{kind}.json").write_text(json.dumps(
            {"compared": {k: {"limit": v} for k, v in lim.items()}}))
    spec = {
        "command": ["python3", "bench/run.py"], "paths": ["bench"], "run_seconds": 1,
        "configs": [{"name": "tiny", "source": "test", "file": "bench/configs/tiny.json",
                     "reduced": [], "why": "test"}],
        "workloads": [{"name": "tiny.serve", "config": "tiny", "traffic": "tiny.serve",
                       "chips": 1, "why": "test"},
                      {"name": "tiny.train", "config": "tiny", "traffic": "tiny.train",
                       "chips": 1, "why": "test"}],
        "end_to_end": [
            {"name": "serve_frames_per_s", "unit": "frames/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": ["tiny.serve"]},
            {"name": "serve_latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "host_clock", "workloads": ["tiny.serve"]},
            {"name": "train_seqs_per_s", "unit": "sequences/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": ["tiny.train"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [
            {"name": "traced_calls", "unit": "calls", "better": "higher",
             "source": "device_trace", "layer": "test", "moves": "serve_frames_per_s",
             "workloads": ["tiny.serve"]},
            {"name": "step_card_ms.train", "unit": "ms", "better": "lower",
             "source": "device_trace", "layer": "captured train step",
             "moves": "train_seqs_per_s", "workloads": ["tiny.train"]}]}
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path
