"""Metric logging to JSONL (the port's own copy of the part of
sast_tpu/utils/logging.py that the trainer uses; Weights & Biases is not
ported)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    """Appends one JSON row per ``log`` call to ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": int(step), "time": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class SmoothedValue:
    """Running average over all steps."""

    def __init__(self):
        self.count = 0
        self.value = 0.0

    def update(self, v: float) -> float:
        self.value = (self.value * self.count + float(v)) / (self.count + 1)
        self.count += 1
        return self.value
