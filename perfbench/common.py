"""What every cell's run shares: the benchmark's files by name, the card,
the guard against JAX, statistics, and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sast_tpu")


class Refused(RuntimeError):
    """A run that cannot measure: no result is printed, the exit code is 2."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by its file (names may hold dots)."""
    if not path.is_file():
        raise Refused(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` in ``BENCHMARK.json`` with the files it
    names: ``configs/<config>.json`` (through the ``file`` of its
    configuration), ``traffic/<traffic>.json`` (whose ``generator`` names
    ``traffic/<generator>.py`` and whose ``loop`` names
    ``loops/<loop>.py``), ``limits/<name>.json`` and one reader
    ``metrics/<metric>.py`` per metric of the cell."""

    def __init__(self, name: str, spec_path: Path = ROOT / "BENCHMARK.json",
                 bench_dir: Path = BENCH_DIR):
        self.dir = bench_dir
        if not spec_path.is_file():
            raise Refused(f"{spec_path} is missing")
        spec = load_json(spec_path)
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.spec = spec
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        config = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config = load_json(spec_path.parent / config["file"])
        self.mix = load_json(bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(bench_dir / "limits" / f"{name}.json")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        return [m for m in self.spec["per_layer"] if self.name in m.get("workloads", [self.name])]

    def generator(self) -> ModuleType:
        return load_module(self.dir / "traffic" / f"{self.mix['generator']}.py")

    def loop(self) -> ModuleType:
        return load_module(self.dir / "loops" / f"{self.mix['loop']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py")


def use_checkout_caches() -> None:
    """Every kernel and build cache inside the checkout, at fixed paths (the
    port builds its own kernels under ``build/sast_tpu_torch``)."""
    cache = ROOT / "build" / "perfbench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_or_refuse(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("CUDA is not available: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def jax_loaded() -> List[str]:
    """Modules of JAX or of the JAX package in this process, by their
    top-level names compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].split(",")[-1].strip() if out.returncode == 0 and line else None


def device_info(chips: int, memory_peak_bytes: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": memory_peak_bytes, "power_limit": power_limit()}


def p95(values: List[float]) -> float:
    """The 95th percentile; of a single value, that value."""
    return statistics.quantiles(values, n=100)[94] if len(values) > 1 else values[0]


class Clock:
    """Seconds since the run's process started its measurement of set-up."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)
