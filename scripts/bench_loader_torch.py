#!/usr/bin/env python3
"""Host data-pipeline throughput of the port: batches/s of
``data/module.DataModule.train_batches`` per sampling mode (port of
scripts/bench_loader.py).

The training loop is fed from the host (HDF5 read, augmentation, batch
assembly, the prefetch thread; ``sast_tpu_torch/data/``), so the loader's
rate bounds trained frames/s. This script measures it at the gen1-base
recipe geometry (B 8, T 21) for the ``stream``, ``random`` and ``mixed``
training samplers and the evaluation stream, over a synthetic dataset in
the preprocessed layout: ``--data``, or one that ``scripts/
make_synth_dataset.py`` (numpy and h5py only, shared with the JAX package)
writes there first, run as a subprocess as the JAX script runs it.

With ``--step-ms`` (a train step's time on the card, from
``bench_train_sparsity_torch.py`` or ``profile_train_torch.py``) each row
gets a verdict: OK when the loader sustains ``1000 / step-ms`` batches/s,
else BOTTLENECK. The JAX script's table of device step times held TPU
times and is not carried over; without ``--step-ms`` there is no verdict.
Its ``--no-malloc-retain`` (a glibc arena tuning of the JAX package) has no
counterpart.

    python scripts/bench_loader_torch.py [--data DIR] [--batches 30]
        [--batch-size 8] [--seq-len 21] [--step-ms X]

Runs on the host only: the dataset reader needs ``h5py``, which the card's
machine lacks, so this CLI runs where ``h5py`` is installed. Prints a table,
then one JSON line per row.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sast_tpu_torch.utils import profiling  # noqa: E402

EV_REPR = "stacked_histogram_dt=50_nbins=10"  # what make_synth_dataset.py writes
MODES = ("stream", "random", "mixed")


def ensure_dataset(path: Path, seqs: int, frames: int, layout: str = "tchw") -> Path:
    """``path`` if it holds a dataset of ``layout`` (refused if it holds
    another layout), else a new one written by ``make_synth_dataset.py``."""
    if (path / "train").is_dir():
        import h5py

        h5 = next((path / "train").glob("*/event_representations_v2/*/*.h5"))
        with h5py.File(str(h5), "r") as f:
            found = f["data"].attrs.get("layout", "TCHW")
        found = found.decode() if isinstance(found, bytes) else found
        if found.lower() != layout:
            raise SystemExit(f"bench_loader_torch.py: the dataset at {path} is {found}, but "
                             f"--layout {layout} was asked for")
        return path
    print(f"# generating a synthetic dataset at {path}", file=sys.stderr)
    subprocess.run([sys.executable, str(ROOT / "scripts" / "make_synth_dataset.py"), str(path),
                    "--seqs", str(seqs), "--frames", str(frames), "--layout", layout],
                   check=True, stdout=subprocess.DEVNULL)
    return path


def loader_config(get_config, root, seq_len: int, batch_size: int, mode: str = "stream"):
    """The gen1-base configuration over the dataset at ``root`` with
    ``train_sampling`` ``mode``; ``get_config`` is a package's preset
    function (the port's here; a test passes the JAX package's)."""
    cfg = get_config("gen1", "base")
    ds = dataclasses.replace(cfg.dataset, path=str(root), ev_repr_name=EV_REPR,
                             sequence_length=seq_len, train_sampling=mode)
    tr = dataclasses.replace(cfg.training, batch_size_train=batch_size,
                             batch_size_eval=batch_size)
    return dataclasses.replace(cfg, dataset=ds, training=tr)


def time_iterator(it, n_batches: int, warmup: int = 5):
    """(batches/s, p50 ms, p95 ms) over ``n_batches`` after ``warmup``."""
    for _ in range(warmup):
        next(it)
    ts = []
    t0 = time.perf_counter()
    for _ in range(n_batches):
        t_a = time.perf_counter()
        next(it)
        ts.append(time.perf_counter() - t_a)
    total = time.perf_counter() - t0
    ms = np.asarray(ts) * 1e3
    return n_batches / total, float(np.percentile(ms, 50)), float(np.percentile(ms, 95))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default=str(ROOT / "runs" / "loader_bench_data"))
    ap.add_argument("--seqs", type=int, default=8)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--batches", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=21)
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--layout", choices=("tchw", "thwc"), default="tchw")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="a train step's time on the card, for the OK/BOTTLENECK verdict")
    args = ap.parse_args(argv)

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.module import DataModule

    data_dir = args.data
    if args.layout != "tchw" and data_dir == ap.get_default("data"):
        data_dir += f"_{args.layout}"  # one default directory per layout
    root = ensure_dataset(Path(data_dir), args.seqs, args.frames, args.layout)
    B, T = args.batch_size, args.seq_len
    need = 1e3 / args.step_ms if args.step_ms else None
    prefetch = not args.no_prefetch
    rows = []
    for mode in MODES:
        dm = DataModule(loader_config(get_config, root, T, B, mode))
        it = iter(dm.train_batches(prefetch=prefetch))
        bps, p50, p95 = time_iterator(it, args.batches, args.warmup)
        rows.append(dict(metric="loader", split=f"train/{mode}", batches_per_s=bps,
                         frames_per_s=bps * B * T, p50_ms=p50, p95_ms=p95))
        if hasattr(it, "close"):
            it.close()
    dm = DataModule(loader_config(get_config, root, T, B))
    it = iter(dm.eval_batches("val", prefetch=prefetch))
    try:
        bps, p50, p95 = time_iterator(it, min(args.batches, 10), warmup=1)
        rows.append(dict(metric="loader", split="eval/stream", batches_per_s=bps,
                         frames_per_s=bps * B * T, p50_ms=p50, p95_ms=p95))
    except StopIteration:
        print("# the evaluation split is too small for the asked batch count")
    for r in rows:
        r.update(batch=B, seq_len=T, prefetch=prefetch, data=str(root), need_batches_per_s=need,
                 verdict=None if need is None else ("OK" if r["batches_per_s"] >= need
                                                    else "BOTTLENECK"))
    profiling.emit(f"# gen1-base loader, B={B} T={T} over {root} (prefetch {prefetch})"
                   + (f"; the card needs >= {need:.2f} batches/s" if need else ""), rows,
                   ("split", "batches_per_s", "frames_per_s", "p50_ms", "p95_ms", "verdict"))


if __name__ == "__main__":
    main()
