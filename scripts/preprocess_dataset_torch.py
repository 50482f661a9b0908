"""Offline preprocessing with the PyTorch port: raw Prophesee events -> the
preprocessed GenX layout (port of scripts/preprocess_dataset.py; the same
command line and the same files).

Reads raw event .h5 files and .npy box files, applies the label filter
chain, aligns label-frame and event-representation timestamps, tensorizes
event windows into stacked histograms (or mixed-density stacks) with the
port's ``data/representations.py`` on ``--device`` (the card by default),
and writes the per-sequence layout that ``sast_tpu_torch.data.sequence``
reads:

    <out>/<split>/<seq>/labels_v2/labels.npz, timestamps_us.npy
    <out>/<split>/<seq>/event_representations_v2/<name>/
        event_representations[_ds2_nearest].h5, objframe_idx_2_repr_idx.npy,
        timestamps_us.npy

The time correction, the scatter-add, the 2x downsample and the THWC
transpose run in torch (JAX's package uses numpy or its C++ fast path);
every file equals the JAX script's bit for bit. Compression is blosc where
``hdf5plugin`` imports, else h5py's lzf. Restartable: ``*_in_progress``
files, an atomic rename, and checks that what exists matches. ``h5py`` is
imported inside the functions that read and write HDF5.

Usage:
    python scripts/preprocess_dataset_torch.py IN_DIR OUT_DIR -ds gen1 \\
        --repr stacked_histogram --nbins 10 --count-cutoff 10 --dt-ms 50 -np 4
    (--device cpu runs the CPU versions)
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import shutil
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sast_tpu_torch.data.representations import (  # noqa: E402
    MixedDensityEventStack,
    StackedHistogram,
    downsample2x_nearest_u8,
    monotonize_time,
    transpose_tchw_to_thwc,
)

DATASET_HW = {"gen1": (240, 304), "gen4": (720, 1280)}

# Sequences whose labels all vanish after filtering (reference
# preprocess_dataset.py:58-64).
DIRS_TO_IGNORE = {
    "gen1": (
        "17-04-06_09-57-37_6344500000_6404500000",
        "17-04-13_19-17-27_976500000_1036500000",
        "17-04-06_15-14-36_1159500000_1219500000",
        "17-04-11_15-13-23_122500000_182500000",
    ),
    "gen4": (),
}


class NoLabelsException(Exception):
    pass


def _h5py():
    """``h5py``, with the blosc filter registered where ``hdf5plugin`` is
    installed."""
    try:
        import hdf5plugin  # noqa: F401
    except ImportError:
        pass
    import h5py

    return h5py


def _compression_opts():
    try:
        import hdf5plugin
    except ImportError:
        return dict(compression="lzf")
    return dict(hdf5plugin.Blosc(cname="zstd", clevel=1, shuffle=hdf5plugin.Blosc.SHUFFLE))


# ---------------------------------------------------------------------------
# raw event reading
# ---------------------------------------------------------------------------


class RawEventReader:
    """Raw Prophesee event .h5: events/{x,y,p,t} (+ height/width). The
    timestamps are made non-decreasing on ``device``."""

    def __init__(self, h5_file: Path, dataset: str, device):
        self.h5f = _h5py().File(str(h5_file), "r")
        self.device = device
        ev = self.h5f["events"]
        try:
            self.height = int(ev["height"][()])
            self.width = int(ev["width"][()])
        except KeyError:
            self.height, self.width = DATASET_HW[dataset]
        self._time: Optional[np.ndarray] = None

    def close(self):
        self.h5f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @property
    def time(self) -> np.ndarray:
        if self._time is None:
            t = np.asarray(self.h5f["events"]["t"], np.int64)
            if t[0] < 0:
                raise ValueError("negative first timestamp")
            self._time = monotonize_time(torch.from_numpy(t).to(self.device)).cpu().numpy()
        return self._time

    def get_event_slice(self, lo: int, hi: int):
        ev = self.h5f["events"]
        return dict(
            x=np.asarray(ev["x"][lo:hi], np.int64),
            y=np.asarray(ev["y"][lo:hi], np.int64),
            p=np.clip(np.asarray(ev["p"][lo:hi], np.int64), 0, None),
            t=self.time[lo:hi],
        )


# ---------------------------------------------------------------------------
# label filter chain (reference :191-267)
# ---------------------------------------------------------------------------


def filter_labels(labels: np.ndarray, dataset: str, is_train: bool,
                  apply_psee_bbox_filter: bool, apply_faulty_bbox_filter: bool) -> np.ndarray:
    h_frame, w_frame = DATASET_HW[dataset]

    if dataset == "gen4":
        # keep pedestrian / two-wheeler / car (class_id <= 2)
        labels = labels[labels["class_id"] <= 2]

    # crop to the field of view
    x0 = np.clip(labels["x"], 0, w_frame - 1)
    y0 = np.clip(labels["y"], 0, h_frame - 1)
    x1 = np.clip(labels["x"] + labels["w"], 0, w_frame - 1)
    y1 = np.clip(labels["y"] + labels["h"], 0, h_frame - 1)
    labels = labels.copy()
    labels["x"], labels["y"] = x0, y0
    labels["w"], labels["h"] = x1 - x0, y1 - y0
    labels = labels[(labels["w"] > 0) & (labels["h"] > 0)]

    w, h = labels["w"], labels["h"]
    if apply_psee_bbox_filter:
        min_diag = 60 if dataset == "gen4" else 30
        min_side = 20 if dataset == "gen4" else 10
        keep = (w ** 2 + h ** 2 >= min_diag ** 2) & (w >= min_side) & (h >= min_side)
        labels = labels[keep]
    else:
        labels = labels[(w >= 5) & (h >= 5)]

    if is_train and apply_faulty_bbox_filter:
        labels = labels[labels["w"] <= (9 * w_frame) // 10]
    return labels


# ---------------------------------------------------------------------------
# timestamp alignment (reference :288-428)
# ---------------------------------------------------------------------------


def base_label_delta_us(unique_ts_us: np.ndarray, dataset: str) -> int:
    if dataset == "gen1":
        return 250_000  # 4 Hz labels
    median = np.median(np.diff(unique_ts_us))
    hz = int(np.rint(1e6 / median))
    if hz not in (30, 60):
        raise ValueError(f"gen4 labels at {hz} Hz, expected 30 or 60")
    return int(6 * median if hz == 60 else 3 * median)


def labels_and_ev_repr_timestamps(
    npy_file: Path,
    dataset: str,
    is_train: bool,
    align_t_ms: int,
    ts_step_ev_repr_ms: int,
    apply_psee_bbox_filter: bool = True,
    apply_faulty_bbox_filter: bool = True,
    tick_mode: str = "reference",
):
    """Frame selection and event-representation tick placement, as the JAX
    script's. ``tick_mode`` ``'reference'`` (default) places the reference's
    ``count * (100 ms // dt)`` ticks per label gap (2 per gen1 250 ms gap;
    required to read reference-preprocessed data or checkpoints alike);
    ``'physical'`` ticks on the true dt grid (5 per gen1 gap at dt 50 ms).
    Both coincide for gen4."""
    labels = np.load(str(npy_file))
    if len(labels) == 0:
        raise ValueError(f"{npy_file} holds no labels")
    labels = filter_labels(labels, dataset, is_train, apply_psee_bbox_filter,
                           apply_faulty_bbox_filter)
    if labels.size == 0:
        raise NoLabelsException

    align_t_us = align_t_ms * 1000
    delta_t_us = ts_step_ev_repr_ms * 1000
    ts_step_frame_ms = 100
    if ts_step_frame_ms % ts_step_ev_repr_ms:
        raise ValueError(f"dt {ts_step_ev_repr_ms} ms must divide {ts_step_frame_ms} ms")

    unique_ts = np.unique(np.asarray(labels["t"], np.int64))
    base_delta = base_label_delta_us(unique_ts, dataset)

    first = int(np.searchsorted(unique_ts, align_t_us, side="left"))
    frame_ts = [int(unique_ts[first])]
    reprs_between: List[int] = []
    if tick_mode == "reference":
        reprs_per_base = ts_step_frame_ms // ts_step_ev_repr_ms
    elif tick_mode == "physical":
        reprs_per_base = max(1, round(base_delta / delta_t_us))
    else:
        raise ValueError(f"tick_mode {tick_mode!r}")
    for i in range(first + 1, len(unique_ts)):
        ts = int(unique_ts[i])
        diff = ts - frame_ts[-1]
        count = round(diff / base_delta)
        if abs(diff - count * base_delta) <= 2000:  # <= 2 ms jitter
            if count <= 0:
                raise RuntimeError(f"label times {frame_ts[-1]} and {ts} round to one frame")
            frame_ts.append(ts)
            reprs_between.append(count * reprs_per_base)
    frame_ts = np.asarray(frame_ts, np.int64)

    lo = np.searchsorted(labels["t"], frame_ts, side="left")
    hi = np.searchsorted(labels["t"], frame_ts, side="right")
    labels_per_frame = [labels[a:b] for a, b in zip(lo, hi)]

    # Event representation end times: warm-up ticks before the first frame,
    # then ticks interpolated between consecutive frames.
    ev_ts = list(reversed(range(int(frame_ts[0]), 0, -delta_t_us)))[1:-1]
    for idx, (n_between, t0, t1) in enumerate(zip(reprs_between, frame_ts[:-1], frame_ts[1:])):
        edges = np.linspace(t0, t1, n_between + 1).astype(np.int64).tolist()
        if idx != len(reprs_between) - 1:
            edges = edges[:-1]
        ev_ts.extend(edges)
    if len(frame_ts) == 1:
        ev_ts.append(int(frame_ts[0]))
    ev_ts = np.asarray(ev_ts, np.int64)

    frameidx_2_repridx = np.searchsorted(ev_ts, frame_ts, side="left")
    for lab, fts, ridx in zip(labels_per_frame, frame_ts, frameidx_2_repridx):
        if not lab["t"][0] == fts == ev_ts[ridx]:
            raise RuntimeError(f"frame at {fts} us is not on a representation tick")
    return labels_per_frame, frame_ts, ev_ts, frameidx_2_repridx


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def _save_or_match(path: Path, data: np.ndarray) -> None:
    """Write ``data`` as ``path``, or check that the existing file holds it
    (a restarted run)."""
    if path.exists():
        if not np.array_equal(np.load(str(path)), data):
            raise RuntimeError(f"{path} exists with other contents")
    else:
        np.save(str(path), data)


def save_labels(out_dir: Path, labels_per_frame, frame_ts: np.ndarray) -> None:
    start_idx = np.cumsum([0] + [len(lab) for lab in labels_per_frame[:-1]])
    all_labels = np.concatenate(labels_per_frame)
    outfile = out_dir / "labels.npz"
    if outfile.exists():
        old = np.load(str(outfile))
        if not (np.array_equal(old["labels"], all_labels)
                and np.array_equal(old["objframe_idx_2_label_idx"], start_idx)):
            raise RuntimeError(f"{outfile} exists with other contents")
    else:
        np.savez(str(outfile), labels=all_labels, objframe_idx_2_label_idx=start_idx)
    _save_or_match(out_dir / "timestamps_us.npy", frame_ts)


def downsample_ev_repr_by2(x: torch.Tensor) -> torch.Tensor:
    """(C, H, W) nearest-exact 2x downsample; int8 passes through uint8 with
    an offset of 128, as the reference does."""
    if x.dtype == torch.int8:
        u8 = (x.to(torch.int16) + 128).to(torch.uint8)
        return (downsample2x_nearest_u8(u8).to(torch.int16) - 128).to(torch.int8)
    return downsample2x_nearest_u8(x)


def write_event_representations(
    in_h5: Path,
    ev_out_dir: Path,
    dataset: str,
    representation,
    ev_repr_timestamps_us: np.ndarray,
    delta_ts_ms: Optional[int],
    num_events: Optional[int],
    downsample_by_2: bool,
    layout: str = "tchw",
) -> None:
    """``layout='thwc'`` stores frames in the model's NHWC layout (with a
    ``layout`` HDF5 attribute the reader keys on); 'tchw' keeps the
    reference's channel-first layout."""
    suffix = "_ds2_nearest" if downsample_by_2 else ""
    outfile = ev_out_dir / f"event_representations{suffix}.h5"
    if outfile.exists():
        return
    in_progress = outfile.parent / (outfile.stem + "_in_progress" + outfile.suffix)
    if in_progress.exists():
        os.remove(in_progress)
    if layout not in ("tchw", "thwc"):
        raise ValueError(f"layout {layout!r}")

    shape = tuple(representation.get_shape())
    if downsample_by_2:
        shape = (shape[0], shape[1] // 2, shape[2] // 2)
    if layout == "thwc":
        shape = (shape[1], shape[2], shape[0])
    h5py = _h5py()
    with RawEventReader(in_h5, dataset, representation.device) as reader, \
            h5py.File(str(in_progress), "w") as out:
        dset = out.create_dataset(
            "data", dtype=representation.get_numpy_dtype(),
            shape=(len(ev_repr_timestamps_us), *shape), chunks=(1, *shape),
            **_compression_opts(),
        )
        dset.attrs["layout"] = "THWC" if layout == "thwc" else "TCHW"
        ev_ts = reader.time
        end_idx = np.searchsorted(ev_ts, ev_repr_timestamps_us, side="right")
        if num_events is not None:
            start_idx = np.maximum(end_idx - num_events, 0)
        else:
            start_idx = np.searchsorted(ev_ts, ev_repr_timestamps_us - delta_ts_ms * 1000,
                                        side="left")
        for i, (lo, hi) in enumerate(zip(start_idx, end_idx)):
            win = reader.get_event_slice(int(lo), int(hi))
            rep = representation.construct_tensor(win["x"], win["y"], win["p"], win["t"])
            if downsample_by_2:
                rep = downsample_ev_repr_by2(rep)
            if layout == "thwc":
                rep = transpose_tchw_to_thwc(rep[None])[0]
            dset[i] = rep.cpu().numpy()
    os.rename(in_progress, outfile)


# ---------------------------------------------------------------------------
# sequence / dataset drivers
# ---------------------------------------------------------------------------


def repr_name(args) -> str:
    num_events = getattr(args, "num_events", None)
    agg = f"ne={num_events}" if num_events else f"dt={args.dt_ms}"
    base = "stacked_histogram" if args.repr == "stacked_histogram" else "mixeddensity_stack"
    return f"{base}_{agg}_nbins={args.nbins}"


def build_representation(args, hw: Tuple[int, int]):
    cls = StackedHistogram if args.repr == "stacked_histogram" else MixedDensityEventStack
    return cls(bins=args.nbins, height=hw[0], width=hw[1], count_cutoff=args.count_cutoff,
               device=args.device)


def process_sequence(task) -> str:
    (in_npy, in_h5, out_seq_dir, dataset, is_train, args_dict) = task
    args = argparse.Namespace(**args_dict)
    out_labels = out_seq_dir / "labels_v2"
    out_ev = out_seq_dir / "event_representations_v2" / repr_name(args)
    out_labels.mkdir(parents=True, exist_ok=True)
    out_ev.mkdir(parents=True, exist_ok=True)

    try:
        labels_per_frame, frame_ts, ev_ts, f2r = labels_and_ev_repr_timestamps(
            in_npy, dataset, is_train, align_t_ms=100, ts_step_ev_repr_ms=args.dt_ms,
            apply_psee_bbox_filter=not args.no_psee_filter,
            apply_faulty_bbox_filter=not args.no_faulty_filter,
            tick_mode=args.ticks,
        )
    except NoLabelsException:
        shutil.rmtree(out_seq_dir)
        return f"{out_seq_dir.name}: no labels after filtering, removed"

    save_labels(out_labels, labels_per_frame, frame_ts)
    _save_or_match(out_ev / "objframe_idx_2_repr_idx.npy", f2r)
    _save_or_match(out_ev / "timestamps_us.npy", ev_ts)

    num_events = getattr(args, "num_events", None)
    write_event_representations(
        in_h5, out_ev, dataset, build_representation(args, DATASET_HW[dataset]), ev_ts,
        delta_ts_ms=None if num_events else args.dt_ms, num_events=num_events,
        downsample_by_2=args.downsample_by_2, layout=args.layout,
    )
    return f"{out_seq_dir.name}: ok ({len(ev_ts)} reprs, {len(frame_ts)} frames)"


def find_sequences(split_dir: Path) -> List[Tuple[Path, Path, str]]:
    """(npy, h5, name) triples. gen1: <seq>_bbox.npy + <seq>_td.dat.h5."""
    out = []
    for npy in sorted(split_dir.glob("*_bbox.npy")):
        stem = npy.name[: -len("_bbox.npy")]
        for suffix in ("_td.dat.h5", "_td.h5", ".h5"):
            h5 = split_dir / f"{stem}{suffix}"
            if h5.exists():
                out.append((npy, h5, stem))
                break
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input_dir", type=Path)
    ap.add_argument("output_dir", type=Path)
    ap.add_argument("-ds", "--dataset", choices=("gen1", "gen4"), required=True)
    ap.add_argument("--repr", choices=("stacked_histogram", "mixeddensity_stack"),
                    default="stacked_histogram")
    ap.add_argument("--nbins", type=int, default=10)
    ap.add_argument("--count-cutoff", type=int, default=10)
    ap.add_argument("--dt-ms", type=int, default=50,
                    help="event-window duration (DURATION aggregation)")
    ap.add_argument("--num-events", type=int, default=None,
                    help="fixed event count per window (COUNT aggregation, overrides the "
                         "duration window)")
    ap.add_argument("--downsample-by-2", action="store_true",
                    help="additionally write the _ds2_nearest variant (gen4)")
    ap.add_argument("--layout", choices=("tchw", "thwc"), default="tchw",
                    help="per-frame on-disk layout: tchw = the reference's channel-first; "
                         "thwc = the model's NHWC layout")
    ap.add_argument("--ticks", choices=("reference", "physical"), default="reference",
                    help="event-repr tick placement (see labels_and_ev_repr_timestamps)")
    ap.add_argument("--no-psee-filter", action="store_true")
    ap.add_argument("--no-faulty-filter", action="store_true")
    ap.add_argument("-np", "--num-processes", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the representations are computed (default: the card)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("CUDA is not available: pass --device cpu to run on the CPU")

    tasks = []
    for split in ("train", "val", "test"):
        split_in = args.input_dir / split
        if not split_in.is_dir():
            continue
        for npy, h5, name in find_sequences(split_in):
            if name in DIRS_TO_IGNORE[args.dataset]:
                print(f"skipping ignored sequence {name}")
                continue
            tasks.append((npy, h5, args.output_dir / split / name, args.dataset,
                          split == "train", vars(args)))

    print(f"{len(tasks)} sequences to process")
    if args.num_processes > 1:
        with mp.get_context("spawn").Pool(args.num_processes) as pool:
            for msg in pool.imap_unordered(process_sequence, tasks):
                print(msg)
    else:
        for task in tasks:
            print(process_sequence(task))


if __name__ == "__main__":
    main()
