"""On-disk sequence reading for the preprocessed GenX datasets (the port's
own copy of sast_tpu/data/sequence.py).

Reads the standard RVT/SAST preprocessed layout:

    <seq>/event_representations_v2/<repr_name>/
        event_representations[_ds2_nearest].h5   (dataset 'data', blosc chunks)
        objframe_idx_2_repr_idx.npy
        timestamps_us.npy
    <seq>/labels_v2/labels.npz                   ('labels', 'objframe_idx_2_label_idx')

plus the clip-splitting logic of the streaming dataset: length-`seq_len`
windows aligned so that every training clip contains at least one labeled
frame, zero-padding + padding masks for the tail, and random-access samples
= the seq_len representations ending at a labeled frame.

``h5py`` is the one third-party import of the port besides torch and numpy,
and only this module imports it, inside a function: the rest of the port,
``data/module.py`` included, imports where ``h5py`` is absent, and only
reading a dataset needs it. blosc-compressed HDF5 also needs the optional
``hdf5plugin`` filter (uncompressed h5 works without it).
"""

from __future__ import annotations

import contextlib
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from sast_tpu_torch.config import DATASET_RES_HW
from sast_tpu_torch.data.labels import FrameLabels, LabelStore


def _h5py():
    """The ``h5py`` module, with the blosc filter registered where
    ``hdf5plugin`` is installed."""
    try:  # optional C plugin for blosc-compressed datasets
        import hdf5plugin  # noqa: F401
    except ImportError:
        pass
    import h5py

    return h5py


class SequenceReader:
    """One recorded sequence: event representations + sparse labels."""

    def __init__(
        self,
        path: Path,
        ev_repr_name: str,
        dataset_name: str,
        downsample_by_factor_2: bool = False,
    ):
        path = Path(path)
        assert path.is_dir(), path
        ev_dir = path / "event_representations_v2" / ev_repr_name
        ds_suffix = "_ds2_nearest" if downsample_by_factor_2 else ""
        self.ev_repr_file = ev_dir / f"event_representations{ds_suffix}.h5"
        assert self.ev_repr_file.exists(), self.ev_repr_file
        self.path = path
        self.name = path.name

        label_data = np.load(str(path / "labels_v2" / "labels.npz"))
        self.labels = LabelStore(
            labels=label_data["labels"],
            objframe_idx_2_label_idx=label_data["objframe_idx_2_label_idx"],
            input_size_hw=DATASET_RES_HW[dataset_name],
            downsample_factor=2 if downsample_by_factor_2 else None,
        )
        self.objframe_idx_2_repr_idx = np.load(
            str(ev_dir / "objframe_idx_2_repr_idx.npy")
        ).astype(np.int64)
        self._repr_idx_2_objframe_idx = {
            int(r): int(i) for i, r in enumerate(self.objframe_idx_2_repr_idx)
        }
        with _h5py().File(str(self.ev_repr_file), "r") as f:
            self.num_ev_repr = f["data"].shape[0]
            # Per-frame layout on disk: "TCHW" (reference-compatible
            # default) or "THWC" (our preprocess --layout thwc: the model's
            # NHWC layout written once offline so the loader never
            # transposes). ev_repr_shape is normalized to (C, H, W).
            layout = f["data"].attrs.get("layout", "TCHW")
            if isinstance(layout, bytes):
                layout = layout.decode()
            assert layout in ("TCHW", "THWC"), layout
            self._disk_layout = layout
            s = f["data"].shape[1:]
            self.ev_repr_shape = (s[2], s[0], s[1]) if layout == "THWC" else s
        self._h5: Optional["h5py.File"] = None
        # h5py handles are not thread-safe; batch lanes fetching in parallel
        # (data/streaming.py) serialize per sequence through this lock.
        self._lock = threading.Lock()

    # -- raw access ---------------------------------------------------------
    def _file(self) -> "h5py.File":
        if self._h5 is None:
            self._h5 = _h5py().File(str(self.ev_repr_file), "r")
        return self._h5

    def close(self) -> None:
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def get_ev_repr(
        self, start: int, end: int, file: Optional["h5py.File"] = None
    ) -> np.ndarray:
        """[start, end) representations as (T, H, W, C) uint8 (NHWC).

        ``file``: an independent read handle (``open_handle``) — readers
        that stream one sequence from several batch lanes concurrently pass
        their own handle so chunk decode parallelizes across cores instead
        of serializing on the shared handle's lock."""
        assert 0 <= start < end <= self.num_ev_repr
        if file is not None:
            data = file["data"][start:end]  # per-frame layout: _disk_layout
        else:
            with self._lock:
                data = self._file()["data"][start:end]
        if self._disk_layout == "THWC":
            return data  # already the model layout; no per-batch transpose
        return np.ascontiguousarray(np.transpose(data, (0, 2, 3, 1)))

    def open_handle(self) -> "h5py.File":
        """A private read-only handle (caller closes). h5py handles are not
        thread-safe, but separate handles on one read-only file are."""
        return _h5py().File(str(self.ev_repr_file), "r")

    def labels_at_repr_idx(self, repr_idx: int) -> Optional[FrameLabels]:
        objframe = self._repr_idx_2_objframe_idx.get(repr_idx)
        return None if objframe is None else self.labels[objframe]

    # -- streaming clip ranges -----------------------------------------------
    def streams(self, seq_len: int, guarantee_labels: bool) -> List[List[Tuple[int, int]]]:
        """Independent streams of consecutive [start, end) clip windows.

        guarantee_labels=True (training): labeled frames are grouped wherever
        consecutive labels are <= seq_len apart; each group becomes its own
        stream tiled from ``max(first_label - seq_len + 1, 0)`` so every clip
        contains at least one label (sequence_for_streaming.py:21-50,87-111).
        The recurrent state resets at each stream start.

        guarantee_labels=False (eval): one stream from
        ``max(first_label - seq_len + 1, 0)`` to the end of the sequence
        (sequence_for_streaming.py:72-74).
        """
        n = self.num_ev_repr
        idx = self.objframe_idx_2_repr_idx
        if len(idx) == 0:
            return []

        def tile(start: int, stop: int) -> List[Tuple[int, int]]:
            return [(s, min(s + seq_len, stop)) for s in range(start, stop, seq_len)]

        if not guarantee_labels:
            start = max(int(idx[0]) - seq_len + 1, 0)
            return [tile(start, n)]

        # Group labels at gaps > seq_len (reference _get_ev_repr_range_indices).
        stops = np.flatnonzero(np.diff(idx) > seq_len)
        starts = np.concatenate(([0], stops + 1))
        stops = np.concatenate((stops, [len(idx) - 1]))
        streams = []
        for a, b in zip(starts, stops):
            start = max(int(idx[a]) - seq_len + 1, 0)
            stop = int(idx[b]) + 1
            streams.append(tile(start, stop))
        return streams

    # -- random-access samples -------------------------------------------------
    def random_access_start_offset(self, seq_len: int) -> int:
        """First objframe whose labeled repr fits a full seq_len window
        (sequence_rnd.py:24-32: samples with ``repr_idx - seq_len + 1 < 0``
        are excluded from the random-access dataset entirely)."""
        idx = self.objframe_idx_2_repr_idx
        return int(np.searchsorted(idx, seq_len - 1, side="left"))

    def num_random_access_samples(self, seq_len: int) -> int:
        return len(self.objframe_idx_2_repr_idx) - self.random_access_start_offset(
            seq_len
        )

    def random_access_sample(
        self,
        objframe_idx: int,
        seq_len: int,
        only_load_end_labels: bool = False,
        file: Optional["h5py.File"] = None,
    ):
        """The seq_len reprs ending at labeled frame `objframe_idx`
        (sequence_rnd.py:43-75). ``objframe_idx`` is absolute (callers add
        ``random_access_start_offset``), so the window always fits.

        The reference default (only_load_end_labels=False,
        config/dataset/gen1.yaml:9) supervises EVERY labeled frame inside the
        window; True nullifies all but the final label (the preceding frames
        then only warm the recurrent state)."""
        end = int(self.objframe_idx_2_repr_idx[objframe_idx]) + 1
        start = end - seq_len
        assert start >= 0, (
            f"objframe {objframe_idx} (repr {end - 1}) cannot fit a "
            f"{seq_len}-long window; index from random_access_start_offset"
        )
        ev = self.get_ev_repr(start, end, file=file)
        if only_load_end_labels:
            labels: List[Optional[FrameLabels]] = [None] * (seq_len - 1) + [
                self.labels_at_repr_idx(end - 1)
            ]
        else:
            labels = [self.labels_at_repr_idx(r) for r in range(start, end)]
        return ev, labels

    def window_class_ids(
        self, objframe_idx: int, seq_len: int, only_load_end_labels: bool = False
    ) -> np.ndarray:
        """Class ids of every GT box a random-access sample supervises
        (labels of all labeled frames in its window) — the per-sample label
        statistic the reference weighted sampler iterates the whole dataset
        in labels-only mode to collect (dataset_rnd.py:120-131)."""
        end = int(self.objframe_idx_2_repr_idx[objframe_idx]) + 1
        start = end - seq_len
        if only_load_end_labels:
            objframes = [objframe_idx]
        else:
            idx = self.objframe_idx_2_repr_idx
            lo = int(np.searchsorted(idx, start, side="left"))
            objframes = list(range(lo, objframe_idx + 1))
        ids = [
            np.asarray(self.labels[o].class_id, np.int64) for o in objframes
        ]
        return np.concatenate(ids) if ids else np.zeros((0,), np.int64)


class MemorySequenceReader(SequenceReader):
    """A sequence held in memory, with ``SequenceReader``'s methods: the
    event representations as a (N, H, W, C) uint8 array and the labels as
    ``labels.npz`` holds them. For a machine without ``h5py`` (the data
    pipeline and the card-resident cache read it as they read a file)."""

    def __init__(self, name: str, ev_repr: np.ndarray, labels: np.ndarray,
                 objframe_idx_2_label_idx: np.ndarray, objframe_idx_2_repr_idx: np.ndarray,
                 dataset_name: str, downsample_by_factor_2: bool = False):
        self.path = Path(name)
        self.name = name
        self._ev = np.asarray(ev_repr, np.uint8)
        self.labels = LabelStore(
            labels=labels,
            objframe_idx_2_label_idx=objframe_idx_2_label_idx,
            input_size_hw=DATASET_RES_HW[dataset_name],
            downsample_factor=2 if downsample_by_factor_2 else None,
        )
        self.objframe_idx_2_repr_idx = np.asarray(objframe_idx_2_repr_idx, np.int64)
        self._repr_idx_2_objframe_idx = {
            int(r): int(i) for i, r in enumerate(self.objframe_idx_2_repr_idx)
        }
        self.num_ev_repr = self._ev.shape[0]
        n, h, w, c = self._ev.shape
        self.ev_repr_shape = (c, h, w)
        self._disk_layout = "THWC"
        self._h5 = None
        self._lock = threading.Lock()

    def get_ev_repr(self, start: int, end: int, file=None) -> np.ndarray:
        assert 0 <= start < end <= self.num_ev_repr
        return self._ev[start:end].copy()

    def open_handle(self):
        return contextlib.nullcontext()

    def close(self) -> None:
        pass


class ClipIterator:
    """Iterates (ev_repr, labels, is_first) clips over one stream of ranges.

    Clips shorter than seq_len (stream tails) are zero-padded with an
    ``is_real_mask`` marking real frames (sequence_for_streaming.py:137-181).
    """

    def __init__(self, reader: SequenceReader, seq_len: int, ranges: List[Tuple[int, int]]):
        self.reader = reader
        self.seq_len = seq_len
        self.ranges = ranges

    def __len__(self) -> int:
        return len(self.ranges)

    def __iter__(self) -> Iterator[dict]:
        # Own read handle: several batch lanes may stream this sequence at
        # once; a shared handle would serialize their chunk decodes.
        with self.reader.open_handle() as f:
            yield from self._iter_with(f, first=True)

    def _iter_with(self, f, first: bool) -> Iterator[dict]:
        for start, end in self.ranges:
            ev = self.reader.get_ev_repr(start, end, file=f)
            labels = [
                self.reader.labels_at_repr_idx(r) for r in range(start, end)
            ]
            n_real = ev.shape[0]
            n_pad = self.seq_len - n_real
            mask = np.ones((self.seq_len,), bool)
            if n_pad > 0:
                ev = np.concatenate(
                    [ev, np.zeros((n_pad, *ev.shape[1:]), ev.dtype)], axis=0
                )
                labels = labels + [None] * n_pad
                mask[n_real:] = False
            yield {
                "ev_repr": ev,
                "labels": labels,
                "is_first": first,
                "is_real_mask": mask,
            }
            first = False
