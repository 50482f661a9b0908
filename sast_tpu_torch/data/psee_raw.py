"""Prophesee raw-file readers: ``.dat`` events and ``.npy`` boxes (port of
sast_tpu/data/psee_raw.py; numpy and the standard library only).

Dataset tooling for raw Prophesee releases; training reads the
preprocessed HDF5 layout instead (``data/sequence.py``).

DAT format: ASCII '%'-prefixed header lines, then a 2-byte event-type/size
tag, then packed little-endian events. For EVENT_CD (2D) events each record
is 8 bytes: uint32 timestamp (us) + uint32 payload with x (14 bits),
y (14 bits), polarity (4 bits).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from sast_tpu_torch.eval.prophesee import BBOX_DTYPE

EV_TYPE_DTYPE = np.dtype([("ts", "<u4"), ("data", "<u4")])
EVENT_DTYPE = np.dtype([("t", "<i8"), ("x", "<u2"), ("y", "<u2"), ("p", "<u1")])


def _parse_header(f) -> Tuple[int, int, int]:
    """Returns (first_data_byte, height, width); header lines start with '%'."""
    height = width = -1
    while True:
        pos = f.tell()
        line = f.readline()
        if not line.startswith(b"%"):
            f.seek(pos)
            break
        text = line.decode("latin-1").strip("% \r\n")
        if text.lower().startswith("height"):
            height = int(text.split()[-1])
        elif text.lower().startswith("width"):
            width = int(text.split()[-1])
    f.read(2)  # event type (1 byte) + event size (1 byte)
    return f.tell(), height, width


class PSEELoader:
    """Chunked reader over one .dat event file."""

    def __init__(self, datfile: str):
        self._path = Path(datfile)
        self._f = open(datfile, "rb")
        self._start, self.height, self.width = _parse_header(self._f)
        self._f.seek(0, 2)
        self._ev_count = (self._f.tell() - self._start) // EV_TYPE_DTYPE.itemsize
        self._f.seek(self._start)
        self.done = False
        if self._ev_count > 0:  # the duration is the last event's time
            self._f.seek(self._start + (self._ev_count - 1) * EV_TYPE_DTYPE.itemsize)
            last = np.frombuffer(self._f.read(8), EV_TYPE_DTYPE)
            self.duration_us = int(last["ts"][0])
            self._f.seek(self._start)
        else:
            self.duration_us = 0

    def event_count(self) -> int:
        return self._ev_count

    def total_time(self) -> int:
        return self.duration_us

    def reset(self) -> None:
        self._f.seek(self._start)
        self.done = False

    def _decode(self, raw: np.ndarray) -> np.ndarray:
        out = np.empty(raw.shape[0], EVENT_DTYPE)
        out["t"] = raw["ts"]
        out["x"] = raw["data"] & 0x3FFF
        out["y"] = (raw["data"] >> 14) & 0x3FFF
        out["p"] = (raw["data"] >> 28) & 0xF
        return out

    def load_n_events(self, n: int) -> np.ndarray:
        raw = np.frombuffer(self._f.read(n * 8), EV_TYPE_DTYPE)
        if raw.size < n:
            self.done = True
        return self._decode(raw)

    def load_delta_t(self, delta_t_us: int) -> np.ndarray:
        """Load all events within the next delta_t microseconds."""
        start_pos = self._f.tell()
        peek = np.frombuffer(self._f.read(8), EV_TYPE_DTYPE)
        if peek.size == 0:
            self.done = True
            return self._decode(peek)
        t_end = int(peek["ts"][0]) + delta_t_us
        self._f.seek(start_pos)

        chunks: List[np.ndarray] = []
        chunk_events = 65536
        while True:
            pos = self._f.tell()
            raw = np.frombuffer(self._f.read(chunk_events * 8), EV_TYPE_DTYPE)
            if raw.size == 0:
                self.done = True
                break
            over = np.searchsorted(raw["ts"], t_end, side="left")
            chunks.append(raw[:over])
            if over < raw.size:
                self._f.seek(pos + over * 8)
                break
        raw = np.concatenate(chunks) if chunks else np.empty(0, EV_TYPE_DTYPE)
        return self._decode(raw)

    def close(self) -> None:
        self._f.close()


def write_dat(path: str, events: np.ndarray, height: int, width: int) -> None:
    """Write events (EVENT_DTYPE) into a .dat file (for tests and tools)."""
    with open(path, "wb") as f:
        f.write(b"% Data file containing CD events.\n")
        f.write(f"% Height {height}\n".encode())
        f.write(f"% Width {width}\n".encode())
        f.write(bytes([0x0C, 0x08]))  # event type CD, event size 8
        raw = np.empty(events.shape[0], EV_TYPE_DTYPE)
        raw["ts"] = events["t"].astype(np.uint32)
        raw["data"] = (
            (events["x"].astype(np.uint32) & 0x3FFF)
            | ((events["y"].astype(np.uint32) & 0x3FFF) << 14)
            | ((events["p"].astype(np.uint32) & 0xF) << 28)
        )
        f.write(raw.tobytes())


def load_npy_boxes(path: str) -> np.ndarray:
    """Load a Prophesee box .npy, renaming legacy fields (``ts`` -> ``t``,
    ``confidence`` -> ``class_confidence``) into ``BBOX_DTYPE``."""
    boxes = np.load(path)
    names = boxes.dtype.names
    if "t" in names and "class_confidence" in names:
        return boxes
    out = np.zeros(boxes.shape[0], BBOX_DTYPE)
    for name in names:
        if name == "ts":
            out["t"] = boxes[name]
        elif name == "confidence":
            out["class_confidence"] = boxes[name]
        elif name in out.dtype.names:
            out[name] = boxes[name]
    return out
