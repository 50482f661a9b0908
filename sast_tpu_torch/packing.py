"""Host-side event packing for the serving runtime (numpy-only).

The port's copy of ``sast_tpu/packing.py``: one frame of raw events becomes
rows of a static ``(E, 4)`` int32 upload (``pack_events``,
``pack_event_batch``). The serving runtime's own upload is
``pack_event_fields``: the same events field by field and lane after lane,
with no padding, which the serving step unpacks into ``pack_event_batch``'s
``(S, E, 4)`` on the device (``graphs.unpack_events``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def pack_events(
    x: np.ndarray,
    y: np.ndarray,
    p: np.ndarray,
    t: np.ndarray,
    max_events: int,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int]:
    """Pack one frame's raw event arrays into the static (E, 4) int32 layout.

    ``out``: optional preallocated zeroed (E, 4) int32 view to fill in place
    (the batched hot path passes ``packed[i]`` to avoid a second allocation
    + full-buffer copy per lane).
    """
    n = int(x.size)
    if n > max_events:
        raise ValueError(f"{n} events exceed budget {max_events}")
    packed = np.zeros((max_events, 4), np.int32) if out is None else out
    packed[:n, 0] = x[:n]
    packed[:n, 1] = y[:n]
    packed[:n, 2] = p[:n]
    packed[:n, 3] = t[:n]
    return packed, n


def pack_event_batch(
    frames: List[Dict[str, np.ndarray]],
    num_streams: int,
    max_events: int,
    out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack one frame dict per lane into ((S, E, 4) int32, (S,) int32).

    The host-side contract of ``serving.StreamingDetector``. ``out``: the
    (packed, n) of the previous batch packed by this function, rewritten in
    place (a serving loop's pinned staging buffers); only the rows that the
    previous batch filled past this one's counts are zeroed again, so the
    result equals a fresh pack.
    """
    S = num_streams
    if len(frames) != S:
        raise ValueError(f"{len(frames)} frames for {S} streams")
    if out is None:
        packed = np.zeros((S, max_events, 4), np.int32)
        n = np.zeros((S,), np.int32)
    else:
        packed, n = out
        if packed.shape != (S, max_events, 4) or n.shape != (S,):
            raise ValueError(f"out is {packed.shape} / {n.shape}, expected "
                             f"{(S, max_events, 4)} / {(S,)}")
    for i, f in enumerate(frames):
        if out is not None:
            packed[i, min(int(f["x"].size), max_events):n[i]] = 0
        _, n[i] = pack_events(
            f["x"], f["y"], f["p"], f["t"], max_events, out=packed[i]
        )
    return packed, n


FIELDS = ("x", "y", "p", "t")


def pack_event_fields(frames: List[Dict[str, np.ndarray]], events: np.ndarray,
                      n: np.ndarray) -> int:
    """Pack one frame dict per lane into ``events`` ((4, S * E) int32, one
    row per field of ``FIELDS``) and ``n`` ((S,) int32), field-major and
    compact: lane ``i``'s events lie in every row at ``[o_i, o_i + n_i)``,
    ``o_i`` the sum of the counts before it, so the batch's events are the
    first ``n.sum()`` columns; the columns past them keep what they held.
    Each field of each lane is one contiguous copy, cast to int32 as
    ``pack_event_batch`` casts it. Returns the number of events packed.
    """
    S = n.shape[0]
    max_events = events.shape[1] // S
    if len(frames) != S:
        raise ValueError(f"{len(frames)} frames for {S} streams")
    start = 0
    for i, f in enumerate(frames):
        m = int(f["x"].size)
        if m > max_events:
            raise ValueError(f"{m} events exceed budget {max_events}")
        for row, key in zip(events, FIELDS):
            row[start:start + m] = f[key][:m]
        n[i] = m
        start += m
    return start
