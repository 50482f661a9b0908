"""Host-side event packing for the serving runtime (numpy-only).

The port's copy of ``sast_tpu/packing.py``: one frame of raw events becomes
rows of a static ``(E, 4)`` int32 upload.
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
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack one frame dict per lane into ((S, E, 4) int32, (S,) int32).

    The host-side contract of ``serving.StreamingDetector``.
    """
    S = num_streams
    if len(frames) != S:
        raise ValueError(f"{len(frames)} frames for {S} streams")
    packed = np.zeros((S, max_events, 4), np.int32)
    n = np.zeros((S,), np.int32)
    for i, f in enumerate(frames):
        _, n[i] = pack_events(
            f["x"], f["y"], f["p"], f["t"], max_events, out=packed[i]
        )
    return packed, n
