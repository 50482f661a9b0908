"""Batch plumbing between the host and the device (the port's own copy of
sast_tpu/data/batch.py).

``assemble_batch`` turns a list of B host clips (from the streaming and
random samplers) into the static-layout arrays of ``training/steps.py``.
Events ship as uint8 at the dataset's resolution and are padded to the
model's on the device. Which timesteps carry labels is worked out here on
the host, so the device-side gather has a static shape. ``Prefetcher``
produces batches on a background thread.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sast_tpu_torch.data.labels import FrameLabels, pad_labels_yolox

_dropped_warned = False


def _warn_dropped_frames(found: int, budget: int) -> None:
    """Warn once if labeled frames exceed the static per-lane budget L
    (training.max_labeled_frames_per_lane is too small for this dataset's
    label density x sequence_length)."""
    global _dropped_warned
    if not _dropped_warned:
        print(
            f"WARNING: clip has {found} labeled frames but the budget "
            f"max_labeled_frames_per_lane={budget}; excess frames are dropped "
            "from the loss. Raise training.max_labeled_frames_per_lane.",
            file=sys.stderr,
        )
        _dropped_warned = True


def pack_batch_labels(
    label_lists: List[List[Optional[FrameLabels]]],
    max_labeled_frames: int,
    max_gt: int,
    keep_last: bool = True,
) -> Dict[str, np.ndarray]:
    """Per-lane per-timestep label lists -> static label arrays.

    The labeled timesteps of each lane, at most ``max_labeled_frames`` of
    them (the latest with ``keep_last``), as static arrays."""
    B = len(label_lists)
    L = max_labeled_frames

    frame_tidx = np.zeros((B, L), np.int32)
    frame_valid = np.zeros((B, L), bool)
    sel_labels: List[List[Optional[FrameLabels]]] = []
    for b, labels in enumerate(label_lists):
        tidx = [
            t for t, fl in enumerate(labels) if fl is not None and len(fl) > 0
        ]
        if len(tidx) > L:
            _warn_dropped_frames(len(tidx), L)
        if keep_last:
            tidx = tidx[-L:]
        else:
            tidx = tidx[:L]
        frame_tidx[b, : len(tidx)] = tidx
        frame_valid[b, : len(tidx)] = True
        lane_labels: List[Optional[FrameLabels]] = [labels[t] for t in tidx]
        lane_labels += [None] * (L - len(tidx))
        sel_labels.append(lane_labels)

    flat = [fl for lane in sel_labels for fl in lane]
    boxes, classes, valid = pad_labels_yolox(flat, max_gt)  # (B*L, G, ...)

    return {
        "frame_tidx": frame_tidx,
        "frame_valid": frame_valid,
        "gt_boxes": boxes.reshape(B, L, max_gt, 4),
        "gt_classes": classes.reshape(B, L, max_gt),
        "gt_valid": valid.reshape(B, L, max_gt),
        # Host-side references for evaluation (not shipped to device).
        "_labels": sel_labels,
    }


def assemble_batch(
    clips: List[dict],
    max_labeled_frames: int,
    max_gt: int,
    keep_last: bool = True,
) -> Dict[str, np.ndarray]:
    """B clips -> batch dict (see training/steps.py for the layout).

    Every labeled timestep beyond the ``max_labeled_frames`` budget is
    dropped from the loss (keep_last=True keeps the latest ones).
    ``ev_repr`` keeps the JAX package's (T, B, H, W*C) layout; the train and
    eval steps split (W*C) -> (W, C) per timestep on the device.
    """
    ev = np.stack([c["ev_repr"] for c in clips], axis=1)
    T_, B_, H_, W_, C_ = ev.shape
    ev = np.ascontiguousarray(ev).reshape(T_, B_, H_, W_ * C_)
    is_first = np.array([c["is_first"] for c in clips], bool)

    batch = pack_batch_labels(
        [c["labels"] for c in clips], max_labeled_frames, max_gt,
        keep_last=keep_last,
    )
    batch["ev_repr"] = ev  # (T, B, H, W*C) uint8/float32, native resolution
    batch["is_first"] = is_first
    return batch


def split_device_batch(batch: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """(device_arrays, host_extras): keys starting with ``_`` stay on the host."""
    device = {k: v for k, v in batch.items() if not k.startswith("_")}
    host = {k: v for k, v in batch.items() if k.startswith("_")}
    return device, host


def to_device(device_batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The numpy arrays of a device batch as contiguous tensors on
    ``device`` (the stem kernel reads its input contiguous); a tensor, e.g.
    the card-resident cache's ``ev_repr``, moves only if it lies
    elsewhere."""
    return {k: (v if torch.is_tensor(v)
                else torch.as_tensor(np.ascontiguousarray(v))).to(device)
            for k, v in device_batch.items()}


class Prefetcher:
    """Background-thread batch producer with a bounded queue: the host
    overlaps h5 read, decode and batch assembly with the device's work;
    queue depth 2 hides the latency."""

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._it = iter(iterable)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._exc: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                # Bounded put that re-checks close(): a consumer that stops
                # early (validate(max_batches=N), fit break at max_steps)
                # must not leave this thread blocked forever holding
                # multi-GB assembled batches + open h5 handles.
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            self._exc = e
        finally:
            # The end-of-data sentinel must be delivered even when the queue
            # is momentarily full (a slow consumer still expects it) — but
            # never block past close().
            while not self._stop.is_set():
                try:
                    self._q.put(self._done, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def close(self) -> None:
        """Stop the producer and release its buffered batches/handles.
        Idempotent; safe from any thread."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._done:
                if self._exc is not None:
                    # A producer crash must fail the consumer loudly, not
                    # masquerade as normal end-of-data (a training run would
                    # otherwise silently stop mid-epoch and "succeed").
                    raise self._exc
                return
            yield item
