"""Streaming samplers: train concat-streams and eval sharded streams (the
port's own copy of sast_tpu/data/streaming.py).

Each batch *lane* is itself a continuous stream (the training step carries
one LSTM state per lane):

- ``ConcatStreamsSampler`` (train): each of the B lanes independently
  shuffles the stream list and walks it, concatenating clips; lane b's next
  batch element always continues lane b's current stream.
- ``ShardedEvalSampler`` (eval): streams sorted long -> short are dealt
  zig-zag over (world_size * batch_size) global lanes for load balance; this
  process iterates its own lanes zipped, padding exhausted lanes with
  fully-padded fill clips so every process performs the same number of steps.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from sast_tpu_torch.data.augment import SpatialAugmentor
from sast_tpu_torch.data.sequence import ClipIterator


def _fill_clip(seq_len: int, hwc, dtype=np.uint8) -> dict:
    """Fully-padded clip (the eval sampler's fill sample)."""
    return {
        "ev_repr": np.zeros((seq_len, *hwc), dtype),
        "labels": [None] * seq_len,
        "is_first": True,  # keeps the padded lane's state reset
        "is_real_mask": np.zeros((seq_len,), bool),
    }


def zigzag_assign(lengths: Sequence[int], num_lanes: int) -> List[List[int]]:
    """Deal items (sorted by length desc) over lanes in a zig-zag (pyramid)
    pattern: 0..L-1, L-1..0, ..."""
    order = np.argsort(-np.asarray(lengths), kind="stable")
    lanes: List[List[int]] = [[] for _ in range(num_lanes)]
    forward = True
    i = 0
    while i < len(order):
        lane_iter = range(num_lanes) if forward else range(num_lanes - 1, -1, -1)
        for lane in lane_iter:
            if i >= len(order):
                break
            lanes[lane].append(int(order[i]))
            i += 1
        forward = not forward
    return lanes


class ConcatStreamsSampler:
    """Infinite training batches of B lane-continuous clips."""

    def __init__(
        self,
        streams: List[ClipIterator],
        batch_size: int,
        augmentor: Optional[SpatialAugmentor] = None,
        seed: int = 0,
    ):
        assert len(streams) > 0
        self.streams = streams
        self.batch_size = batch_size
        self.augmentor = augmentor
        self.seed = seed

    def _lane_iter(self, lane: int) -> Iterator[dict]:
        # mod 2**32: RandomState rejects larger seeds, and user seeds are
        # unbounded (seed * 104729 overflows for any seed >= ~41k).
        rng = np.random.RandomState((self.seed * 7919 + lane) % (2**32))
        # Lanes run on parallel threads: each needs its own augmentor (the
        # RandomState inside is not thread-safe).
        augmentor = None
        if self.augmentor is not None:
            augmentor = SpatialAugmentor(
                self.augmentor.cfg,
                self.augmentor.stream_mode,
                rng=np.random.RandomState(
                    (self.seed * 104729 + lane + 1) % (2**32)
                ),
            )
        while True:
            order = rng.permutation(len(self.streams))
            for si in order:
                # Stream-mode augmentation: one state for the whole stream.
                state = None
                for clip in self.streams[si]:
                    if augmentor is not None:
                        if state is None:
                            hw = clip["ev_repr"].shape[1:3]
                            state = augmentor.sample_state(hw)
                        ev, labels = augmentor.apply(
                            state, clip["ev_repr"], clip["labels"]
                        )
                        clip = dict(clip, ev_repr=ev, labels=labels)
                    yield clip

    def __iter__(self) -> Iterator[List[dict]]:
        lanes = [self._lane_iter(b) for b in range(self.batch_size)]
        # Lanes fetch in parallel threads: h5 chunk decompression releases
        # the GIL and different sequences use independent (locked) handles.
        pool = ThreadPoolExecutor(max_workers=self.batch_size)
        try:
            while True:
                yield list(pool.map(next, lanes))
        finally:
            # No blocking join: when the generator is GC'd at interpreter
            # shutdown, joining worker threads raises inside teardown.
            pool.shutdown(wait=False, cancel_futures=True)


class ShardedEvalSampler:
    """Finite eval batches; deterministic zig-zag sharding across processes."""

    def __init__(
        self,
        streams: List[ClipIterator],
        batch_size: int,
        rank: int = 0,
        world_size: int = 1,
    ):
        assert len(streams) > 0
        self.streams = streams
        self.batch_size = batch_size
        num_lanes = world_size * batch_size
        lanes = zigzag_assign([len(s) for s in streams], num_lanes)
        # This process owns lanes [rank * B, (rank+1) * B).
        self.local_lanes = lanes[rank * batch_size : (rank + 1) * batch_size]
        # All processes step the same global count (max lane length in clips).
        self.global_steps = max(
            sum(len(streams[i]) for i in lane) for lane in lanes
        ) if lanes else 0
        r0 = streams[0].reader
        c, h, w = r0.ev_repr_shape
        self.seq_len = streams[0].seq_len
        self.fill_hwc = (h, w, c)

    def _lane_iter(self, stream_ids: List[int]) -> Iterator[dict]:
        for si in stream_ids:
            yield from self.streams[si]

    def __iter__(self) -> Iterator[List[dict]]:
        lanes = [self._lane_iter(ids) for ids in self.local_lanes]
        actives = [True] * len(lanes)

        def fetch(i: int) -> dict:
            clip = None
            if actives[i]:
                clip = next(lanes[i], None)
                if clip is None:
                    actives[i] = False
            return clip if clip is not None else _fill_clip(
                self.seq_len, self.fill_hwc
            )

        # Lanes decode in parallel threads, same as the train sampler (each
        # ClipIterator opens its own h5 handle; chunk decode releases the
        # GIL) — serial fetching left the device idle ~B x longer per eval
        # batch.
        pool = ThreadPoolExecutor(max_workers=len(lanes) or 1)
        try:
            for _ in range(self.global_steps):
                yield list(pool.map(fetch, range(len(lanes))))
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def __len__(self) -> int:
        return self.global_steps
