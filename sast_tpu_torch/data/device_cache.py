"""Card-resident dataset cache (port of sast_tpu/data/device_cache.py): no
per-step upload of event representations.

The host loader reads, augments, assembles and uploads every batch; the
upload of the (T, B, H, W*C) uint8 clip window is pure interconnect traffic.
Where a split fits on the card (synthetic recipes, overfit runs, benchmark
loops), this module uploads it once and gathers each step's clips there:

- every sequence's event representations go to the card once, uint8,
  concatenated on the frame axis, with a zero tail of T frames;
- each step's (T, B) clip windows are one indexed gather on the card, then
  zero past each lane's real frames and a horizontal flip (W reversed, C
  kept in order) of the lanes that flip, without a loop over lanes;
- labels (kilobytes) are packed on the host by ``data/batch.pack_batch_labels``;
- ``gather_into(buffer)`` (the trainer's, from a captured step's static
  ``ev_repr`` buffer) makes every later gather write into that buffer, so
  that the clip exists once on the card: each batch's ``ev_repr`` is then
  the buffer itself, which the next batch rewrites.

The three train sampling modes ('stream', 'random', 'mixed', weighted
sampling included) follow the host samplers' lane schedules, RNG streams,
clip windows, tail padding and ``is_first`` resets bit for bit; the eval
stream follows ``ShardedEvalSampler``. Augmentation: the horizontal flip
only; zoom and rotate resample on the host and are forced off, with one
message. One process only: a world of several processes uses the host
loader. The readers come from the dataset directory (``h5py``) unless the
caller hands in objects with ``SequenceReader``'s methods (``readers=``).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from sast_tpu_torch.config import ExperimentConfig
from sast_tpu_torch.data.augment import SpatialAugmentor
from sast_tpu_torch.data.batch import pack_batch_labels
from sast_tpu_torch.data.labels import FrameLabels
from sast_tpu_torch.data.module import RandomAccessSampler, discover_sequences
from sast_tpu_torch.data.sequence import SequenceReader
from sast_tpu_torch.data.streaming import zigzag_assign
from sast_tpu_torch.parallel.mesh import process_shard_info

# (global start, n_real, is_first, flip, labels) of one lane's clip.
Row = Tuple[int, int, bool, bool, List[Optional[FrameLabels]]]


def _flip_labels(labels: List[Optional[FrameLabels]]):
    """The label side of the host augmentor's flip: copy, flip, drop the
    frames left empty."""
    labels = [fl.copy() if fl is not None else None for fl in labels]
    for fl in labels:
        if fl is not None:
            fl.flip_lr_()
    return [fl if (fl is not None and len(fl) > 0) else None for fl in labels]


def _flip_only(aug_cfg):
    """Stream augmentation restricted to what the card's gather does."""
    zoom = dataclasses.replace(aug_cfg.zoom, prob=0.0)
    return dataclasses.replace(aug_cfg, rotate_prob=0.0, zoom=zoom)


class _LaneSchedule:
    """``ConcatStreamsSampler._lane_iter`` without the pixels: the same
    seeds, stream permutations and one augmentation state per stream,
    yielding (global start, n_real, is_first, flip, labels) rows."""

    def __init__(self, streams, readers, offsets, seq_len: int, lane: int, seed: int, aug_cfg,
                 hw: Tuple[int, int]):
        self.streams, self.readers, self.offsets = streams, readers, offsets
        self.seq_len = seq_len
        self.rng = np.random.RandomState((seed * 7919 + lane) % (2**32))
        self.augmentor = SpatialAugmentor(
            aug_cfg, stream_mode=True,
            rng=np.random.RandomState((seed * 104729 + lane + 1) % (2**32)))
        self.hw = hw
        self._gen = self._iter()

    def _iter(self) -> Iterator[Row]:
        while True:
            for si in self.rng.permutation(len(self.streams)):
                ri, ranges = self.streams[si]
                state = self.augmentor.sample_state(self.hw)
                first = True
                for start, end in ranges:
                    labels = [self.readers[ri].labels_at_repr_idx(r) for r in range(start, end)]
                    labels += [None] * (self.seq_len - (end - start))
                    if state.apply_hflip:
                        labels = _flip_labels(labels)
                    yield (int(self.offsets[ri]) + start, end - start, first,
                           bool(state.apply_hflip), labels)
                    first = False

    def __next__(self) -> Row:
        return next(self._gen)


class _RandomSchedule:
    """``RandomAccessSampler.__iter__`` without the pixels: the real
    sampler's index and weights, and its draw order per batch (augmentation
    state, index, the per-item seed), yielding rows for all its lanes."""

    def __init__(self, readers, offsets, seq_len: int, batch_size: int, seed: int, aug_cfg,
                 aug_seed: int, hw: Tuple[int, int], weighted: bool, only_load_end_labels: bool):
        self.sampler = RandomAccessSampler(readers, seq_len, batch_size, augmentor=None,
                                           weighted=weighted, seed=seed,
                                           only_load_end_labels=only_load_end_labels)
        self.readers, self.offsets = readers, offsets
        self.seq_len, self.batch_size = seq_len, batch_size
        self.only_load_end_labels = only_load_end_labels
        self.augmentor = SpatialAugmentor(aug_cfg, stream_mode=False,
                                          rng=np.random.RandomState(aug_seed))
        self.hw = hw

    def next_rows(self) -> List[Row]:
        rows = []
        for _ in range(self.batch_size):
            state = self.augmentor.sample_state(self.hw)
            k = self.sampler._draw()
            # The per-item seed feeds only the zoom window, off here; it is
            # drawn to keep the sampler's stream aligned with the host's.
            self.sampler.rng.randint(2**31)
            ri, oi = self.sampler.index[k]
            r = self.readers[ri]
            end = int(r.objframe_idx_2_repr_idx[oi]) + 1
            start = end - self.seq_len
            if self.only_load_end_labels:
                labels = [None] * (self.seq_len - 1) + [r.labels_at_repr_idx(end - 1)]
            else:
                labels = [r.labels_at_repr_idx(i) for i in range(start, end)]
            if state.apply_hflip:
                labels = _flip_labels(labels)
            rows.append((int(self.offsets[ri]) + start, self.seq_len, True,
                         bool(state.apply_hflip), labels))
        return rows


def _refuse_a_world():
    if process_shard_info()[1] > 1:
        raise RuntimeError("the card-resident cache serves one process; a world of "
                           "several processes uses the host loader (DataModule)")


class _HbmCache:
    """One split's event representations on the card and the clip gather;
    shared by the train and eval streams."""

    def __init__(self, cfg: ExperimentConfig, split: str, device, readers=None):
        ds = cfg.dataset
        self.seq_len = ds.sequence_length
        self.device = torch.device(device)
        if readers is None:
            readers = [SequenceReader(p, ds.ev_repr_name, ds.name, ds.downsample_by_factor_2)
                       for p in discover_sequences(Path(ds.path), split)]
        self.readers = readers
        c, h, w = readers[0].ev_repr_shape
        self.hw, self.channels = (h, w), c
        counts = np.array([r.num_ev_repr for r in readers], np.int64)
        self.offsets = np.concatenate(([0], np.cumsum(counts)))[:-1]
        total = int(counts.sum())
        # The zero tail of seq_len frames keeps every window in bounds: a
        # tail clip reads past its stream's end, into frames zeroed anyway.
        self.nbytes = (total + self.seq_len) * h * w * c
        print(f"card cache[{split}]: uploading {len(readers)} sequences, {total} frames, "
              f"{self.nbytes / 2**30:.2f} GiB uint8 to {self.device}", file=sys.stderr)
        self.cache = torch.zeros((total + self.seq_len, h, w * c), dtype=torch.uint8,
                                 device=self.device)
        for r, off in zip(readers, self.offsets):
            ev = r.get_ev_repr(0, r.num_ev_repr)  # (n, H, W, C) uint8
            self.cache[off:off + r.num_ev_repr] = torch.from_numpy(
                np.ascontiguousarray(ev).reshape(r.num_ev_repr, h, w * c)).to(self.device)
            r.close()
        self._steps = torch.arange(self.seq_len, device=self.device)
        self.into: Optional[torch.Tensor] = None

    def gather(self, starts: np.ndarray, n_real: np.ndarray, flip: np.ndarray) -> torch.Tensor:
        """(T, B, H, W*C) uint8 on the card: frame ``starts[b] + t`` of lane
        b, zero from ``n_real[b]`` on, W reversed where ``flip[b]``; written
        into ``into`` where that buffer has this shape."""
        T, (H, W), C = self.seq_len, self.hw, self.channels
        B = len(starts)
        starts_d = torch.as_tensor(starts, device=self.device)
        n_real_d = torch.as_tensor(n_real, device=self.device)
        frames = (starts_d[None, :] + self._steps[:, None]).reshape(T * B)
        out = self.into
        if out is None or tuple(out.shape) != (T, B, H, W * C) or not out.is_contiguous():
            out = torch.empty((T, B, H, W * C), dtype=torch.uint8, device=self.device)
        torch.index_select(self.cache, 0, frames, out=out.view(T * B, H, W * C))
        ev = out
        ev *= (self._steps[:, None] < n_real_d[None, :]).to(torch.uint8)[:, :, None, None]
        if flip.any():
            lanes = torch.as_tensor(np.flatnonzero(flip), device=self.device)
            ev5 = ev.view(T, -1, H, W, C)
            ev5[:, lanes] = ev5[:, lanes].flip(3)
        return ev

    def rows_to_batch(self, rows: List[Row], max_labeled_frames: int, max_gt: int) -> dict:
        batch = pack_batch_labels([r[4] for r in rows], max_labeled_frames, max_gt)
        batch["ev_repr"] = self.gather(np.array([r[0] for r in rows], np.int64),
                                       np.array([r[1] for r in rows], np.int64),
                                       np.array([r[3] for r in rows], bool))
        batch["is_first"] = np.array([r[2] for r in rows], bool)
        return batch


class DeviceCachedTrainStream:
    """Endless train batches whose ``ev_repr`` is gathered on the card from
    the cached split: a stand-in for ``DataModule.train_batches`` in the
    'stream', 'random' and 'mixed' modes when the split fits there.
    ``ev_repr`` comes as a tensor on ``device``, the rest as numpy arrays."""

    def __init__(self, cfg: ExperimentConfig, seed: int = 0, device="cuda", readers=None):
        ds = cfg.dataset
        mode = ds.train_sampling
        if mode not in ("stream", "random", "mixed"):
            raise ValueError(f"unknown dataset.train_sampling {mode!r}")
        _refuse_a_world()
        self.cfg = cfg
        # The host samplers take seed + rank; one process: rank 0.
        self._seed = seed
        self.batch_size = B = cfg.training.batch_size_train
        self._cache = _HbmCache(cfg, "train", device, readers)
        self.seq_len, self.readers = self._cache.seq_len, self._cache.readers
        self.offsets, self.hw = self._cache.offsets, self._cache.hw

        def flip_only(aug, kind):
            if aug.rotate_prob > 0 or aug.zoom.prob > 0:
                print(f"card cache: zoom/rotate {kind} augmentation is host-only; running with "
                      "horizontal flip only", file=sys.stderr)
            return _flip_only(aug)

        self.aug_cfg = flip_only(ds.data_augmentation_stream, "stream")
        self.aug_cfg_random = flip_only(ds.data_augmentation_random, "random")

        # The lane split of DataModule.train_batches.
        if mode == "stream":
            self.b_stream, self.b_random = B, 0
        elif mode == "random":
            self.b_stream, self.b_random = 0, B
        elif B == 1:
            print("mixed sampling with a per-host batch of 1 lane: using stream sampling for "
                  "this host", file=sys.stderr)
            self.b_stream, self.b_random = 1, 0
        else:
            total_w = ds.mixed_w_stream + ds.mixed_w_random
            self.b_stream = max(1, min(B - 1, round(B * ds.mixed_w_stream / total_w)))
            self.b_random = B - self.b_stream

        # DataModule._stream_clips' streams (guarantee_labels=True), each
        # tagged with its reader.
        self.streams = [(ri, ranges) for ri, r in enumerate(self.readers)
                        for ranges in r.streams(self.seq_len, True)]
        if not self.streams and self.b_stream:
            raise ValueError("no labeled streams in the train split")

    @property
    def nbytes(self) -> int:
        return self._cache.nbytes

    def gather_into(self, buffer: torch.Tensor) -> None:
        """Gather every later batch's ``ev_repr`` into ``buffer`` (module
        docstring)."""
        self._cache.into = buffer

    def __iter__(self) -> Iterator[dict]:
        ds, tr = self.cfg.dataset, self.cfg.training
        lanes = [_LaneSchedule(self.streams, self.readers, self.offsets, self.seq_len, b,
                               self._seed, self.aug_cfg, self.hw) for b in range(self.b_stream)]
        random_sched = None
        if self.b_random:
            random_sched = _RandomSchedule(
                self.readers, self.offsets, self.seq_len, self.b_random, seed=self._seed,
                aug_cfg=self.aug_cfg_random, aug_seed=self._seed + 202, hw=self.hw,
                weighted=ds.weighted_sampling, only_load_end_labels=ds.only_load_end_labels)
        max_gt = self.cfg.model.head.max_gt
        while True:
            # MixedSampler's order: stream lanes, then random lanes.
            rows = [next(lane) for lane in lanes]
            if random_sched is not None:
                rows += random_sched.next_rows()
            yield self._cache.rows_to_batch(rows, tr.max_labeled_frames_per_lane, max_gt)


class DeviceCachedEvalStream:
    """Finite eval batches from the cached split: ``DataModule.eval_batches``'
    zig-zag lanes, lane chaining, per-stream ``is_first`` and all-zero fill
    clips (one process). Evaluation does not augment, so the batches equal
    the host's whatever the config. Iterating again replays the split."""

    def __init__(self, cfg: ExperimentConfig, split: str = "val", device="cuda", readers=None):
        _refuse_a_world()
        self.cfg = cfg
        self.batch_size = cfg.training.batch_size_eval
        self._cache = _HbmCache(cfg, split, device, readers)
        T = self._cache.seq_len
        self.streams = [(ri, ranges) for ri, r in enumerate(self._cache.readers)
                        for ranges in r.streams(T, False)]
        self.lanes = zigzag_assign([len(ranges) for _, ranges in self.streams], self.batch_size)
        self.global_steps = (max(sum(len(self.streams[i][1]) for i in lane)
                                 for lane in self.lanes) if self.lanes else 0)

    @property
    def nbytes(self) -> int:
        return self._cache.nbytes

    def gather_into(self, buffer: torch.Tensor) -> None:
        """Gather every later batch's ``ev_repr`` into ``buffer`` (module
        docstring)."""
        self._cache.into = buffer

    def __len__(self) -> int:
        return self.global_steps

    def _lane_rows(self, stream_ids: List[int]) -> Iterator[Row]:
        T = self._cache.seq_len
        for si in stream_ids:
            ri, ranges = self.streams[si]
            r = self._cache.readers[ri]
            first = True
            for start, end in ranges:
                labels = [r.labels_at_repr_idx(i) for i in range(start, end)]
                labels += [None] * (T - (end - start))
                yield int(self._cache.offsets[ri]) + start, end - start, first, False, labels
                first = False

    def __iter__(self) -> Iterator[dict]:
        T, tr = self._cache.seq_len, self.cfg.training
        fill = (0, 0, True, False, [None] * T)  # n_real 0: all-zero frames
        lane_iters = [self._lane_rows(ids) for ids in self.lanes]
        for _ in range(self.global_steps):
            rows = [next(it, fill) for it in lane_iters]
            yield self._cache.rows_to_batch(rows, tr.max_labeled_frames_per_lane,
                                            self.cfg.model.head.max_gt)
