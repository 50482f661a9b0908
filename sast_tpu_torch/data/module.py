"""Data module: builds train/eval batch iterators from the experiment
config (the port's own copy of sast_tpu/data/module.py).

- train sampling modes 'stream' | 'random' | 'mixed' (mixed splits the batch
  lanes between a streaming part and a random-access part);
- eval always streams, sharded by (rank, world) with padded fill batches;
- random-access samples draw the seq_len reprs ending at a labeled frame with
  per-item augmentation and optional class-frequency weighted sampling;
- every batch is assembled host-side into the static device layout
  (data/batch.py) and prefetched on a background thread.

Reading a dataset needs ``h5py`` (``data/sequence.py``); importing this
module does not.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from sast_tpu_torch.config import ExperimentConfig
from sast_tpu_torch.data.augment import SpatialAugmentor
from sast_tpu_torch.data.batch import Prefetcher, assemble_batch
from sast_tpu_torch.data.sequence import ClipIterator, SequenceReader
from sast_tpu_torch.data.streaming import ConcatStreamsSampler, ShardedEvalSampler


def discover_sequences(root: Path, split: str) -> List[Path]:
    split_dir = Path(root) / split
    assert split_dir.is_dir(), f"missing dataset split dir: {split_dir}"
    return sorted(p for p in split_dir.iterdir() if p.is_dir())


class RandomAccessSampler:
    """Infinite batches of independent labeled-frame-anchored samples."""

    def __init__(
        self,
        readers: List[SequenceReader],
        seq_len: int,
        batch_size: int,
        augmentor: Optional[SpatialAugmentor],
        weighted: bool,
        seed: int = 0,
        only_load_end_labels: bool = False,
    ):
        self.readers = readers
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.augmentor = augmentor
        self.only_load_end_labels = only_load_end_labels
        self.rng = np.random.RandomState(seed)

        # Flat index of (reader_idx, objframe_idx) over full-window samples
        # only.
        self.index: List = []
        for ri, r in enumerate(readers):
            off = r.random_access_start_offset(seq_len)
            for oi in range(off, len(r.objframe_idx_2_repr_idx)):
                self.index.append((ri, oi))
        assert self.index, (
            f"no random-access samples: no sequence has a labeled frame at "
            f">= sequence_length={seq_len} representations — shorten "
            f"dataset.sequence_length or use stream sampling"
        )
        self.probs = (
            self._reference_sample_weights() if weighted else None
        )

    def _reference_sample_weights(self) -> np.ndarray:
        """Per-SAMPLE weights, the reference formula: global class counts over every sample's window labels ->
        class2weight = 1/count -> weight(sample) = sum over its window's boxes
        of class2weight[class], biasing toward frames with more boxes."""
        per_sample: List = []
        class2count: Dict[int, int] = {}
        for ri, oi in self.index:
            ids = self.readers[ri].window_class_ids(
                oi, self.seq_len, self.only_load_end_labels
            )
            cls, cnt = np.unique(ids, return_counts=True)
            per_sample.append((cls, cnt))
            for c, n in zip(cls, cnt):
                class2count[int(c)] = class2count.get(int(c), 0) + int(n)
        class2weight = {
            c: 1.0 / max(n, 1) for c, n in class2count.items()
        }
        w = np.array(
            [
                sum(class2weight[int(c)] * int(n) for c, n in zip(cls, cnt))
                for cls, cnt in per_sample
            ],
            np.float64,
        )
        if w.sum() == 0:  # degenerate: no boxes anywhere
            w = np.ones_like(w)
        return w / w.sum()

    def _draw(self) -> int:
        """Index draw (main thread only: RandomState is not thread-safe)."""
        if self.probs is not None:
            return int(self.rng.choice(len(self.index), p=self.probs))
        return int(self.rng.randint(len(self.index)))

    def _fetch(self, k: int, aug_state, rng_seed: int = 0) -> dict:
        rng = np.random.RandomState(rng_seed)
        ri, oi = self.index[k]
        # Private read handle per fetch: lanes drawing from the same sequence
        # must not serialize chunk decode on the reader's shared handle lock
        # (same rationale as ClipIterator; open cost ~ms vs ~100 ms decode).
        with self.readers[ri].open_handle() as f:
            ev, labels = self.readers[ri].random_access_sample(
                oi, self.seq_len, self.only_load_end_labels, file=f
            )
        if self.augmentor is not None:
            ev, labels = self.augmentor.apply(aug_state, ev, labels, rng=rng)
        return {
            "ev_repr": ev,
            "labels": labels,
            "is_first": True,  # random-access always resets the state
            "is_real_mask": np.ones((self.seq_len,), bool),
        }

    def __iter__(self) -> Iterator[List[dict]]:
        hw = self.readers[0].ev_repr_shape[1:]
        pool = ThreadPoolExecutor(max_workers=self.batch_size)
        try:
            while True:
                # All randomness drawn on the main thread; threads only read.
                jobs = []
                for _ in range(self.batch_size):
                    state = (
                        self.augmentor.sample_state(hw)
                        if self.augmentor is not None
                        else None
                    )
                    jobs.append((self._draw(), state, self.rng.randint(2**31)))
                futures = [pool.submit(self._fetch, k, s, r) for k, s, r in jobs]
                yield [f.result() for f in futures]
        finally:
            # No blocking join: a GC'd generator at interpreter shutdown must
            # not join worker threads inside teardown (same as streaming.py).
            pool.shutdown(wait=False, cancel_futures=True)


class MixedSampler:
    """Zips stream lanes and random lanes into one batch."""

    def __init__(self, stream_sampler, random_sampler):
        self.stream_sampler = stream_sampler
        self.random_sampler = random_sampler

    def __iter__(self) -> Iterator[List[dict]]:
        s_it = iter(self.stream_sampler)
        r_it = iter(self.random_sampler)
        while True:
            yield next(s_it) + next(r_it)


class DataModule:
    """Batches of the configured dataset for process ``rank`` of
    ``world_size``. ``readers`` (split name -> readers with
    ``SequenceReader``'s methods, e.g. ``MemorySequenceReader``s) replaces
    the dataset's directory."""

    def __init__(self, cfg: ExperimentConfig, rank: int = 0, world_size: int = 1,
                 readers: Optional[Dict[str, List[SequenceReader]]] = None):
        self.cfg = cfg
        self.rank = rank
        self.world_size = world_size
        self.readers = readers

    def _readers(self, split: str) -> List[SequenceReader]:
        if self.readers is not None:
            return self.readers[split]
        ds = self.cfg.dataset
        return [
            SequenceReader(
                p, ds.ev_repr_name, ds.name, ds.downsample_by_factor_2
            )
            for p in discover_sequences(Path(ds.path), split)
        ]

    def _stream_clips(self, readers, guarantee_labels: bool) -> List[ClipIterator]:
        seq_len = self.cfg.dataset.sequence_length
        clips = []
        for r in readers:
            for ranges in r.streams(seq_len, guarantee_labels):
                clips.append(ClipIterator(r, seq_len, ranges))
        return clips

    def _assemble(self, sampler) -> Iterator[Dict[str, np.ndarray]]:
        tr = self.cfg.training
        max_gt = self.cfg.model.head.max_gt
        for clips in sampler:
            yield assemble_batch(
                clips, tr.max_labeled_frames_per_lane, max_gt
            )

    def train_batches(self, seed: int = 0, prefetch: bool = True):
        ds = self.cfg.dataset
        tr = self.cfg.training
        B = tr.batch_size_train // self.world_size
        assert B >= 1
        readers = self._readers("train")

        mode = ds.train_sampling
        assert mode in ("stream", "random", "mixed"), mode
        stream_aug = SpatialAugmentor(
            ds.data_augmentation_stream, stream_mode=True,
            rng=np.random.RandomState(seed + 101 + self.rank),
        )
        random_aug = SpatialAugmentor(
            ds.data_augmentation_random, stream_mode=False,
            rng=np.random.RandomState(seed + 202 + self.rank),
        )

        if mode == "stream":
            sampler = ConcatStreamsSampler(
                self._stream_clips(readers, True), B, stream_aug,
                seed=seed + self.rank,
            )
        elif mode == "random":
            sampler = RandomAccessSampler(
                readers, ds.sequence_length, B, random_aug,
                ds.weighted_sampling, seed=seed + self.rank,
                only_load_end_labels=ds.only_load_end_labels,
            )
        elif B == 1:
            # mixed needs >= 1 lane of each kind; a 1-lane-per-host batch
            # degrades to pure streaming (the dominant part by the default
            # weights) instead of constructing a 0-lane random sampler.
            print(
                "mixed sampling with a per-host batch of 1 lane: using "
                "stream sampling for this host",
                file=sys.stderr,
            )
            sampler = ConcatStreamsSampler(
                self._stream_clips(readers, True), B, stream_aug,
                seed=seed + self.rank,
            )
        else:  # mixed
            # Static lane split. The reference's mixed mode splits *workers*
            # between the two pipelines and merges their sub-batches
            # (modules/detection.py merge_mixed_batches); here the split is
            # by batch lanes, computed once from the weights. Multi-worker
            # parallelism is orthogonal (each sampler already draws from the
            # thread-parallel reader pool). NOTE on multi-host: like the
            # reference's train streaming (per-worker shuffled FULL sequence
            # list, stream_concat_datapipe.py:25-103), every rank draws from
            # all train sequences with a rank-distinct seed — only EVAL is
            # sharded by rank (ShardedEvalSampler).
            total_w = ds.mixed_w_stream + ds.mixed_w_random
            b_stream = max(1, min(B - 1, round(B * ds.mixed_w_stream / total_w)))
            b_random = B - b_stream
            sampler = MixedSampler(
                ConcatStreamsSampler(
                    self._stream_clips(readers, True), b_stream, stream_aug,
                    seed=seed + self.rank,
                ),
                RandomAccessSampler(
                    readers, ds.sequence_length, b_random, random_aug,
                    ds.weighted_sampling, seed=seed + self.rank,
                    only_load_end_labels=ds.only_load_end_labels,
                ),
            )
        it = self._assemble(sampler)
        return Prefetcher(it) if prefetch else it

    def eval_batches(self, split: str = "val", prefetch: bool = True):
        tr = self.cfg.training
        B = tr.batch_size_eval // self.world_size
        assert B >= 1
        readers = self._readers(split)
        sampler = ShardedEvalSampler(
            self._stream_clips(readers, False), B,
            rank=self.rank, world_size=self.world_size,
        )
        it = self._assemble(sampler)
        return Prefetcher(it) if prefetch else it
