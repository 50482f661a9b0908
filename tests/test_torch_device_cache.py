"""The port's card-resident dataset cache (``sast_tpu_torch/data/device_cache.py``)
against the JAX package's ``DeviceCached*Stream`` and the port's host
``DataModule`` on the on-disk fixture dataset (CPU tensors here).

The same sampling modes as ``tests/test_device_cache.py`` (no flip, flip,
mixed flip, random, random weighted, mixed, eval): every batch bit for bit,
pixels and packed labels; then the forced-off zoom and the refused sampling
mode. JAX's streams run with the same config and seed; the port's host
pipeline is already held against JAX's by ``tests/test_torch_data.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.data import device_cache as j_cache
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data import device_cache
from sast_tpu_torch.data.module import DataModule

KEYS = ("is_first", "frame_tidx", "frame_valid", "gt_boxes", "gt_classes", "gt_valid")


def _cfg(get_cfg, dataset_root, prob_hflip, zoom_prob=0.0, batch=3, mode="stream",
         weighted=False):
    cfg = get_cfg()

    def aug(a):
        return dataclasses.replace(a, prob_hflip=prob_hflip, rotate_prob=0.0,
                                   zoom=dataclasses.replace(a.zoom, prob=zoom_prob))

    ds = dataclasses.replace(
        cfg.dataset, path=str(dataset_root), ev_repr_name="test_repr", sequence_length=5,
        train_sampling=mode, weighted_sampling=weighted,
        data_augmentation_stream=aug(cfg.dataset.data_augmentation_stream),
        data_augmentation_random=aug(cfg.dataset.data_augmentation_random))
    tr = dataclasses.replace(cfg.training, batch_size_train=batch, batch_size_eval=batch)
    return dataclasses.replace(cfg, dataset=ds, training=tr)


def _assert_batches_equal(got, ref, i):
    np.testing.assert_array_equal(np.asarray(got["ev_repr"]), np.asarray(ref["ev_repr"]),
                                  err_msg=f"batch {i}")
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=f"batch {i} key {k}")


@pytest.mark.parametrize("kw, seed, n", [
    (dict(prob_hflip=0.0), 7, 12),
    (dict(prob_hflip=1.0), 3, 8),
    (dict(prob_hflip=0.5), 11, 10),
    (dict(prob_hflip=0.5, mode="random", batch=4), 5, 10),
    (dict(prob_hflip=0.0, mode="random", batch=4, weighted=True), 2, 10),
    (dict(prob_hflip=0.5, mode="mixed", batch=4), 9, 12),
], ids=["no-flip", "flip", "mixed-flip", "random", "random-weighted", "mixed"])
def test_cached_train_stream_bit_matches_jax_and_the_host(dataset_root, kw, seed, n):
    cfg = _cfg(get_test_config, dataset_root, **kw)
    port = iter(device_cache.DeviceCachedTrainStream(cfg, seed=seed, device="cpu"))
    jax_ = iter(j_cache.DeviceCachedTrainStream(_cfg(j_test_config, dataset_root, **kw),
                                                seed=seed))
    host = iter(DataModule(cfg).train_batches(seed=seed, prefetch=False))
    for i in range(n):
        got = next(port)
        assert isinstance(got["ev_repr"], torch.Tensor) and got["ev_repr"].dtype == torch.uint8
        _assert_batches_equal(got, next(jax_), i)
        _assert_batches_equal(got, next(host), i)


def test_cached_eval_stream_bit_matches_jax_and_the_host(dataset_root):
    cfg = _cfg(get_test_config, dataset_root, prob_hflip=0.0)
    stream = device_cache.DeviceCachedEvalStream(cfg, "val", device="cpu")
    cached = list(stream)
    ref = list(j_cache.DeviceCachedEvalStream(_cfg(j_test_config, dataset_root, 0.0), "val"))
    host = list(DataModule(cfg).eval_batches("val", prefetch=False))
    assert len(cached) == len(ref) == len(host) == len(stream)
    for i, (got, r, h) in enumerate(zip(cached, ref, host)):
        _assert_batches_equal(got, r, i)
        _assert_batches_equal(got, h, i)
        for lane_h, lane_c in zip(h["_labels"], got["_labels"]):
            for fh, fc in zip(lane_h, lane_c):
                assert (fh is None) == (fc is None)
                if fh is not None:
                    np.testing.assert_array_equal(fh.to_structured(), fc.to_structured())
    again = list(stream)  # fit validates repeatedly: the stream replays
    assert len(again) == len(cached)
    assert torch.equal(again[0]["ev_repr"], cached[0]["ev_repr"])
    assert stream.nbytes == (sum(r.num_ev_repr for r in stream._cache.readers) + 5) * 240 * 304 * 4


def test_cached_stream_takes_in_memory_readers(dataset_root):
    """``readers=`` objects with ``SequenceReader``'s methods (here
    ``MemorySequenceReader``s holding the fixture's arrays) give the batches
    the dataset directory gives, cached and through ``DataModule``."""
    from sast_tpu_torch.data.sequence import MemorySequenceReader

    cfg = _cfg(get_test_config, dataset_root, prob_hflip=0.5, mode="mixed", batch=4)
    disk = DataModule(cfg)._readers("train")
    memory = [MemorySequenceReader(r.name, r.get_ev_repr(0, r.num_ev_repr), r.labels._all.arr,
                                   r.labels.start_idx, r.objframe_idx_2_repr_idx, "gen1")
              for r in disk]
    ref = iter(device_cache.DeviceCachedTrainStream(cfg, seed=4, device="cpu"))
    got = iter(device_cache.DeviceCachedTrainStream(cfg, seed=4, device="cpu", readers=memory))
    host = iter(DataModule(cfg, readers={"train": memory}).train_batches(seed=4, prefetch=False))
    for i in range(6):
        b = next(got)
        _assert_batches_equal(b, next(ref), i)
        _assert_batches_equal(b, next(host), i)


def test_cached_stream_forces_unsupported_augment_off(dataset_root, capsys):
    cfg = _cfg(get_test_config, dataset_root, prob_hflip=0.5, zoom_prob=0.5)
    stream = device_cache.DeviceCachedTrainStream(cfg, seed=0, device="cpu")
    assert stream.aug_cfg.zoom.prob == 0.0 and stream.aug_cfg_random.zoom.prob == 0.0
    assert "host-only" in capsys.readouterr().err
    assert next(iter(stream))["ev_repr"].shape[1] == 3  # (T, B, H, W*C)


def test_cached_stream_refuses_unknown_sampling_and_a_world(dataset_root, monkeypatch):
    cfg = _cfg(get_test_config, dataset_root, prob_hflip=0.0)
    bogus = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset,
                                                                 train_sampling="bogus"))
    with pytest.raises(ValueError, match="bogus"):
        device_cache.DeviceCachedTrainStream(bogus, seed=0, device="cpu")
    monkeypatch.setattr(device_cache, "process_shard_info", lambda: (0, 2))
    for make in (lambda: device_cache.DeviceCachedTrainStream(cfg, device="cpu"),
                 lambda: device_cache.DeviceCachedEvalStream(cfg, "val", device="cpu")):
        with pytest.raises(RuntimeError, match="one process"):
            make()
