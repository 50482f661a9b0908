"""The traffic generator: the same seed gives the same inputs, another seed
the same work in another order."""

import numpy as np
import pytest

from perfbench.reference.detector import Sizes
from perfbench.tests import tiny
from perfbench.traffic import clustered

SEEDS = (1, 2 ** 31 + 11)


def _flat(pool):
    return [a for lane in pool for f in lane for a in (f["x"], f["y"], f["p"], f["t"])]


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_pool_is_the_seeds(seed):
    a = clustered.serve_pool(tiny.SERVE, (60, 90), seed, "cpu")
    b = clustered.serve_pool(tiny.SERVE, (60, 90), seed, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    f = a[0][0]
    assert f["x"].dtype == np.uint16 and f["p"].dtype == np.uint8 and f["t"].dtype == np.int64
    assert (f["x"] < 90).all() and (f["y"] < 60).all() and (np.diff(f["t"]) >= 0).all()


def test_seeds_change_the_scene_not_the_work():
    a, b = (clustered.serve_pool(tiny.SERVE, (60, 90), s, "cpu") for s in SEEDS)
    sizes = [sorted(len(f["x"]) for lane in p for f in lane) for p in (a, b)]
    assert sizes[0] == sizes[1]
    assert not all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(b)))


def test_resets_are_staggered_and_periodic():
    mix = dict(tiny.SERVE, lanes=4, reset_frames=16)
    hits = np.array([clustered.resets(mix, k) for k in range(32)])
    assert hits.sum(axis=0).tolist() == [2, 2, 2, 2]
    assert len({int(np.flatnonzero(hits[:, i])[0]) for i in range(4)}) == 4


def test_pool_index_plays_forward_and_back():
    mix = dict(tiny.SERVE, pool_frames=4)
    assert [clustered.pool_index(mix, 0, k) for k in range(8)] == [0, 1, 2, 3, 2, 1, 0, 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_train_pool_is_the_seeds(seed):
    sz = Sizes(tiny.CONFIG)
    a = clustered.train_pool(tiny.TRAIN, sz, seed, "cpu")
    b = clustered.train_pool(tiny.TRAIN, sz, seed, "cpu")
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    first = a[0]
    assert first["ev_repr"].shape == (2, 2, 60, 90 * 20) and first["ev_repr"].any()
    assert first["is_first"].all() and not a[1]["is_first"].any()
    assert first["gt_valid"].sum(axis=-1)[first["frame_valid"]].min() >= 1
