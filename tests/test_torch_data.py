"""Port vs JAX package: the data pipeline on the on-disk fixture dataset.

The port's ``DataModule`` (its own copies of the numpy samplers, the HDF5
reader and the batch assembly) must yield exactly the JAX package's batches:
every array equal, every ``FrameLabels`` of ``_labels`` equal field by field,
for the three training sampling modes, two seeds, with and without the
prefetch thread, and for both evaluation splits. ``SpatialAugmentor`` is held
on fixed augmentation states. No jit runs here.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.data import augment as j_augment
from sast_tpu.data.labels import FrameLabels as JFrameLabels
from sast_tpu.data.module import DataModule as JDataModule
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data import augment
from sast_tpu_torch.data.labels import FrameLabels
from sast_tpu_torch.data.module import DataModule

BATCHES = 4


def _cfg(get_cfg, dataset_root, **dataset):
    cfg = get_cfg()
    ds = dataclasses.replace(cfg.dataset, path=str(dataset_root), ev_repr_name="test_repr",
                             sequence_length=5, **dataset)
    return dataclasses.replace(cfg, dataset=ds)


def _assert_labels_equal(got, ref, where):
    assert len(got) == len(ref), where
    for b, (lane_g, lane_r) in enumerate(zip(got, ref)):
        assert len(lane_g) == len(lane_r), (where, b)
        for f, (g, r) in enumerate(zip(lane_g, lane_r)):
            if r is None:
                assert g is None, (where, b, f)
                continue
            assert isinstance(g, FrameLabels) and isinstance(r, JFrameLabels)
            assert g.input_size_hw == r.input_size_hw, (where, b, f)
            assert g.arr.dtype == r.arr.dtype
            np.testing.assert_array_equal(g.arr, r.arr, err_msg=f"{where} lane {b} frame {f}")


def _assert_batches_equal(got_it, ref_it, n, where):
    got = list(itertools.islice(got_it, n))
    ref = list(itertools.islice(ref_it, n))
    for it in (got_it, ref_it):
        if hasattr(it, "close"):
            it.close()
    assert len(got) == len(ref) == n, where
    for i, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r), where
        for k in r:
            if k == "_labels":
                _assert_labels_equal(g[k], r[k], f"{where} batch {i}")
                continue
            assert g[k].dtype == r[k].dtype, (where, i, k)
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"{where} batch {i} {k}")
    return got


@pytest.mark.parametrize("prefetch", [False, True], ids=["direct", "prefetch"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mode", ["stream", "random", "mixed"])
def test_train_batches_equal_the_jax_data_module(dataset_root, mode, seed, prefetch):
    """Training batches of every sampling mode, with the augmentations of
    the default config (zoom, flip; rotation turned on for the random
    lanes), the same bits as the JAX package's."""
    aug = dict(train_sampling=mode)
    tcfg, jcfg = _cfg(get_test_config, dataset_root, **aug), _cfg(j_test_config, dataset_root, **aug)
    tcfg = dataclasses.replace(tcfg, dataset=dataclasses.replace(
        tcfg.dataset, data_augmentation_random=dataclasses.replace(
            tcfg.dataset.data_augmentation_random, rotate_prob=0.5)))
    jcfg = dataclasses.replace(jcfg, dataset=dataclasses.replace(
        jcfg.dataset, data_augmentation_random=dataclasses.replace(
            jcfg.dataset.data_augmentation_random, rotate_prob=0.5)))
    got = _assert_batches_equal(DataModule(tcfg).train_batches(seed=seed, prefetch=prefetch),
                                JDataModule(jcfg).train_batches(seed=seed, prefetch=prefetch),
                                BATCHES, f"{mode} seed {seed}")
    assert any(b["frame_valid"].any() for b in got)
    assert got[0]["ev_repr"].shape == (5, 2, 240, 304 * 4)


@pytest.mark.parametrize("prefetch", [False, True], ids=["direct", "prefetch"])
@pytest.mark.parametrize("split", ["val", "test"])
def test_eval_batches_equal_the_jax_data_module(dataset_root, split, prefetch):
    """Every evaluation batch of the split (the zig-zag lanes, the padded
    tails and the fill clips of exhausted lanes)."""
    tcfg, jcfg = _cfg(get_test_config, dataset_root), _cfg(j_test_config, dataset_root)
    got = list(DataModule(tcfg).eval_batches(split, prefetch=prefetch))
    ref = list(JDataModule(jcfg).eval_batches(split, prefetch=prefetch))
    assert len(got) == len(ref) >= BATCHES
    _assert_batches_equal(iter(got), iter(ref), len(ref), split)


def _clip(seed, T=3, H=48, W=64, C=4):
    rng = np.random.RandomState(seed)
    ev = (rng.rand(T, H, W, C) * 5).astype(np.uint8)
    labels = []
    for t in range(T):
        if t == 1:
            labels.append(None)
            continue
        n = 3
        rows = np.stack([np.full(n, 1000.0 * t), rng.uniform(0, W - 20, n), rng.uniform(0, H - 20, n),
                         rng.uniform(6, 18, n), rng.uniform(6, 18, n), rng.randint(0, 2, n),
                         np.ones(n)], 1)
        labels.append(rows.astype(np.float32))
    return ev, labels


@pytest.mark.parametrize("state", [
    dict(apply_hflip=True),
    dict(rotate_angle_deg=-4.5),
    dict(zoom_out=(5, 3, 1.15)),
    dict(zoom_in_factor=1.4),
    dict(apply_hflip=True, rotate_angle_deg=3.0, zoom_out=(2, 4, 1.1)),
], ids=["hflip", "rotate", "zoom_out", "zoom_in", "all"])
def test_spatial_augmentor_on_a_fixed_state(state):
    """``SpatialAugmentor.apply`` on one fixed state, and ``sample_state``
    from one seed, in both packages: equal events and labels."""
    ev, rows = _clip(3)
    cfg = get_test_config().dataset.data_augmentation_random
    jcfg = j_test_config().dataset.data_augmentation_random
    tl = [None if r is None else FrameLabels(r, ev.shape[1:3]) for r in rows]
    jl = [None if r is None else JFrameLabels(r, ev.shape[1:3]) for r in rows]
    t_ev, t_lab = augment.SpatialAugmentor(cfg, False).apply(
        augment.AugmentState(**state), ev, tl, rng=np.random.RandomState(5))
    j_ev, j_lab = j_augment.SpatialAugmentor(jcfg, False).apply(
        j_augment.AugmentState(**state), ev, jl, rng=np.random.RandomState(5))
    np.testing.assert_array_equal(t_ev, j_ev)
    _assert_labels_equal([t_lab], [j_lab], str(state))
    assert not np.array_equal(t_ev, ev)
    for stream_mode in (False, True):
        t_state = augment.SpatialAugmentor(cfg, stream_mode, np.random.RandomState(9)).sample_state((48, 64))
        j_state = j_augment.SpatialAugmentor(jcfg, stream_mode, np.random.RandomState(9)).sample_state((48, 64))
        assert dataclasses.asdict(t_state) == dataclasses.asdict(j_state)


def test_data_module_imports_without_h5py():
    """``h5py`` is imported only when a dataset is read: the port's data
    module, samplers and batch assembly import where it is absent (a fresh
    interpreter in which ``import h5py`` raises)."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; sys.modules['h5py'] = None\n"
            "import sast_tpu_torch.data.module as m\n"
            "from sast_tpu_torch.data import sequence\n"
            "assert 'h5py' not in {k for k, v in sys.modules.items() if v is not None}\n"
            "try:\n    sequence._h5py()\nexcept ImportError:\n    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
