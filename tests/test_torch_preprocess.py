"""Port vs JAX package: the offline preprocessing path on the CPU.

``data/psee_raw.py`` against JAX's reader on the same ``.dat`` files; the
representations and the host helpers against JAX's (its classes as they
run here, with the C++ fast path, and its numpy path); then the CLI
``scripts/preprocess_dataset_torch.py --device cpu`` against
``scripts/preprocess_dataset.py`` on a tiny synthetic raw dataset: every
array, index file, timestamp file and HDF5 dataset equal, bit for bit.
"""

import importlib.util
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from sast_tpu import native
from sast_tpu.data import psee_raw as j_raw
from sast_tpu.data import representations as j_repr
from sast_tpu_torch.data import psee_raw
from sast_tpu_torch.data import representations as repr_

ROOT = Path(__file__).resolve().parents[1]
RAW_LABEL_DTYPE = np.dtype([("t", "<u8"), ("x", "<f4"), ("y", "<f4"), ("w", "<f4"),
                            ("h", "<f4"), ("class_id", "<u4"), ("class_confidence", "<f4"),
                            ("track_id", "<u4")])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- raw readers ------------------------------------------------------------------

def _events(n=20_000, seed=0, h=240, w=304):
    rng = np.random.RandomState(seed)
    ev = np.empty(n, psee_raw.EVENT_DTYPE)
    ev["t"] = np.sort(rng.randint(0, 1_000_000, n))
    ev["x"], ev["y"], ev["p"] = rng.randint(0, w, n), rng.randint(0, h, n), rng.randint(0, 2, n)
    return ev


@pytest.mark.parametrize("n", [0, 1, 70_000])
def test_dat_round_trip_and_jax_reads_the_same(tmp_path, n):
    """``write_dat`` then ``PSEELoader`` gives the events back; JAX's loader
    reads the port's file, and the port's JAX's, chunk for chunk (by count
    and by time window, across the reader's 65536-event chunks)."""
    ev = _events(n)
    paths = {"port": str(tmp_path / "port_td.dat"), "jax": str(tmp_path / "jax_td.dat")}
    psee_raw.write_dat(paths["port"], ev, 240, 304)
    j_raw.write_dat(paths["jax"], ev, 240, 304)
    assert Path(paths["port"]).read_bytes() == Path(paths["jax"]).read_bytes()
    loader, ref = psee_raw.PSEELoader(paths["jax"]), j_raw.PSEELoader(paths["port"])
    assert (loader.height, loader.width, loader.event_count(), loader.total_time()) == (
        ref.height, ref.width, ref.event_count(), ref.total_time()) == (
        240, 304, n, int(ev["t"][-1]) if n else 0)
    got = loader.load_n_events(n + 5)
    assert got.dtype == psee_raw.EVENT_DTYPE and loader.done
    for f in ("t", "x", "y", "p"):
        np.testing.assert_array_equal(got[f], ev[f])
    loader.reset()
    ref.reset()
    while not (loader.done and ref.done):
        a, b = loader.load_delta_t(70_000), ref.load_delta_t(70_000)
        assert a.tobytes() == b.tobytes() and loader.done == ref.done
    loader.close()
    ref.close()


def test_load_npy_boxes_matches_jax(tmp_path):
    legacy = np.zeros(5, [("ts", "<u8"), ("x", "<f4"), ("y", "<f4"), ("w", "<f4"),
                          ("h", "<f4"), ("class_id", "<u1"), ("confidence", "<f4"),
                          ("track_id", "<u4")])
    rng = np.random.RandomState(0)
    for name in legacy.dtype.names:
        legacy[name] = rng.randint(0, 100, 5)
    current = np.zeros(3, psee_raw.BBOX_DTYPE)
    for arr, name in ((legacy, "legacy.npy"), (current, "current.npy")):
        np.save(str(tmp_path / name), arr)
        got = psee_raw.load_npy_boxes(str(tmp_path / name))
        want = j_raw.load_npy_boxes(str(tmp_path / name))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# -- representations -------------------------------------------------------------

def _stream(rng, n, h, w, span=1_000_000):
    return (rng.randint(0, w, n), rng.randint(0, h, n), rng.randint(0, 2, n),
            np.sort(rng.randint(0, span, n)).astype(np.int64))


def _both_jax_paths(monkeypatch, make_ref, *events):
    """JAX's result with its C++ fast path (as it runs here) and with its
    numpy path; the two must agree for the comparison to mean one thing."""
    with_native = make_ref().construct(*events)
    monkeypatch.setattr(native, "available", lambda: False)
    plain = make_ref().construct(*events)
    monkeypatch.undo()
    assert with_native.dtype == plain.dtype and np.array_equal(with_native, plain)
    return plain


CASES = [(seed, n, bins, cutoff) for seed, n in ((0, 1), (1, 500), (2, 60_000))
         for bins, cutoff in ((10, 10), (5, None), (3, 1))]


@pytest.mark.parametrize("seed,n,bins,cutoff", CASES)
def test_representations_equal_jax(monkeypatch, seed, n, bins, cutoff):
    h, w = 48, 64
    ev = _stream(np.random.RandomState(seed), n, h, w)
    for port_cls, jax_cls, cc in ((repr_.StackedHistogram, j_repr.StackedHistogram, cutoff),
                                  (repr_.MixedDensityEventStack, j_repr.MixedDensityEventStack,
                                   None if cutoff is None else 3 * cutoff)):
        got = port_cls(bins, h, w, cc, device="cpu").construct(*ev)
        want = _both_jax_paths(monkeypatch, lambda: jax_cls(bins, h, w, cc), *ev)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_representations_edge_cases_equal_jax(monkeypatch):
    """Empty input, identical times, saturation at the cutoff (and of the
    int8 stack), and an event at every power-of-two fraction of the window,
    where the mixed stack's bin is an exact integer."""
    h, w = 16, 20
    empty = tuple(np.zeros(0, np.int64) for _ in range(4))
    same = (np.full(300, 3), np.full(300, 4), np.ones(300, int), np.full(300, 77, np.int64))
    span = 1 << 20
    t = np.array([0] + [span >> k for k in range(20, -1, -1)], np.int64)
    pow2 = (np.arange(t.size) % w, np.arange(t.size) // w, np.ones(t.size, int), t)
    for ev in (empty, same, pow2):
        for bins in (1, 10, 25):
            for cc in (None, 2):
                got = repr_.StackedHistogram(bins, h, w, cc, device="cpu").construct(*ev)
                want = _both_jax_paths(monkeypatch, lambda: j_repr.StackedHistogram(bins, h, w, cc),
                                       *ev)
                np.testing.assert_array_equal(got, want)
                assert got.dtype == np.uint8
                got = repr_.MixedDensityEventStack(bins, h, w, cc, device="cpu").construct(*ev)
                want = _both_jax_paths(
                    monkeypatch, lambda: j_repr.MixedDensityEventStack(bins, h, w, cc), *ev)
                np.testing.assert_array_equal(got, want)
                assert got.dtype == np.int8
    assert repr_.StackedHistogram(3, h, w, 2, device="cpu").construct(*same).max() == 2
    assert repr_.MixedDensityEventStack(3, h, w, None, device="cpu").construct(*same).max() == 127
    if not torch.cuda.is_available():  # the card by default, never the CPU on its own
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repr_.StackedHistogram(3, h, w)


def test_host_helpers_equal_jax():
    rng = np.random.RandomState(4)
    t = np.sort(rng.randint(0, 10_000, 500)).astype(np.int64)
    t[[10, 200, 201]] = [0, 3, 2]
    np.testing.assert_array_equal(repr_.monotonize_time(torch.from_numpy(t)).numpy(),
                                  native.monotonize_time(t.copy()))
    for h, w in ((6, 8), (7, 9)):
        x = rng.randint(0, 255, (3, h, w)).astype(np.uint8)
        np.testing.assert_array_equal(repr_.downsample2x_nearest_u8(torch.from_numpy(x)).numpy(),
                                      native.downsample2x_nearest_u8(x))
    x = rng.randint(0, 255, (2, 4, 5, 6)).astype(np.uint8)
    np.testing.assert_array_equal(repr_.transpose_tchw_to_thwc(torch.from_numpy(x)).numpy(),
                                  native.transpose_tchw_to_thwc(x))


# -- the CLI ------------------------------------------------------------------------

def _raw_sequence(dir_: Path, name: str, dataset: str, seed: int) -> None:
    """A raw sequence: events .h5 (with a slightly non-monotonic time) and a
    box .npy; gen1 at 4 Hz labels, gen4 at 30 Hz."""
    rng = np.random.RandomState(seed)
    h, w = (240, 304) if dataset == "gen1" else (720, 1280)
    n = 40_000
    t = np.sort(rng.randint(0, 1_400_000, n)).astype(np.int64)
    t[100] = t[101] + 5
    with h5py.File(str(dir_ / f"{name}_td.dat.h5"), "w") as f:
        ev = f.create_group("events")
        ev.create_dataset("t", data=t)
        ev.create_dataset("x", data=rng.randint(0, w, n).astype(np.uint16))
        ev.create_dataset("y", data=rng.randint(0, h, n).astype(np.uint16))
        ev.create_dataset("p", data=rng.randint(0, 2, n).astype(np.int8))
        if dataset == "gen1":
            ev.create_dataset("height", data=h)
            ev.create_dataset("width", data=w)
    times = (range(250_000, 1_400_000, 250_000) if dataset == "gen1"
             else [int(100_000 + 33_333.4 * k) for k in range(30)])
    rows = [(ts, rng.uniform(0, w - 200), rng.uniform(0, h - 150), rng.uniform(40, 190),
             rng.uniform(40, 140), rng.randint(0, 4), 1.0, 0)
            for ts in times for _ in range(rng.randint(1, 3))]
    np.save(str(dir_ / f"{name}_bbox.npy"), np.array(rows, RAW_LABEL_DTYPE))


def _tree(root: Path):
    """Every file under ``root``: arrays of .npy/.npz/.h5 files."""
    out = {}
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = str(path.relative_to(root))
        if path.suffix == ".npy":
            out[rel] = np.load(str(path))
        elif path.suffix == ".npz":
            with np.load(str(path)) as z:
                out.update({f"{rel}:{k}": z[k] for k in z.files})
        elif path.suffix == ".h5":
            with h5py.File(str(path), "r") as f:
                out[rel] = f["data"][()]
                out[f"{rel}:layout"] = np.asarray(f["data"].attrs["layout"])
        else:
            out[rel] = path.read_bytes()
    return out


@pytest.mark.parametrize("dataset,extra", [
    ("gen1", []),
    ("gen1", ["--repr", "mixeddensity_stack", "--layout", "thwc", "--ticks", "physical"]),
    ("gen4", ["--nbins", "2", "--downsample-by-2", "--layout", "thwc"]),
    ("gen4", ["--repr", "mixeddensity_stack", "--nbins", "3", "--downsample-by-2",
              "--num-events", "5000"]),
])
def test_cli_writes_what_the_jax_cli_writes(tmp_path, monkeypatch, dataset, extra):
    raw = tmp_path / "raw"
    for split, seed in (("train", 0), ("test", 1)):
        (raw / split).mkdir(parents=True)
        _raw_sequence(raw / split, f"seq{seed}", dataset, seed)
    jax_cli = _script("scripts/preprocess_dataset.py", "j_preprocess_dataset")
    port_cli = _script("scripts/preprocess_dataset_torch.py", "preprocess_dataset_torch")
    argv = [str(raw), None, "-ds", dataset, *extra]
    monkeypatch.setattr(sys, "argv", ["preprocess_dataset.py", *[str(tmp_path / "jax")
                                                                 if a is None else a for a in argv]])
    jax_cli.main()
    port_cli.main([str(tmp_path / "port") if a is None else a for a in argv] + ["--device", "cpu"])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want) and any(k.endswith(".h5") for k in got)
    for key in want:
        if isinstance(want[key], bytes):
            assert got[key] == want[key], key
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    h5 = [v for k, v in got.items() if k.endswith(".h5")]
    assert all(v.any() for v in h5)  # events landed in the representations
    # A second run finds every file and checks it: nothing changes.
    port_cli.main([str(tmp_path / "port") if a is None else a for a in argv] + ["--device", "cpu"])
    again = _tree(tmp_path / "port")
    assert all(np.array_equal(again[k], got[k]) if not isinstance(got[k], bytes)
               else again[k] == got[k] for k in got)


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    port_cli = _script("scripts/preprocess_dataset_torch.py", "preprocess_dataset_torch")
    with pytest.raises(SystemExit, match="--device cpu"):
        port_cli.main([str(tmp_path), str(tmp_path / "out"), "-ds", "gen1"])
