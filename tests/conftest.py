"""Test harness: CPU platform with 8 virtual devices + persistent compile cache.

The host has one CPU core and XLA compiles are slow; the on-disk compilation
cache makes pytest reruns fast. Multi-device tests use the virtual CPU mesh
(the same mechanism the driver uses for the multichip dry run).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
# 8 virtual device threads on 1 host core: a stall past XLA:CPU's 40 s
# rendezvous termination timeout CHECK-kills pytest mid-collective (flaky
# abort observed in test_multichip). Stretch the watchdogs — each only if
# the user has not already set it (last-wins parsing would override theirs).
for _flag in (
    "--xla_cpu_collective_call_warn_stuck_timeout_seconds=300",
    "--xla_cpu_collective_timeout_seconds=3000",
    # The flag that controls the 40 s termination CHECK in this jaxlib
    # build (xla::cpu::TerminateTimeout; verified by symbol dump — see
    # __graft_entry__._worker_env). Without it the two flags above only
    # delay the warning, not the process kill.
    "--xla_cpu_collective_call_terminate_timeout_seconds=3000",
):
    if _flag.split("=")[0] not in os.environ["XLA_FLAGS"]:
        os.environ["XLA_FLAGS"] += " " + _flag

import jax  # noqa: E402

# SAST_TPU_TESTS=1 keeps the real backend so the opt-in TPU regression
# tests (tests/test_tpu_pallas.py) can touch hardware; everything else in
# the suite runs on the virtual-device CPU platform.
if not os.environ.get("SAST_TPU_TESTS"):
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sast_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

LABEL_DTYPE = np.dtype(
    [
        ("t", "<u8"),
        ("x", "<f4"),
        ("y", "<f4"),
        ("w", "<f4"),
        ("h", "<f4"),
        ("class_id", "<u4"),
        ("class_confidence", "<f4"),
    ]
)


def make_sequence(root, name, num_repr, labeled_reprs, seed=0, hw=(240, 304), ch=4,
                  layout="tchw"):
    """Create one synthetic sequence dir in the reference on-disk layout
    (or the optional THWC layout when ``layout='thwc'``)."""
    import h5py

    H, W = hw
    rng = np.random.RandomState(seed)
    seq = root / name
    ev_dir = seq / "event_representations_v2" / "test_repr"
    ev_dir.mkdir(parents=True)
    (seq / "labels_v2").mkdir(parents=True)

    data = (rng.rand(num_repr, ch, H, W) * 4).astype(np.uint8)
    if layout == "thwc":
        data = np.ascontiguousarray(np.transpose(data, (0, 2, 3, 1)))
    with h5py.File(str(ev_dir / "event_representations.h5"), "w") as f:
        dset = f.create_dataset("data", data=data, chunks=(1, *data.shape[1:]))
        dset.attrs["layout"] = "THWC" if layout == "thwc" else "TCHW"
    np.save(str(ev_dir / "objframe_idx_2_repr_idx.npy"), np.asarray(labeled_reprs))
    np.save(
        str(ev_dir / "timestamps_us.npy"),
        np.arange(num_repr, dtype=np.int64) * 50_000,
    )

    rows = []
    start_idx = []
    for r in labeled_reprs:
        start_idx.append(len(rows))
        for _ in range(rng.randint(1, 4)):
            w = rng.uniform(20, 60)
            h = rng.uniform(20, 60)
            rows.append(
                (
                    r * 50_000,
                    rng.uniform(0, W - w - 2),
                    rng.uniform(0, H - h - 2),
                    w,
                    h,
                    rng.randint(0, 2),
                    1.0,
                )
            )
    labels = np.array(rows, dtype=LABEL_DTYPE)
    np.savez(
        str(seq / "labels_v2" / "labels.npz"),
        labels=labels,
        objframe_idx_2_label_idx=np.asarray(start_idx, np.int64),
    )
    np.save(
        str(seq / "labels_v2" / "timestamps_us.npy"),
        np.asarray(labeled_reprs, np.int64) * 50_000,
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where CUDA is absent"
    )


@pytest.fixture(scope="session")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("genx")
    for split, seeds in [("train", (0, 1, 2)), ("val", (3, 4)), ("test", (5, 6))]:
        d = root / split
        d.mkdir()
        make_sequence(d, f"seq_a{seeds[0]}", 20, [3, 7, 11, 15, 19], seeds[0])
        make_sequence(d, f"seq_b{seeds[1]}", 30, [2, 5, 25, 29], seeds[1])
        if len(seeds) > 2:
            make_sequence(d, f"seq_c{seeds[2]}", 12, [4, 9], seeds[2])
    return root
