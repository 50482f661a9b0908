"""The port's measuring CLIs (``scripts/*_torch.py``) on the CPU at tiny
sizes: each ``main([... "--device", "cpu"])`` prints its table and one JSON
line per row, and what it counts holds against the JAX package where there
is a counterpart: ``model_info_torch.py``'s parameter counts against
``scripts/model_info.py`` (``jax.eval_shape``) for every preset, and
``bench_loader_torch.py``'s batches against the JAX ``DataModule`` over a
``scripts/make_synth_dataset.py`` dataset. Every CLI that runs the model
refuses a card it does not find, by name.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
TINY = ["--device", "cpu", "--set", "model.compute_dtype=float32"]
SMALL_RES = ["--set", "dataset.resolution_hw_override=(60, 100)"]
CARD_CLIS = ("bench_serving", "bench_sparse_layer", "bench_train_sparsity", "profile_inference",
             "profile_train", "roofline_inference")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    """The module of ``scripts/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"_cli_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rows(capsys, name, argv):
    """Run ``scripts/<name>_torch.py``'s ``main(argv)``; its JSON lines."""
    _script(f"{name}_torch").main(argv)
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("name", CARD_CLIS + ("model_info",))
def test_cli_refuses_a_missing_card_by_name(name):
    """Asked for the card where there is none, a CLI stops with the reason
    before it builds anything, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a host without a card")
    argv = ["--device", "cuda"] + (["--flops"] if name == "model_info" else [])
    with pytest.raises(SystemExit, match=r"needs an NVIDIA card.*is_available\(\) is false"):
        _script(f"{name}_torch").main(argv)


def test_bench_serving_times_the_full_step(capsys):
    """Two lanes of gen1-tiny on clustered events made on the device: one
    row with the slope's ms per step and frames/s of the L1/L2 chunks."""
    (row,) = _rows(capsys, "bench_serving", [
        "--size", "tiny", "--streams", "2", "--events", "300", "--clustered", "2", "--L1", "1",
        "--L2", "2", "--blocks", "1", *TINY])
    assert (row["streams"], row["events"], row["clustered"], row["path"]) == (2, 300, 2, "default")
    assert len(row["t_L1_s"]) == len(row["t_L2_s"]) == 1 and min(row["t_L1_s"]) > 0
    assert row["frames_per_s"] == pytest.approx(2e3 / row["ms_per_step"])
    assert row["device_kind"] == "cpu"


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "fwd+bwd"])
def test_bench_sparse_layer_checks_then_times_each_path(capsys, grad):
    """One layer at window densities 0.25 and 1: every path within the fp32
    tolerance of the masked path (outputs, and with ``--grad`` the input's
    gradient), then a time per path; the crossover line last. F is forward
    only."""
    rows = _rows(capsys, "bench_sparse_layer", [
        "--B", "2", "--N", "8", "--hw", "6", "--C", "32", "--dim-head", "16", "--iters", "4",
        "--blocks", "1", "--densities", "0.25,1.0", "--dtype", "float32", "--device", "cpu"]
        + (["--grad"] if grad else []))
    *layers, crossover = rows
    assert [r["kept_windows"] for r in layers] == [4, 16]
    timed = ("masked", "gather", "sparse") + (() if grad else ("looped",))
    for r in layers:
        assert r["mode"] == ("fwd+bwd" if grad else "fwd")
        assert all(f"{p}_ms" in r for p in timed) and ("looped_ms" in r) == (not grad)
        checked = {f"{p}_{o}" for p in timed[1:] for o in ("y", "dx") if o == "y" or grad}
        assert set(r["worst_error_over_tolerance"]) >= checked
        assert max(r["worst_error_over_tolerance"].values()) <= 1.0
    assert crossover["metric"] == "sparse_layer_crossover"


def test_bench_train_sparsity_paths_compute_one_step(capsys):
    """gen1-tiny at 60x100, B 2, T 3: the masked, sparse-kernel and gather
    train steps from the same seed on the same batch give the same loss
    (fp32, 1e-4 relative) and a time each."""
    (row,) = _rows(capsys, "bench_train_sparsity", [
        "--size", "tiny", "--batch", "2", "--seq", "3", "--iters", "1", "--repeats", "1",
        "--sparsities", "0.9", "--paths", "xla,pallas,gather", *TINY, *SMALL_RES])
    assert (row["batch"], row["seq"], row["sparsity"]) == (2, 3, 0.9)
    for path in ("masked", "sparse", "gather"):
        assert row[f"{path}_ms"] > 0
        assert row[f"{path}_loss"] == pytest.approx(row["masked_loss"], rel=1e-4)
    assert row["P"] > 0


def test_profile_inference_tables_the_chunk(capsys, tmp_path):
    """A 2-frame gen1-tiny chunk profiled: kernel rows (on the CPU the
    operators' host time), each in a group, a summary line with the groups
    and the wall time, and the Chrome trace on disk."""
    rows = _rows(capsys, "profile_inference", [
        "--dataset", "gen1", "--size", "tiny", "--length", "2", "--batch", "1", "--top-k", "5",
        "--out", str(tmp_path), *TINY])
    *kernels, summary = rows
    assert len(kernels) == 5 and all(r["metric"] == "profile_inference_kernel" for r in kernels)
    assert summary["metric"] == "profile_inference" and summary["wall_ms_per_frame"] > 0
    assert sum(summary["groups"].values()) == pytest.approx(summary["kernel_ms_per_frame"])
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


def test_profile_train_policies_compute_one_step(capsys, tmp_path):
    """Remat ``full`` and ``none`` at gen1-tiny 60x100, B 2, T 3: the same
    loss after the same steps, more FLOPs under ``full`` (its recomputed
    forward), and with ``--trace`` a table and a trace per policy."""
    full, none = _rows(capsys, "profile_train", [
        "--size", "tiny", "--batch", "2", "--seq", "3", "--L1", "1", "--L2", "2", "--repeats",
        "1", "--policies", "full,none", "--trace", str(tmp_path), "--top-k", "3",
        *TINY, *SMALL_RES])
    assert (full["policy"], none["policy"]) == ("full", "none")
    assert full["loss"] == pytest.approx(none["loss"], rel=1e-5)
    assert full["tflop_per_step"] > none["tflop_per_step"] > 0
    assert (tmp_path / "full.json").is_file() and (tmp_path / "none.json").is_file()
    assert full["peak_gib"] is None and full["mfu_pct"] is None  # no card


def test_roofline_counts_on_the_cpu_without_floors(capsys):
    """On the CPU the step's FLOPs and bytes are counted and its time taken
    as given, and the floors, the shares and the bound are null: the
    table holds no CPU numbers, and no flag states any."""
    (row,) = _rows(capsys, "roofline_inference", [
        "--dataset", "gen1", "--size", "tiny", "--batch", "1", "--measured-ms", "50", *TINY])
    assert row["gflop_per_step"] > 0 and row["mb_per_step"] > 0 and row["measured_given"]
    assert row["measured_ms"] == 50 and row["device_kind"] == "cpu"
    assert row["flop_per_byte"] == pytest.approx(row["gflop_per_step"] * 1e3
                                                 / row["mb_per_step"])
    for key in ("peak_tflops", "mem_tb_per_s", "compute_floor_ms", "memory_floor_ms",
                "compute_share", "memory_share", "ridge_flop_per_byte", "bound"):
        assert row[key] is None, key


def test_roofline_floors_come_from_the_card_table():
    """On a card of ``CARDS`` each floor is the count over the table's
    peak or memory rate, each share the floor over the step, and the bound
    the side of the ridge the step's intensity lies on."""
    from sast_tpu_torch.utils.profiling import CARDS

    cli = _script("roofline_inference_torch")
    h100 = CARDS["NVIDIA H100 80GB HBM3"]
    row = cli.floors(2e12, 1e9, 50.0, h100)
    assert row["compute_floor_ms"] == pytest.approx(2e12 / 989.4e12 * 1e3)
    assert row["memory_floor_ms"] == pytest.approx(1e9 / 3.35e12 * 1e3)
    assert row["compute_share"] == pytest.approx(row["compute_floor_ms"] / 50)
    assert row["memory_share"] == pytest.approx(row["memory_floor_ms"] / 50)
    assert row["ridge_flop_per_byte"] == pytest.approx(989.4 / 3.35)
    assert row["bound"] == "compute"  # 2000 FLOP/B, above the ridge
    assert cli.floors(2e9, 1e9, 50.0, h100)["bound"] == "memory"


def test_roofline_refuses_a_card_without_its_numbers(monkeypatch):
    """A card that ``CARDS`` does not hold is refused by name before the
    model is built, and no flag states its numbers instead."""
    from sast_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "card", lambda device: torch.device("cuda"))
    monkeypatch.setattr(profiling, "card_info",
                        lambda device: dict(kind="Some Other GPU", smi="Some Other GPU, 300 W"))
    with pytest.raises(SystemExit, match=r"no peak or memory rate known for 'Some Other GPU'"):
        _script("roofline_inference_torch").main([])
    with pytest.raises(SystemExit):
        _script("roofline_inference_torch").main(["--peak-tflops", "2", "--device", "cpu"])


PRESETS = [(d, s) for d in ("gen1", "gen4") for s in ("tiny", "small", "base", "large")]


@pytest.mark.parametrize("dataset,size", PRESETS, ids=[f"{d}-{s}" for d, s in PRESETS])
def test_model_info_counts_equal_the_jax_script(capsys, dataset, size):
    """Parameters per group and in total, from the port's model on the meta
    device, equal ``scripts/model_info.py``'s from ``jax.eval_shape``."""
    from sast_tpu.config import get_config as j_get_config

    (row,) = _rows(capsys, "model_info", ["--datasets", dataset, "--sizes", size])
    want = _script("model_info").count_params(j_get_config(dataset, size))
    assert {k: row[k] for k in want} == want


@pytest.fixture(scope="module")
def synth_dataset(tmp_path_factory):
    """A dataset written by ``scripts/make_synth_dataset.py`` (2 training
    sequences of 40 frames)."""
    root = tmp_path_factory.mktemp("synth") / "data"
    subprocess.run([sys.executable, str(SCRIPTS / "make_synth_dataset.py"), str(root), "--seqs",
                    "2", "--frames", "40"], check=True, stdout=subprocess.DEVNULL)
    return root


@pytest.mark.parametrize("mode", ["stream", "random", "mixed"])
def test_bench_loader_batches_equal_the_jax_data_module(synth_dataset, mode):
    """The loader's configuration over the synthetic dataset gives the first
    training batches of the JAX ``DataModule`` bit for bit."""
    from sast_tpu.config import get_config as j_get_config
    from sast_tpu.data.module import DataModule as JDataModule
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.module import DataModule
    from tests.test_torch_data import _assert_batches_equal

    cli = _script("bench_loader_torch")
    got = _assert_batches_equal(
        DataModule(cli.loader_config(get_config, synth_dataset, 5, 2, mode)).train_batches(
            prefetch=False),
        JDataModule(cli.loader_config(j_get_config, synth_dataset, 5, 2, mode)).train_batches(
            prefetch=False), 2, mode)
    assert got[0]["ev_repr"].shape[:2] == (5, 2)
    assert np.any(got[0]["ev_repr"])


def test_bench_loader_rows(capsys, synth_dataset):
    """One row per training sampler and the evaluation stream, with the
    verdict against a stated step time."""
    rows = _rows(capsys, "bench_loader", [
        "--data", str(synth_dataset), "--batches", "2", "--warmup", "1", "--batch-size", "2",
        "--seq-len", "5", "--no-prefetch", "--step-ms", "1e6"])
    assert [r["split"] for r in rows] == ["train/stream", "train/random", "train/mixed",
                                          "eval/stream"]
    for r in rows:
        assert r["batches_per_s"] > 0 and r["verdict"] == "OK"
        assert r["frames_per_s"] == pytest.approx(r["batches_per_s"] * 10)
