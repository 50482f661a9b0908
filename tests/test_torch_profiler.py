"""``Trainer.fit(profile_steps=(first, last))`` and the training CLI's new
options on the CPU (tiny config, plain versions): the trace covers its
window, also from a resumed step inside it; ``train_torch.py`` trains from
the card-resident cache (CPU tensors here) and writes the trace.

The JAX trainer writes a ``jax.profiler`` trace with the same window logic;
the traces themselves cannot be compared, so the port is held to the
window: a ``train_step <n>`` range for each step inside it, none outside.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data.synthetic import synthetic_train_batch
from sast_tpu_torch.training.loop import Trainer

import train_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    cfg = get_test_config()
    return dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, seed=0))


def _batches(cfg, n):
    rng = np.random.RandomState(0)
    return [synthetic_train_batch(cfg, rng) for _ in range(n)]


def _traced_steps(workdir):
    """The ``train_step <n>`` ranges of the one trace under ``workdir/trace``."""
    files = sorted((workdir / "trace").glob("rank0.*.pt.trace.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return sorted({int(e["name"].split()[1]) for e in events
                   if e.get("name", "").startswith("train_step ")})


@pytest.mark.parametrize("window, steps, traced", [((2, 3), 4, [2, 3]), ((3, 9), 4, [3, 4])],
                         ids=["inside", "past-the-end"])
def test_profile_steps_trace_covers_its_window(tmp_path, window, steps, traced):
    """The trace starts before step ``first`` and stops after step
    ``last``, or when ``fit`` ends inside the window."""
    cfg = _cfg()
    trainer = Trainer(cfg, str(tmp_path / "run"), log_every=1, device="cpu")
    trainer.fit(_batches(cfg, steps), max_steps=steps, profile_steps=window)
    assert trainer.state.step == steps
    assert _traced_steps(tmp_path / "run") == traced


def test_profile_steps_from_a_resumed_step_inside_the_window(tmp_path):
    """A run resumed at step 2 with the window (2, 4) records the rest of
    it, steps 3 and 4, as the JAX trainer does (``first <= step + 1``)."""
    cfg = _cfg()
    first = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    first.fit(_batches(cfg, 2), max_steps=2)  # saves step 2 at the end
    resumed = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    resumed.maybe_resume(True)
    assert resumed.state.step == 2
    resumed.fit(_batches(cfg, 2), max_steps=4, profile_steps=(2, 4))
    assert _traced_steps(tmp_path / "run") == [3, 4]


def test_train_cli_trains_from_the_card_cache_and_traces(dataset_root, tmp_path):
    """``train_torch.py --device-cache --profile-steps 2:2`` on the fixture
    dataset: two steps from the cached split, validation of the cached test
    split at step 2, the trace of step 2."""
    from tests.test_torch_validate import _cli

    workdir = tmp_path / "run"
    metrics = train_torch.main(_cli(dataset_root, "--workdir", str(workdir), "--max-steps", "2",
                                    "--val-every", "2", "--log-every", "1", "--device-cache",
                                    "--profile-steps", "2:2"))
    assert np.isfinite(metrics["train/loss"]) and "val/AP" in metrics
    assert _traced_steps(workdir) == [2]
    assert train_torch.parse_profile_steps("5") == (5, 5)
    assert train_torch.parse_profile_steps(None) is None


def test_kernel_table_counts_no_annotation():
    """``utils/profiling.kernel_table`` counts the work, not the spans laid
    over it: under a profiler ``schedule`` with a warm-up step, the one
    active step's operators are its rows, and neither the profiler's step
    nor a ``record_function`` range is one."""
    from sast_tpu_torch.utils.profiling import kernel_table

    a = torch.randn(64, 64)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                schedule=schedule) as prof:
        torch.mm(a, a)
        prof.step()
        with torch.profiler.record_function("a range"):
            torch.add(a, a)
        prof.step()
    table = kernel_table(prof, device_type="cpu")
    assert [r["name"] for r in table["rows"]] == ["aten::add"]
    assert table["kernel_ms"] == table["rows"][0]["ms"]
