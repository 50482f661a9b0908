"""The port's checkpoints: save and restore, the retention policy, full and
weights-only resume, a resumed step against the uninterrupted one, and the
reference ``.ckpt`` loader against the JAX package's converter. CPU, the
tiny test config; the same arithmetic on both sides of every comparison,
so every comparison is exact."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sast_tpu.checkpoint.torch_convert import convert_state_dict as j_convert_state_dict
from sast_tpu.config import get_test_config as j_test_config
from sast_tpu_torch.checkpoint.io import CheckpointManager
from sast_tpu_torch.checkpoint.torch_convert import convert_state_dict, load_torch_checkpoint
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data.batch import split_device_batch, to_device
from sast_tpu_torch.data.synthetic import synthetic_train_batch
from sast_tpu_torch.models.detector import YoloXDetector, init_weights
from sast_tpu_torch.training.loop import Trainer
from sast_tpu_torch.weights import load_jax_variables, to_jax_variables
from tests.test_torch_convert import _synthesize_torch_sd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on few cores, and torch's own thread pool in each of them
    oversubscribes the cores (its spinning threads then slow every worker
    many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**training):
    cfg = get_test_config()
    training = dict(dict(ema_decay=0.9, weight_decay=0.01, seed=0), **training)
    tr = dataclasses.replace(cfg.training, **training,
                             lr_scheduler=dataclasses.replace(cfg.training.lr_scheduler,
                                                              total_steps=10, pct_start=0.2))
    return dataclasses.replace(cfg, training=tr)


def _batches(cfg, n, seed=0):
    rng = np.random.RandomState(seed)
    out = [synthetic_train_batch(cfg, rng) for _ in range(n)]
    for b in out[1:]:
        b["is_first"] = np.zeros_like(b["is_first"])
    return out


def _step(trainer, batch):
    B = batch["ev_repr"].shape[1]
    trainer.state, _, _ = trainer.train_step(
        trainer.state, to_device(split_device_batch(batch)[0], "cpu"), trainer._zero_states(B))


def _assert_states_equal(a, b, optimizer=True):
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), name
    if a.ema_params is not None or b.ema_params is not None:
        for name in a.ema_params:
            assert torch.equal(a.ema_params[name], b.ema_params[name]), f"ema {name}"
    if optimizer:
        assert a.optimizer.count == b.optimizer.count
        sa, sb = a.optimizer.adamw.state_dict(), b.optimizer.adamw.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        assert set(sa["state"]) == set(sb["state"])
        for i in sa["state"]:
            for k, v in sa["state"][i].items():
                assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_save_and_restore_are_bit_equal(tmp_path):
    """Parameters, BatchNorm statistics, AdamW moments and count, EMA copy:
    a fresh trainer restored from a checkpoint holds the saved bits; the
    checkpoint file is written whole (no temporary file is left)."""
    cfg = _cfg()
    a = Trainer(cfg, str(tmp_path / "a"), device="cpu")
    for b in _batches(cfg, 2):
        _step(a, b)
    path = a.ckpt.save(2, a.state, metrics={"val_AP": 0.25})
    assert sorted(os.listdir(tmp_path / "a" / "ckpts")) == ["index.json", "step_2.pt"]
    assert os.path.getsize(path) > 0
    b = Trainer(cfg, str(tmp_path / "b"), device="cpu")
    assert b.state.step == 0
    CheckpointManager(str(tmp_path / "a" / "ckpts")).restore(b.state)
    _assert_states_equal(a.state, b.state)
    assert b.state.step == 2
    moved = [n for (n, x), (_, y) in zip(a.model.named_parameters(),
                                         Trainer(cfg, str(tmp_path / "c"), device="cpu")
                                         .model.named_parameters()) if not torch.equal(x, y)]
    assert moved, "the two steps moved no parameter"


@pytest.mark.parametrize("max_last", [1, 2])
def test_retention_keeps_the_best_and_the_latest(tmp_path, max_last):
    """After every save: the first step with the highest val_AP and the
    last ``max_last`` steps, nothing else. A save without metrics never
    evicts the latest save, and never counts as the best."""
    cfg = get_test_config()
    state = Trainer(cfg, str(tmp_path / "t"), device="cpu").state
    mgr = CheckpointManager(str(tmp_path / "ckpts"), max_last=max_last)
    saves = [(1, {"val_AP": 0.3}), (2, {"val_AP": 0.5}), (3, None), (4, {"val_AP": 0.1}),
             (5, {}), (6, {"val_AP": 0.5}), (7, None)]
    expect_best = {1: 1, 2: 2, 3: 2, 4: 2, 5: 2, 6: 2, 7: 2}
    for step, metrics in saves:
        mgr.save(step, state, metrics=metrics)
        last = [s for s, _ in saves if s <= step][-max_last:]
        assert mgr.all_steps() == sorted(set(last) | {expect_best[step]}), step
        assert mgr.latest_step() == step
        assert mgr.best_step() == expect_best[step]
    assert mgr.best_val_ap() == 0.5
    assert mgr.metrics(7) is None and mgr.metrics(2) == {"val_AP": 0.5}
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.latest_step() is None and empty.best_step() is None
    assert empty.best_val_ap() == -1.0
    with pytest.raises(FileNotFoundError):
        empty.restore(state)


def test_full_and_weights_only_resume(tmp_path):
    """``maybe_resume(True)`` restores everything and recovers the best
    val/AP; with ``weights_only`` the optimizer stays fresh (count 0) and
    the trainer keeps its own best (-1). Weights-only takes the best step,
    not the latest."""
    cfg = _cfg()
    workdir = str(tmp_path / "run")
    a = Trainer(cfg, workdir, device="cpu")
    batches = _batches(cfg, 2)
    _step(a, batches[0])
    a.ckpt.save(1, a.state, metrics={"val_AP": 0.45})
    best_model = {k: v.clone() for k, v in a.model.state_dict().items()}
    best_ema = {k: v.clone() for k, v in a.state.ema_params.items()}
    _step(a, batches[1])
    a.ckpt.save(2, a.state, metrics={"val_AP": 0.2})

    full = Trainer(cfg, workdir, device="cpu")
    assert full.best_val_ap == -1.0
    full.maybe_resume(True)
    _assert_states_equal(a.state, full.state)
    assert full.best_val_ap == 0.45 and full.state.step == 2

    ft = Trainer(cfg, workdir, device="cpu")
    ft.maybe_resume(True, weights_only=True)
    assert ft.state.step == 0 and ft.best_val_ap == -1.0
    assert not ft.state.optimizer.adamw.state
    for k, v in ft.model.state_dict().items():
        assert torch.equal(v, best_model[k]), k
    for k, v in ft.state.ema_params.items():
        assert torch.equal(v, best_ema[k]), k

    fresh = Trainer(cfg, str(tmp_path / "empty"), device="cpu")
    fresh.maybe_resume(True)
    fresh.maybe_resume(False)
    assert fresh.state.step == 0


def test_resumed_step_equals_the_uninterrupted_one(tmp_path):
    """``fit`` for two steps ends with a save; a new trainer resumed from it
    and the first trainer then take the same step: the same bits
    (parameters, statistics, moments, EMA)."""
    cfg = _cfg()
    batches = _batches(cfg, 3)
    a = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    a.fit(batches[:2], max_steps=2)
    assert a.ckpt.all_steps() == [2]
    b = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    b.maybe_resume(True)
    _step(a, batches[2])
    _step(b, batches[2])
    assert a.state.step == b.state.step == 3
    _assert_states_equal(a.state, b.state)


def test_restore_refuses_an_ema_mismatch(tmp_path):
    """A checkpoint with an EMA copy into a state without one (or the
    reverse) is refused, not half loaded."""
    a = Trainer(_cfg(), str(tmp_path / "a"), device="cpu")
    _step(a, _batches(a.cfg, 1)[0])
    a.ckpt.save(1, a.state)
    no_ema = Trainer(_cfg(ema_decay=0.0), str(tmp_path / "b"), device="cpu")
    before = {k: v.clone() for k, v in no_ema.model.state_dict().items()}
    no_ema.ckpt.save(0, no_ema.state)
    for src, dst in ((a, no_ema), (no_ema, a)):
        with pytest.raises(ValueError, match="EMA"):
            src.ckpt.restore_weights(dst.state)
    for k, v in no_ema.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def _reference_file(tmp_path):
    """A reference-style Lightning checkpoint of a seeded port model with
    random BatchNorm statistics, built by inverting the converter."""
    cfg = get_test_config()
    src = YoloXDetector(cfg.model)
    g = torch.Generator().manual_seed(3)
    init_weights(src, g)
    with torch.no_grad():
        for name, buf in src.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + (0.5 if name.endswith("var") else -0.5))
    variables = to_jax_variables(src)
    sd = _synthesize_torch_sd(variables["params"], variables["batch_stats"])
    path = tmp_path / "reference.ckpt"
    torch.save({"state_dict": sd, "epoch": 3, "hyper_parameters": {"lr": 1e-4}}, path)
    return cfg, src, sd, path


def test_reference_checkpoint_loads_parameters_and_statistics(tmp_path):
    """``load_torch_checkpoint`` on a reference-style file gives, tensor for
    tensor, what the JAX package's ``convert_state_dict`` followed by
    ``load_jax_variables`` gives, BatchNorm statistics included, and the
    model the file was made from."""
    cfg, src, sd, path = _reference_file(tmp_path)
    got = load_torch_checkpoint(str(path), YoloXDetector(cfg.model))
    params, stats = j_convert_state_dict(sd, j_test_config().model)
    ref = load_jax_variables(YoloXDetector(cfg.model), {"params": params, "batch_stats": stats})
    port_params, port_stats = convert_state_dict(sd, cfg.model)
    assert set(port_params) == set(params) and set(port_stats) == set(stats)
    sd_got, sd_ref, sd_src = got.state_dict(), ref.state_dict(), src.state_dict()
    assert set(sd_got) == set(sd_ref) == set(sd_src)
    for k in sd_ref:
        assert torch.equal(sd_got[k], sd_ref[k]), k
        assert torch.equal(sd_got[k], sd_src[k]), k
    # Without the Lightning wrapper and its prefixes, the same.
    bare = {k[len("mdl."):].replace("head.", "yolox_head.", 1) if k.startswith("mdl.head.")
            else k[len("mdl."):]: v for k, v in sd.items()}
    torch.save(bare, tmp_path / "bare.pth")
    again = load_torch_checkpoint(str(tmp_path / "bare.pth"), YoloXDetector(cfg.model))
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd_src[k]), k
