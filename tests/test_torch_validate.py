"""The port's trainer on the on-disk fixture dataset: ``fit`` with
validation and checkpoints, ``validate`` against the JAX package's
Prophesee evaluator, the EMA swap, and the two CLIs (CPU, plain versions).

The JAX trainer is not built here (its init and jit take over a minute on
the CPU): ``validate``'s metrics are held against the JAX package's
``PropheseeEvaluator`` fed the port's own ``eval_step`` detections.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sast_tpu.eval import prophesee as j_psee
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data.batch import split_device_batch, to_device
from sast_tpu_torch.data.module import DataModule
from sast_tpu_torch.training.loop import Trainer

import chip_smoke
import train_torch
import validation_torch


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


def _cfg(dataset_root, **training):
    """The tiny test detector on the fixture's 4-channel 240x304 clips
    (model resolution 256x320), with EMA and a confidence threshold of 0 so
    that random weights still give detections to score."""
    cfg = get_test_config()
    ds = dataclasses.replace(cfg.dataset, path=str(dataset_root), ev_repr_name="test_repr",
                             sequence_length=4, train_sampling="stream")
    bb = dataclasses.replace(cfg.model.backbone, input_channels=4, in_res_hw=(256, 320),
                             attention=dataclasses.replace(cfg.model.backbone.attention,
                                                           partition_size=(4, 5)))
    pp = dataclasses.replace(cfg.model.postprocess, confidence_threshold=0.0)
    tr = dataclasses.replace(cfg.training, **dict(dict(ema_decay=0.9, seed=0), **training))
    model = dataclasses.replace(cfg.model, backbone=bb, postprocess=pp)
    return dataclasses.replace(cfg, dataset=ds, model=model, training=tr)


def test_fit_validates_saves_the_best_and_always_ends_with_a_save(dataset_root, tmp_path):
    """``val_every=2`` over 3 steps: one validation at step 2, saved with
    its val/AP, then the final save at step 3 (not aligned): both kept, the
    first as the best. Without an evaluation loader ``ckpt_every`` saves."""
    cfg = _cfg(dataset_root)
    dm = DataModule(cfg)
    trainer = Trainer(cfg, str(tmp_path / "run"), log_every=2, val_every=2, device="cpu")
    calls = []
    metrics = trainer.fit(dm.train_batches(prefetch=False),
                          eval_loader_fn=lambda: calls.append(1) or dm.eval_batches("val"),
                          max_steps=3, eval_max_batches=2)
    assert calls == [1] and trainer.state.step == 3
    assert set(metrics) >= {"train/loss", "val/AP", "val/AP_50"}
    assert trainer.best_val_ap == metrics["val/AP"] >= 0.0
    assert trainer.ckpt.all_steps() == [2, 3]
    assert trainer.ckpt.metrics(2) == {"val_AP": metrics["val/AP"]}
    assert trainer.ckpt.metrics(3) is None and trainer.ckpt.best_step() == 2
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "val/AP" in r] == [2]

    periodic = Trainer(cfg, str(tmp_path / "periodic"), ckpt_every=2, device="cpu")
    periodic.fit(dm.train_batches(prefetch=False), max_steps=2)
    assert periodic.ckpt.all_steps() == [2] and periodic.ckpt.metrics(2) is None


def _port_detections_scored_by_jax(trainer, batches, max_batches):
    """What ``validate`` computes, written out against the JAX package's
    evaluator: the port's ``eval_step`` on the EMA copy, the labeled frames
    selected, ``detections_to_prophesee`` and ``PropheseeEvaluator``."""
    cfg = trainer.cfg
    ev = j_psee.PropheseeEvaluator(cfg.dataset.name, cfg.dataset.downsample_by_factor_2)
    trained = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    with torch.no_grad():
        for n, p in trainer.model.named_parameters():
            p.copy_(trainer.state.ema_params[n])
    lstm = None
    for i, batch in enumerate(batches):
        if i == max_batches:
            break
        device_batch, host = split_device_batch(batch)
        device_batch = to_device(device_batch, "cpu")
        lstm = lstm or trainer._zero_states(device_batch["ev_repr"].shape[1])
        lstm, dets = trainer.eval_step(device_batch, lstm)
        dets = {k: v.numpy() for k, v in dets.items()}
        flat = [fl for lane in host["_labels"] for fl in lane]
        sel = [f for f, fl in enumerate(flat)
               if batch["frame_valid"].reshape(-1)[f] and fl is not None and len(fl)]
        if sel:
            ev.add_labels([flat[f].to_structured() for f in sel])
            ev.add_predictions(j_psee.detections_to_prophesee(
                {k: v[sel] for k, v in dets.items()}, [int(flat[f].t[0]) for f in sel]))
    with torch.no_grad():
        for n, p in trainer.model.named_parameters():
            p.copy_(trained[n])
    return {f"val/{k}": v for k, v in ev.evaluate_buffer(1, 1).items()}


def _with_ground_truth(eval_step):
    """``eval_step`` whose first ``max_gt`` detection slots per frame hold
    the frame's ground truth moved by a few pixels, with scores that vary:
    random weights alone score an AP of 0, which would compare nothing."""

    def step(batch, lstm):
        lstm, dets = eval_step(batch, lstm)
        G = batch["gt_boxes"].shape[2]
        gt = batch["gt_boxes"].reshape(-1, G, 4)
        wiggle = 3.0 * torch.sin(torch.arange(gt.numel(), dtype=torch.float32)).reshape(gt.shape)
        dets["boxes"][:, :G] = torch.cat([gt[..., :2] - gt[..., 2:] / 2,
                                          gt[..., :2] + gt[..., 2:] / 2], -1) + wiggle
        dets["classes"][:, :G] = batch["gt_classes"].reshape(-1, G)
        dets["cls_conf"][:, :G] = 0.5 + 0.4 * torch.cos(torch.arange(G * gt.shape[0])).reshape(-1, G)
        dets["valid"][:, :G] = batch["gt_valid"].reshape(-1, G)
        return lstm, dets

    return step


def test_validate_matches_the_jax_evaluator_on_the_ema_copy(dataset_root, tmp_path):
    """After one training step the EMA copy differs from the parameters;
    ``validate`` runs ``eval_step`` on the EMA copy, scores its detections
    (with the ground truth written into some slots) exactly as the JAX
    evaluator scores them (to 1e-12), leaves the trained parameters
    bit-equal, and closes what it was given."""
    cfg = _cfg(dataset_root)
    dm = DataModule(cfg)
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    trainer.fit(dm.train_batches(prefetch=False), max_steps=1)
    trained = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    assert any(not torch.equal(trained[n], e) for n, e in trainer.state.ema_params.items())

    seen = []
    inner = _with_ground_truth(trainer._eval_step)

    def spy(batch, lstm):
        seen.append(all(torch.equal(p, trainer.state.ema_params[n])
                        for n, p in trainer.model.named_parameters()))
        return inner(batch, lstm)

    trainer._eval_step = spy
    batches = dm.eval_batches("val")
    got = trainer.validate(batches, max_batches=5)
    assert seen == [True] * 5
    assert batches._stop.is_set()  # the prefetcher was closed
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, trained[n]), n
    ref = _port_detections_scored_by_jax(trainer, dm.eval_batches("val", prefetch=False), 5)
    assert set(got) == set(ref) and 0 < ref["val/AP"] < 1
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12, (k, got[k], ref[k])
    assert trainer.validate([]) == {}
    # Panels are drawn of labeled frames only: none here, and no file.
    assert trainer.validate([], save_viz=1) == {}
    assert not (tmp_path / "run" / "viz" / "val_0000.png").exists()


def test_validate_restores_the_parameters_when_it_raises(dataset_root, tmp_path):
    cfg = _cfg(dataset_root)
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    with torch.no_grad():
        for p in trainer.state.ema_params.values():
            p.add_(1.0)
    trained = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    def broken():
        yield next(iter(DataModule(cfg).eval_batches("val", prefetch=False)))
        raise RuntimeError("reader failed")

    with pytest.raises(RuntimeError, match="reader failed"):
        trainer.validate(broken())
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, trained[n]), n


CLI_SETS = ["dataset.ev_repr_name=test_repr", "model.backbone.input_channels=4",
            "dataset.sequence_length=4", "dataset.train_sampling=stream",
            "training.batch_size_train=2", "training.batch_size_eval=2",
            "training.max_labeled_frames_per_lane=2", "model.compute_dtype=float32"]


def _cli(dataset_root, *args):
    return ["--dataset", "gen1", "--size", "tiny", "--data", str(dataset_root), "--device", "cpu",
            *[a for s in CLI_SETS for a in ("--set", s)], *args]


def test_train_and_validation_clis_on_the_cpu(dataset_root, tmp_path, capsys):
    """``train_torch.main`` for 2 steps (validating the test split at step
    2), then ``validation_torch.main`` on its checkpoint directory for one
    batch, and on a reference-style ``.ckpt`` of the same weights: the
    second loads parameters and BatchNorm statistics, and both score the
    batch alike."""
    workdir = tmp_path / "run"
    metrics = train_torch.main(_cli(dataset_root, "--workdir", str(workdir), "--max-steps", "2",
                                    "--val-every", "2", "--log-every", "1"))
    assert "val/AP" in metrics and np.isfinite(metrics["train/loss"])
    assert sorted(p.name for p in (workdir / "ckpts").iterdir()) == ["index.json", "step_2.pt"]

    args = ["--max-batches", "1", "--split", "test", "--workdir", str(tmp_path / "val")]
    got, trainer = validation_torch.main(_cli(dataset_root, "--ckpt", str(workdir / "ckpts"), *args))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert trainer.cfg.model.postprocess.confidence_threshold == 0.001
    saved = torch.load(workdir / "ckpts" / "step_2.pt", weights_only=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k

    from sast_tpu_torch.weights import to_jax_variables

    ref_path = tmp_path / "reference.ckpt"
    torch.save({"state_dict": chip_smoke.reference_state_dict(
        torch, np, to_jax_variables(trainer.model), trainer.cfg.model)}, ref_path)
    again, loaded = validation_torch.main(_cli(dataset_root, "--ckpt", str(ref_path), *args))
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert loaded.state.ema_params is None and again == got


@pytest.mark.parametrize("argv", [["--wandb"], ["--wandb-runpath", "a/b/c"],
                                  ["--resume-wandb-artifact", "a/b/c:best"], ["--device-cache"],
                                  ["--profile-steps", "1:2"], ["WORLD_SIZE=2"]],
                         ids=["wandb", "wandb-runpath", "artifact", "device-cache", "profile",
                              "world"])
def test_clis_refuse_what_is_not_ported(argv, monkeypatch, capsys, tmp_path):
    """Only the Weights & Biases options are refused, by name. The card
    cache and profiler traces are accepted and the run goes on to read the
    (missing) dataset; a torchrun world with half its variables set stops
    before any rendezvous, naming what is missing."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    cpu = ["--size", "tiny", "--device", "cpu", "--workdir", str(tmp_path / "run")]
    if argv == ["WORLD_SIZE=2"]:
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="RANK, MASTER_ADDR, MASTER_PORT missing"):
            train_torch.main(["--data", "unused", *cpu])
        return
    if argv[0] in ("--wandb", "--wandb-runpath", "--resume-wandb-artifact"):
        with pytest.raises(SystemExit) as err:
            train_torch.main(["--data", "unused", *argv])
        assert err.value.code == 2 and "not ported" in capsys.readouterr().err
        return
    with pytest.raises(AssertionError, match="missing dataset split dir"):
        train_torch.main(["--data", str(tmp_path / "unused"), *cpu, *argv])
    assert "not ported" not in capsys.readouterr().err
    if argv == ["--device-cache"]:
        # Parsed: validation goes on to read the (missing) checkpoint.
        with pytest.raises(FileNotFoundError):
            validation_torch.main(["--data", "unused", "--ckpt", str(tmp_path / "none.ckpt"),
                                   *cpu, *argv])


def test_reference_state_dict_inverts_the_converter_as_the_convert_test_does():
    """chip_smoke's reference-style state_dict builder (any model config)
    gives, at the test config, the state_dict of the JAX package's own
    converter test."""
    from sast_tpu_torch.models.detector import YoloXDetector, init_weights
    from sast_tpu_torch.weights import to_jax_variables
    from tests.test_torch_convert import _synthesize_torch_sd

    cfg = get_test_config()
    model = YoloXDetector(cfg.model)
    init_weights(model, torch.Generator().manual_seed(5))
    variables = to_jax_variables(model)
    got = chip_smoke.reference_state_dict(torch, np, variables, cfg.model)
    ref = _synthesize_torch_sd(variables["params"], variables["batch_stats"])
    ref = {k.replace("mdl.head.", "mdl.yolox_head.", 1): v for k, v in ref.items()}
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
