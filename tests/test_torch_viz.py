"""Port vs JAX package: ``utils/viz.py`` (arrays and PNG bytes), the numpy
gradient-flow figure, and the trainer's figures (``fit`` writes
``viz/gradflow.png`` at each validation; ``validate(save_viz=n)`` writes n
panels), on the CPU."""

import json

import numpy as np
import pytest
import torch

from sast_tpu.utils import viz as j_viz
from sast_tpu_torch.data.module import DataModule
from sast_tpu_torch.eval.prophesee import detections_to_prophesee
from sast_tpu_torch.training import loop
from sast_tpu_torch.training.loop import Trainer
from sast_tpu_torch.utils import viz
from tests.test_torch_validate import _cfg

import chip_smoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ev(rng, h=40, w=56, bins=5):
    return rng.poisson(0.4, (h, w, 2 * bins)).clip(0, 255).astype(np.uint8)


def _boxes(rng, n, h=40, w=56):
    xy = rng.uniform(-5, 50, (n, 2))
    return np.concatenate([xy, rng.uniform(0, 30, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_images_equal_jax(seed):
    """``ev_repr_to_img``, ``draw_bboxes`` (boxes partly outside, empty
    ones, thickness 2, class ids past the palette) and
    ``render_detection_frame`` array for array."""
    rng = np.random.RandomState(seed)
    ev = _ev(rng)
    np.testing.assert_array_equal(viz.ev_repr_to_img(ev), j_viz.ev_repr_to_img(ev))
    boxes, labels = _boxes(rng, 9), rng.randint(0, 9, 9)
    for thickness in (1, 2):
        got = viz.draw_bboxes(viz.ev_repr_to_img(ev), boxes, labels, thickness=thickness)
        want = j_viz.draw_bboxes(j_viz.ev_repr_to_img(ev), boxes, labels, thickness=thickness)
        np.testing.assert_array_equal(got, want)
    kw = dict(gt_boxes=_boxes(rng, 4), pred_boxes=_boxes(rng, 6),
              pred_classes=rng.randint(0, 3, 6), gt_classes=rng.randint(0, 3, 4))
    np.testing.assert_array_equal(viz.render_detection_frame(ev, **kw),
                                  j_viz.render_detection_frame(ev, **kw))
    np.testing.assert_array_equal(viz.render_detection_frame(ev), j_viz.render_detection_frame(ev))


def test_save_png_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    img = viz.render_detection_frame(_ev(rng), gt_boxes=_boxes(rng, 3), pred_boxes=_boxes(rng, 2))
    viz.save_png(str(tmp_path / "port.png"), img)
    j_viz.save_png(str(tmp_path / "jax.png"), img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(chip_smoke.png_decodes(np, tmp_path / "port.png"), img)
    with pytest.raises(ValueError, match="uint8"):
        viz.save_png(str(tmp_path / "bad.png"), img.astype(np.float32))


def test_render_gradflow_passes_the_jax_figure_checks():
    """The checks of tests/test_utils.py's gradflow test, on the numpy
    figure; a curve per component in its palette colour; a non-positive or
    missing value is left out rather than raising."""
    steps = [50, 100, 150]
    series = {"backbone": [10.0, 5.0, 2.0], "fpn": [3.0, 2.0, 1.5], "head": [1.0, 0.8, 0.5],
              "total": [11.0, 6.0, 3.0]}
    img = viz.render_gradflow(steps, series)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    assert img.shape[0] > 100 and img.shape[1] > 100
    assert img.min() < 250  # non-blank: coloured curves on white
    for k in range(len(series)):
        assert (img == viz._PALETTE[k]).all(-1).sum() > 100  # each curve drawn
    odd = viz.render_gradflow([1, 2, 3], {"a": [0.0, float("nan"), 1.0], "b": [2.0]})
    assert odd.shape == img.shape
    assert viz.render_gradflow([], {}).shape == img.shape


def _recording(monkeypatch):
    """Every image the trainer saves, with its file name, in order."""
    saved = []
    monkeypatch.setattr(loop, "save_png", lambda path, img: saved.append((path, img)))
    return saved


def test_fit_writes_the_gradient_flow_at_each_validation(dataset_root, tmp_path, monkeypatch):
    """Fault 3c: ``fit`` with an evaluation loader draws the gradient norms
    logged so far (per component, and the total) at each validation, as
    ``viz/gradflow.png``; the file is a PNG of that figure."""
    cfg = _cfg(dataset_root)
    dm = DataModule(cfg)
    work = tmp_path / "run"
    trainer = Trainer(cfg, str(work), log_every=1, val_every=2, device="cpu")
    saved = _recording(monkeypatch)
    trainer.fit(dm.train_batches(prefetch=False),
                lambda: dm.eval_batches("val", prefetch=False), max_steps=4, eval_max_batches=1)
    assert [p for p, _ in saved] == [str(work / "viz" / "gradflow.png")] * 2
    rows = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if "train/grad_norm" in r]
    for (_, img), upto in zip(saved, (2, 4)):
        seen = [r for r in rows if r["step"] <= upto]
        series = {}
        for r in seen:
            for k, v in r.items():
                if k.startswith("train/grad_norm"):
                    name = k[len("train/grad_norm/"):] if "/" in k[len("train/"):] else "total"
                    series.setdefault(name, []).append(v)
        assert {"total", "backbone", "fpn", "head"} <= set(series)
        np.testing.assert_array_equal(img, viz.render_gradflow([r["step"] for r in seen], series))
    monkeypatch.undo()
    viz.save_png(str(tmp_path / "g.png"), saved[-1][1])
    assert chip_smoke.png_decodes(np, tmp_path / "g.png") is not None


def test_validate_saves_a_panel_of_each_batch_it_scores(dataset_root, tmp_path, monkeypatch):
    """``validate(save_viz=2)`` writes ``viz/val_<batch>.png`` for the first
    two batches with a labeled frame, each the ``render_detection_frame`` of
    that batch's first labeled frame with its labels and the predictions
    ``validate`` scored (JAX's choice of frame and name)."""
    cfg = _cfg(dataset_root)
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    dets_seen = []
    inner = trainer._eval_step

    def spy(batch, lstm):
        lstm, dets = inner(batch, lstm)
        dets_seen.append({k: (v.float() if v.is_floating_point() else v).numpy()
                          for k, v in dets.items()})
        return lstm, dets

    trainer._eval_step = spy
    saved = _recording(monkeypatch)
    batches = list(DataModule(cfg).eval_batches("val", prefetch=False))[:4]
    trainer.validate(iter(batches), save_viz=2)
    want = []
    for n, (batch, dets) in enumerate(zip(batches, dets_seen)):
        flat = [fl for lane in batch["_labels"] for fl in lane]
        sel = [f for f, fl in enumerate(flat)
               if batch["frame_valid"].reshape(-1)[f] and fl is not None and len(fl)]
        if not sel or len(want) == 2:
            continue
        f = sel[0]
        gt = flat[f].to_structured()
        pred = detections_to_prophesee({k: v[[f]] for k, v in dets.items()}, [int(gt["t"][0])])[0]
        slots = batch["frame_tidx"].shape[1]
        ev = batch["ev_repr"][batch["frame_tidx"][f // slots, f % slots], f // slots]
        ev = ev.reshape(ev.shape[0], -1, cfg.model.backbone.input_channels)
        panel = viz.render_detection_frame(
            ev, gt_boxes=np.stack([gt["x"], gt["y"], gt["w"], gt["h"]], -1),
            gt_classes=gt["class_id"],
            pred_boxes=np.stack([pred["x"], pred["y"], pred["w"], pred["h"]], -1),
            pred_classes=pred["class_id"])
        want.append((str(tmp_path / "run" / "viz" / f"val_{n:04d}.png"), panel))
    assert len(want) == 2 and [p for p, _ in saved] == [p for p, _ in want]
    for (_, got), (_, ref) in zip(saved, want):
        np.testing.assert_array_equal(got, ref)
        assert (got != 114).any()  # boxes or events drawn on the grey
