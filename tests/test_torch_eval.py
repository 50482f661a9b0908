"""Port vs JAX package: COCO AP and the Prophesee evaluator (numpy on both
sides) on the same seeded labels and predictions. The metrics must agree to
1e-12."""

import numpy as np
import pytest

from sast_tpu.eval import coco as j_coco
from sast_tpu.eval import prophesee as j_psee
from sast_tpu_torch.eval import coco, prophesee

TOL = 1e-12


def _images(seed, n_img=12, n_cls=3, empty=(3, 7)):
    """Per-image GT and detection dicts for ``evaluate_coco_ap``: boxes of
    every COCO area range, detections near the GT plus false positives,
    some images with no GT or no detection."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for i in range(n_img):
        g = 0 if i in empty else rng.randint(1, 8)
        wh = np.exp(rng.uniform(np.log(8), np.log(160), (g, 2)))
        xy = rng.uniform(0, 400, (g, 2))
        gb = np.concatenate([xy, wh], 1)
        gc = rng.randint(0, n_cls, g)
        keep = rng.rand(g) < 0.8
        db = gb[keep] + rng.normal(0, 3, (int(keep.sum()), 4))
        dc = gc[keep].copy()
        flip = rng.rand(len(dc)) < 0.1
        dc[flip] = rng.randint(0, n_cls, int(flip.sum()))
        f = rng.randint(0, 4) if i != 7 else 0
        fb = np.concatenate([rng.uniform(0, 400, (f, 2)), rng.uniform(8, 120, (f, 2))], 1)
        db = np.concatenate([db, fb]) if f else db
        dc = np.concatenate([dc, rng.randint(0, n_cls, f)])
        if i == 5:
            db, dc = db[:0], dc[:0]
        scores = rng.rand(len(dc))
        gts.append({"boxes": gb.astype(np.float64).reshape(-1, 4), "classes": gc.astype(np.int64)})
        dts.append({"boxes": db.astype(np.float64).reshape(-1, 4), "classes": dc.astype(np.int64),
                    "scores": scores})
    return gts, dts


def _assert_metrics_equal(got, ref):
    assert got is not None and ref is not None
    assert set(got) == set(ref) == {"AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= TOL, (k, got[k], ref[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_coco_ap_matches_jax(seed):
    gts, dts = _images(seed)
    got = coco.evaluate_coco_ap(gts, dts, num_classes=3)
    ref = j_coco.evaluate_coco_ap(gts, dts, num_classes=3)
    _assert_metrics_equal(got, ref)
    assert 0 < ref["AP"] < 1


def _structured(dtype, rows, t):
    out = np.zeros((len(rows),), dtype)
    if len(rows):
        out["t"] = t
        out["x"], out["y"], out["w"], out["h"] = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
        out["class_id"] = rows[:, 4].astype(np.uint32)
        out["class_confidence"] = rows[:, 5]
    return out


def _frames(dtype, seed, n_cls, scale, n=10):
    """Label and prediction frames as the trainer buffers them: one
    timestamp per frame (some before the 0.5 s skip), boxes around the
    filters' size limits, frame 4 with no label and no prediction."""
    rng = np.random.RandomState(seed)
    labels, preds = [], []
    for f in range(n):
        t = 250_000 + f * 50_000
        g = 0 if f == 4 else rng.randint(1, 6)
        wh = rng.uniform(5, 90, (g, 2)) * scale
        rows = np.concatenate([rng.uniform(0, 300, (g, 2)), wh, rng.randint(0, n_cls, (g, 1)),
                               np.ones((g, 1))], 1)
        p = rows[rng.rand(g) < 0.7].copy()
        p[:, :4] += rng.normal(0, 2, (len(p), 4))
        extra = rng.randint(0, 3) if f != 4 else 0
        fp = np.concatenate([rng.uniform(0, 300, (extra, 2)), rng.uniform(5, 90, (extra, 2)) * scale,
                             rng.randint(0, n_cls, (extra, 1)), np.zeros((extra, 1))], 1)
        p = np.concatenate([p, fp])
        p[:, 5] = rng.rand(len(p))
        labels.append(_structured(dtype, rows, t))
        preds.append(_structured(dtype, p, t))
    return labels, preds


@pytest.mark.parametrize("downsample", [False, True], ids=["full", "ds2"])
@pytest.mark.parametrize("dataset", ["gen1", "gen4"])
def test_prophesee_evaluator_matches_jax(dataset, downsample):
    """``PropheseeEvaluator.evaluate_buffer``: the box filters of each
    dataset with and without the downsampling, the time windows, an empty
    frame; labels and predictions buffered in two calls each."""
    assert prophesee.BBOX_DTYPE == j_psee.BBOX_DTYPE
    n_cls = 2 if dataset == "gen1" else 3
    labels, preds = _frames(prophesee.BBOX_DTYPE, 11, n_cls, 1.0 if dataset == "gen1" else 1.6)
    got_ev = prophesee.PropheseeEvaluator(dataset, downsample)
    ref_ev = j_psee.PropheseeEvaluator(dataset, downsample)
    assert not got_ev.has_data() and got_ev.evaluate_buffer(1, 1) is None
    for ev in (got_ev, ref_ev):
        ev.add_labels(labels[:6])
        ev.add_predictions(preds[:6])
        ev.add_labels(labels[6:])
        ev.add_predictions(preds[6:])
    got, ref = got_ev.evaluate_buffer(360, 640), ref_ev.evaluate_buffer(360, 640)
    _assert_metrics_equal(got, ref)
    assert ref["AP"] > 0
    got_ev.reset_buffer()
    assert not got_ev.has_data()


def test_detections_to_prophesee_matches_jax():
    """Fixed-budget detections to structured arrays, frame by frame (the
    second frame has no valid detection)."""
    rng = np.random.RandomState(4)
    F, K = 3, 6
    x0 = rng.uniform(0, 200, (F, K, 2)).astype(np.float32)
    dets = {"boxes": np.concatenate([x0, x0 + rng.uniform(5, 50, (F, K, 2))], -1).astype(np.float32),
            "classes": rng.randint(0, 3, (F, K)).astype(np.int32),
            "cls_conf": rng.rand(F, K).astype(np.float32),
            "valid": rng.rand(F, K) < 0.6}
    dets["valid"][1] = False
    times = [600_000, 650_000, 700_000]
    got = prophesee.detections_to_prophesee(dets, times)
    ref = j_psee.detections_to_prophesee(dets, times)
    assert len(got) == len(ref) == F and len(got[1]) == 0
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_gather_across_processes():
    """With an allgather function the buffers of all ranks are merged in
    rank order; without one a single process keeps its own."""
    labels, preds = _frames(prophesee.BBOX_DTYPE, 3, 2, 1.0, n=4)
    ev = prophesee.PropheseeEvaluator("gen1")
    ev.add_labels(labels[:2])
    ev.add_predictions(preds[:2])
    other = {"lab": labels[2:], "pred": preds[2:]}
    ev.gather_across_processes(lambda buf: [buf, other])
    whole = prophesee.PropheseeEvaluator("gen1")
    whole.add_labels(labels)
    whole.add_predictions(preds)
    assert ev.evaluate_buffer(1, 1) == whole.evaluate_buffer(1, 1)
    ev.gather_across_processes()
    assert len(ev._buffer["lab"]) == 4
