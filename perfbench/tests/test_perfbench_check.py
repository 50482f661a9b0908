"""The serve check's comparison of slates (``check_serve.unmatched``): a box
narrower or lower than one pixel is matched as a one-pixel box about its
centre. Boxes a fraction of a pixel wide whose edges the program's bfloat16
moved by a fraction of a pixel are partners, where plain IoU read them as
misses; a box under a pixel moved by a pixel, a wider one moved by its
width, or a box given another class still has none; a whole run with such
boxes on both sides comes out correct with the check and not correct with
plain IoU; and the per-frame readout (``diagnose.py``) reads what the
check reads."""

import functools

import numpy as np
import pytest

from perfbench import check_serve
from perfbench.tests.test_perfbench_runs import drive


def _slate(boxes, classes=None):
    n = len(boxes)
    return {"boxes": np.asarray(boxes, np.float32), "scores": np.full(n, 0.9998, np.float32),
            "classes": np.zeros(n, np.int64) if classes is None else classes,
            "valid": np.ones(n, bool)}


def _thin_slate(rng, n=300):
    """``n`` boxes 0.1-0.5 px wide and 1.3-6 px high on a 640 x 384 frame,
    as the stand-in weights give a gen4-base slate."""
    cx, cy = rng.uniform(10, 630, n), rng.uniform(10, 374, n)
    w, h = rng.uniform(0.1, 0.5, n), rng.uniform(1.3, 6.0, n)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)


def test_thin_boxes_moved_by_rounding_are_partners():
    rng = np.random.default_rng(3)
    ref = _thin_slate(rng)
    got = ref + rng.uniform(-0.3, 0.3, (len(ref), 1)) * np.array([1, 0, 1, 0])
    plain, total = check_serve.unmatched(_slate(got), _slate(ref), min_px=0.0)
    assert plain / total > 0.11  # the accepted limit read these as misses
    miss, total = check_serve.unmatched(_slate(got), _slate(ref))
    assert abs(miss) / total < 1e-6


@pytest.mark.parametrize("fault", ["thin_moved_a_pixel", "wide_moved_its_width",
                                   "other_class"])
def test_a_wrong_box_has_no_partner(fault):
    rng = np.random.default_rng(4)
    thin = _thin_slate(rng, 100)
    ref = thin if fault.startswith("thin") else thin + np.array([-2.0, 0.0, 2.0, 0.0])
    classes = np.zeros(len(ref), np.int64)
    got = ref.copy()
    if fault == "thin_moved_a_pixel":
        got += np.array([1.0, 0.0, 1.0, 0.0])
    elif fault == "wide_moved_its_width":  # 4.1-4.5 px wide
        got += (ref[:, 2:3] - ref[:, 0:1]) * np.array([1, 0, 1, 0])
    else:
        classes = np.ones(len(ref), np.int64)
    miss, total = check_serve.unmatched(_slate(got, classes), _slate(ref))
    assert miss == pytest.approx(total)


def _thin(slate, shift):
    """Every box of ``slate`` 0.3 px wide about its centre, moved ``shift`` px."""
    boxes = slate["boxes"]
    centre = (boxes[..., 0:1] + boxes[..., 2:3]) / 2 + shift
    slate["boxes"] = boxes.clone()
    slate["boxes"][..., 0:1] = centre - 0.15
    slate["boxes"][..., 2:3] = centre + 0.15
    return slate


def test_a_run_of_thin_boxes_is_correct(tiny_bench, monkeypatch):
    """The tiny serve cell with every box 0.3 px wide on both sides and the
    program's moved 0.2 px: correct with the check, not with plain IoU."""
    from perfbench.reference import detector as R
    from sast_tpu_torch import serving

    program, reference = serving.postprocess, R.slate
    monkeypatch.setattr(serving, "postprocess", lambda *a, **k: _thin(program(*a, **k), 0.2))
    monkeypatch.setattr(R, "slate", lambda *a, **k: _thin(reference(*a, **k), 0.0))
    _, result, correct = drive(tiny_bench, "tiny.serve", seconds=2.0)
    assert correct, result["checks"]
    monkeypatch.setattr(check_serve, "unmatched",
                        functools.partial(check_serve.unmatched, min_px=0.0))
    _, result, correct = drive(tiny_bench, "tiny.serve", seconds=2.0)
    assert not correct and result["checks"]["slate_miss"] > 0.5, result["checks"]


def test_the_readout_reads_what_the_check_reads(tiny_bench):
    """``diagnose.py`` on the tiny serve cell: its frames sum to the check's
    ``slate_miss``, the program's eager step gives the captured slates, and
    the reference's NMS on the program's predictions gives its slates."""
    import torch

    from perfbench import diagnose
    from perfbench.common import Cell

    spec, bench = tiny_bench
    cell = Cell("tiny.serve", spec, bench)
    seed, cpu = 2 ** 31 + 5, torch.device("cpu")
    seen, batches = diagnose.program_seen(cell, seed, cpu)
    checks = seen.compare(cell, check_serve.R.Sizes(cell.config), seed, cpu)
    out, saved = diagnose.readout(cell, seen, seed, cpu,
                                  diagnose.ProgramFrame(cell, seed, cpu, batches))
    assert out["slate_miss"]["check"] == pytest.approx(checks["slate_miss"], abs=1e-9)
    assert abs(out["slate_miss"]["nms_on_prog"]) < 1e-6
    lanes = [lane for frame in out["frames"] for lane in frame["lanes"]]
    assert len(lanes) == 3 * cell.mix["check_lanes"] and all(x["eager_is_captured"] for x in lanes)
    assert max(x["state_gap"] for x in lanes) == pytest.approx(checks["state_gap"])
    assert {k.split(".", 1)[1] for k in saved} == {
        f"{side}.{n}" for side in ("prog", "ref") for n in ("boxes", "scores", "classes", "valid")}
