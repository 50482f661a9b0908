"""The reference against the port's plain path on the CPU at the tiny size,
in float32 (the test may import both; the reference imports nothing of the
port): one serving frame, slate and carried state, and three training steps."""

import numpy as np
import pytest
import torch

from perfbench import check_serve, check_train
from perfbench.common import Cell
from perfbench.program import program_config, program_model
from perfbench.reference import detector as R
from perfbench.reference import training as RT
from perfbench.tests import tiny
from perfbench.weights import make_weights


@pytest.fixture
def cell(tiny_bench):
    spec, bench = tiny_bench
    return Cell("tiny.serve", spec, bench)


def test_parameters_are_the_ports(cell):
    from sast_tpu_torch.models.detector import YoloXDetector

    sd = YoloXDetector(program_config(cell).model).state_dict()
    shapes = R.param_shapes(R.Sizes(tiny.CONFIG))
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes


@pytest.mark.parametrize("seed", (3, 2 ** 31 + 3))
def test_serving_frame_matches_the_port(cell, seed):
    from sast_tpu_torch.models.backbone import zero_states
    from sast_tpu_torch.serving import StreamingStep

    sz = R.Sizes(tiny.CONFIG)
    cfg = program_config(cell)
    P = make_weights(R.param_shapes(sz), seed, "cpu")
    step = StreamingStep(cfg, program_model(cfg, P, "cpu"), 10, 10, torch.device("cpu"))
    pool = cell.generator().serve_pool(tiny.SERVE, sz.sensor_hw, seed, "cpu")
    packed, n = check_serve.pack([lane[0] for lane in pool], tiny.SERVE["max_events"], "cpu")
    states = zero_states(cfg.model.backbone, 4)
    with torch.no_grad():
        dets, new, _ = step(states, packed, n, torch.zeros(4, dtype=torch.bool))
        ref, ref_state, _ = R.serve_frame(P, sz, packed, n, R.zero_state(sz, 4, "cpu"))
        dets2, _, _ = step(new, packed, n, torch.zeros(4, dtype=torch.bool))
        ref2, _, _ = R.serve_frame(P, sz, packed, n, ref_state)
    for (h, c), (hr, cr) in zip(new, ref_state):
        torch.testing.assert_close(h, hr, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(c, cr, rtol=1e-4, atol=1e-5)
    for got, want in ((dets, ref), (dets2, ref2)):
        assert torch.equal(got["valid"], want["valid"]) and got["valid"].any()
        torch.testing.assert_close(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got["scores"], want["scores"], rtol=1e-4, atol=1e-6)


def test_training_steps_match_the_port(tiny_bench):
    from sast_tpu_torch.training.steps import create_train_state, make_train_step

    spec, bench = tiny_bench
    tcell = Cell("tiny.train", spec, bench)
    sz = R.Sizes(tiny.CONFIG)
    cfg = program_config(tcell)
    pool = tcell.generator().train_pool(tiny.TRAIN, sz, 9, "cpu")
    batches = [pool[j % len(pool)] for j in range(3)]
    state, model = create_train_state(cfg, device="cpu")
    with torch.no_grad():
        model.load_state_dict(make_weights(R.param_shapes(sz), 9, "cpu", head_gain={}))
    step = make_train_step(model, cfg)
    lstm = [tuple(torch.zeros_like(t) for t in hc) for hc in R.zero_state(sz, 2, "cpu")]
    losses, objs = [], []
    for b in batches:
        _, lstm, metrics = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
                                lstm)
        losses.append(float(metrics["loss"]))
        gts = max(int((b["gt_valid"] & b["frame_valid"][..., None]).sum()), 1)
        objs.append(float(metrics["conf_loss"]) * max(round(float(metrics["num_fg"]) * gts), 1))
    ref_losses, obj_sums, _, start, after = check_train.reference_run(tcell, sz, 9, "cpu",
                                                                      batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(objs, obj_sums, rtol=1e-4)
    # Adam's first updates are +-lr wherever a gradient is above eps, so an
    # element whose gradient sits at rounding level may move either way:
    # compare each leaf's change by its norm, as the check does.
    prog = {n: p.detach() - start[n] for n, p in model.named_parameters()}
    assert max(check_train.leaf_gaps(prog, {n: after[n] - start[n] for n in prog}).values()) < 0.05
    assert RT.one_cycle(0, 3.46e-4, 600000, 0.005, 20.0, 1e4) == pytest.approx(1.73e-5)
