"""A whole run of a cell, less the look for a card, on the CPU at the tiny
size: the cell's configuration, mixes, limits and a metric reader are new
files in a folder of their own, found by name with no edit to any file of
the benchmark; a sound run comes out correct, and the timed path broken
underneath comes out not correct, once for each fault the cell can have."""

import argparse

import numpy as np
import pytest
import torch

from perfbench.common import Cell, Clock
from perfbench.run import per_layer, verdict


def drive(spec_and_bench, name, trace=0, seed=2 ** 31 + 77, seconds=0.3):
    spec, bench = spec_and_bench
    cell = Cell(name, spec, bench)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    result = cell.loop().run(cell, args, Clock(), torch.device("cpu"))
    correct, rows = verdict(cell.limits, result["checks"])
    return cell, result, correct


def test_new_files_are_found_by_name(tiny_bench):
    cell, result, correct = drive(tiny_bench, "tiny.serve", trace=1)
    assert correct, result["checks"]
    assert set(result["end_to_end"]) == {"serve_frames_per_s", "serve_latency_p95_ms"}
    assert per_layer(cell, result["readings"]) == {
        "traced_calls": {"value": 2, "unit": "calls"}}
    assert result["attempted"] == 4 * result["readings"]["calls"] and result["failed"] == 0


def test_sound_training_is_correct(tiny_bench):
    _, result, correct = drive(tiny_bench, "tiny.train")
    assert correct, result["checks"]
    assert result["end_to_end"]["train_seqs_per_s"] > 0


def _state_unchanged(monkeypatch):
    from sast_tpu_torch.models import layers

    def forward(self, x, h_and_c=None, deterministic=True, dropout=None):
        if h_and_c is None:
            return torch.zeros_like(x), torch.zeros(x.shape, device=x.device)
        return h_and_c[0].to(x.dtype), h_and_c[1]

    monkeypatch.setattr(layers.DWSConvLSTM2d, "forward", forward)


def _answer_altered(monkeypatch):
    from sast_tpu_torch import serving

    plain = serving.postprocess

    def altered(*args, **kwargs):
        out = plain(*args, **kwargs)
        boxes = out["boxes"]
        out["boxes"] = boxes + (boxes[..., 2:3] - boxes[..., 0:1])  # one box width right
        return out

    monkeypatch.setattr(serving, "postprocess", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered])
def test_broken_serving_is_not_correct(tiny_bench, monkeypatch, fault):
    fault(monkeypatch)
    _, result, correct = drive(tiny_bench, "tiny.serve")
    assert not correct, result["checks"]


def _update_skipped(monkeypatch):
    from sast_tpu_torch.training import optimizer

    def update(self):
        mu, _ = self.adamw.moments()
        torch._foreach_add_(mu, torch._foreach_mul([p.grad for p in self.params], 0.1))
        self.adamw.count.add_(1.0)

    monkeypatch.setattr(optimizer.OptaxAdamW, "update", update)


def _half_batch(monkeypatch):
    from sast_tpu_torch.training import steps

    plain = steps.yolox_loss

    def half(*args, frame_valid, **kwargs):
        keep = torch.arange(frame_valid.shape[0]) < frame_valid.shape[0] // 2
        return plain(*args, frame_valid=frame_valid & keep, **kwargs)

    monkeypatch.setattr(steps, "yolox_loss", half)


@pytest.mark.parametrize("fault", [_update_skipped, _half_batch])
def test_broken_training_is_not_correct(tiny_bench, monkeypatch, fault):
    fault(monkeypatch)
    _, result, correct = drive(tiny_bench, "tiny.train")
    assert not correct, result["checks"]


@pytest.mark.parametrize("name", ["tiny.serve", "tiny.train"])
def test_the_control_is_not_correct(tiny_bench, name):
    """The reference in float8 in the program's place fails the check."""
    from perfbench import control

    spec, bench = tiny_bench
    cell = Cell(name, spec, bench)
    run = control.train_control if name.endswith("train") else control.serve_control
    readings = run(cell, 5, "fp8", torch.device("cpu"))
    correct, _ = verdict(cell.limits, readings)
    assert not correct, readings
    fp32 = run(cell, 5, "fp32", torch.device("cpu"))
    assert verdict(cell.limits, fp32)[0], fp32
    assert np.isfinite(list(readings.values())).all()
