"""The yardstick's counts: kernel A's bytes and operations, and the model's
FLOPs over the reference against ``FlopCounterMode`` over the port."""

import pytest
import torch

from perfbench import yardstick
from perfbench.tests import tiny


def test_kernel_a_bytes_and_operations():
    cfg = dict(tiny.CONFIG)  # model 64 x 96, 20 channels, 32 output channels
    n_bytes, flops = yardstick.stem_bytes_and_flops(2, cfg)
    x = 2 * 64 * 96 * 20
    w = 32 * 20 * 49 * 2
    y = 2 * 16 * 24 * 32 * 2
    counts = 2 * 4 * 20 * 4
    assert n_bytes == x + w + y + counts
    assert flops == 2 * (2 * 16 * 24) * 32 * 20 * 49
    least = yardstick.least_seconds(n_bytes, flops)
    assert least == max(n_bytes / 3.35e12, flops / 989.4e12)


def test_gen4_base_frame_flops():
    """31.448 GFLOP a frame at gen4-base, the count of the port's own benchmark library."""
    from perfbench.common import BENCH_DIR, load_json

    cfg = load_json(BENCH_DIR / "configs" / "gen4-base.json")
    assert yardstick.frame_flops(cfg) == 31_447_979_520
    assert yardstick.sequence_flops(cfg, 5, 3) == 5 * 20_805_096_960 + 3 * 10_642_882_560


def test_reference_flops_equal_the_ports_count():
    """At the tiny size the reference's count on the meta device equals
    ``FlopCounterMode`` over the port's forward (its kernels' operators
    count as their plain versions)."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.program import program_config
    from sast_tpu_torch.models.backbone import zero_states
    from sast_tpu_torch.models.detector import YoloXDetector

    class Cell:
        config = tiny.CONFIG
        entry = {"config": "tiny"}

    cfg = program_config(Cell)
    model = YoloXDetector(cfg.model).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    x = torch.zeros((1, 64, 96, 20), dtype=torch.uint8)
    states = zero_states(cfg.model.backbone, 1)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, states)
    assert counter.get_total_flops() == yardstick.frame_flops(tiny.CONFIG)


def test_the_cells_readers():
    """The readers of ``BENCHMARK.json``'s per-layer metrics: a value from
    what a traced run reads, nothing where there is nothing to read."""
    from perfbench.common import Cell

    cell = Cell("gen4-base.serve.clustered")
    trace = {"window_s": 1.2, "busy_s": 0.84, "calls": 40,
             "kernels": {"stem_conv_mma_kernel": (0.008, 40), "elementwise": (0.5, 900)}}
    readings = {"frames_per_s": 500.0, "lanes": 16, "trace": trace}
    got = {m["name"]: cell.reader(m["name"]).read(readings, cell) for m in cell.per_layer()}
    assert got["device_idle_share.serve"] == pytest.approx(30.0)
    assert got["step_card_ms.serve"] == pytest.approx(21.0)
    assert got["mfu.serve"] == pytest.approx(100 * 31_447_979_520 * 500 / 989.4e12)
    least = yardstick.least_seconds(*yardstick.stem_bytes_and_flops(16, cell.config))
    assert got["roofline.stem_conv.serve"] == pytest.approx(100 * least / (0.008 / 40))
    empty = {"frames_per_s": None, "lanes": 16, "trace": {}}
    assert all(cell.reader(m["name"]).read(empty, cell) is None for m in cell.per_layer())
