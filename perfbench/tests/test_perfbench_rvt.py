"""The RVT cell's files: the reference's parameters against the port's, the
configuration file against gen4-base's, the counts of the RVT yardstick
against hand arithmetic at gen4 shapes, and a tiny RVT cell run on the CPU
(a sound run correct, a broken one and the float8 control not)."""

import argparse
import json

import pytest
import torch

from perfbench import yardstick, yardstick_rvt
from perfbench.common import BENCH_DIR, Cell, Clock, Refused, load_json
from perfbench.reference import detector as R
from perfbench.reference import rvt
from perfbench.run import per_layer, verdict
from perfbench.tests import tiny

RVT = {"model.backbone.name": "MaxViTRNN"}
CONFIG = dict(tiny.CONFIG, name="tiny-rvt", backbone="MaxViTRNN",
              experiment=dict(tiny.CONFIG["experiment"],
                              overrides=dict(tiny.CONFIG["experiment"]["overrides"], **RVT)))
MIX = dict(tiny.SERVE, loop="serve_rvt")
READERS = ("mfu.serve.rvt", "roofline.rvt_block.serve")


@pytest.fixture(scope="module")
def rvt_bench(tiny_bench):
    """The tiny benchmark with a tiny RVT serve cell beside its cells."""
    spec_path, bench = tiny_bench
    path = spec_path.parent / "BENCHMARK.rvt.json"
    (bench / "configs" / "tiny-rvt.json").write_text(json.dumps(CONFIG))
    (bench / "traffic" / "tiny.serve.rvt.json").write_text(json.dumps(MIX))
    (bench / "limits" / "tiny-rvt.serve.json").write_text(json.dumps(
        {"compared": {k: {"limit": v} for k, v in tiny.LIMITS["serve"].items()}}))
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "tiny-rvt", "source": "test",
                            "file": "bench/configs/tiny-rvt.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-rvt.serve", "config": "tiny-rvt",
                              "traffic": "tiny.serve.rvt", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "tiny.serve" in m.get("workloads", []):
            m["workloads"].append("tiny-rvt.serve")
    for name in READERS:
        spec["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "test",
                                  "moves": "serve_frames_per_s", "workloads": ["tiny-rvt.serve"]})
    path.write_text(json.dumps(spec))
    return path, bench


def drive(rvt_bench, trace=0, seed=2 ** 31 + 77):
    spec, bench = rvt_bench
    cell = Cell("tiny-rvt.serve", spec, bench)
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=0.3, trace=trace)
    result = cell.loop().run(cell, args, Clock(), torch.device("cpu"))
    return cell, result, verdict(cell.limits, result["checks"])[0]


def test_parameters_are_the_ports():
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.models.detector import YoloXDetector

    for cfg, sizes in ((get_config("gen1", "tiny", **CONFIG["experiment"]["overrides"]), CONFIG),
                       (get_config("gen4", "base", **RVT),
                        load_json(BENCH_DIR / "configs" / "gen4-rvt-base.json"))):
        sd = YoloXDetector(cfg.model).state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == rvt.param_shapes(R.Sizes(sizes))


def test_the_configuration_holds_gen4_bases_sizes():
    """gen4-rvt-base.json: gen4-base.json's keys and values (so that the
    port is held to them), RVT's backbone, nothing cut; the port's
    configuration of it passes the loop's check, and a file that names
    another backbone is refused."""
    from perfbench.loops import serve_rvt

    base = load_json(BENCH_DIR / "configs" / "gen4-base.json")
    cfg = load_json(BENCH_DIR / "configs" / "gen4-rvt-base.json")
    same = set(base) - {"name", "source", "experiment", "assumed"}
    assert {k: cfg[k] for k in same} == {k: base[k] for k in same}
    assert (cfg["backbone"], cfg["reduced"]) == ("MaxViTRNN", [])
    assert cfg["experiment"]["overrides"] == RVT
    cell = Cell("gen4-rvt-base.serve.clustered")
    assert cell.mix == dict(load_json(BENCH_DIR / "traffic" / "rig16.clustered.json"),
                            loop="serve_rvt", about=cell.mix["about"])
    port = serve_rvt.program_config(cell)
    assert port.model.backbone.name == "MaxViTRNN"
    cell.config = dict(cell.config, backbone="SASTRNN")
    with pytest.raises(Refused, match="backbone MaxViTRNN"):
        serve_rvt.program_config(cell)


def test_frame_flops_match_hand_arithmetic():
    """31.259 GFLOP a gen4 RVT-B frame: the downsampling convolutions, the
    attention layers (two a stage, 2 T (12 C^2 + 2 hw C) each with an MLP
    of 4C), the ConvLSTM's 1x1 convolutions, and gen4-base's neck and head
    (the same modules, counted over the SAST reference)."""
    cfg = load_json(BENCH_DIR / "configs" / "gen4-rvt-base.json")
    px, dims = (15360, 3840, 960, 240), (64, 128, 256, 512)
    cin, k = (20, 64, 128, 256), (7, 3, 3, 3)
    down = sum(2 * p * c * i * kk * kk for p, c, i, kk in zip(px, dims, cin, k))
    attention = sum(2 * 2 * p * (12 * c * c + 2 * 60 * c) for p, c in zip(px, dims))
    lstm = sum(2 * p * (4 * c) * (2 * c) for p, c in zip(px, dims))
    neck_head = yardstick.model_flops(load_json(BENCH_DIR / "configs" / "gen4-base.json"))[1]
    assert attention == 12_964_331_520
    assert yardstick_rvt.frame_flops(cfg) == down + attention + lstm + neck_head == 31_259_197_440


def test_the_variants_bytes_and_operations_match_hand_arithmetic():
    """Stage 1 of the 16-lane step: 245,760 tokens of 64 channels in windows
    of 60, an MLP of 256; the tokens in and out in bf16, the four matrices
    in bf16 and 11 C + I fp32 vectors; 2 operations a multiply-add."""
    cfg = load_json(BENCH_DIR / "configs" / "gen4-rvt-base.json")
    layers = yardstick_rvt.block_layers(16, cfg)
    assert layers == [(245760, 60, 64, 256)] * 2 + [(61440, 60, 128, 512)] * 2 + [
        (15360, 60, 256, 1024)] * 2 + [(3840, 60, 512, 2048)] * 2
    n_bytes, flops = yardstick_rvt.layer_bytes_and_flops(245760, 60, 64, 256)
    assert n_bytes == 4 * 245760 * 64 + (4 * 64 * 64 + 2 * 64 * 256) * 2 + (11 * 64 + 256) * 4
    assert n_bytes == 63_016_704
    macs = 245760 * (3 * 64 * 64 + 60 * 64 + 60 * 64 + 64 * 64 + 64 * 256 + 256 * 64)
    assert flops == 2 * macs == 27_934_064_640
    least = sum(max(b / 3.35e12, f / 989.4e12)
                for b, f in (yardstick_rvt.layer_bytes_and_flops(*la) for la in layers))
    assert yardstick_rvt.block_least_seconds(16, cfg) == pytest.approx(least, rel=1e-12)
    assert all(f / 989.4e12 > b / 3.35e12
               for b, f in (yardstick_rvt.layer_bytes_and_flops(*la) for la in layers))


def test_a_sound_rvt_run_is_correct(rvt_bench):
    cell, result, correct = drive(rvt_bench, trace=1)
    assert correct, result["checks"]
    assert set(result["end_to_end"]) == {"serve_frames_per_s", "serve_latency_p95_ms"}
    metrics = per_layer(cell, result["readings"])
    assert metrics["mfu.serve.rvt"]["value"] > 0
    assert "roofline.rvt_block.serve" not in metrics  # no kernel runs on the CPU


def test_a_broken_rvt_run_is_not_correct(rvt_bench, monkeypatch):
    from sast_tpu_torch.models import layers

    def forward(self, x, h_and_c=None, deterministic=True, dropout=None):
        if h_and_c is None:
            return torch.zeros_like(x), torch.zeros(x.shape, device=x.device)
        return h_and_c[0].to(x.dtype), h_and_c[1]

    monkeypatch.setattr(layers.DWSConvLSTM2d, "forward", forward)
    _, result, correct = drive(rvt_bench)
    assert not correct, result["checks"]


def test_the_rvt_control_is_not_correct(rvt_bench):
    """The RVT reference in float8 in the program's place fails the check;
    in float32 it passes."""
    from perfbench import check_serve_rvt

    spec, bench = rvt_bench
    cell = Cell("tiny-rvt.serve", spec, bench)
    fp8 = check_serve_rvt.control(cell, 5, "fp8", torch.device("cpu"))
    assert not verdict(cell.limits, fp8)[0], fp8
    fp32 = check_serve_rvt.control(cell, 5, "fp32", torch.device("cpu"))
    assert verdict(cell.limits, fp32)[0], fp32


def test_the_rvt_check_is_check_serves_code_on_the_rvt_reference():
    """``check_serve_rvt`` runs ``check_serve.py``'s and ``control.py``'s own
    code with RVT's parameters and frame; the SAST modules keep the SAST
    reference."""
    from perfbench import check_serve, check_serve_rvt, control

    assert check_serve.R is R and control.R is R and control.check_serve is check_serve
    for got, want in ((check_serve_rvt.Seen.compare, check_serve.Seen.compare),
                      (check_serve_rvt.unmatched, check_serve.unmatched),
                      (check_serve_rvt.control, control.serve_control)):
        assert got is not want and got.__code__.co_filename == want.__code__.co_filename
    reference = check_serve_rvt.Seen.compare.__globals__["R"]
    assert reference.serve_frame is rvt.serve_frame and reference.param_shapes is rvt.param_shapes
    assert reference.zero_state is R.zero_state
    assert check_serve_rvt.control.__globals__["check_serve"].Seen is check_serve_rvt.Seen

