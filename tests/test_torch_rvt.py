"""RVT-B (``MaxViTRNN``) in the port against the benchmark's plain RVT
reference (``perfbench/reference/rvt.py``), on the CPU at a tiny size in
float32 with the benchmark's seeded stand-in weights; the port's entry
points (``StreamingDetector``, the exported artifact, ``Trainer.fit``) on
it; the RVT variant of kernel D's operator on its plain version; SAST's
configurations as they were; and, marked ``cuda``, the variant on the card
at the gen4-base stage shapes. This file imports neither JAX nor the JAX
package, so on a machine with a card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rvt.py -m cuda
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.reference import detector as R  # noqa: E402
from perfbench.reference import rvt  # noqa: E402
from perfbench.reference.precision import fp8_e4m3  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402
from sast_tpu_torch import export  # noqa: E402
from sast_tpu_torch.config import get_config, get_test_config  # noqa: E402
from sast_tpu_torch.models.backbone import zero_states  # noqa: E402
from sast_tpu_torch.models.detector import YoloXDetector  # noqa: E402
from sast_tpu_torch.models.layers import Dense  # noqa: E402
from sast_tpu_torch.models.maxvit import PartitionAttention  # noqa: E402
from sast_tpu_torch.ops import fused_block  # noqa: E402
from sast_tpu_torch.ops.partition import (  # noqa: E402
    grid_partition, grid_reverse, window_partition, window_reverse)
from sast_tpu_torch.serving import StreamingDetector, StreamingStep  # noqa: E402

RVT = {"model.backbone.name": "MaxViTRNN"}
TINY = dict(RVT, **{"dataset.resolution_hw_override": (60, 90), "model.compute_dtype": "float32",
                    "model.postprocess.pre_nms_topk": 64, "model.postprocess.max_detections": 16})
EVENTS = 3000
SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny():
    return get_config("gen1", "tiny", **TINY)


def _sizes(cfg) -> R.Sizes:
    """The reference's sizes of a port configuration."""
    bb, m = cfg.model.backbone, cfg.model
    return R.Sizes(dict(
        sensor_hw=list(cfg.dataset.resolution_hw), model_hw=list(bb.in_res_hw),
        input_channels=bb.input_channels, embed_dim=bb.embed_dim,
        dim_multiplier=list(bb.dim_multiplier), dim_head=bb.attention.dim_head,
        mlp_ratio=bb.attention.mlp_ratio, partition_size=list(bb.attention.partition_size),
        num_classes=m.head.num_classes, fpn_depth=m.fpn.depth, count_cutoff=10,
        confidence_threshold=m.postprocess.confidence_threshold,
        nms_threshold=m.postprocess.nms_threshold, pre_nms_topk=m.postprocess.pre_nms_topk,
        max_detections=m.postprocess.max_detections))


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny()
    sz = _sizes(cfg)
    P = make_weights(rvt.param_shapes(sz), SEED, "cpu")
    model = YoloXDetector(cfg.model)
    model.load_state_dict(P, strict=True)
    return cfg, sz, P, model.eval()


def _histograms(sz, frames, lanes, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.poisson(0.4, (frames, lanes, *sz.model_hw, sz.in_ch)).clip(0, 255)
    return torch.from_numpy(x.astype(np.uint8))


def _frames(rng, lanes, sz):
    out = []
    for _ in range(lanes):
        n = rng.randint(500, EVENTS)
        out.append(dict(x=rng.randint(0, sz.sensor_hw[1], n), y=rng.randint(0, sz.sensor_hw[0], n),
                        p=rng.randint(0, 2, n), t=np.sort(rng.randint(0, 50_000, n))))
    return out


def test_rvt_is_chosen_by_the_configuration():
    """The backbone's name alone builds RVT-B at gen4-base's published
    widths: MaxViT layers with an ungated 4C MLP, about 18.5 M parameters;
    SAST's layers keep their gated MLP."""
    cfg = get_config("gen4", "base", **RVT)
    bb = cfg.model.backbone
    assert (bb.name, bb.stage_dims) == ("MaxViTRNN", (64, 128, 256, 512))
    model = YoloXDetector(cfg.model)
    layer = model.backbone.stage3.block0.grid_attn
    assert isinstance(layer, PartitionAttention) and layer.num_heads == 16
    assert tuple(layer.mlp.Dense_0.kernel.shape) == (2048, 512)
    assert sum(p.numel() for p in model.parameters()) == 18_538_776
    sast = YoloXDetector(get_config("gen4", "base").model).backbone
    assert not isinstance(sast, type(model.backbone))
    with pytest.raises(ValueError, match="unknown backbone"):
        YoloXDetector(get_config("gen4", "base", **{"model.backbone.name": "RVT"}).model)
    for unused in ({"model.backbone.attention.drop_path": 0.1},
                   {"model.backbone.attention.enable_cb": True},
                   {"model.backbone.attention.mlp_activation": "relu"},
                   {"model.backbone.enable_masking": True}):
        with pytest.raises(ValueError, match="MaxViTRNN"):
            YoloXDetector(get_config("gen4", "base", **RVT, **unused).model)


# The digest of every module (path, class) and state-dict entry (name,
# shape, dtype) of each SAST configuration, as the port built them before
# RVT was added.
SAST_DIGESTS = {("gen1", "tiny"): "447ccc39eef3be95", ("gen1", "small"): "441e4f93ace005ba",
                ("gen1", "base"): "bc65ed48a8a1ac07", ("gen1", "large"): "0f6ac76dd094662f",
                ("gen4", "tiny"): "804a9768d005d53c", ("gen4", "small"): "a88c4d4b49b7a416",
                ("gen4", "base"): "9f9d9f9246c97f2d", ("gen4", "large"): "25787f2524a876a6",
                ("test", ""): "447ccc39eef3be95"}


@pytest.mark.parametrize("dataset,size", sorted(SAST_DIGESTS))
def test_sast_configurations_build_what_they_built(dataset, size):
    cfg = get_test_config() if dataset == "test" else get_config(dataset, size)
    model = YoloXDetector(cfg.model)
    lines = [f"{n} {type(m).__name__}" for n, m in model.named_modules()]
    lines += [f"{k} {tuple(v.shape)} {v.dtype}" for k, v in model.state_dict().items()]
    digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]
    assert digest == SAST_DIGESTS[(dataset, size)]


def test_parameters_are_the_references(tiny):
    cfg, sz, _, model = tiny
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == rvt.param_shapes(sz)


def test_stages_and_lstm_states_match_the_reference_over_three_frames(tiny):
    """Every stage's features and LSTM (h, c) over 3 frames, lane 1 reset at
    the third (fp32, another summation order: 1e-4 relative, 1e-5
    absolute), and every token slot reported as attended."""
    cfg, sz, P, model = tiny
    xs = _histograms(sz, 3, 2)
    states, ref = zero_states(cfg.model.backbone, 2), R.zero_state(sz, 2, "cpu")
    with torch.no_grad():
        for f in range(3):
            if f == 2:
                keep = torch.tensor([True, False]).view(-1, 1, 1, 1)
                states = [tuple(torch.where(keep, t, 0.0) for t in hc) for hc in states]
                ref = [tuple(torch.where(keep, t, 0.0) for t in hc) for hc in ref]
            feats, states, slots = model.forward_backbone(xs[f], states)
            ref_feats, ref = rvt.backbone(P, sz, xs[f], ref, R.identity)
            for s in range(4):
                torch.testing.assert_close(feats[s + 1], ref_feats[s + 1], rtol=1e-4, atol=1e-5)
                for got, want in zip(states[s], ref[s]):
                    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
            assert slots.tolist() == [2.0 * h * w for h, w in map(sz.stage_hw, range(4))]


def test_slates_match_the_reference(tiny):
    """Two frames through the serving step from raw events, the state
    carried: the same detections (fp32: boxes 1e-3 px, scores 1e-6)."""
    cfg, sz, P, model = tiny
    step = StreamingStep(cfg, model, 10, 10, torch.device("cpu"))
    rng = np.random.RandomState(3)
    from perfbench.check_serve import pack

    states, ref_state = zero_states(cfg.model.backbone, 4), R.zero_state(sz, 4, "cpu")
    no_reset = torch.zeros(4, dtype=torch.bool)
    with torch.no_grad():
        for _ in range(2):
            packed, n = pack(_frames(rng, 4, sz), EVENTS, "cpu")
            dets, states, _ = step(states, packed, n, no_reset)
            ref, ref_state, _ = rvt.serve_frame(P, sz, packed, n, ref_state)
            assert torch.equal(dets["valid"], ref["valid"]) and dets["valid"].any()
            torch.testing.assert_close(dets["boxes"], ref["boxes"], rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(dets["scores"], ref["scores"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("which", ["win_attn", "grid_attn"])
def test_the_block_alone_matches_the_reference(tiny, which):
    """One layer of stage 2 on a (2, 8, 12, 64) map, window or grid
    partition: the port's torch ops, the variant's plain version and its
    operator on the CPU against the reference (fp32: 1e-5)."""
    cfg, sz, P, model = tiny
    layer = getattr(model.backbone.stage1.block0, which)
    p = tuple(cfg.model.backbone.attention.partition_size)
    part, back = ((window_partition, window_reverse) if which == "win_attn"
                  else (grid_partition, grid_reverse))
    x = torch.randn(2, 8, 12, 64, generator=torch.Generator().manual_seed(1))
    t = part(x, p)
    want = back(rvt.attention_layer(P, f"backbone.stage1.block0.{which}", t, 2, R.identity),
                p, (8, 12))
    with torch.no_grad():
        params = fused_block.rvt_params(layer)
        M = t.shape[0] * t.shape[1]
        flat = t.reshape(M, *t.shape[2:])
        for got in (layer(t), layer.block_math(t),
                    fused_block.rvt_block_plain(flat, params, 2, 32).reshape(t.shape),
                    fused_block.rvt_window_block(flat, params, 2, 32).reshape(t.shape)):
            torch.testing.assert_close(back(got, p, (8, 12)), want, rtol=1e-5, atol=1e-5)


def test_under_grad_the_layer_runs_torch_ops_and_the_operator_refuses(tiny):
    """The operator has no backward: a token tensor that takes a gradient is
    refused, and under grad the layer differentiates through its torch ops,
    the gradients of autograd through the variant's plain version."""
    _, _, _, model = tiny
    layer = model.backbone.stage0.block0.win_attn
    x = torch.randn(1, 5, 6, 32, generator=torch.Generator().manual_seed(2), requires_grad=True)
    g = torch.randn(1, 5, 6, 32, generator=torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="no backward"):
        fused_block.rvt_window_block(x[0], fused_block.rvt_params(layer), 1, 32)
    leaves = [p for p in layer.parameters()]
    got = torch.autograd.grad(layer(x), (x, *leaves), g)
    params = dict(fused_block.rvt_params(layer))
    live = {"ln1_scale": layer.norm1.scale, "ln1_bias": layer.norm1.bias,
            "wqkv": layer.qkv.kernel, "bqkv": layer.qkv.bias, "wproj": layer.proj.kernel,
            "bproj": layer.proj.bias, "ls1": layer.ls1.gamma, "ln2_scale": layer.norm2.scale,
            "ln2_bias": layer.norm2.bias, "w1": layer.mlp.Dense_0.kernel,
            "b1": layer.mlp.Dense_0.bias, "w2": layer.mlp.Dense_1.kernel,
            "b2": layer.mlp.Dense_1.bias, "ls2": layer.ls2.gamma}
    assert set(live) == set(params) == set(fused_block.RVT_KEYS)
    want = torch.autograd.grad(fused_block.rvt_block_plain(x[0], live, 1, 32), (x, *leaves),
                               g[0])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_the_operator_exports_and_passes_opcheck(tiny):
    """``rvt_block_fwd`` stands in an exported graph by its shape and runs
    its plain version there; ``torch.library.opcheck`` passes."""
    _, _, _, model = tiny
    layer = model.backbone.stage1.block0.grid_attn
    params = fused_block.rvt_params(layer)
    x = torch.randn(6, 6, 64, generator=torch.Generator().manual_seed(4))

    class Layer(torch.nn.Module):
        def forward(self, x):
            return fused_block.rvt_window_block(x, params, 2, 32)

    with torch.no_grad():
        program = torch.export.export(Layer(), (x,))
        targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
        assert "sast_tpu_torch.rvt_block_fwd.default" in targets, sorted(targets)
        torch.testing.assert_close(program.module()(x), Layer()(x), rtol=0, atol=0)
    torch.library.opcheck(torch.ops.sast_tpu_torch.rvt_block_fwd,
                          (x, [params[k] for k in fused_block.RVT_KEYS], 2, 32, 1e-5))


def test_the_exported_artifact_serves_the_live_detectors_slates(tiny):
    """An RVT detector exports; its loaded artifact gives the live
    detector's slates, selected-token telemetry and carried state bit for
    bit over three frames, lane 1 reset at the third."""
    cfg, sz, P, _ = tiny

    def detector():
        model = YoloXDetector(cfg.model)
        model.load_state_dict(P, strict=True)
        return StreamingDetector(cfg, model, max_events=EVENTS, num_streams=2, device="cpu")

    rng = np.random.RandomState(5)
    frames = [_frames(rng, 2, sz) for _ in range(3)]
    resets = [np.array([False, i == 2]) for i in range(3)]

    def run(det):
        outs = [det.process_batch(frames[i], reset=resets[i]) for i in range(3)]
        return outs, [t.clone() for hc in det.states for t in hc]

    live_outs, live_states = run(detector())
    art = export.ExportedStreamingDetector(export.export_streaming_detector(detector()))
    outs, states = run(art)
    for a, b in zip(outs, live_outs):
        assert set(a) == set(b) and b["valid"].any()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    slots = [2 * h * w for h, w in map(sz.stage_hw, range(4))]
    np.testing.assert_array_equal(live_outs[0]["selected_tokens"], slots)
    for a, b in zip(states, live_states):
        assert torch.equal(a, b)


def test_serve_spans_and_counters_record_for_the_rvt_detector(tiny):
    """RVT adds no host work: ``process_batch`` of an RVT detector records
    ``serve.pack``, ``serve.launch`` and ``serve.wait`` once a call and
    counts its events and uploaded bytes, as for SAST
    (tests/test_torch_spans.py)."""
    from sast_tpu_torch.utils import timers

    cfg, sz, P, _ = tiny
    model = YoloXDetector(cfg.model)
    model.load_state_dict(P, strict=True)
    det = StreamingDetector(cfg, model, max_events=EVENTS, num_streams=2, device="cpu")
    rng = np.random.RandomState(6)
    frames = [_frames(rng, 2, sz) for _ in range(2)]
    timers.reset()
    timers.set_spans(True)
    try:
        for f in frames:
            det.process_batch(f)
        stats = timers.timer_stats()
    finally:
        timers.set_spans(False)
        timers.reset()
    for name in ("serve.batch", "serve.pack", "serve.launch", "serve.wait"):
        assert stats[name]["count"] == 2, name
    events = sum(d["x"].size for f in frames for d in f)
    assert stats["serve.events"]["total"] == events
    assert stats["serve.upload_bytes"]["total"] == 16 * events + 2 * 2 * (4 + 4 + 1)


def test_trainer_fit_trains_every_rvt_parameter(tmp_path):
    """One ``Trainer.fit`` step on the tiny RVT configuration (CPU, torch
    ops): a finite loss, and a finite non-zero gradient on every
    parameter."""
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.training.loop import Trainer

    cfg = get_config("gen1", "tiny", **RVT, **{
        "dataset.resolution_hw_override": (60, 90), "model.compute_dtype": "float32",
        "model.backbone.attention.ls_init_value": 0.3, "training.batch_size_train": 2,
        "training.max_labeled_frames_per_lane": 2, "dataset.sequence_length": 2,
        "model.head.max_gt": 8})
    trainer = Trainer(cfg, str(tmp_path / "run"), log_every=1, device="cpu")
    metrics = trainer.fit([synthetic_train_batch(cfg, np.random.RandomState(0))], max_steps=1)
    assert trainer.state.step == 1 and np.isfinite(metrics["train/loss"])
    names = [n for n, _ in trainer.model.named_parameters()]
    assert any(".block0.win_attn.mlp.Dense_1." in n for n in names)
    for name, p in trainer.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name


# ---------------------------------------------------------------------------
# On the card.

GEN4_STAGES = [(4096, 64), (1024, 128), (256, 256), (64, 512)]  # 16 lanes: windows, C


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _update_gap(got, want, x):
    """||(got - x) - (want - x)|| / ||want - x||: the layer's update, which
    a LayerScale keeps small beside x, compared relative to its size."""
    d = (want.float() - x.float())
    return float(((got.float() - x.float()) - d).norm() / d.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("windows,C", GEN4_STAGES)
def test_the_variant_on_the_card_at_gen4_stage_shapes(dev, windows, C):
    """The variant's launches on the card (bf16 tokens and weights, 60-token
    windows) against the port's torch-op block on the same layer and
    against the fp32 reference, with LayerScale 1 so that the update is the
    block's whole work. Compared on the update relative to its size
    (``_update_gap``). Tolerance 0.03: bf16's relative rounding is 2^-8 =
    0.004 an operand, which the products and the softmax sum into about 1%
    of the update; the float8 control (the reference's operands in e4m3,
    2^-4 relative) must read above it, so that a lower precision than the
    configuration's fails. The kernel against its plain version (the same
    rounding points, another summation order): 2e-3."""
    cfg = get_config("gen4", "base", **RVT)
    attn = cfg.model.backbone.attention
    torch.manual_seed(windows)
    layer = PartitionAttention(C, attn, torch.bfloat16).to(dev)
    for m in layer.modules():
        if isinstance(m, Dense):
            torch.nn.init.normal_(m.kernel, std=m.kernel.shape[1] ** -0.5)
            torch.nn.init.normal_(m.bias, std=0.1)
    with torch.no_grad():
        layer.ls1.gamma.fill_(1.0)
        layer.ls2.gamma.fill_(1.0)
    x = torch.randn(1, windows, 60, C, device=dev).to(torch.bfloat16)
    name = "block0.win_attn"
    P = {f"{name}.{k}": v.float() for k, v in layer.state_dict().items()}
    n = fused_block.rvt_window_block.launches
    with torch.no_grad():
        got = layer(x)
        plain = fused_block.rvt_block_plain(x[0], fused_block.rvt_params(layer), C // 32, 32)
        ops = layer.block_math(x)
        want = rvt.attention_layer(P, name, x.float(), C // 32, R.identity)
        control = rvt.attention_layer(P, name, x.float(), C // 32, fp8_e4m3)
    torch.cuda.synchronize()
    assert fused_block.rvt_window_block.launches == n + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert _update_gap(got[0], plain, x[0]) <= 2e-3
    assert _update_gap(got, ops, x) <= 0.03
    assert _update_gap(got, want, x) <= 0.03
    assert _update_gap(control, want, x) > 0.03


def _card_frames(rng, lanes, hw, n_max):
    out = []
    for _ in range(lanes):
        n = rng.randint(n_max // 4, n_max)
        out.append(dict(x=rng.randint(0, hw[1], n), y=rng.randint(0, hw[0], n),
                        p=rng.randint(0, 2, n), t=np.sort(rng.randint(0, 50_000, n))))
    return out


@pytest.mark.cuda
def test_the_captured_step_and_its_artifact_run_the_variant_on_the_card(dev):
    """gen4 RVT-B at 2 lanes on the card: the captured serving step launches
    the variant on all 8 layers at the eager warm-up and at the capture, and
    its replays run with no host call; the live detector's exported
    artifact, captured too, gives its slates and carried state bit for bit
    over three frames, lane 1 reset at the third. Exported after the live
    detector stepped, as a deployment exports one: a detector that has not
    stepped holds its head's anchor grids as CPU constants, which a capture
    cannot copy (ROADMAP fault 1a)."""
    from sast_tpu_torch.models.detector import build_detector

    cfg = get_config("gen4", "base", **RVT)
    hw = cfg.dataset.resolution_hw
    rng = np.random.RandomState(7)
    frames = [_card_frames(rng, 2, hw, 40_000) for _ in range(3)]
    resets = [np.array([False, i == 2]) for i in range(3)]

    def run(det):
        det.reset()
        outs = [det.process_batch(frames[i], reset=resets[i]) for i in range(3)]
        return outs, [t.cpu() for hc in det.states for t in hc]

    n = fused_block.rvt_window_block.launches
    live = StreamingDetector(cfg, build_detector(cfg.model, seed=3, device=dev),
                             max_events=40_000, num_streams=2, device=dev)
    want = run(live)
    assert fused_block.rvt_window_block.launches - n == 16  # the eager warm-up and the capture
    assert live.steps[0].run.replays == 2
    art = export.ExportedStreamingDetector(export.export_streaming_detector(live))
    got = run(art)
    for a, b in zip(got[0], want[0]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_trainer_fit_trains_rvt_on_the_card(dev, tmp_path):
    """Two captured ``Trainer.fit`` steps of RVT-B (gen4 widths, a cut
    resolution, bf16, torch ops under grad) on the card: finite losses."""
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.training.loop import Trainer

    cfg = get_config("gen4", "base", **RVT, **{
        "dataset.resolution_hw_override": (128, 256), "training.batch_size_train": 2,
        "dataset.sequence_length": 2, "training.max_labeled_frames_per_lane": 2})
    trainer = Trainer(cfg, str(tmp_path / "run"), log_every=1, device=dev)
    rng = np.random.RandomState(0)
    metrics = trainer.fit([synthetic_train_batch(cfg, rng) for _ in range(2)], max_steps=2)
    assert trainer.state.step == 2 and np.isfinite(metrics["train/loss"])
