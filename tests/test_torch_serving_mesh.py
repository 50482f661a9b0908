"""``StreamingDetector(mesh=...)``: the serving lanes over several devices,
and the export CLI ``scripts/export_model_torch.py`` (CPU, plain versions).

At the tests/test_serving.py geometry (gen1 240x304 events, model
resolution 256x320, partition (4, 5), tiny widths, fp32, confidence
threshold 0): a mesh of two CPU devices with 2 lanes each against the JAX
package's single-device 4-lane detector and against two 2-lane port
detectors; then the CLI on a reference-style ``.ckpt``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.models.backbone import zero_states as j_zero_states
from sast_tpu.models.detector import YoloXDetector as JDetector
from sast_tpu.serving import StreamingDetector as JStreamingDetector
from sast_tpu_torch.config import get_config, get_test_config
from sast_tpu_torch.models.detector import YoloXDetector, init_weights
from sast_tpu_torch.serving import StreamingDetector
from sast_tpu_torch.weights import load_jax_variables, to_jax_variables
from tests.test_torch_serving import _frame, _serving_config

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 3
EVENTS = 4000
RESETS = [np.array([False, False, False, i == 2]) for i in range(FRAMES)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores; torch's own pool in each would oversubscribe them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshed(_one_torch_thread):
    """The JAX variables, the port config and 3 frames of 4 lanes (lane 3,
    the second device's, reset at frame 2), with the two-device detector's
    outputs and carried states."""
    jcfg = _serving_config(j_test_config)
    x0 = jnp.zeros((1, 256, 320, 20), jnp.float32)
    variables = jax.device_get(jax.jit(JDetector(jcfg.model).init)(
        jax.random.PRNGKey(0), x0, j_zero_states(jcfg.model.backbone, 1)))
    tcfg = _serving_config(get_test_config)
    rng = np.random.RandomState(3)
    frames = [[_frame(rng, i) for _ in range(4)] for i in range(FRAMES)]
    model = load_jax_variables(YoloXDetector(tcfg.model), variables)
    det = StreamingDetector(tcfg, model, max_events=EVENTS, num_streams=4, mesh=("cpu", "cpu"))
    outs = [det.process_batch(frames[i], reset=RESETS[i]) for i in range(FRAMES)]
    return dict(jcfg=jcfg, variables=variables, tcfg=tcfg, frames=frames, det=det, outs=outs)


def test_mesh_matches_the_jax_single_device_detector(meshed):
    """Two devices of 2 lanes against JAX's one device of 4 lanes, as
    tests/test_multichip.py holds JAX's own mesh: every key of the slate
    within atol 1e-5. The selected-token telemetry is the 4-lane aggregate:
    equal to the port's own one-device 4-lane detector, and to JAX's within
    one token of one lane per stage (1 / 4): a token whose fp32 score sits at
    the selection threshold can flip between the two frameworks' summation
    orders (here lane 2 at frame 2, stage 2, alike on one lane alone)."""
    jdet = JStreamingDetector(meshed["jcfg"], meshed["variables"], max_events=EVENTS,
                              num_streams=4)
    model = load_jax_variables(YoloXDetector(meshed["tcfg"].model), meshed["variables"])
    single = StreamingDetector(meshed["tcfg"], model, max_events=EVENTS, num_streams=4,
                               device="cpu")
    for i in range(FRAMES):
        oj = jdet.process_batch(meshed["frames"][i], reset=RESETS[i])
        os_ = single.process_batch(meshed["frames"][i], reset=RESETS[i])
        ot = meshed["outs"][i]
        assert ot["valid"].all()
        np.testing.assert_array_equal(ot["selected_tokens"], os_["selected_tokens"],
                                      err_msg=f"frame {i} selected_tokens, one device")
        np.testing.assert_allclose(ot["selected_tokens"], np.asarray(oj["selected_tokens"]),
                                   rtol=0, atol=1 / 4, err_msg=f"frame {i} selected_tokens")
        for k in ("boxes", "scores", "classes", "valid"):
            np.testing.assert_allclose(ot[k], np.asarray(oj[k]), rtol=0, atol=1e-5,
                                       err_msg=f"frame {i} {k}")


def test_the_one_selected_token_apart_sits_at_the_threshold(meshed, monkeypatch):
    """Why the telemetry above is held within 1/4 and not exactly: over the
    three frames, one token of all layers is selected by the port and not by
    JAX (lane 2, frame 2, stage 2's window layer, window 16, token 3). Its
    fp32 softmax is the f32 threshold ``(1/hw)/(1+bounce)`` itself in the
    port and one ulp below it in JAX: the two frameworks sum the row's
    scores in other orders. Every other selection, of every layer, lane and
    frame, agrees."""
    import sast_tpu.models.sast as j_sast
    import sast_tpu_torch.models.sast as t_sast

    j_calls, t_calls = [], []
    n_traced = [0]
    j_select, t_select = j_sast.select_windows_and_tokens, t_sast.select_windows_and_tokens

    def j_recorded(scores, bounce):
        win_keep, tok_keep = j_select(scores, bounce)
        tag = n_traced[0]  # the layer, in trace order: one trace serves every frame
        n_traced[0] += 1
        soft = jax.nn.softmax(jnp.sum(jnp.abs(scores.astype(jnp.float32)), axis=3), axis=-1)
        jax.debug.callback(lambda *a, tag=tag: j_calls.append((tag, [np.asarray(v) for v in a])),
                           soft, tok_keep)
        return win_keep, tok_keep

    def t_recorded(scores, bounce):
        win_keep, tok_keep = t_select(scores, bounce)
        soft = torch.softmax(scores.to(torch.float32).abs().sum(dim=3), dim=-1)
        t_calls.append([soft.numpy(), tok_keep.numpy()])
        return win_keep, tok_keep

    monkeypatch.setattr(j_sast, "select_windows_and_tokens", j_recorded)
    monkeypatch.setattr(t_sast, "select_windows_and_tokens", t_recorded)
    jdet = JStreamingDetector(meshed["jcfg"], meshed["variables"], max_events=EVENTS,
                              num_streams=4)
    model = load_jax_variables(YoloXDetector(meshed["tcfg"].model), meshed["variables"])
    single = StreamingDetector(meshed["tcfg"], model, max_events=EVENTS, num_streams=4,
                               device="cpu")
    tel, j_frames = [], []
    for i in range(FRAMES):
        oj = jdet.process_batch(meshed["frames"][i], reset=RESETS[i])
        ot = single.process_batch(meshed["frames"][i], reset=RESETS[i])
        tel.append(ot["selected_tokens"] - np.asarray(oj["selected_tokens"]))
        jax.effects_barrier()
        j_frames += [c for _, c in sorted(j_calls, key=lambda e: e[0])]
        j_calls.clear()
    layers = n_traced[0]
    assert len(j_frames) == len(t_calls) == layers * FRAMES
    apart = []
    for k, ((j_soft, j_keep), (t_soft, t_keep)) in enumerate(zip(j_frames, t_calls)):
        for lane, win, tok in np.argwhere(j_keep != t_keep):
            apart.append((k // layers, k % layers, int(lane), int(win), int(tok),
                          j_soft[lane, win, tok], t_soft[lane, win, tok], t_keep[lane, win, tok]))
    # frame 2, the third selection (stage 2, window layer), lane 2
    assert [a[:5] for a in apart] == [(2, 2, 2, 16, 3)]
    _, _, _, _, _, j_value, t_value, kept_by_port = apart[0]
    hw = t_calls[2][0].shape[-1]
    bounce = meshed["tcfg"].model.backbone.attention.bounce
    threshold = np.float32((1.0 / hw) / (1.0 + bounce))
    bits = [int(v.view(np.int32)) for v in (j_value, t_value, threshold)]
    assert kept_by_port and bits[1] == bits[2] and bits[0] == bits[2] - 1, bits
    want = np.zeros((FRAMES, 4), np.float32)
    want[2, 1] = 1 / 4  # one token of one lane of four, stage 2
    np.testing.assert_array_equal(np.stack(tel), want)


def test_mesh_is_two_detectors_bit_for_bit(meshed):
    """Each device runs its block of lanes as a 2-lane detector would, on
    a replica of the weights: slates and carried states bit-equal, the
    lane-3 reset acting on the second device only, and the telemetry the
    mean of the two detectors' aggregates."""
    det = meshed["det"]
    model = load_jax_variables(YoloXDetector(meshed["tcfg"].model), meshed["variables"])
    pairs = [StreamingDetector(meshed["tcfg"], model, max_events=EVENTS, num_streams=2,
                               device="cpu") for _ in range(2)]
    assert len(det.replicas) == 2 and det.replicas[1].model is not det.model
    for i in range(FRAMES):
        outs = [p.process_batch(meshed["frames"][i][2 * r:2 * r + 2],
                                reset=RESETS[i][2 * r:2 * r + 2]) for r, p in enumerate(pairs)]
        for k in outs[0]:
            want = (np.mean([o[k] for o in outs], axis=0, dtype=np.float32)
                    if k == "selected_tokens" else np.concatenate([o[k] for o in outs]))
            np.testing.assert_array_equal(meshed["outs"][i][k], want, err_msg=f"frame {i} {k}")
    for states, pair in zip(det.states, pairs):
        for a, b in zip(pytree.tree_leaves(states), pytree.tree_leaves(pair.states)):
            assert torch.equal(a, b)
    det.reset()
    assert not any(t.any() for t in pytree.tree_leaves(det.states))


@pytest.mark.parametrize("streams,mesh", [(3, ("cpu", "cpu")), (2, ())])
def test_mesh_must_be_tiled_by_the_lanes(meshed, streams, mesh):
    with pytest.raises(ValueError, match="must tile"):
        StreamingDetector(meshed["tcfg"], YoloXDetector(meshed["tcfg"].model), max_events=64,
                          num_streams=streams, mesh=mesh)


def _script():
    spec = importlib.util.spec_from_file_location(
        "export_model_torch", ROOT / "scripts" / "export_model_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_export_cli_on_a_reference_checkpoint(tmp_path, capsys):
    """``scripts/export_model_torch.py`` on a reference-style ``.ckpt``
    (parameters and BatchNorm statistics) at gen1-tiny, fp32, on the CPU:
    its artifact, loaded and stepped once, equals a live detector on the
    weights the converter loads; ``--platforms`` and
    ``--allow-tpu-kernels`` are refused by name."""
    from sast_tpu_torch.checkpoint.torch_convert import load_torch_checkpoint
    from sast_tpu_torch.export import ExportedStreamingDetector

    script = _script()
    sets = {"model.compute_dtype": "float32", "model.postprocess.confidence_threshold": 0.0}
    cfg = get_config("gen1", "tiny", **sets)
    src = YoloXDetector(cfg.model)
    init_weights(src, torch.Generator().manual_seed(4))
    ckpt = tmp_path / "reference.ckpt"
    torch.save({"state_dict": chip_smoke.reference_state_dict(
        torch, np, to_jax_variables(src), cfg.model)}, ckpt)
    argv = ["--dataset", "gen1", "--size", "tiny", "--ckpt", str(ckpt), "--out",
            str(tmp_path / "art"), "--max-events", "1500", "--device", "cpu",
            *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]
    path = script.main(argv)
    assert "streaming_step.pt2" in capsys.readouterr().out
    art = ExportedStreamingDetector(path)
    assert (art.num_streams, art.max_events) == (1, 1500)
    live = StreamingDetector(cfg, load_torch_checkpoint(str(ckpt), YoloXDetector(cfg.model)),
                             max_events=1500, device="cpu")
    frame = _frame(np.random.RandomState(5), 0)
    got, want = art.process_events(**frame), live.process_events(**frame)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for option in (["--platforms", "cpu,tpu"], ["--allow-tpu-kernels"]):
        with pytest.raises(SystemExit) as err:
            script.main(argv + option)
        assert err.value.code == 2 and "not ported" in capsys.readouterr().err
