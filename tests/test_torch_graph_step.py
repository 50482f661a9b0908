"""The serving step on static buffers, the weights cast once, the baked
artifact (``sast_tpu_torch/graphs.py``, ``models/layers.compute_copy``,
``export.bake_compute_weights``) on the CPU.

At the tests/test_torch_serving.py geometry (gen1 events at 240x304, model
resolution 256x320, partition (4, 5), tiny widths): the static-buffer body
that a card captures, run eagerly here, against JAX's jitted
``StreamingDetector`` on the same weights; the state buffers kept in place;
the compute-dtype copies of the weights against per-call casts, after new
weights, and under training; the artifact with its weights baked in the
compute dtype. The capture itself needs a card (tests/test_torch_cuda.py).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.models.backbone import zero_states as j_zero_states
from sast_tpu.models.detector import YoloXDetector as JDetector
from sast_tpu.serving import StreamingDetector as JStreamingDetector
from sast_tpu_torch import export
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.models.detector import YoloXDetector, build_detector
from sast_tpu_torch.models.layers import Dense
from sast_tpu_torch.packing import pack_event_batch
from sast_tpu_torch.serving import StreamingDetector
from sast_tpu_torch.weights import load_jax_variables
from tests.test_torch_serving import _frame, _serving_config

FRAMES = 6
EVENTS = 4000
RESETS = [np.array([i == 3, i == 2]) for i in range(FRAMES)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              compute_dtype="bfloat16"))


@pytest.fixture(scope="module")
def variables():
    """The JAX detector's variables from ``PRNGKey(0)`` and ``PRNGKey(1)``,
    as numpy."""
    jcfg = _serving_config(j_test_config)
    x0 = jnp.zeros((1, 256, 320, 20), jnp.float32)
    init = jax.jit(JDetector(jcfg.model).init)
    return jcfg, [jax.device_get(init(jax.random.PRNGKey(k), x0,
                                      j_zero_states(jcfg.model.backbone, 1))) for k in (0, 1)]


def _frames(seed=1):
    rng = np.random.RandomState(seed)
    return [[_frame(rng, i), _frame(rng, i)] for i in range(FRAMES)]


def _run(det, frames):
    det.reset()
    outs = [det.process_batch(f, reset=r) for f, r in zip(frames, RESETS)]
    return outs, [t.clone() for hc in det.states for t in hc]


def _same(a, b):
    (outs_a, states_a), (outs_b, states_b) = a, b
    for i, (x, y) in enumerate(zip(outs_a, outs_b)):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"frame {i} {k}")
    for x, y in zip(states_a, states_b):
        assert torch.equal(x, y)


# The one telemetry entry apart (ROADMAP section 3, 3f): frame 3, stage 3,
# the port's batch aggregate against JAX's; every other frame and stage, and
# every slate, agrees. One window of lane 1 sits at the f32 selection
# threshold, which the port's scores reach and JAX's miss by two ulps: its
# 12 selected tokens are 6 per lane in the aggregate
# (test_the_one_window_apart_sits_at_the_threshold).
TELEMETRY_APART = {(3, 2): (295.0, 289.0)}


def test_static_buffer_body_matches_jax(variables):
    """Six frames on two lanes with lane resets at frames 2 and 3: the body
    that a card captures, run eagerly on the CPU (``graph`` asks for the
    capture; the CPU runs eagerly), against JAX's jitted step. Validity,
    classes and telemetry exact but for ``TELEMETRY_APART``, pinned; boxes
    and scores within tests/test_torch_serving.py's 1e-4 absolute / 1e-5
    relative."""
    jcfg, (v0, _) = variables
    tcfg = _serving_config(get_test_config)
    jdet = JStreamingDetector(jcfg, v0, max_events=EVENTS, num_streams=2)
    tdet = StreamingDetector(tcfg, load_jax_variables(YoloXDetector(tcfg.model), v0),
                             max_events=EVENTS, num_streams=2, device="cpu", graph=True)
    assert not tdet.steps[0].run.graph
    for i, (frames, reset) in enumerate(zip(_frames(), RESETS)):
        oj = jdet.process_batch(frames, reset=reset)
        ot = tdet.process_batch(frames, reset=reset)
        tel_t, tel_j = ot["selected_tokens"].copy(), np.asarray(oj["selected_tokens"]).copy()
        for (f, stage), pair in TELEMETRY_APART.items():
            if f == i:
                assert (tel_t[stage], tel_j[stage]) == pair
                tel_t[stage] = tel_j[stage]
        np.testing.assert_array_equal(tel_t, tel_j, err_msg=f"frame {i} selected_tokens")
        for k in ("valid", "classes"):
            np.testing.assert_array_equal(ot[k], np.asarray(oj[k]), err_msg=f"frame {i} {k}")
        for k in ("boxes", "scores", "obj_conf", "cls_conf"):
            np.testing.assert_allclose(ot[k], np.asarray(oj[k]), rtol=1e-5, atol=1e-4,
                                       err_msg=f"frame {i} {k}")


def test_the_one_window_apart_sits_at_the_threshold(variables, monkeypatch):
    """Why ``TELEMETRY_APART`` holds one pair: over the six frames, one
    selection of all layers, lanes, windows and tokens differs from JAX's
    (frame 3, stage 3's window layer, lane 1, window 10, kept by the port
    with its 12 selected tokens and dropped by JAX). Its fp32 window
    softmax is the f32 threshold ``(1/N)/(1+bounce)`` itself in the port and
    two ulps below it in JAX; the window's L1 score is one ulp apart, from
    the two frameworks' orders of summation upstream (the port's softmax of
    JAX's scores gives JAX's value). Not the reset: lane 1 was reset at
    frame 2, and the state masking (``torch.where`` of a zero) is JAX's."""
    import sast_tpu.models.sast as j_sast
    import sast_tpu_torch.models.sast as t_sast

    j_calls, t_calls = [], []
    n_traced = [0]
    j_select, t_select = j_sast.select_windows_and_tokens, t_sast.select_windows_and_tokens

    def j_recorded(scores, bounce):
        win_keep, tok_keep = j_select(scores, bounce)
        tag = n_traced[0]  # the layer, in trace order: one trace serves every frame
        n_traced[0] += 1
        hw = scores.shape[2]
        soft = jax.nn.softmax(jnp.sum(jnp.abs(scores.astype(jnp.float32)), axis=(2, 3)) / hw,
                              axis=-1)
        jax.debug.callback(lambda *a, tag=tag: j_calls.append((tag, [np.asarray(v) for v in a])),
                           soft, win_keep, tok_keep)
        return win_keep, tok_keep

    def t_recorded(scores, bounce):
        win_keep, tok_keep = t_select(scores, bounce)
        hw = torch.full((), float(scores.shape[2]))
        soft = torch.softmax(scores.to(torch.float32).abs().sum(dim=(2, 3)) / hw, dim=-1)
        t_calls.append([soft.numpy(), win_keep.numpy(), tok_keep.numpy()])
        return win_keep, tok_keep

    monkeypatch.setattr(j_sast, "select_windows_and_tokens", j_recorded)
    monkeypatch.setattr(t_sast, "select_windows_and_tokens", t_recorded)
    jcfg, (v0, _) = variables
    tcfg = _serving_config(get_test_config)
    jdet = JStreamingDetector(jcfg, v0, max_events=EVENTS, num_streams=2)
    tdet = StreamingDetector(tcfg, load_jax_variables(YoloXDetector(tcfg.model), v0),
                             max_events=EVENTS, num_streams=2, device="cpu")
    j_frames = []
    for frames, reset in zip(_frames(), RESETS):
        jdet.process_batch(frames, reset=reset)
        tdet.process_batch(frames, reset=reset)
        jax.effects_barrier()
        j_frames += [c for _, c in sorted(j_calls, key=lambda e: e[0])]
        j_calls.clear()
    layers = n_traced[0]
    assert len(j_frames) == len(t_calls) == layers * FRAMES
    windows, tokens = [], []
    for k, ((j_soft, j_win, j_tok), (t_soft, t_win, t_tok)) in enumerate(zip(j_frames, t_calls)):
        for lane, win in np.argwhere(j_win != t_win):
            windows.append((k // layers, k % layers, int(lane), int(win),
                            j_soft[lane, win], t_soft[lane, win], bool(t_win[lane, win])))
        tokens += [(k // layers, k % layers, int(lane), int(win))
                   for lane, win, _ in np.argwhere(j_tok != t_tok)]
    # frame 3, the fifth selection (stage 3, window layer), lane 1, window 10
    assert [w[:4] for w in windows] == [(3, 4, 1, 10)]
    assert set(tokens) == {(3, 4, 1, 10)} and len(tokens) == 12
    _, _, _, _, j_value, t_value, kept_by_port = windows[0]
    N = t_calls[4][0].shape[-1]
    bounce = tcfg.model.backbone.attention.bounce
    threshold = np.float32((1.0 / N) / (1.0 + bounce))
    bits = [int(v.view(np.int32)) for v in (j_value, t_value, threshold)]
    assert kept_by_port and bits[1] == bits[2] and bits[0] == bits[2] - 2, bits


def test_state_buffers_stay_in_place():
    """The carried state is the step's own buffers: the same storage after
    steps and after ``reset()``, which zeroes them in place; a lane's reset
    mask zeroes that lane alone before the step."""
    cfg = _serving_config(get_test_config)
    det = StreamingDetector(cfg, build_detector(cfg.model, seed=0, device="cpu"),
                            max_events=EVENTS, num_streams=2, device="cpu")
    leaves = [t for hc in det.states for t in hc]
    ptrs = [t.data_ptr() for t in leaves]
    frames = _frames()
    det.process_batch(frames[0])
    assert all(t.abs().sum() > 0 for t in leaves)
    assert [t.data_ptr() for hc in det.states for t in hc] == ptrs
    det.reset()
    assert [t.data_ptr() for hc in det.states for t in hc] == ptrs
    assert not any(t.any() for t in leaves)
    det.process_batch(frames[1])
    lane0 = [t[0].clone() for t in leaves]
    packed, n = pack_event_batch(frames[2], 2, EVENTS)
    det.step(torch.from_numpy(packed), torch.from_numpy(n), torch.tensor([False, True]))
    fresh = StreamingDetector(cfg, det.model, max_events=EVENTS, num_streams=2, device="cpu")
    fresh.step(torch.from_numpy(packed), torch.from_numpy(n), torch.tensor([False, False]))
    for t, f, before in zip(leaves, (u for hc in fresh.states for u in hc), lane0):
        assert torch.equal(t[1], f[1])  # lane 1 started from zeros, as a fresh detector
        assert not torch.equal(t[0], before) or not before.any()


def test_packing_into_staging_buffers_equals_a_fresh_pack():
    """``pack_event_batch(out=...)`` rewrites the previous batch's buffers
    into what a fresh pack gives, rows past a shorter frame zeroed again."""
    frames = _frames()
    packed, n = np.zeros((2, EVENTS, 4), np.int32), np.zeros((2,), np.int32)
    for f in frames[:3] + [[frames[0][0], dict(x=np.zeros(0, int), y=np.zeros(0, int),
                                                 p=np.zeros(0, int), t=np.zeros(0, int))]]:
        got = pack_event_batch(f, 2, EVENTS, out=(packed, n))
        want = pack_event_batch(f, 2, EVENTS)
        assert got[0] is packed and got[1] is n
        np.testing.assert_array_equal(packed, want[0])
        np.testing.assert_array_equal(n, want[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cast_once_equals_per_call_casts(dtype):
    """Without grad each layer reads its weights through one kept copy in
    the compute dtype (the parameter itself in fp32); with grad it casts at
    each call. Both give the same bits; the copy is made once and reused."""
    cfg = _serving_config(get_test_config)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    model = build_detector(cfg.model, seed=0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).poisson(0.2, (2, 256, 320, 20))
                         .clip(0, 255).astype(np.uint8))
    with torch.no_grad():
        cached = model(x)
        again = model(x)
    with torch.enable_grad():
        per_call = model(x)
    for a, b, c in zip(*(torch.utils._pytree.tree_leaves(o) for o in (cached, again, per_call))):
        assert torch.equal(a, c.detach()) and torch.equal(a, b)
    dense = next(m for m in model.modules() if isinstance(m, Dense))
    copies = dense.__dict__.get("_compute_copies", {})
    if dtype == "float32":
        assert not copies  # .to returns the parameter itself: no copy
    else:
        held = copies["kernel"][1]
        assert held.dtype == torch.bfloat16 and held is not dense.kernel
        with torch.no_grad():
            model(x)
        assert dense.__dict__["_compute_copies"]["kernel"][1] is held


def test_new_weights_reach_a_detector_that_has_stepped(variables):
    """bf16: ``load_jax_variables`` writes the ``PRNGKey(1)`` weights into a
    detector that has stepped on the ``PRNGKey(0)`` ones; its compute copies
    are rewritten in place (same storage), and its detections equal a fresh
    detector's on the new weights, bit for bit."""
    _, (v0, v1) = variables
    cfg = _bf16(_serving_config(get_test_config))
    model = load_jax_variables(YoloXDetector(cfg.model), v0)
    det = StreamingDetector(cfg, model, max_events=EVENTS, num_streams=2, device="cpu")
    frames = _frames()
    before = _run(det, frames)
    dense = next(m for m in model.modules() if isinstance(m, Dense))
    held = dense.__dict__["_compute_copies"]["kernel"][1]
    load_jax_variables(model, v1)
    got = _run(det, frames)
    assert dense.__dict__["_compute_copies"]["kernel"][1] is held
    assert torch.equal(held, dense.kernel.detach().to(torch.bfloat16))
    fresh = StreamingDetector(cfg, load_jax_variables(YoloXDetector(cfg.model), v1),
                              max_events=EVENTS, num_streams=2, device="cpu")
    _same(got, _run(fresh, frames))
    assert not all(torch.equal(a, b) for a, b in zip(before[1], got[1]))


def test_training_gradients_do_not_use_the_cache():
    """bf16: gradients of a loss after a no-grad forward (the copies kept)
    equal those of a model that never kept a copy, bit for bit, and land on
    the fp32 parameters."""
    cfg = _bf16(_serving_config(get_test_config))
    x = torch.from_numpy(np.random.RandomState(3).poisson(0.2, (2, 256, 320, 20))
                         .clip(0, 255).astype(np.uint8))
    grads = []
    for warm in (True, False):
        model = build_detector(cfg.model, seed=0, device="cpu").train()
        if warm:
            with torch.no_grad():
                model(x)
        out, _, _ = model(x)
        out["preds"].float().square().mean().backward()
        grads.append([(n, p.grad) for n, p in model.named_parameters()])
    for (name, a), (_, b) in zip(*grads):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == torch.float32 and torch.equal(a, b), name
    assert sum(g is not None for _, g in grads[0]) > 100


def test_baked_artifact_equals_its_live_detector():
    """bf16: the artifact stores every parameter that the step reads only
    cast to bf16 already cast, its graph holds no cast of a parameter, and
    it steps the same bits as its live detector (detections, telemetry,
    carried states)."""
    cfg = _bf16(_serving_config(get_test_config))
    det = StreamingDetector(cfg, build_detector(cfg.model, seed=0, device="cpu"),
                            max_events=EVENTS, num_streams=2, device="cpu")
    art = export.ExportedStreamingDetector(export.export_streaming_detector(det))
    assert export.parameter_casts(art.program) == 0
    kept = art.program.state_dict
    assert sum(t.dtype == torch.bfloat16 for t in kept.values()) > 50
    assert all(kept[k].dtype == torch.float32 for k in kept if k.endswith("norm2.scale"))
    frames = _frames()
    _same(_run(det, frames), _run(art, frames))


def test_captured_frame_needs_a_card():
    """The benchmark's captured frame refuses the CPU by name (nothing falls
    back to the eager frame)."""
    from sast_tpu_torch.utils import benchmark

    cfg = get_test_config()
    model = build_detector(cfg.model, seed=0, device="cpu")
    x = torch.zeros((1, *cfg.model.backbone.in_res_hw, 20), dtype=torch.uint8)
    from sast_tpu_torch.models.backbone import zero_states

    with pytest.raises(RuntimeError, match="needs a card"):
        benchmark.streaming_chunk(model, 2, graph=True)(x, zero_states(cfg.model.backbone, 1))


class _Schedule:
    """Stands in for a captured ``graphs.Schedule``: a replay is one launch,
    written to ``log``."""

    def __init__(self, name, log):
        self.name, self.log = name, log
        self.replays = 0

    def replay(self):
        self.log.append(f"{self.name} launch")
        self.replays += 1

    def replayed(self):
        return collections.Counter({"stem_conv7x4": self.replays})


def _replaying(name, log):
    from sast_tpu_torch import graphs

    run = graphs.Captured(lambda: None, "cpu")
    run.graph, run.schedule, run.outputs = True, _Schedule(name, log), name
    run._switches = graphs._kernel_switches()
    return run


def test_replicas_enqueue_their_graphs_before_any_predicate_read():
    """``graphs.run_together`` replays each replica as one launch (its
    choices are conditional nodes, taken on the card), every replica's
    launch enqueued before any output is returned; an eager replica runs
    its body in turn; the outputs come back in order, and each replica
    counts its replay and the launches it ran."""
    from sast_tpu_torch import graphs

    log = []
    eager = graphs.Captured(lambda: log.append("c body") or "c", "cpu")
    runs = [_replaying("a", log), _replaying("b", log), eager]
    assert graphs.run_together(runs) == ["a", "b", "c"]
    assert log == ["a launch", "b launch", "c body"]
    assert [r.replays for r in runs] == [1, 1, 0]
    assert runs[0].replayed == collections.Counter({"stem_conv7x4": 1})


@pytest.mark.parametrize("change", ["looped", "none"])
def test_captured_graphs_follow_the_kernel_switch(change):
    """A switch that picks a kernel (``sparse_block.MODEL_USES_LOOPED``)
    changed since the capture makes the next call capture again instead of
    replaying graphs of the other kernel; unchanged, the graphs replay."""
    from sast_tpu_torch import graphs
    from sast_tpu_torch.utils.benchmark import looped_kernel

    log = []
    run = _replaying("a", log)
    run._warm_up_and_capture = lambda: log.append("captured") or "new"
    with looped_kernel(change == "looped"):
        out = run()
    assert (out, log) == (("new", ["captured"]) if change == "looped" else ("a", ["a launch"]))
    assert run.replays == (change != "looped")
    assert graphs._kernel_switches() == (False,)
