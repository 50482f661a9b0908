"""The port's artifacts of the configurations whose attention layers choose a
branch from the scene: the budget-gather path below a budget of 1
(``n_win <= K``) and the sparse kernel below a density threshold of 1.

At the tests/test_export.py geometry (gen1 240x304 events, model resolution
256x320, partition (4, 5), tiny widths, fp32, two lanes, confidence
threshold 0), ``attention.gather_budget`` 0.5 and ``sparse_kernel=True``
with ``attention.pallas_density_threshold`` 0.5: each exported graph holds
one ``torch.cond`` node per such layer, the loaded artifact equals the live
detector bit for bit over frames that drive every layer's predicate both
ways (an empty first frame keeps few windows, the next ones many), and it
matches the JAX package's artifact of the same configuration (its Pallas
kernel in interpret mode, as tests/test_torch_paths.py runs it). The
weights are baked through the branches: no cast of a parameter is left in
the graph or in a branch, in fp32 and in bf16, where the threshold
configuration's masked branch casts the biases that its kernel branch
reads in fp32.
"""

import collections
import dataclasses
import io
from functools import partial

import jax
import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.export import ExportedStreamingDetector as JExported
from sast_tpu.export import export_streaming_detector as j_export
from sast_tpu.serving import StreamingDetector as JStreamingDetector
from sast_tpu_torch import export
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.models.detector import YoloXDetector, build_detector
from sast_tpu_torch.models.sast import MaskedSparseAttention, density_limit, gather_size
from sast_tpu_torch.serving import StreamingDetector
from sast_tpu_torch.weights import load_jax_variables
from tests.test_torch_export import _assert_same, _jax_variables
from tests.test_torch_serving import _frame, _serving_config

EVENTS = 4000
FRAMES = 4
RESETS = [np.array([False, i == 3]) for i in range(FRAMES)]
# name -> (attention switches, sparse_kernel, the true branch)
CONFIGS = {
    "gather-0.5": (dict(gather_budget=0.5), False, "gathered"),
    "threshold-0.5": (dict(pallas_density_threshold=0.5), True, "kernel"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(get_cfg, attention):
    cfg = _serving_config(get_cfg)
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, **attention))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))


def _dense(rng, i):
    """A frame of the full event budget, uniform over the sensor."""
    n = EVENTS
    return dict(x=rng.randint(0, 304, n), y=rng.randint(0, 240, n), p=rng.randint(0, 2, n),
                t=np.sort(rng.randint(0, 50_000, n)) + i * 50_000)


def _frames():
    """An empty frame on both lanes, one of 300-1200 events, one of the full
    event budget, and one of 300-1200 events with lane 1 reset."""
    rng = np.random.RandomState(1)
    empty = dict(x=np.zeros(0, np.int64), y=np.zeros(0, np.int64), p=np.zeros(0, np.int64),
                 t=np.zeros(0, np.int64))
    return [[empty, empty], [_frame(rng, 1), _frame(rng, 1)], [_dense(rng, 2), _dense(rng, 2)],
            [_frame(rng, 3), _frame(rng, 3)]]


def _run(det, frames):
    outs = [det.process_batch(frames[i], reset=RESETS[i]) for i in range(FRAMES)]
    return outs, [t.clone() for t in pytree.tree_leaves(det.states)]


def _choosing_layers(det):
    """Names of the attention layers whose branch depends on the scene:
    every window layer (cond-free ones have K == M or a threshold of 1)."""
    bb = det.cfg.model.backbone
    ph, pw = bb.attention.partition_size
    names = []
    for stage, stride in enumerate(bb.stage_strides):
        M = det.num_streams * (bb.in_res_hw[0] // stride // ph) * (bb.in_res_hw[1] // stride // pw)
        att = bb.attention
        if (gather_size(att.gather_budget, M) < M if att.gather_budget > 0
                else density_limit(att.pallas_density_threshold, M) < M):
            names += [f"stage{stage}.block{b}.{kind}" for b in range(bb.num_blocks[stage])
                      for kind in ("win_attn", "grid_attn")]
    return names


@pytest.fixture(scope="module", params=list(CONFIGS))
def artifact(request, _one_torch_thread):
    """A live detector's outputs over the frames with the branch each layer
    took at each frame (a spy on the branch methods), its artifact, and the
    artifact's outputs."""
    attention, sparse_kernel, _ = CONFIGS[request.param]
    jcfg = _config(j_test_config, attention)
    variables = _jax_variables(jcfg)
    tcfg = _config(get_test_config, attention)
    model = load_jax_variables(YoloXDetector(tcfg.model), variables)
    names = {m: n.removeprefix("backbone.") for n, m in model.named_modules()
             if isinstance(m, MaskedSparseAttention)}
    live = StreamingDetector(tcfg, model, max_events=EVENTS, num_streams=2, device="cpu",
                             sparse_kernel=sparse_kernel)
    frames = _frames()
    taken = collections.defaultdict(list)
    mp = pytest.MonkeyPatch()
    for branch in ("masked", "gathered", "kernel"):
        def spy(self, *args, _orig=getattr(MaskedSparseAttention, branch), _branch=branch, **kw):
            taken[names[self]].append(_branch)
            return _orig(self, *args, **kw)
        mp.setattr(MaskedSparseAttention, branch, spy)
    try:
        before = _run(live, frames)
    finally:
        mp.undo()
    live.reset()
    blob = export.export_streaming_detector(live)
    art = export.ExportedStreamingDetector(blob)
    return dict(name=request.param, jcfg=jcfg, variables=variables, live=live, frames=frames,
                before=before, taken=dict(taken), artifact=art, got=_run(art, frames))


def test_frames_drive_every_predicate_both_ways(artifact):
    """Each layer that chooses takes its true branch (gather or kernel) at
    one frame and the masked branch at another."""
    true_branch = CONFIGS[artifact["name"]][2]
    layers = _choosing_layers(artifact["live"])
    assert len(layers) == 8
    for layer in layers:
        seen = artifact["taken"][layer]
        assert len(seen) == FRAMES and set(seen) == {true_branch, "masked"}, (layer, seen)


def test_graph_has_one_cond_per_choosing_layer(artifact):
    """One ``torch.ops.higher_order.cond`` node per layer that chooses, and
    it survives ``torch.export.save`` / ``load`` (the artifact was loaded
    from its bytes); kernel E's operator stands in the threshold
    artifact's branches; no tensor-metadata assertion is left in the graph
    or its branches (the export drops them)."""
    program = artifact["artifact"].program
    conds = [n for n in program.graph.nodes if n.target is torch.ops.higher_order.cond]
    assert len(conds) == len(_choosing_layers(artifact["live"]))
    nodes = [n for m in program.graph_module.modules() if isinstance(m, torch.fx.GraphModule)
             for n in m.graph.nodes]
    targets = {str(n.target) for n in nodes}
    assert ("sast_tpu_torch.sparse_block_fwd.default" in targets) == (
        artifact["name"].startswith("threshold"))
    asserts = torch.ops.aten._assert_tensor_metadata.default
    assert not any(n.target is asserts for n in nodes)


def test_artifact_is_the_live_detector_bit_for_bit(artifact):
    """Detections, telemetry and carried state of the loaded artifact equal
    the live detector's over the frames, bit for bit."""
    _assert_same(artifact["got"], artifact["before"], artifact["name"])


def test_artifact_matches_the_jax_artifact(artifact, monkeypatch):
    """The port's artifact against JAX's ``ExportedStreamingDetector`` of
    the same configuration, same weights and frames: validity, classes and
    selected-token telemetry exact; boxes and scores within 1e-4 absolute /
    1e-5 relative (fp32, another summation order), as
    tests/test_torch_export.py."""
    monkeypatch.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
    use_pallas = CONFIGS[artifact["name"]][1]
    jdet = JStreamingDetector(artifact["jcfg"], artifact["variables"], max_events=EVENTS,
                              num_streams=2, use_pallas=use_pallas)
    jart = JExported(j_export(jdet))
    outs, _ = artifact["got"]
    for i in range(FRAMES):
        oj = jax.device_get(jart.process_batch(artifact["frames"][i], reset=RESETS[i]))
        ot = outs[i]
        assert ot["valid"].all()
        for k in ("valid", "classes", "selected_tokens"):
            np.testing.assert_array_equal(ot[k], np.asarray(oj[k]), err_msg=f"frame {i} {k}")
        for k in ("boxes", "scores", "obj_conf", "cls_conf"):
            np.testing.assert_allclose(ot[k], np.asarray(oj[k]), rtol=1e-5, atol=1e-4,
                                       err_msg=f"frame {i} {k}")


def test_no_parameter_cast_in_the_graph_or_its_branches(artifact):
    """``export.parameter_casts``, which counts inside the cond nodes'
    branches, reads 0 on the loaded artifact: the casts of a parameter to
    its own dtype (fp32 here) are gone from the branches as from the
    graph."""
    assert export.parameter_casts(artifact["artifact"].program) == 0


def _top_level_casts(program):
    names = program.graph_signature.inputs_to_parameters
    return sum(1 for n in program.graph.nodes if n.op == "placeholder" and n.name in names
               for u in n.users if u.target is torch.ops.aten.to.dtype)


def test_baked_branches_in_bfloat16_keep_the_bits(monkeypatch):
    """bf16, the threshold configuration: the program exported without the
    bake casts parameters inside its branches, which ``parameter_casts``
    counts beside the graph's own; baked, it holds none, stores the
    matrices in bf16, gives each bias and LayerScale vector that the masked
    branch casts and the kernel branch reads in fp32 a bf16 twin, and its
    artifact, smaller, steps the live detector's bits over the frames."""
    attention, sparse_kernel, _ = CONFIGS["threshold-0.5"]
    cfg = _config(get_test_config, attention)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    live = StreamingDetector(cfg, build_detector(cfg.model, seed=0, device="cpu"), max_events=EVENTS,
                             num_streams=2, device="cpu", sparse_kernel=sparse_kernel)
    frames = _frames()
    want = _run(live, frames)
    live.reset()
    bake, programs = export.bake_compute_weights, []
    monkeypatch.setattr(export, "bake_compute_weights", lambda p: programs.append(p) or 0)
    unbaked = len(export.export_streaming_detector(live))
    (program,) = programs
    top = _top_level_casts(program)
    assert top > 0 and export.parameter_casts(program) > top
    assert bake(program) > 0
    assert export.parameter_casts(program) == 0
    kept = program.state_dict
    twins = [k for k in kept if k.endswith("_bfloat16")]
    assert twins and all(kept[k].dtype == torch.bfloat16 for k in twins)
    assert all(kept[k.removesuffix("_bfloat16")].dtype == torch.float32 for k in twins)
    assert all(kept[k].dtype == torch.bfloat16 for k in kept if k.endswith("qkv.kernel"))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    assert len(buf.getvalue()) < unbaked
    art = export.ExportedStreamingDetector(buf.getvalue())
    assert export.parameter_casts(art.program) == 0
    _assert_same(_run(art, frames), want, "bf16 threshold")

