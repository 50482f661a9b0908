"""The port's deployment artifact (``sast_tpu_torch/export.py``) on the CPU.

At the tests/test_export.py geometry (gen1 240x304 events, model resolution
256x320, partition (4, 5), tiny widths, fp32; two lanes here, confidence
threshold 0 so that the slates are full): the port's artifact against the
JAX package's artifact on the same weights and frames, against the live
detector it was traced from, the live detector after the trace, the
artifact's own signature, a loader that imports no model code, and
``torch.library.opcheck`` on each operator. The configurations whose layers
choose a branch on the card are in tests/test_torch_export_cond.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.export import ExportedStreamingDetector as JExported
from sast_tpu.export import export_streaming_detector as j_export
from sast_tpu.models.backbone import zero_states as j_zero_states
from sast_tpu.models.detector import YoloXDetector as JDetector
from sast_tpu.serving import StreamingDetector as JStreamingDetector
from sast_tpu_torch import export
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.models.detector import YoloXDetector
from sast_tpu_torch.ops import block
from sast_tpu_torch.serving import StreamingDetector
from sast_tpu_torch.weights import load_jax_variables
from tests.test_torch_serving import _frame, _serving_config

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 3
EVENTS = 4000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores; torch's own pool in each would oversubscribe them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_variables(jcfg):
    """The JAX detector's variables from ``PRNGKey(0)``, as numpy."""
    x0 = jnp.zeros((1, 256, 320, 20), jnp.float32)
    return jax.device_get(jax.jit(JDetector(jcfg.model).init)(
        jax.random.PRNGKey(0), x0, j_zero_states(jcfg.model.backbone, 1)))


def _frames():
    rng = np.random.RandomState(1)
    return [[_frame(rng, i), _frame(rng, i)] for i in range(FRAMES)]


RESETS = [np.array([False, i == 2]) for i in range(FRAMES)]


def _run(det, frames):
    """Outputs of each frame, and the carried state after the last."""
    outs = [det.process_batch(frames[i], reset=RESETS[i]) for i in range(FRAMES)]
    return outs, [t.clone() for t in pytree.tree_leaves(det.states)]


def _caches(det):
    """What the live model keeps between calls: the position embeddings and
    the anchor grids."""
    model = det.model
    held = [t for i in range(4) for t in getattr(model.backbone, f"stage{i}")._pos.values()]
    return held + [t for pair in model.head._grids.values() for t in pair]


@pytest.fixture(scope="module")
def exported(_one_torch_thread, tmp_path_factory):
    """A reference detector's outputs; a second detector on the same weights
    traced into an artifact on disk before it ever steps, what its caches
    hold after the trace, and its outputs after the trace; the loaded
    artifact's outputs."""
    jcfg = _serving_config(j_test_config)
    variables = _jax_variables(jcfg)
    tcfg = _serving_config(get_test_config)

    def detector():
        model = load_jax_variables(YoloXDetector(tcfg.model), variables)
        return StreamingDetector(tcfg, model, max_events=EVENTS, num_streams=2, device="cpu")

    frames = _frames()
    before = _run(detector(), frames)
    live = detector()
    path = tmp_path_factory.mktemp("artifact")
    blob = export.export_streaming_detector(live, path=str(path))
    cached_by_trace = _caches(live)
    after = _run(live, frames)
    artifact = export.ExportedStreamingDetector(str(path))
    return dict(jcfg=jcfg, variables=variables, live=live, path=path, blob=blob, frames=frames,
                before=before, after=after, cached_by_trace=cached_by_trace,
                artifact=artifact, got=_run(artifact, frames))


def _assert_same(a, b, what):
    (outs_a, states_a), (outs_b, states_b) = a, b
    for i, (oa, ob) in enumerate(zip(outs_a, outs_b)):
        assert set(oa) == set(ob)
        for k in oa:
            np.testing.assert_array_equal(oa[k], ob[k], err_msg=f"{what}: frame {i} {k}")
    assert len(states_a) == len(states_b)
    for i, (sa, sb) in enumerate(zip(states_a, states_b)):
        assert sa.dtype == sb.dtype and torch.equal(sa, sb), f"{what}: state leaf {i}"


def test_artifact_matches_the_jax_artifact(exported):
    """The port's artifact against JAX's ``ExportedStreamingDetector`` on the
    same weights and frames, lane 1 reset at frame 2. Validity, classes and
    selected-token telemetry exact; boxes and scores within 1e-4 absolute /
    1e-5 relative (fp32, another summation order; boxes are pixels up to
    ~300), as tests/test_torch_serving.py."""
    jdet = JStreamingDetector(exported["jcfg"], exported["variables"], max_events=EVENTS,
                              num_streams=2)
    jart = JExported(j_export(jdet))
    outs, _ = exported["got"]
    for i in range(FRAMES):
        oj = jart.process_batch(exported["frames"][i], reset=RESETS[i])
        ot = outs[i]
        assert ot["valid"].all()
        for k in ("valid", "classes", "selected_tokens"):
            np.testing.assert_array_equal(ot[k], np.asarray(oj[k]), err_msg=f"frame {i} {k}")
        for k in ("boxes", "scores", "obj_conf", "cls_conf"):
            np.testing.assert_allclose(ot[k], np.asarray(oj[k]), rtol=1e-5, atol=1e-4,
                                       err_msg=f"frame {i} {k}")


def test_artifact_is_the_live_detector_bit_for_bit(exported):
    """Detections, telemetry and the carried state of the loaded artifact
    equal the live detector's, bit for bit; loading from the returned bytes
    gives the same program."""
    _assert_same(exported["got"], exported["before"], "artifact")
    assert (exported["path"] / export.ARTIFACT_NAME).read_bytes() == exported["blob"]
    again = export.ExportedStreamingDetector(exported["blob"])
    _assert_same(_run(again, exported["frames"]), exported["before"], "from bytes")


def test_live_detector_is_unchanged_by_the_export(exported):
    """Tracing leaves the live detector as it was: nothing is cached from
    inside the trace, and the detector then steps bit for bit as one that
    was never traced; its caches hold real tensors."""
    assert exported["cached_by_trace"] == []
    _assert_same(exported["after"], exported["before"], "live after export")
    held = _caches(exported["live"])
    assert held and all(type(t) is torch.Tensor for t in held)


def test_artifact_describes_itself(exported):
    """The event budget, the lane count, the device and the state's
    structure, shapes and dtypes come from the program's own signature; a
    reset zeroes the state. The graph holds no tensor-metadata assertion
    (the export drops them)."""
    art, live = exported["artifact"], exported["live"]
    assert (art.max_events, art.num_streams) == (EVENTS, 2)
    assert art.device == torch.device("cpu")
    assert pytree.tree_structure(art.states) == pytree.tree_structure(live.states)
    for a, b in zip(pytree.tree_leaves(art.states), pytree.tree_leaves(live.states)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    asserts = torch.ops.aten._assert_tensor_metadata.default
    assert not any(n.target is asserts for n in art.program.graph.nodes)
    fresh = export.ExportedStreamingDetector(exported["blob"])
    art.reset()
    for a, b in zip(pytree.tree_leaves(art.states), pytree.tree_leaves(fresh.states)):
        assert torch.equal(a, b) and not a.any()


def test_loader_imports_no_model_code(exported):
    """A fresh process that imports ``sast_tpu_torch.export`` alone loads the
    artifact and steps it (to the live detector's first frame) without any
    module of ``sast_tpu_torch.models``, ``training`` or ``data``."""
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from sast_tpu_torch.export import ExportedStreamingDetector\n"
        "det = ExportedStreamingDetector(sys.argv[1])\n"
        "frames = np.load(sys.argv[2], allow_pickle=True)\n"
        "out = det.process_batch(list(frames))\n"
        "bad = [m for m in sys.modules if m.startswith(('sast_tpu_torch.models', "
        "'sast_tpu_torch.training', 'sast_tpu_torch.data'))]\n"
        "assert not bad, bad\n"
        "np.save(sys.argv[3], out['boxes'])\n"
    )
    frames = np.empty(2, dtype=object)
    frames[:] = exported["frames"][0]
    np.save(exported["path"] / "frames.npy", frames)
    boxes = exported["path"] / "boxes.npy"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code, str(exported["path"]),
                           str(exported["path"] / "frames.npy"), str(boxes)],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(np.load(boxes), exported["before"][0][0]["boxes"])


KERNEL_PATHS = {"sparse": (dict(), True, False, "sparse_block_fwd"),
                "looped": (dict(), True, True, "sparse_block_looped"),
                "fused": (dict(fused_block=True), False, False, "fused_block_fwd")}


@pytest.mark.parametrize("path", list(KERNEL_PATHS))
def test_kernel_paths_export_through_their_operators(exported, path, monkeypatch):
    """On the sparse, looped and fused attention paths (2 frames, after the
    live detector has stepped and filled its caches, ``kernel_params``
    among them): the block kernel's operator stands in the traced graph,
    the artifact equals the live detector bit for bit, and the live
    detector steps as before."""
    from sast_tpu_torch.ops import sparse_block

    attention, sparse_kernel, looped, op = KERNEL_PATHS[path]
    monkeypatch.setattr(sparse_block, "MODEL_USES_LOOPED", looped)
    cfg = _serving_config(get_test_config)
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, **attention))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))
    model = load_jax_variables(YoloXDetector(cfg.model), exported["variables"])
    live = StreamingDetector(cfg, model, max_events=EVENTS, num_streams=2, device="cpu",
                             sparse_kernel=sparse_kernel)
    frames = exported["frames"][:2]
    run = lambda det: [det.process_batch(f) for f in frames]  # noqa: E731
    before = run(live)
    live.reset()
    art = export.ExportedStreamingDetector(export.export_streaming_detector(live))
    targets = {str(n.target) for n in art.program.graph.nodes if n.op == "call_function"}
    assert f"sast_tpu_torch.{op}.default" in targets, sorted(targets)
    live.reset()
    for outs in (run(live), run(art)):
        for a, b in zip(outs, before):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path} {k}")


def _params(C, inner, gen):
    shapes = {"ln2_scale": (C,), "ln2_bias": (C,), "wqkv": (C, 3 * C), "bqkv": (3 * C,),
              "wproj": (C, C), "bproj": (C,), "ls1": (C,), "wglu": (C, 2 * inner),
              "bglu": (2 * inner,), "wout": (inner, C), "bout": (C,), "ls2": (C,)}
    return [torch.randn(shapes[k], generator=gen) * 0.2 for k in block.PARAM_KEYS]


def _op_cases():
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((1, 32, 32, 4), generator=g) < 0.2).to(torch.uint8) * 3
    w = torch.randn((16, 4, 7, 7), generator=g)
    boxes = torch.rand((2, 6, 4), generator=g) * 10
    boxes[..., 2:] += boxes[..., :2]
    scores = torch.sort(torch.rand((2, 6), generator=g), dim=1, descending=True).values
    y = torch.randn((4, 6, 32), generator=g)
    keep = torch.rand((4, 6), generator=g) < 0.7
    win = torch.tensor([True, False, True, True])
    params = _params(32, 32, g)
    ops = torch.ops.sast_tpu_torch
    return {
        "stem_conv7x4": (ops.stem_conv7x4, (x, w)),
        "stem_conv_density7x4": (ops.stem_conv_density7x4, (x, w)),
        "density_ratio": (ops.density_ratio, (x,)),
        "greedy_keep": (ops.greedy_keep, (boxes, scores, 0.5)),
        "sparse_block_fwd": (ops.sparse_block_fwd, (y, keep, win, params, 2, 16, 1e-5, False)),
        "sparse_block_fwd-h1": (ops.sparse_block_fwd, (y, keep, win, params, 2, 16, 1e-5, True)),
        "fused_block_fwd": (ops.fused_block_fwd, (y, keep, params, 2, 16, 1e-5)),
        "sparse_block_looped": (ops.sparse_block_looped, (y, keep, win, params, 2, 16, 1e-5)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_operators_pass_opcheck_on_the_cpu(case):
    """``torch.library.opcheck`` on each operator's CPU implementation (the
    plain version) and its shape-only implementation, at tiny shapes: the
    schema, the fake tensors against the real ones, and the traced
    dispatch."""
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)
