"""Port vs JAX package: the measurement library (``utils/benchmark.py``,
``utils/timers.py``) and the blocks' selection telemetry, at the tiny test
config in fp32 on the CPU.

Nothing here times the card: the timers are held on host spans, the slope
on sleeps, the rest on counts and values. One JAX init of the detector is
shared by the module; the port loads the same variables.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.models.backbone import zero_states as j_zero_states
from sast_tpu.models.detector import YoloXDetector as JDetector
from sast_tpu.utils import benchmark as j_bench
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import YoloXDetector
from sast_tpu_torch.models.layers import Dense
from sast_tpu_torch.ops import block, density, fused_block, nms_keep, sparse_block, stem_conv
from sast_tpu_torch.utils import benchmark, timers
from sast_tpu_torch.weights import load_jax_variables

ROOT = Path(__file__).resolve().parents[1]
HW = (64, 96)  # the test config's model resolution


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models(_one_torch_thread):
    cfg = j_test_config()
    jmodel = JDetector(cfg.model)
    x0 = jnp.zeros((1, *HW, 20), jnp.uint8)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), x0, j_zero_states(cfg.model.backbone, 1)))
    tcfg = get_test_config()
    tmodel = load_jax_variables(YoloXDetector(tcfg.model), variables).eval()
    return cfg, jmodel, variables, tcfg, tmodel


def _clustered(seed, batch=1):
    """Events in one blob of the frame: most windows see none, so the
    selection drops them."""
    rng = np.random.RandomState(seed)
    x = np.zeros((batch, *HW, 20), np.uint8)
    x[:, 4:28, 8:40] = rng.poisson(2.0, (batch, 24, 32, 20)).clip(0, 255)
    return x


# -- timers -------------------------------------------------------------------

def test_timers_record_spans_and_reset_empties_the_registry():
    """The counterpart of tests/test_utils.py's timer test: host spans, a
    DeviceTimer over CPU tensors (nothing to wait for), the dummy; reset
    empties the registry."""
    with timers.Timer("unit_test_timer"):
        time.sleep(0.01)
    with timers.DeviceTimer("unit_test_device", block_on={"a": [torch.ones(4)]}):
        pass
    with timers.TimerDummy("ignored"):
        pass
    stats = timers.timer_stats()
    assert stats["unit_test_timer"]["count"] == 1 and stats["unit_test_timer"]["mean_ms"] >= 10
    assert stats["unit_test_device"]["count"] == 1 and "ignored" not in stats
    timers.reset()
    assert timers.timer_stats() == {}


def test_chip_smoke_last_line_stays_last_after_a_timer():
    """A process that timed something prints the timer table at exit;
    ``chip_smoke.print_result`` empties the registry first, so its ok line
    stays the last line of stdout."""
    prog = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            "from sast_tpu_torch.utils.timers import Timer\n"
            "with Timer('t'): pass\n{tail}")
    def run(tail):
        out = subprocess.run([sys.executable, "-c", prog.format(root=str(ROOT), tail=tail)],
                             capture_output=True, text=True, timeout=120, check=True)
        return out.stdout.strip().splitlines()

    assert "Timing statistics" in run("print('last')")[-2]  # the table would come after
    lines = run("chip_smoke.print_result([], 'H100, 700 W', 'NVIDIA H100 80GB HBM3', 1)")
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert lines[-2] == "H100, 700 W" and not any("Timing" in line for line in lines)


def test_slope_time_validates_and_measures():
    """The counterpart of tests/test_utils.py's slope test: degenerate chunk
    lengths raise, and a fixed cost plus a linear part gives the slope."""
    for L1, L2 in ((10, 10), (10, 5), (0, 5)):
        with pytest.raises(ValueError, match="L1 < L2"):
            benchmark.slope_time(lambda L: lambda: None, L1=L1, L2=L2)
    per_iter = 2e-3

    def make_fn(L):
        return lambda: time.sleep(0.01 + per_iter * L)

    dt = benchmark.slope_time(make_fn, L1=5, L2=25, blocks=2)
    assert abs(dt - per_iter) < per_iter * 0.5


def test_compute_fps_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        benchmark.compute_fps(get_test_config(), device="cpu")


# -- selection telemetry and its MACs -------------------------------------------

def _jax_telemetry(models, x):
    cfg, jmodel, variables, _, _ = models
    (_, _, p), tel = jax.jit(lambda v, x, s: jmodel.apply(
        v, x, s, method=JDetector.forward_backbone, mutable=["telemetry"]))(
        variables, jnp.asarray(x), j_zero_states(cfg.model.backbone, x.shape[0]))
    return jax.device_get(tel["telemetry"]), np.asarray(p)


def _port_telemetry(models, x):
    _, _, _, tcfg, tmodel = models
    tel = {}
    with torch.no_grad():
        _, _, p = tmodel.forward_backbone(
            torch.from_numpy(x), zero_states(tcfg.model.backbone, x.shape[0]), telemetry=tel)
    return tel, p.numpy()


def _flat(tree, prefix=""):
    """{"backbone/stage0/block0/sel_win/0": array, ...} of nested dicts and
    tuples (JAX's collection, or the port's dict)."""
    if isinstance(tree, tuple):
        items = enumerate(tree)
    elif hasattr(tree, "items"):
        items = tree.items()
    else:
        return {prefix: tree}
    return {k: v for key, sub in items for k, v in _flat(sub, f"{prefix}/{key}").items()}


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.int32 and tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_selection_telemetry_matches_jax(models, seed):
    """``sel_win`` and ``sel_grid`` of every block, nested as JAX's mutable
    ``telemetry`` collection, equal exactly, on a clustered input whose
    selection drops windows; the outputs are those of a call without it."""
    x = _clustered(seed, batch=2)
    jtel, jp = _jax_telemetry(models, x)
    ttel, tp = _port_telemetry(models, x)
    _assert_same_tree(ttel, jtel)
    np.testing.assert_array_equal(tp, jp)
    tcfg, tmodel = models[3], models[4]
    with torch.no_grad():
        _, _, p = tmodel.forward_backbone(torch.from_numpy(x), zero_states(tcfg.model.backbone, 2))
    np.testing.assert_array_equal(p.numpy(), tp)
    stats = [t[0].numpy() for stage in ttel["backbone"].values() for blk in stage.values()
             for t in blk.values()]
    ph, pw = models[3].model.backbone.attention.partition_size
    n_windows = (HW[0] // 4 // ph) * (HW[1] // 4 // pw)  # stage 1
    assert stats[0][:, 0].max() < n_windows  # stage 1 kept fewer windows than it has
    assert all(s.shape == (2, 3) for s in stats)


@pytest.mark.parametrize("seed", [0, 3])
def test_transformer_macs_from_telemetry_match_jax(models, seed):
    cfg, _, _, tcfg, _ = models
    x = _clustered(seed)
    jtel, _ = _jax_telemetry(models, x)
    ttel, _ = _port_telemetry(models, x)
    got = benchmark.transformer_macs_from_telemetry(tcfg, ttel)
    assert got == j_bench.transformer_macs_from_telemetry(cfg, jtel)
    assert 0 < got["gflops_transformer"] and got["t_eff_total"] > 0


# -- the timed chunk -----------------------------------------------------------

def test_streaming_chunk_matches_jax(models):
    """Two chained frames, fp32, B 2: ``acc`` and the carried states within
    the model parity tolerance (rtol 1e-5, atol 1e-4)."""
    cfg, jmodel, variables, tcfg, tmodel = models
    x = np.random.RandomState(5).poisson(0.3, (2, *HW, 20)).clip(0, 255).astype(np.uint8)
    jst, jacc = j_bench.streaming_chunk(jmodel, 2)(
        variables, jnp.asarray(x), j_zero_states(cfg.model.backbone, 2))
    tst, tacc = benchmark.streaming_chunk(tmodel, 2)(
        torch.from_numpy(x), zero_states(tcfg.model.backbone, 2))
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-5, atol=1e-4)
    for (hj, cj), (ht, ct) in zip(jst, tst):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-4)
    # With detect, the frame also runs decode and NMS; the states do not move.
    tst2, tacc2 = benchmark.streaming_chunk(tmodel, 2, detect=True)(
        torch.from_numpy(x), zero_states(tcfg.model.backbone, 2))
    assert all(torch.equal(a, b) for hc, hc2 in zip(tst, tst2) for a, b in zip(hc, hc2))
    assert torch.isfinite(tacc2) and tacc2 >= tacc  # scores are not negative


# -- FLOP counts -------------------------------------------------------------------

def test_flops_of_one_dense_by_hand():
    d = Dense(48, 80)
    x = torch.randn(3, 7, 48)
    flops, n_bytes = benchmark.count_flops_and_bytes(d, x)
    assert flops == 2 * (3 * 7) * 48 * 80
    assert n_bytes >= 4 * (x.numel() + 48 * 80 + 3 * 7 * 80)


def _count(fn, *args):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return counter.get_total_flops()


def _block_case(M=6, hw=20, C=32, heads=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    inner = 64
    params = {
        "ln2_scale": torch.ones(C), "ln2_bias": torch.zeros(C),
        "wqkv": torch.randn(C, 3 * C, generator=g), "bqkv": torch.zeros(3 * C),
        "wproj": torch.randn(C, C, generator=g), "bproj": torch.zeros(C),
        "ls1": torch.full((C,), 0.1), "wglu": torch.randn(C, 2 * inner, generator=g),
        "bglu": torch.zeros(2 * inner), "wout": torch.randn(inner, C, generator=g),
        "bout": torch.zeros(C), "ls2": torch.full((C,), 0.1)}
    y = torch.randn(M, hw, C, generator=g)
    token_keep = torch.rand(M, hw, generator=g) > 0.3
    win_keep = torch.tensor([True, False] * (M // 2))
    return y, token_keep, win_keep, params, heads, C // heads


def test_each_operator_formula_counts_its_plain_version():
    """Each kernel operator's registered formula gives what
    ``FlopCounterMode`` counts of its plain version at full window density:
    the conv for A, nothing for B and C, the dense block for D, E and F
    (whatever share of windows is kept)."""
    x = torch.from_numpy(np.random.RandomState(0).poisson(0.5, (2, 64, 96, 20)).astype(np.uint8))
    w = torch.randn(32, 20, 7, 7)
    assert _count(stem_conv.stem_conv7x4, x, w) == _count(stem_conv.stem_conv7x4_plain, x, w) > 0
    assert _count(stem_conv.stem_conv7x4, x, w, True) == _count(stem_conv.stem_conv7x4_plain, x, w)
    assert _count(density.density_ratio, x) == _count(density.density_ratio_plain, x) == 0
    boxes = torch.rand(2, 50, 4) * 50
    boxes[..., 2:] += boxes[..., :2]
    scores = torch.rand(2, 50).sort(dim=1, descending=True).values
    assert _count(nms_keep.greedy_keep, boxes, scores, 0.5) == _count(
        nms_keep.greedy_keep_plain, boxes, scores, 0.5) == 0

    y, tk, wk, params, heads, dh = _block_case()
    dense = _count(block.block_window_plain, y, tk, params, heads, dh)
    every = torch.ones_like(wk)
    assert dense > 0
    assert _count(fused_block.fused_window_block, y, tk, params, heads, dh) == dense
    assert _count(fused_block.fused_block_plain, y, tk, params, heads, dh) == dense
    for fn in (sparse_block.sparse_window_block, sparse_block.sparse_window_block_looped):
        assert _count(fn, y, tk, wk, params, heads, dh) == dense
    assert _count(sparse_block.sparse_window_block_plain, y, tk, every, params, heads, dh) == dense


def test_compute_flops_is_one_count_on_every_path():
    """The tiny detector at batch 1 reads one GFLOP count on every path:
    the plain torch ops, the kernels' operators and their formulas."""
    cfg = get_test_config()
    got = {p: benchmark.compute_flops(cfg, path=p, device="cpu") for p in benchmark.PATHS}
    assert len({g["gflops_total"] for g in got.values()}) == 1, got
    assert all(g["gflops_total"] > 0 and g["bytes_accessed_mb"] > 0 for g in got.values())
    with pytest.raises(ValueError, match="not one of"):
        benchmark.path_config(cfg, "gather")


def test_cli_scripts_refuse_to_run_without_a_card():
    for script in ("bench_torch.py", "scripts/benchmark_torch.py"):
        out = subprocess.run([sys.executable, str(ROOT / script)], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and out.stdout == "", script
        assert "cuda.is_available() is false" in out.stderr, script


def test_per_sample_rows_match_jax_telemetry(models):
    """``scripts/benchmark_torch.py --per-sample``'s rows on the CPU: the
    port's telemetry MACs of each sample equal JAX's on the same weights."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("benchmark_torch",
                                                  ROOT / "scripts" / "benchmark_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg, _, _, tcfg, _ = models
    samples = [(f"s{i}", _clustered(i)) for i in range(2)]
    rows = cli.per_sample_rows(tcfg, samples, "cpu")
    for (name, x), row in zip(samples, rows):
        jtel, jp = _jax_telemetry(_with_seed0_weights(models), x)
        want = j_bench.transformer_macs_from_telemetry(cfg, jtel)
        assert row["sample"] == name and row["p_tokens"] == [int(v) for v in jp]
        assert row["gflops_transformer"] == round(want["gflops_transformer"], 4)


def _with_seed0_weights(models):
    """The JAX detector with the weights of the port's seed-0 detector
    (``build_detector(seed=0)``, which the per-sample rows use)."""
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.weights import to_jax_variables

    cfg, jmodel, _, tcfg, _ = models
    variables = to_jax_variables(build_detector(tcfg.model, seed=0, device="cpu"))
    return cfg, jmodel, variables, tcfg, None
