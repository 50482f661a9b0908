"""Port vs JAX package: the attention execution paths and the serving step
on them.

The port's ``MaskedSparseAttention`` and ``StreamingDetector`` against the
JAX ones with the same switches (masked, sparse kernel at both density
thresholds, fused kernel, budget-gather, Context Broadcasting, token
masking), same weights through ``load_jax_variables``, same seeded numpy
inputs, fp32 on the CPU. The JAX package's Pallas kernels run in interpret
mode, patched as its own tests/test_model.py patches them; its fused path
falls back to XLA off the TPU, which is its CPU reference. The port's
wrappers run their plain versions on CPU tensors.
"""

import dataclasses
from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.models.backbone import zero_states as j_zero_states
from sast_tpu.models.detector import YoloXDetector as JDetector
from sast_tpu.models.sast import MaskedSparseAttention as JMSA
from sast_tpu.serving import StreamingDetector as JStreamingDetector
from sast_tpu_torch.config import AttentionConfig, get_test_config
from sast_tpu_torch.models.detector import YoloXDetector
from sast_tpu_torch.models.sast import MaskedSparseAttention
from sast_tpu_torch.serving import StreamingDetector
from sast_tpu_torch.weights import load_jax_variables

B, N, HW, C, DH = 2, 5, 6, 32, 16


@pytest.fixture
def interpret():
    """Run every Pallas call of the JAX package in interpret mode."""
    orig = pl.pallas_call
    pl.pallas_call = partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


# name -> (JAX module switches, port AttentionConfig switches, port sparse_kernel)
PATHS = {
    "masked": (dict(), dict(), False),
    "sparse-1.0": (dict(use_pallas=True, pallas_threshold=1.0),
                   dict(pallas_density_threshold=1.0), True),
    "sparse-0.4": (dict(use_pallas=True, pallas_threshold=0.4),
                   dict(pallas_density_threshold=0.4), True),
    "fused": (dict(fused=True), dict(fused_block=True), False),
    "gather-0.5": (dict(gather_budget=0.5), dict(gather_budget=0.5), False),
    "gather-1.0": (dict(gather_budget=1.0), dict(gather_budget=1.0), False),
    "cb": (dict(enable_cb=True), dict(enable_cb=True), False),
    "cb-sparse": (dict(enable_cb=True, use_pallas=True), dict(enable_cb=True), True),
}


def _masks(density, seed):
    """Window density ``density`` of B * N = 10 windows (3 or 7 kept), one
    kept window with a single kept token."""
    rng = np.random.RandomState(seed)
    win = np.zeros(B * N, bool)
    win[rng.permutation(B * N)[: int(round(density * B * N))]] = True
    win = win.reshape(B, N)
    tok = (rng.rand(B, N, HW) > 0.4) & win[..., None]
    b, n = np.argwhere(win)[0]
    tok[b, n] = False
    tok[b, n, 2] = True
    win &= tok.any(-1)
    return win, tok


@pytest.mark.parametrize("density", [0.3, 0.7])
@pytest.mark.parametrize("path", list(PATHS))
def test_attention_paths_match_jax(interpret, path, density):
    """Each execution path against the JAX module with the same switches,
    below and above the 0.4 / 0.5 dispatch points. LayerScale 0.5 so that the
    block moves its input. rtol 2e-4, atol 2e-5: the kernel paths take a
    two-pass LayerNorm and other summation orders."""
    j_kw, t_kw, sparse_kernel = PATHS[path]
    rng = np.random.RandomState(5)
    x = rng.randn(B, N, HW, C).astype(np.float32)
    win, tok = _masks(density, 6)
    jm = JMSA(dim=C, dim_head=DH, ls_init_value=0.5, dtype=jnp.float32, **j_kw)
    v = jax.device_get(JMSA(dim=C, dim_head=DH, ls_init_value=0.5, dtype=jnp.float32).init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(tok), jnp.asarray(win)))
    yj = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(tok), jnp.asarray(win)))
    acfg = AttentionConfig(partition_size=(2, 3), dim_head=DH, ls_init_value=0.5, **t_kw)
    tm = load_jax_variables(MaskedSparseAttention(C, acfg, sparse_kernel=sparse_kernel), v)
    with torch.no_grad():
        yt = tm(torch.from_numpy(x), torch.from_numpy(tok), torch.from_numpy(win)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=2e-4, atol=2e-5)
    assert np.abs(yt[tok] - x[tok]).max() > 0.1
    if not path.startswith("cb"):  # all paths compute one function
        ref = JMSA(dim=C, dim_head=DH, ls_init_value=0.5, dtype=jnp.float32)
        yr = np.asarray(ref.apply(v, jnp.asarray(x), jnp.asarray(tok), jnp.asarray(win)))
        np.testing.assert_allclose(yt, yr, rtol=2e-4, atol=2e-5)


def _serving_config(get_cfg, masking=False, **attention):
    """The tests/test_serving.py geometry (gen1 native 240x304, model
    256x320, partition (4, 5)); confidence threshold 0 so that every top-k
    candidate reaches NMS; LayerScale 0.3 so that the attention path shows
    in the detections."""
    cfg = get_cfg()
    bb = dataclasses.replace(
        cfg.model.backbone, in_res_hw=(256, 320), enable_masking=masking,
        attention=dataclasses.replace(cfg.model.backbone.attention, partition_size=(4, 5),
                                      ls_init_value=0.3, **attention),
    )
    pp = dataclasses.replace(cfg.model.postprocess, confidence_threshold=0.0)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb, postprocess=pp))


def _frame(rng, i):
    n = rng.randint(300, 1200)
    return dict(
        x=rng.randint(0, 304, n), y=rng.randint(0, 240, n), p=rng.randint(0, 2, n),
        t=np.sort(rng.randint(0, 50_000, n)) + i * 50_000,
    )


def _by_box(out):
    """Each lane's slate reordered by its boxes (rounded to 0.01 px)."""
    order = [np.lexsort(np.round(b, 2).T[::-1]) for b in out["boxes"]]
    return {k: v if k == "selected_tokens" else np.stack([lane[o] for lane, o in zip(v, order)])
            for k, v in out.items()}


SERVING = {
    "sparse": (dict(), True, False),
    "fused": (dict(fused_block=True), False, False),
    "gather": (dict(gather_budget=0.5), False, False),
    "token-mask": (dict(), False, True),
}


@pytest.mark.parametrize("path", list(SERVING))
def test_streaming_detector_paths_match_jax(interpret, path):
    """Three frames on two lanes, lane 1 reset at frame 2, on each serving
    switch: ``sparse_kernel=True`` against JAX ``use_pallas=True``,
    ``attention.fused_block``, ``attention.gather_budget`` and the
    token-mask path (``enable_masking``) against JAX with the same
    configuration. Validity, classes and selected-token telemetry exact;
    boxes and scores within 1e-4 absolute / 1e-4 relative (fp32; the kernel
    paths take other summation orders and a two-pass LayerNorm)."""
    attention, sparse_kernel, masking = SERVING[path]
    jcfg = _serving_config(j_test_config, masking, **attention)
    tcfg = _serving_config(get_test_config, masking, **attention)
    jmodel = JDetector(jcfg.model)
    x0 = jnp.zeros((1, 256, 320, 20), jnp.float32)
    init_args = (x0, j_zero_states(jcfg.model.backbone, 1))
    if masking:
        init_args += (jnp.zeros((1, 64, 80), bool),)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), *init_args))
    if masking:
        assert "mask_token" in variables["params"]["backbone"]["stage0"]
    tmodel = load_jax_variables(YoloXDetector(tcfg.model), variables)
    jdet = JStreamingDetector(jcfg, variables, max_events=4000, num_streams=2,
                              use_pallas=sparse_kernel)
    tdet = StreamingDetector(tcfg, tmodel, max_events=4000, num_streams=2, device="cpu",
                             sparse_kernel=sparse_kernel)
    rng = np.random.RandomState(1)
    for i in range(3):
        frames = [_frame(rng, i), _frame(rng, i)]
        reset = np.array([False, i == 2])
        oj = {k: np.asarray(v) for k, v in jdet.process_batch(frames, reset=reset).items()}
        ot = tdet.process_batch(frames, reset=reset)
        assert ot["valid"].all()
        if masking:
            # Anchors over the mask-token border give detections with equal
            # scores, which the two packages may order either way: compare
            # the slates as sets, ordered by box.
            oj, ot = _by_box(oj), _by_box(ot)
        for k in ("valid", "classes", "selected_tokens"):
            np.testing.assert_array_equal(ot[k], np.asarray(oj[k]), err_msg=f"frame {i} {k}")
        for k in ("boxes", "scores", "obj_conf", "cls_conf"):
            np.testing.assert_allclose(
                ot[k], np.asarray(oj[k]), rtol=1e-4, atol=1e-4, err_msg=f"frame {i} {k}"
            )


def test_sparse_kernel_switch_reaches_every_attention_layer():
    """``StreamingDetector(sparse_kernel=...)`` sets the switch on the model
    it is given, as the JAX runtime builds its model with ``use_pallas``."""
    tcfg = _serving_config(get_test_config)
    model = YoloXDetector(tcfg.model)
    layers = [m for m in model.modules() if isinstance(m, MaskedSparseAttention)]
    assert len(layers) == 8 and not any(m.sparse_kernel for m in layers)
    StreamingDetector(tcfg, model, max_events=100, device="cpu", sparse_kernel=True)
    assert all(m.sparse_kernel for m in layers)
    assert all(m.sparse_kernel for m in YoloXDetector(tcfg.model, sparse_kernel=True).modules()
               if isinstance(m, MaskedSparseAttention))
