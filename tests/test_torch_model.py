"""Port vs JAX package: selection, attention, backbone, detector,
postprocess and the weight bridge, at the tiny test config in fp32.

One JAX init of the detector is shared by the module; the port loads the
same variables through ``weights.load_jax_variables``. Inputs are numpy
arrays from seeds, handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.models.backbone import zero_states as j_zero_states
from sast_tpu.models.detector import YoloXDetector as JDetector
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import YoloXDetector
from sast_tpu_torch.models.head import inference_outputs
from sast_tpu_torch.models.sast import MaskedSparseAttention
from sast_tpu_torch.ops.nms import postprocess
from sast_tpu_torch.ops.sparse import select_windows_and_tokens
from sast_tpu_torch.weights import load_jax_variables

B = 2


def _frames(seed, n=2):
    rng = np.random.RandomState(seed)
    shape = (B, 64, 96, 20)
    return [rng.poisson(0.3, shape).clip(0, 255).astype(np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    cfg = j_test_config()
    jmodel = JDetector(cfg.model)
    x0 = jnp.zeros((B, 64, 96, 20), jnp.uint8)
    variables = jax.device_get(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), x0, j_zero_states(cfg.model.backbone, B))
    )
    tmodel = load_jax_variables(YoloXDetector(get_test_config().model), variables).eval()
    return cfg, jmodel, variables, tmodel


def test_bridge_consumes_every_leaf_and_sets_every_tensor(models):
    """Round trip: load_jax_variables raises on any leftover, so a clean
    load is the check; then spot-check layouts and the strict refusals."""
    cfg, _, variables, tmodel = models
    p = variables["params"]
    np.testing.assert_array_equal(  # conv HWIO -> OIHW
        tmodel.backbone.stage1.downsample.Conv_0.kernel.detach().numpy(),
        p["backbone"]["stage1"]["downsample"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(  # dense (in, out) -> (out, in)
        tmodel.backbone.stage0.block0.win_attn.qkv.kernel.detach().numpy(),
        p["backbone"]["stage0"]["block0"]["win_attn"]["qkv"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        tmodel.fpn.C3_p4.BaseConv_0.BatchNorm_0.var.numpy(),
        variables["batch_stats"]["fpn"]["C3_p4"]["BaseConv_0"]["BatchNorm_0"]["var"],
    )
    fresh = YoloXDetector(get_test_config().model)
    extra = {"params": dict(p, extra={"w": np.zeros(3)}), "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_variables(fresh, extra)
    missing = {"params": {k: v for k, v in p.items() if k != "head"},
               "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="without a JAX leaf"):
        load_jax_variables(fresh, missing)


def test_selection_matches_jax():
    """fp32 softmax selection on random scores (no ties at the threshold):
    the masks agree exactly."""
    from sast_tpu.ops.sparse import select_windows_and_tokens as j_select

    rng = np.random.RandomState(0)
    scores = np.abs(rng.randn(2, 12, 30, 16)).astype(np.float32) * rng.rand(2, 12, 1, 1)
    scores = scores.astype(np.float32)
    wj, tj = j_select(jnp.asarray(scores), 1e-3)
    wt, tt = select_windows_and_tokens(torch.from_numpy(scores), 1e-3)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert 0 < wt.sum() < wt.numel() and 0 < tt.sum() < tt.numel()


def test_masked_attention_matches_jax():
    """The masked block in fp32 with LayerScale 0.5 (so the attention and
    MLP really move the output): 1e-5, fp32 matmuls summed in another
    order."""
    from sast_tpu.config import AttentionConfig
    from sast_tpu.models.sast import MaskedSparseAttention as JMSA

    acfg = AttentionConfig(partition_size=(2, 3), dim_head=16, ls_init_value=0.5)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 6, 32).astype(np.float32)
    keep = rng.rand(2, 5, 6) > 0.4
    jm = JMSA(dim=32, dim_head=16, ls_init_value=0.5, dtype=jnp.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(keep)))
    yj = jm.apply(v, jnp.asarray(x), jnp.asarray(keep))
    tm = load_jax_variables(MaskedSparseAttention(32, acfg), v)
    with torch.no_grad():
        yt = tm(torch.from_numpy(x), torch.from_numpy(keep))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    # Unselected tokens pass through as norm1(x): identical there.
    assert np.abs(yt.numpy() - x).max() > 0.1


def test_backbone_stages_and_telemetry_match_jax(models):
    """Two recurrent steps through the backbone (uint8 input, so the stem
    and fused density path run): stage features and LSTM cells within 1e-5
    (fp32, other summation order), selection telemetry P exact, which the
    tiny config allows (docs/PARITY.md: no threshold ties here)."""
    cfg, jmodel, variables, tmodel = models
    j_states = j_zero_states(cfg.model.backbone, B)
    t_states = zero_states(get_test_config().model.backbone, B)
    apply = jax.jit(lambda v, x, s: jmodel.apply(
        {"params": v["params"]}, x, s, method=JDetector.forward_backbone))
    for x in _frames(0):
        fj, j_states, pj = apply(variables, jnp.asarray(x), j_states)
        with torch.no_grad():
            ft, t_states, pt = tmodel.forward_backbone(torch.from_numpy(x), t_states)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        for s in fj:
            np.testing.assert_allclose(ft[s].numpy(), np.asarray(fj[s]), rtol=1e-5, atol=1e-5)
        for (hj, cj), (ht, ct) in zip(j_states, t_states):
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)


def test_detector_preds_match_jax(models):
    """Decoded predictions: boxes are pixels up to ~100 and go through exp,
    so 1e-5 relative plus 1e-4 absolute (fp32 rounding, other order)."""
    cfg, jmodel, variables, tmodel = models
    x = _frames(1, 1)[0]
    out_j, _, _ = jax.jit(jmodel.apply)(variables, jnp.asarray(x), j_zero_states(cfg.model.backbone, B))
    with torch.no_grad():
        out_t, _, _ = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(out_t["preds"].numpy(), np.asarray(out_j["preds"]), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(out_t["grids"].numpy(), np.asarray(out_j["grids"]))


def test_postprocess_matches_jax(models):
    """The same preds into both postprocesses: detections exact (validity,
    classes, boxes, scores). Synthetic preds with duplicate boxes of
    different classes, plus the detector's own preds with the confidence
    threshold at 0 so every top-k candidate reaches NMS."""
    from sast_tpu.ops.nms import postprocess as j_post

    cfg, jmodel, variables, tmodel = models
    rng = np.random.RandomState(0)
    synth = np.zeros((2, 300, 8), np.float32)
    synth[..., :2] = rng.uniform(50, 150, (2, 300, 2))
    synth[..., 2:4] = rng.uniform(10, 30, (2, 300, 2))
    synth[..., 4] = rng.rand(2, 300)
    synth[..., 5:] = rng.rand(2, 300, 3)
    synth[0, 1] = synth[0, 0]
    synth[0, 1, 5:] = synth[0, 0, 5:][::-1]
    x = _frames(2, 1)[0]
    with torch.no_grad():
        preds = inference_outputs(tmodel(torch.from_numpy(x))[0]["preds"]).numpy()
    cases = [(synth, 3, 0.1, 64, 16), (preds, 2, 0.0, 64, 16)]
    for p, n_cls, conf, topk, max_det in cases:
        kw = dict(num_classes=n_cls, conf_threshold=conf, nms_threshold=0.45,
                  pre_nms_topk=topk, max_detections=max_det)
        dj = jax.jit(lambda a: j_post(a, **kw))(jnp.asarray(p))
        dt = postprocess(torch.from_numpy(p), **kw)
        assert dt["valid"].any()
        for k in dj:
            np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]), err_msg=k)
