"""Port vs JAX package: the streaming serving step end to end.

At the tests/test_serving.py geometry (gen1 native 240x304 events, model
resolution 256x320, partition (4, 5), tiny widths, fp32), the port's
``StreamingDetector`` on the CPU against ``sast_tpu.serving.
StreamingDetector`` on the same weights and events, and the port's lanes
against independent single streams.
"""

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
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.models.detector import YoloXDetector
from sast_tpu_torch.serving import StreamingDetector
from sast_tpu_torch.weights import load_jax_variables


def _serving_config(get_cfg):
    """The test_serving geometry; confidence threshold 0 so that every
    top-k candidate reaches NMS and the slates are full."""
    cfg = get_cfg()
    bb = dataclasses.replace(
        cfg.model.backbone, in_res_hw=(256, 320),
        attention=dataclasses.replace(cfg.model.backbone.attention, partition_size=(4, 5)),
    )
    pp = dataclasses.replace(cfg.model.postprocess, confidence_threshold=0.0)
    model = dataclasses.replace(cfg.model, backbone=bb, postprocess=pp)
    return dataclasses.replace(cfg, model=model)


def _frame(rng, i):
    n = rng.randint(300, 1200)
    return dict(
        x=rng.randint(0, 304, n), y=rng.randint(0, 240, n), p=rng.randint(0, 2, n),
        t=np.sort(rng.randint(0, 50_000, n)) + i * 50_000,
    )


@pytest.fixture(scope="module")
def served():
    jcfg = _serving_config(j_test_config)
    jmodel = JDetector(jcfg.model)
    x0 = jnp.zeros((1, 256, 320, 20), jnp.float32)
    variables = jax.device_get(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), x0, j_zero_states(jcfg.model.backbone, 1))
    )
    tcfg = _serving_config(get_test_config)

    def port_model():
        return load_jax_variables(YoloXDetector(tcfg.model), variables)

    return jcfg, variables, tcfg, port_model


def test_streaming_detector_matches_jax(served):
    """Three frames on two lanes, lane 1 reset at frame 2. Validity,
    classes and selected-token telemetry exact; boxes and scores within
    1e-4 absolute / 1e-5 relative (fp32, other summation order; boxes are
    pixels up to ~300)."""
    jcfg, variables, tcfg, port_model = served
    jdet = JStreamingDetector(jcfg, variables, max_events=4000, num_streams=2)
    tdet = StreamingDetector(tcfg, port_model(), max_events=4000, num_streams=2, device="cpu")
    rng = np.random.RandomState(1)
    for i in range(3):
        frames = [_frame(rng, i), _frame(rng, i)]
        reset = np.array([False, i == 2])
        oj = jdet.process_batch(frames, reset=reset)
        ot = tdet.process_batch(frames, reset=reset)
        assert ot["valid"].all()
        for k in ("valid", "classes", "selected_tokens"):
            np.testing.assert_array_equal(ot[k], np.asarray(oj[k]), err_msg=f"frame {i} {k}")
        for k in ("boxes", "scores", "obj_conf", "cls_conf"):
            np.testing.assert_allclose(
                ot[k], np.asarray(oj[k]), rtol=1e-5, atol=1e-4, err_msg=f"frame {i} {k}"
            )


def test_lanes_match_single_streams(served):
    """Two lanes in one step vs two single-stream detectors, with a
    mid-stream reset of lane 1 through the in-step mask (the singles reset
    on the host). Validity and classes exact; boxes and scores within
    1e-5 relative / 1e-4 absolute, since a batch of 2 and a batch of 1 may
    take other matmul and conv blockings on the CPU."""
    _, _, tcfg, port_model = served
    model = port_model()
    batched = StreamingDetector(tcfg, model, max_events=4000, num_streams=2, device="cpu")
    singles = [StreamingDetector(tcfg, model, max_events=4000, device="cpu") for _ in range(2)]
    rng = np.random.RandomState(2)
    lanes = [[_frame(rng, i) for i in range(3)] for _ in range(2)]
    for i in range(3):
        out_b = batched.process_batch([lanes[0][i], lanes[1][i]], reset=[False, i == 2])
        if i == 2:
            singles[1].reset()
        for lane, det in enumerate(singles):
            out_s = det.process_events(**lanes[lane][i])
            for k in ("valid", "classes"):
                np.testing.assert_array_equal(out_b[k][lane], out_s[k], err_msg=f"{i} {lane} {k}")
            for k in ("boxes", "scores"):
                np.testing.assert_allclose(
                    out_b[k][lane], out_s[k], rtol=1e-5, atol=1e-4, err_msg=f"{i} {lane} {k}"
                )


def test_entry_points_need_cuda_unless_cpu_is_asked(served):
    """No silent move to the CPU: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    from sast_tpu_torch.models.detector import build_detector

    _, _, tcfg, port_model = served
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingDetector(tcfg, port_model())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_detector(tcfg.model, seed=0)
    assert build_detector(tcfg.model, seed=0, device="cpu").head.cls_pred0.bias.device.type == "cpu"
