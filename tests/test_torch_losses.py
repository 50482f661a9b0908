"""Port vs JAX package: SimOTA assignment, YOLOX loss, learning-rate
schedule, optimizer update and BatchNorm training statistics.

Same numpy-seeded inputs through both; fp32 on the CPU. The JAX assignment
is one frame ``vmap``ped, the port's carries the frame axis itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from sast_tpu.config import LRSchedulerConfig as JLRSchedulerConfig
from sast_tpu.config import TrainingConfig as JTrainingConfig
from sast_tpu.models import losses as j_losses
from sast_tpu.training import optimizer as j_optimizer
from sast_tpu_torch.config import LRSchedulerConfig, TrainingConfig
from sast_tpu_torch.models import losses as t_losses
from sast_tpu_torch.models.head import build_grids
from sast_tpu_torch.models.layers import BatchNorm
from sast_tpu_torch.training import optimizer as t_optimizer

F_, G, NCLS = 5, 8, 3
LEVELS, STRIDES = ((8, 12), (4, 6), (2, 3)), (8, 16, 32)


def _scene(seed, ties=False):
    """Decoded predictions scattered around the anchors, ground truth with
    padding, one padding frame, one frame without boxes. With ``ties`` every
    prediction of a level is identical up to its anchor's shift and two
    boxes coincide, so that costs tie and the tie rules decide."""
    rng = np.random.RandomState(seed)
    grids, strides = build_grids(LEVELS, STRIDES)
    A = grids.shape[0]
    centers = (grids + 0.5) * strides[:, None]
    noise = 0.0 if ties else 1.0
    xy = centers[None] + noise * rng.randn(F_, A, 2) * strides[None, :, None] * 0.3
    wh = strides[None, :, None] * (3.0 + noise * rng.rand(F_, A, 2) * 3.0)
    logits = (noise * rng.randn(F_, A, 1 + NCLS) * 2.0 - 1.0).astype(np.float32)
    preds = np.concatenate([xy, wh, logits], axis=-1).astype(np.float32)
    gt_boxes = np.zeros((F_, G, 4), np.float32)
    gt_classes = np.zeros((F_, G), np.int32)
    gt_valid = np.zeros((F_, G), bool)
    for f in range(F_):
        n = 0 if f == 3 else rng.randint(1, 6)
        w, h = rng.uniform(10, 40, n), rng.uniform(10, 30, n)
        if ties:  # box centres on anchor centres, so distances and IoUs repeat
            idx = rng.choice(96, n, replace=False)
            cx, cy = centers[idx, 0], centers[idx, 1]
        else:
            cx, cy = rng.uniform(w / 2, 96 - w / 2), rng.uniform(h / 2, 64 - h / 2)
        gt_boxes[f, :n] = np.stack([cx, cy, w, h], -1)
        gt_classes[f, :n] = rng.randint(0, NCLS, n)
        gt_valid[f, :n] = True
    if ties:
        gt_boxes[0, 1], gt_valid[0, 1], gt_classes[0, 1] = gt_boxes[0, 0], True, gt_classes[0, 0]
    frame_valid = np.array([True, True, False, True, True])
    return preds, grids, strides, gt_boxes, gt_classes, gt_valid, frame_valid


@pytest.mark.parametrize("scene", ["random-0", "random-1", "ties"])
def test_simota_assign_matches_jax(scene):
    """fg_mask exact; targets and counts to fp32 rounding."""
    preds, grids, strides, gb, gc, gv, fv = _scene({"random-0": 0, "random-1": 1, "ties": 2}[scene],
                                                   ties=scene == "ties")
    gv = gv & fv[:, None]
    ref = jax.vmap(lambda bp, ol, cl, b, c, v: j_losses.simota_assign(
        bp, ol, cl, b, c, v, jnp.asarray(grids), jnp.asarray(strides), NCLS, 10))(
        jnp.asarray(preds[..., :4]), jnp.asarray(preds[..., 4]), jnp.asarray(preds[..., 5:]),
        jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gv))
    t = torch.from_numpy
    got = t_losses.simota_assign(t(preds[..., :4]), t(preds[..., 4]), t(preds[..., 5:]), t(gb),
                                 t(gc), t(gv), t(grids), t(strides), NCLS, 10)
    np.testing.assert_array_equal(got["fg_mask"].numpy(), np.asarray(ref["fg_mask"]))
    assert got["fg_mask"].sum() > 5
    fg = got["fg_mask"].numpy()
    np.testing.assert_allclose(got["reg_target"].numpy()[fg], np.asarray(ref["reg_target"])[fg],
                               rtol=0, atol=0)
    np.testing.assert_allclose(got["cls_target"].numpy(), np.asarray(ref["cls_target"]),
                               rtol=1e-6, atol=1e-7)
    for k in ("num_fg", "num_gt"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("seed", [0, 1])
def test_yolox_loss_and_gradient_match_jax(seed):
    """Every loss term within rtol 1e-5; the gradient of the loss wrt the
    predictions within rtol 1e-4 / atol 1e-7 (sums over 126 anchors x 5
    frames in another order)."""
    preds, grids, strides, gb, gc, gv, fv = _scene(seed)

    def j_loss(p):
        return j_losses.yolox_loss(p, jnp.asarray(grids), jnp.asarray(strides), jnp.asarray(gb),
                                   jnp.asarray(gc), jnp.asarray(gv), jnp.asarray(fv), NCLS, 10)

    ref = j_loss(jnp.asarray(preds))
    gref = np.asarray(jax.grad(lambda p: j_loss(p)["loss"])(jnp.asarray(preds)))
    t = torch.from_numpy
    tp = t(preds).requires_grad_()
    got = t_losses.yolox_loss(tp, t(grids), t(strides), t(gb), t(gc), t(gv), t(fv), NCLS, 10)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5, err_msg=k)
    got["loss"].backward()
    np.testing.assert_allclose(tp.grad.numpy(), gref, rtol=1e-4, atol=1e-7)
    assert np.abs(gref[2]).max() == 0 and tp.grad[2].abs().max() == 0  # the padding frame


def test_loss_elementwise_pieces_match_jax():
    rng = np.random.RandomState(3)
    a = np.abs(rng.randn(6, 4)).astype(np.float32) * 20 + 1
    b = np.abs(rng.randn(9, 4)).astype(np.float32) * 20 + 1
    t = torch.from_numpy
    np.testing.assert_allclose(t_losses.bboxes_iou_cxcywh(t(a), t(b)).numpy(),
                               np.asarray(j_losses.bboxes_iou_cxcywh(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_losses.iou_loss(t(a), t(b[:6])).numpy(),
                               np.asarray(j_losses.iou_loss(jnp.asarray(a), jnp.asarray(b[:6]))),
                               rtol=1e-6, atol=1e-7)
    x, y = rng.randn(50).astype(np.float32) * 5, rng.rand(50).astype(np.float32)
    np.testing.assert_allclose(t_losses.bce_with_logits(t(x), t(y)).numpy(),
                               np.asarray(j_losses.bce_with_logits(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-6, atol=1e-7)


SCHEDULES = {
    "test-config": dict(total_steps=100, pct_start=0.05, div_factor=20.0, final_div_factor=1e4),
    "short-warmup": dict(total_steps=37, pct_start=0.005, div_factor=25.0, final_div_factor=1e3),
    "half": dict(total_steps=24, pct_start=0.5, div_factor=10.0, final_div_factor=50.0),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax_exactly(name):
    """Every step of a short run, and a few past its end, bit for bit in
    fp32."""
    kw = SCHEDULES[name]
    ref = j_optimizer.build_schedule(JTrainingConfig(
        learning_rate=2e-4, lr_scheduler=JLRSchedulerConfig(**kw)), 3e-4)
    got = t_optimizer.build_schedule(TrainingConfig(
        learning_rate=2e-4, lr_scheduler=LRSchedulerConfig(**kw)), 3e-4)
    for step in range(kw["total_steps"] + 5):
        assert np.float32(got(step)) == np.float32(ref(step)), step
    assert got(0) < got(max(int(kw["total_steps"] * kw["pct_start"]), 1))


def test_constant_schedule_and_lr_scaling():
    cfg = TrainingConfig(learning_rate=2e-4, lr_scheduler=LRSchedulerConfig(use=False))
    assert np.float32(t_optimizer.build_schedule(cfg)(7)) == np.float32(2e-4)
    assert t_optimizer.scale_lr_for_global_batch(2e-4, 32) == j_optimizer.scale_lr_for_global_batch(2e-4, 32)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_updates_match_optax(weight_decay):
    """Four updates of clip-by-value + AdamW on random leaves, gradients up
    to 3 (so the clip bites): parameters within rtol 1e-5 / atol 1e-7."""
    rng = np.random.RandomState(4)
    sched = dict(total_steps=6, pct_start=0.34, div_factor=4.0, final_div_factor=20.0)
    jcfg = JTrainingConfig(learning_rate=1e-2, weight_decay=weight_decay,
                           lr_scheduler=JLRSchedulerConfig(**sched))
    tcfg = TrainingConfig(learning_rate=1e-2, weight_decay=weight_decay,
                          lr_scheduler=LRSchedulerConfig(**sched))
    p0 = {"a": rng.randn(7, 5).astype(np.float32), "b": rng.randn(11).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 1.5).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    tx = j_optimizer.build_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = t_optimizer.build_optimizer(tcfg, tp.values())
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        lr = opt.step()
        assert np.float32(lr) == np.float32(j_optimizer.build_schedule(jcfg)(i))
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"step {i} {k}")
    assert opt.count == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_statistics_match_flax(dtype):
    """Batch statistics (biased variance), the normalised output and the
    momentum-0.9 running statistics after two calls; then inference mode."""
    rng = np.random.RandomState(5)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    xs = [(rng.randn(3, 4, 5, 6) * 2 + 1).astype(np.float32) for _ in range(2)]
    scale, bias = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    tbn = BatchNorm(6, dtype=tdt)
    with torch.no_grad():
        tbn.scale.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    tbn.use_batch_stats = True
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=2 ** -6)
    for x in xs:
        xin = jnp.asarray(x).astype(jdt)
        yj, mutated = jbn.apply(variables, xin, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        yt = tbn(torch.from_numpy(x).to(tdt))
        assert yt.dtype == tdt
        np.testing.assert_allclose(yt.detach().float().numpy(), np.asarray(yj.astype(jnp.float32)),
                                   **tol)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(tbn, k).numpy(),
                                       np.asarray(variables["batch_stats"][k]), rtol=1e-5, atol=1e-6)
    tbn.use_batch_stats = False
    jeval = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jdt)
    yj = jeval.apply(variables, jnp.asarray(xs[0]).astype(jdt))
    np.testing.assert_allclose(tbn(torch.from_numpy(xs[0]).to(tdt)).detach().float().numpy(),
                               np.asarray(yj.astype(jnp.float32)), **tol)
