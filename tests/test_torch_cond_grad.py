"""Port vs JAX package: the gradient of an attention layer that chooses its
branch from the scene, and training through such layers.

Under ``jax.grad`` JAX's ``lax.cond`` (sast_tpu/models/sast.py, the gather
budget's ``n_win <= K`` and the density threshold's float32 test) takes its
backward on the same predicate as its forward. The port's counterpart is
``models/sast._Choice``: ``graphs.choose`` over the two branches forward,
and over their vector-Jacobian products backward, on the saved predicate.
Here the port's ``MaskedSparseAttention`` and JAX's (its Pallas kernels in
interpret mode, as tests/test_torch_branch.py runs them) take the gradient
of one loss on the same weights and inputs, on both switches, with the
predicate true and false and at the float32 tie, and a trainer of each
choosing configuration, fed JAX's initial weights through
``weights.load_jax_variables``, takes two steps beside JAX's jitted
``train_step``.

Tolerances, fp32: the input's and every parameter's gradient within rtol
2e-4 + atol 2e-5 of the largest magnitude of that gradient (the two
packages sum the window products in other orders; the forward is held to
rtol 2e-4, atol 2e-5 by tests/test_torch_branch.py); the train steps'
losses within rtol 1e-4, as tests/test_torch_training.py holds them.
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
from sast_tpu.models.sast import MaskedSparseAttention as JMSA
from sast_tpu.training import steps as j_steps
from sast_tpu_torch import graphs
from sast_tpu_torch.config import AttentionConfig, get_test_config
from sast_tpu_torch.data.batch import split_device_batch
from sast_tpu_torch.models.detector import YoloXDetector
from sast_tpu_torch.models.sast import MaskedSparseAttention
from sast_tpu_torch.training import steps as t_steps
from sast_tpu_torch.weights import load_jax_variables, to_jax_variables
from tests.test_torch_branch import B, C, DH, HW, N, _masks
from tests.test_torch_training import _batches, _cfg, _interpret_pallas, _numpy_tree

THRESHOLD = (dict(use_pallas=True, pallas_threshold=0.5), dict(pallas_density_threshold=0.5), True)
GATHER = (dict(gather_budget=0.5), dict(gather_budget=0.5), False)

# name -> (JAX switches, port switches, sparse_kernel, kept windows of M = 10,
# JAX takes its first branch)
CASES = {
    "gather-0.5-kept-5": (*GATHER, 5, True),
    "gather-0.5-kept-6": (*GATHER, 6, False),
    "threshold-0.5-kept-4": (*THRESHOLD, 4, True),
    "threshold-0.5-kept-5-tie": (*THRESHOLD, 5, True),
    "threshold-0.5-kept-6": (*THRESHOLD, 6, False),
    "threshold-0.3-kept-3-tie": (dict(use_pallas=True, pallas_threshold=0.3),
                                 dict(pallas_density_threshold=0.3), True, 3, True),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5 * scale, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_choice_gradient_is_jax_grad_through_cond(case, monkeypatch):
    """``jax.grad`` of ``sum(layer(x) * up)`` through JAX's ``lax.cond``
    against the port's autograd through ``_Choice``: the same branch taken
    forward and backward (spies on JAX's predicate and on the port's two
    ``graphs.choose`` calls), and the gradients of ``x`` and of every
    parameter within the module docstring's tolerance."""
    j_kw, t_kw, sparse_kernel, kept, jax_first = CASES[case]
    monkeypatch.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
    preds = []
    cond = jax.lax.cond

    def spy_cond(pred, *args, **kw):
        preds.append(bool(pred))
        return cond(pred, *args, **kw)

    monkeypatch.setattr(jax.lax, "cond", spy_cond)
    rng = np.random.RandomState(7)
    x = rng.randn(B, N, HW, C).astype(np.float32)
    up = rng.randn(B, N, HW, C).astype(np.float32)
    win, tok = _masks(kept, 6)
    assert win.sum() == kept
    masks = (jnp.asarray(tok), jnp.asarray(win))
    jlayer = JMSA(dim=C, dim_head=DH, ls_init_value=0.5, dtype=jnp.float32, **j_kw)
    v = jax.device_get(JMSA(dim=C, dim_head=DH, ls_init_value=0.5, dtype=jnp.float32).init(
        jax.random.PRNGKey(1), jnp.asarray(x), *masks))

    def loss(params, xj):
        return jnp.sum(jlayer.apply({"params": params}, xj, *masks) * up)

    jgrad_p, jgrad_x = jax.device_get(jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x)))
    assert preds == [jax_first]

    acfg = AttentionConfig(partition_size=(2, 3), dim_head=DH, ls_init_value=0.5, **t_kw)
    layer = load_jax_variables(MaskedSparseAttention(C, acfg, sparse_kernel=sparse_kernel), v)
    taken = []
    choose = graphs.choose

    def spy_choose(pred, *args, **kw):
        taken.append(bool(pred))
        return choose(pred, *args, **kw)

    monkeypatch.setattr(graphs, "choose", spy_choose)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt, torch.from_numpy(tok), torch.from_numpy(win))
    (out * torch.from_numpy(up)).sum().backward()
    assert taken == [jax_first, jax_first]  # the forward's choice, then the backward's
    _close(xt.grad.numpy(), np.asarray(jgrad_x), "x")
    got = to_jax_variables(layer, grads=True)["params"]
    ref = {jax.tree_util.keystr(p): np.asarray(g)
           for p, g in jax.tree_util.tree_leaves_with_path(jgrad_p)}
    got = {jax.tree_util.keystr(p): np.asarray(g)
           for p, g in jax.tree_util.tree_leaves_with_path(got)}
    assert set(got) == set(ref)
    for key in ref:
        _close(got[key], ref[key], key)


@pytest.mark.parametrize("attention, sparse", [
    (dict(gather_budget=0.5), False),
    (dict(pallas_density_threshold=0.5), True),
], ids=["gather", "threshold"])
def test_choosing_trainer_is_jax_train_step(attention, sparse, monkeypatch):
    """Two steps of the port's ``CapturedTrainStep`` body (eager on the CPU:
    the code a card captures) on a choosing configuration, from JAX's
    initial weights, against JAX's jitted ``train_step``: the four loss
    terms within rtol 1e-4 per step; every attention layer chooses
    (``chooses_in_training``), forward, in the recomputation and backward
    (a spy on ``graphs.choose``)."""
    def choosing(get_cfg):
        cfg = _cfg(get_cfg)
        bb = cfg.model.backbone
        bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, **attention))
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))

    jcfg, tcfg = choosing(j_test_config), choosing(get_test_config)
    batches = _batches(tcfg)
    lanes = batches[0]["ev_repr"].shape[1]
    with _interpret_pallas():
        jstate, jmodel = j_steps.create_train_state(jcfg, jax.random.PRNGKey(0), use_pallas=sparse)
        variables0 = _numpy_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
        jstep = jax.jit(j_steps.make_train_step(jmodel, jcfg))
        jlstm = j_zero_states(jcfg.model.backbone, lanes)
        jlosses = []
        for batch in batches:
            jstate, jlstm, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jlstm)
            jlosses.append({k: float(jm[k]) for k in ("loss", "iou_loss", "conf_loss", "cls_loss")})

    tmodel = load_jax_variables(YoloXDetector(tcfg.model, sparse_kernel=sparse), variables0)
    layers = [m for m in tmodel.modules() if isinstance(m, MaskedSparseAttention)]
    assert layers and all(m.chooses_in_training() for m in layers)
    tstate = t_steps.train_state_for(tmodel, tcfg)
    run = t_steps.CapturedTrainStep({"train": t_steps.make_train_step(tmodel, tcfg)}, tstate,
                                    tcfg, "cpu", graph=True)
    calls = {"forward": 0, "backward": 0}
    choose = graphs.choose

    def spy_choose(pred, true_fn, false_fn, operands, label="a choice"):
        calls["backward" if label.startswith("the backward of") else "forward"] += 1
        return choose(pred, true_fn, false_fn, operands, label)

    monkeypatch.setattr(graphs, "choose", spy_choose)
    for i, batch in enumerate(batches):
        metrics = run(split_device_batch(batch)[0])
        for k, want in jlosses[i].items():
            np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-4, err_msg=f"step {i} {k}")
    # remat "full": each layer's forward and its recomputation, then its backward
    T = batches[0]["ev_repr"].shape[0]
    steps = len(batches)
    assert calls == {"forward": 2 * steps * T * len(layers), "backward": steps * T * len(layers)}
