"""Port vs JAX package: the training step as a whole, the eval step, and
the trainer around them.

One JAX init of the tiny detector is carried into the port by
``load_jax_variables``; two train steps of ``make_train_step`` then run in
both packages on the same synthetic batches, on the masked path and on the
sparse-kernel path (JAX ``use_pallas`` with its Pallas kernels, forward and
backward, in interpret mode; the port with the kernels' plain versions, the
hand-written backward included). The JAX step is jitted once per path in a
module-scoped fixture; results are compared leaf by leaf through
``to_jax_variables``. fp32 on the CPU.
"""

import contextlib
import dataclasses
import json
from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.data.synthetic import synthetic_train_batch as j_synthetic_train_batch
from sast_tpu.models.backbone import zero_states as j_zero_states
from sast_tpu.training import steps as j_steps
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data.batch import split_device_batch, to_device
from sast_tpu_torch.data.synthetic import synthetic_train_batch
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import YoloXDetector
from sast_tpu_torch.ops import sparse_block
from sast_tpu_torch.training import steps as t_steps
from sast_tpu_torch.training.loop import Trainer
from sast_tpu_torch.weights import load_jax_variables, to_jax_variables

LR = 1e-3
STEPS = 2


def _cfg(get_cfg, **training):
    """The tiny test config with LayerScale 0.3 (so that attention shows in
    the loss), EMA, weight decay, a schedule that moves within two steps and
    a confidence threshold of 0 for the eval step; same edits on either
    package's config."""
    cfg = get_cfg()
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, ls_init_value=0.3))
    pp = dataclasses.replace(cfg.model.postprocess, confidence_threshold=0.0)
    tr = dataclasses.replace(
        cfg.training, ema_decay=0.9, weight_decay=0.01, learning_rate=LR, seed=0,
        remat_policy="full",
        lr_scheduler=dataclasses.replace(cfg.training.lr_scheduler, total_steps=10, pct_start=0.2),
    )
    tr = dataclasses.replace(tr, **training)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone=bb, postprocess=pp), training=tr)


@contextlib.contextmanager
def _interpret_pallas():
    orig = pl.pallas_call
    pl.pallas_call = partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


def _batches(cfg, n=STEPS):
    rng = np.random.RandomState(0)
    out = [synthetic_train_batch(cfg, rng) for _ in range(n)]
    out[1]["is_first"] = np.array([False, True])  # lane 0 carries its state on
    return out


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0].mu


@pytest.fixture(scope="module", params=["masked", "sparse"])
def run(request):
    """Two train steps in both packages; a snapshot after each."""
    sparse = request.param == "sparse"
    jcfg, tcfg = _cfg(j_test_config), _cfg(get_test_config)
    batches = _batches(tcfg)
    B = batches[0]["ev_repr"].shape[1]
    with _interpret_pallas():
        jstate, jmodel = j_steps.create_train_state(jcfg, jax.random.PRNGKey(0), use_pallas=sparse)
        variables0 = _numpy_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
        jstep = jax.jit(j_steps.make_train_step(jmodel, jcfg))
        jlstm = j_zero_states(jcfg.model.backbone, B)
        jsnaps = []
        for batch in batches:
            jstate, jlstm, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jlstm)
            jsnaps.append(_numpy_tree(dict(
                metrics=jmetrics, params=jstate.params, ema=jstate.ema_params,
                batch_stats=jstate.batch_stats, lstm=jlstm, mu=_adam_mu(jstate.opt_state))))

    tmodel = load_jax_variables(YoloXDetector(tcfg.model, sparse_kernel=sparse), variables0)
    tstate = t_steps.train_state_for(tmodel, tcfg)
    tstep = t_steps.make_train_step(tmodel, tcfg)
    tlstm = zero_states(tcfg.model.backbone, B)
    calls = {"forward": 0, "backward": 0}
    orig_run, orig_bwd = sparse_block._run, sparse_block.sparse_window_block_bwd

    def counted_run(*a, **k):
        calls["forward"] += 1
        return orig_run(*a, **k)

    def counted_bwd(*a, **k):
        calls["backward"] += 1
        return orig_bwd(*a, **k)

    # The CPU never launches a kernel, so count the wrappers' calls instead.
    sparse_block._run, sparse_block.sparse_window_block_bwd = counted_run, counted_bwd
    tsnaps = []
    try:
        for batch in batches:
            tstate, tlstm, tmetrics = tstep(tstate, to_device(split_device_batch(batch)[0], "cpu"), tlstm)
            tsnaps.append(dict(
                metrics={k: float(v) for k, v in tmetrics.items()},
                params=to_jax_variables(tmodel)["params"],
                batch_stats=to_jax_variables(tmodel)["batch_stats"],
                ema=to_jax_variables(tmodel, tensors=tstate.ema_params)["params"],
                grads=to_jax_variables(tmodel, grads=True)["params"],
                lstm=[tuple(s.numpy() for s in hc) for hc in tlstm]))
    finally:
        sparse_block._run, sparse_block.sparse_window_block_bwd = orig_run, orig_bwd
    T = batches[0]["ev_repr"].shape[0]
    return dict(sparse=sparse, jax=jsnaps, port=tsnaps, calls=calls, T=T, variables0=variables0,
                cfgs=(jcfg, tcfg), jmodel=jmodel)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, ref, rtol, atol, what):
    got, ref = _leaves(got), _leaves(ref)
    assert set(got) == set(ref), what
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {key}")


def test_losses_and_telemetry_match_jax(run):
    """Per step: the four loss terms within rtol 1e-4, ``num_fg`` and ``P``
    (counts) exact to fp32, the global and per-component gradient norms
    within rtol 1e-3."""
    for i in range(STEPS):
        jm, tm = run["jax"][i]["metrics"], run["port"][i]["metrics"]
        assert set(jm) == set(tm)
        for k in ("loss", "iou_loss", "conf_loss", "cls_loss"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=f"step {i} {k}")
        for k in ("num_fg", "P"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, err_msg=f"step {i} {k}")
        for k in jm:
            if k.startswith("grad_norm"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, err_msg=f"step {i} {k}")
        assert np.isfinite(tm["loss"]) and tm["grad_norm/backbone"] > 0


def test_first_step_gradients_match_jax_leaf_by_leaf(run):
    """The clipped gradients of step 1, read back from optax's first moment
    (mu = 0.1 * clip(g) after one update), against the port's ``.grad``s:
    rtol 2e-3, atol 1e-4 of the clip value 1 (the global norm is about 450;
    fp32 sums over the clip and the anchors run in other orders, on the
    sparse path the two-pass LayerNorm as well)."""
    ref = jax.tree.map(lambda m: m / 0.1, run["jax"][0]["mu"])
    _assert_trees_close(run["port"][0]["grads"], ref, 2e-3, 1e-4, "grad")
    flat = _leaves(ref)
    assert sum(np.abs(v).max() > 0 for v in flat.values()) > 0.9 * len(flat)


def test_updated_parameters_and_ema_match_jax(run):
    """After each step. Adam's first updates are +-lr per element whatever
    the gradient's size, so an element whose gradient is rounding noise may
    move by lr in either direction: atol is 2 lr per step taken (and a
    tenth of that for the EMA copy, decay 0.9), beside rtol 1e-4."""
    for i in range(STEPS):
        atol = 2 * LR * (i + 1)
        _assert_trees_close(run["port"][i]["params"], run["jax"][i]["params"], 1e-4, atol,
                            f"step {i} params")
        _assert_trees_close(run["port"][i]["ema"], run["jax"][i]["ema"], 1e-4, atol / 5,
                            f"step {i} ema")
    moved = _leaves(run["port"][1]["params"])
    start = _leaves(run["variables0"]["params"])
    assert all(np.abs(moved[k] - start[k]).max() > 0 for k in start)


def test_most_parameters_move_alike(run):
    """The share of elements that moved as in JAX within 5% of lr after the
    first step: the loose atol above does not hide a wrong update."""
    got, ref = _leaves(run["port"][0]["params"]), _leaves(run["jax"][0]["params"])
    close = sum(int((np.abs(got[k] - ref[k]) < 0.05 * LR).sum()) for k in ref)
    total = sum(v.size for v in ref.values())
    assert close / total > 0.99


def test_batch_stats_match_jax(run):
    """Running BatchNorm statistics after each training step: rtol 1e-3,
    atol 1e-5 (in step 2 the parameters before them differ by up to the
    tolerance above)."""
    for i in range(STEPS):
        _assert_trees_close(run["port"][i]["batch_stats"], run["jax"][i]["batch_stats"],
                            1e-3, 1e-5, f"step {i} batch_stats")
    assert np.abs(_leaves(run["port"][0]["batch_stats"])["['fpn']['C3_p3']['BaseConv_0']"
                                                         "['BatchNorm_0']['mean']"]).max() > 0


def test_carried_lstm_states_match_jax(run):
    """(h, c) per stage after each step: rtol 1e-3, atol 1e-4 (after step 2
    the parameters behind them differ by up to the tolerance above)."""
    for i in range(STEPS):
        for s, (jhc, thc) in enumerate(zip(run["jax"][i]["lstm"], run["port"][i]["lstm"])):
            for name, a, b in zip("hc", thc, jhc):
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                           err_msg=f"step {i} stage {s} {name}")


def test_kernel_calls_per_step(run):
    """On the sparse path every attention layer runs the block wrapper in
    the forward and again in the recomputation (remat ``full``), and the
    hand-written backward once: 8 layers x T timesteps x steps."""
    layers = 8 * run["T"] * STEPS
    expected = {"forward": 2 * layers, "backward": layers} if run["sparse"] else \
        {"forward": 0, "backward": 0}
    assert run["calls"] == expected


def test_eval_step_matches_jax(run):
    """``make_eval_step`` on the initial variables, on the fixture's
    attention path: detections of both as sets (ordered by box: equal scores may come in either order); validity
    and classes exact, boxes and scores within 1e-4."""
    jcfg, tcfg = run["cfgs"]
    batch = _batches(tcfg)[0]
    B = batch["ev_repr"].shape[1]
    jeval = jax.jit(j_steps.make_eval_step(run["jmodel"], jcfg))
    variables = jax.tree.map(jnp.asarray, run["variables0"])
    with _interpret_pallas():
        jstates, jdets = jeval(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                               j_zero_states(jcfg.model.backbone, B))
    tmodel = load_jax_variables(YoloXDetector(tcfg.model, sparse_kernel=run["sparse"]),
                                run["variables0"])
    tstates, tdets = t_steps.make_eval_step(tmodel, tcfg)(
        to_device(split_device_batch(batch)[0], "cpu"), zero_states(tcfg.model.backbone, B))

    def by_box(d):
        d = {k: np.asarray(v) for k, v in d.items()}
        order = [np.lexsort(np.round(b, 2).T[::-1]) for b in d["boxes"]]
        return {k: np.stack([lane[o] for lane, o in zip(v, order)]) for k, v in d.items()}

    jd, td = by_box(jdets), by_box(tdets)
    frame_valid = batch["frame_valid"].reshape(-1)
    assert td["valid"][frame_valid].all() and not td["valid"][~frame_valid].any()
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=1e-4, err_msg=k)
    for (th, tc), (jh, jc) in zip(tstates, jstates):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The port alone


def _one_step(cfg, sparse_kernel=False, seed=1):
    model = YoloXDetector(cfg.model, sparse_kernel=sparse_kernel)
    from sast_tpu_torch.models.detector import init_weights

    init_weights(model, torch.Generator().manual_seed(seed))
    state = t_steps.train_state_for(model, cfg)
    batch = to_device(_batches(cfg)[0], "cpu")
    B = batch["ev_repr"].shape[1]
    _, lstm, metrics = t_steps.make_train_step(model, cfg)(
        state, batch, zero_states(cfg.model.backbone, B))
    return model, lstm, metrics


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_policies_give_the_same_step(policy):
    """``remat_policy`` changes what is kept for the backward, not the
    result: loss equal, gradients within 1e-6 of ``full``'s."""
    ref_model, _, ref = _one_step(_cfg(get_test_config), sparse_kernel=True)
    model, _, got = _one_step(_cfg(get_test_config, remat_policy=policy), sparse_kernel=True)
    assert float(got["loss"]) == float(ref["loss"])
    for (name, a), (_, b) in zip(model.named_parameters(), ref_model.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6, msg=name)
    with pytest.raises(ValueError, match="remat_policy"):
        _one_step(_cfg(get_test_config, remat_policy="some"))


@pytest.mark.parametrize("rate", ["attention.drop_path", "attention.drop_mlp",
                                  "lstm.drop_cell_update"])
def test_nonzero_dropout_rate_raises_under_training(rate):
    """A stochastic regularizer trains through the train step, which gives
    the backbone its dropout key; a training forward with a non-zero rate
    and no key raises, naming the rate; serving does not read the rate."""
    cfg = _cfg(get_test_config)
    bb = cfg.model.backbone
    part, field = rate.split(".")
    bb = dataclasses.replace(bb, **{part: dataclasses.replace(getattr(bb, part), **{field: 0.1})})
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))
    _, _, metrics = _one_step(cfg)
    assert np.isfinite(float(metrics["loss"]))
    model = YoloXDetector(cfg.model)
    x = torch.zeros(1, 64, 96, 20, dtype=torch.uint8)
    with pytest.raises(ValueError, match=field):
        model.forward_backbone(x, deterministic=False)
    with torch.no_grad():
        model.forward_backbone(x)  # deterministic: the rate is not read


def test_synthetic_batches_equal_the_jax_generator():
    jcfg, tcfg = _cfg(j_test_config), _cfg(get_test_config)
    a = j_synthetic_train_batch(jcfg, np.random.RandomState(3), sparsity=0.8)
    b = synthetic_train_batch(tcfg, np.random.RandomState(3), sparsity=0.8)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert abs((b["ev_repr"] == 0).mean() - 0.8) < 0.01


def test_to_jax_variables_inverts_load_jax_variables(run):
    tcfg = run["cfgs"][1]
    model = load_jax_variables(YoloXDetector(tcfg.model), run["variables0"])
    back = to_jax_variables(model)
    ref = _leaves(run["variables0"])
    got = _leaves(back)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    grads = to_jax_variables(model, grads=True)
    assert set(grads) == {"params"}
    assert all(not v.any() for v in _leaves(grads).values())


def test_trainer_fit_on_the_cpu_and_refusals(tmp_path):
    """``Trainer.fit`` for three steps on synthetic batches (CPU, plain
    versions): finite loss, the schedule's rate of the last update, a JSONL
    row per logged step, a save at the end; and what is not ported raises."""
    cfg = _cfg(get_test_config)
    trainer = Trainer(cfg, str(tmp_path / "run"), log_every=1, sparse_kernel_train=True,
                      device="cpu")
    rng = np.random.RandomState(0)
    metrics = trainer.fit((synthetic_train_batch(cfg, rng) for _ in range(5)), max_steps=3)
    assert trainer.state.step == 3 and np.isfinite(metrics["train/loss"])
    assert metrics["train/lr"] == trainer.state.optimizer.schedule(2)
    rows = [json.loads(l) for l in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(k in rows[0] for k in ("train/loss", "train/SN", "train/step_time_s",
                                      "train/grad_norm/backbone"))
    batch = to_device(synthetic_train_batch(cfg, rng), "cpu")
    _, dets = trainer.eval_step(batch, trainer._zero_states(2))
    assert dets["boxes"].shape == (4, cfg.model.postprocess.max_detections, 4)
    with pytest.raises(NotImplementedError):
        Trainer(cfg, str(tmp_path / "no"), device="cpu", use_wandb=True)
    with pytest.raises(TypeError, match="Mesh"):  # a mesh is parallel.mesh.make_mesh()'s
        Trainer(cfg, str(tmp_path / "no"), device="cpu", mesh=object())
    with_ckpt = Trainer(cfg, str(tmp_path / "ckpt"), val_every=10, ckpt_every=5, device="cpu")
    assert (with_ckpt.val_every, with_ckpt.ckpt_every) == (10, 5)
    # The three steps ended with a save; no batch, no step: nothing more to
    # validate or save.
    assert trainer.fit([], eval_loader_fn=lambda: []) == {}
    assert trainer.ckpt.all_steps() == [3] and trainer.ckpt.metrics(3) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(cfg, str(tmp_path / "no"))


def test_fit_starts_every_call_from_zero_states(tmp_path):
    """Two ``fit`` calls in a row, one step each, give the parameters of one
    ``fit`` step followed by a ``train_step`` from zero LSTM states: JAX's
    ``fit`` starts every call from zero states (``lstm = None``). Lane 0 of
    the second batch is not a sequence start, so a state carried over from
    the first call would show. The same CPU arithmetic on both sides:
    exact. The first call passes ``max_steps`` by position, in JAX's
    order."""
    cfg = _cfg(get_test_config)
    batches = _batches(cfg)
    assert not batches[1]["is_first"][0]
    twice = Trainer(cfg, str(tmp_path / "twice"), device="cpu")
    twice.fit([batches[0]], None, 1)
    twice.fit([batches[1]], max_steps=2)
    ref = Trainer(cfg, str(tmp_path / "ref"), device="cpu")
    ref.fit([batches[0]], max_steps=1)
    B = batches[1]["ev_repr"].shape[1]
    ref.state, _, _ = ref.train_step(
        ref.state, to_device(split_device_batch(batches[1])[0], "cpu"), ref._zero_states(B))
    assert twice.state.step == ref.state.step == 2
    for (name, a), (_, b) in zip(twice.model.named_parameters(), ref.model.named_parameters()):
        assert torch.equal(a, b), name


def test_fit_arguments_follow_the_jax_trainer(tmp_path):
    """``Trainer.fit`` takes the JAX trainer's arguments in its order, with
    its defaults, so a positional call means the same in both packages; a
    profiler window over no step records no trace."""
    import inspect

    from sast_tpu.training.loop import Trainer as JTrainer

    def shape(fn):
        return [(n, p.kind, p.default) for n, p in inspect.signature(fn).parameters.items()]

    assert shape(Trainer.fit) == shape(JTrainer.fit)
    trainer = Trainer(_cfg(get_test_config), str(tmp_path / "run"), device="cpu")
    assert trainer.fit([], eval_loader_fn=lambda: [], eval_max_batches=2) == {}
    assert trainer.fit([], profile_steps=(1, 2)) == {}
    assert not (tmp_path / "run" / "trace").exists()
