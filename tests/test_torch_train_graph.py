"""The train and eval steps on static buffers (``training/steps.
CapturedTrainStep`` and ``CapturedEvalStep``), the optimizer's count and
rate on the device, the dropout masks hashed there, and ``Trainer(graph=)``
(CPU, tiny config, fp32).

A card captures these bodies as CUDA graphs (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 12); the CPU runs the same bodies eagerly, and here
they are held against JAX's jitted ``train_step`` over three consecutive
steps and its ``eval_step`` over two batches, on the masked and the
sparse-kernel paths, at ``tests/test_torch_training.py``'s tolerances.

Each train step of the port starts from JAX's state after the step before
(parameters, BatchNorm statistics, EMA copy, Adam's moments and count, the
LSTM states), written into the tensors the body keeps: left to run free,
fp32 rounding that AdamW turns into steps of +-lr compounds, and by the
third step single loss terms stand 3.4e-4 (IoU) and 8.2e-4 (classes) apart
in relative terms, as far as with the earlier ``torch.optim.AdamW``
update (3.5e-4 and 8.4e-4), beyond the 1e-4 that a step from one state
holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sast_tpu.config import get_test_config as j_test_config
from sast_tpu.models.backbone import zero_states as j_zero_states
from sast_tpu.training import optimizer as j_optimizer
from sast_tpu.training import steps as j_steps
from sast_tpu_torch import graphs
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data import device_cache
from sast_tpu_torch.data.batch import split_device_batch
from sast_tpu_torch.data.module import DataModule
from sast_tpu_torch.models.detector import YoloXDetector, build_detector
from sast_tpu_torch.models.layers import DropoutKey
from sast_tpu_torch.parallel import mesh as dp
from sast_tpu_torch.training import optimizer as t_optimizer
from sast_tpu_torch.training import steps as t_steps
from sast_tpu_torch.training.loop import Trainer
from sast_tpu_torch.weights import load_jax_variables, to_jax_variables
from tests.test_torch_training import (
    LR,
    _assert_trees_close,
    _batches,
    _cfg,
    _interpret_pallas,
    _numpy_tree,
)

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _three_batches(cfg):
    out = _batches(cfg, STEPS)
    out[2]["is_first"] = np.array([True, False])  # lane 1 carries its state on
    return out


def _storage(run, state):
    """The data pointers of everything the captured step keeps in place."""
    tensors = [t for hc in run.states for t in hc] + list(run.buffers.tensors.values())
    tensors += state.optimizer.tensors() + list(state.ema_params.values())
    tensors += list(state.model.parameters()) + list(state.model.buffers())
    return [t.data_ptr() for t in tensors]


def _adam(opt_state):
    """optax's ``ScaleByAdamState`` (mu, nu, count) inside ``opt_state``."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


@torch.no_grad()
def _start_from(snap, count, run, state, cfg):
    """Write JAX's state after ``count`` steps (``snap``) into the port's
    model, EMA copy, optimizer and LSTM state buffers, in place."""
    load_jax_variables(state.model, {"params": snap["params"],
                                     "batch_stats": snap["batch_stats"]})
    opt = state.optimizer
    scratch = YoloXDetector(cfg.model)
    names = [name for name, _ in state.model.named_parameters()]
    for tree, into in ((snap["ema"], [state.ema_params[n] for n in names]),
                       (snap["mu"], [opt.adamw.state[p]["exp_avg"] for p in opt.params]),
                       (snap["nu"], [opt.adamw.state[p]["exp_avg_sq"] for p in opt.params])):
        load_jax_variables(scratch, {"params": tree, "batch_stats": snap["batch_stats"]})
        for t, p in zip(into, scratch.parameters()):
            t.copy_(p)
    opt.count = count
    opt.adamw.count.fill_(float(count))
    for hc, jhc in zip(run.states, snap["lstm"]):
        for t, j in zip(hc, jhc):
            t.copy_(torch.from_numpy(np.asarray(j)))


@pytest.fixture(scope="module", params=["masked", "sparse"])
def stepped(request):
    """Three train steps in both packages, JAX's jitted, the port's the body
    of ``CapturedTrainStep`` on its buffers, each from JAX's state after the
    step before (module docstring); a snapshot after each."""
    sparse = request.param == "sparse"
    jcfg, tcfg = _cfg(j_test_config), _cfg(get_test_config)
    batches = _three_batches(tcfg)
    B = batches[0]["ev_repr"].shape[1]
    with _interpret_pallas():
        jstate, jmodel = j_steps.create_train_state(jcfg, jax.random.PRNGKey(0), use_pallas=sparse)
        variables0 = _numpy_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
        jstep = jax.jit(j_steps.make_train_step(jmodel, jcfg))
        jlstm = j_zero_states(jcfg.model.backbone, B)
        jsnaps = []
        for batch in batches:
            jstate, jlstm, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                            jlstm)
            adam = _adam(jstate.opt_state)
            jsnaps.append(_numpy_tree(dict(
                metrics=jmetrics, params=jstate.params, ema=jstate.ema_params,
                batch_stats=jstate.batch_stats, lstm=jlstm, mu=adam.mu, nu=adam.nu)))

    tmodel = load_jax_variables(YoloXDetector(tcfg.model, sparse_kernel=sparse), variables0)
    tstate = t_steps.train_state_for(tmodel, tcfg)
    run = t_steps.CapturedTrainStep({"train": t_steps.make_train_step(tmodel, tcfg)}, tstate,
                                    tcfg, "cpu", graph=True)
    tsnaps, storage = [], []
    for i, batch in enumerate(batches):
        if i:
            _start_from(jsnaps[i - 1], i, run, tstate, tcfg)
        metrics = run(split_device_batch(batch)[0])
        tsnaps.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            params=to_jax_variables(tmodel)["params"],
            batch_stats=to_jax_variables(tmodel)["batch_stats"],
            ema=to_jax_variables(tmodel, tensors=tstate.ema_params)["params"],
            lstm=[tuple(s.clone().numpy() for s in hc) for hc in run.states]))
        storage.append(_storage(run, tstate))
    return dict(sparse=sparse, jax=jsnaps, port=tsnaps, storage=storage, run=run, state=tstate,
                batches=batches, variables0=variables0, cfgs=(jcfg, tcfg), jmodel=jmodel)


def test_captured_body_losses_match_jax(stepped):
    """Per step: the four loss terms within rtol 1e-4, ``num_fg`` and ``P``
    within 1e-6, the gradient norms within rtol 1e-3."""
    for i in range(STEPS):
        jm, tm = stepped["jax"][i]["metrics"], stepped["port"][i]["metrics"]
        assert set(jm) == set(tm)
        for k in ("loss", "iou_loss", "conf_loss", "cls_loss"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=f"step {i} {k}")
        for k in ("num_fg", "P"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, err_msg=f"step {i} {k}")
        for k in jm:
            if k.startswith("grad_norm"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, err_msg=f"step {i} {k}")


def test_captured_body_state_matches_jax(stepped):
    """After each step: parameters within rtol 1e-4 and 2 lr for the step
    taken, the EMA copy within a fifth of that, BatchNorm statistics within
    1e-3 / 1e-5, the carried LSTM states (the step's buffers) within 1e-3 /
    1e-4."""
    for i in range(STEPS):
        atol = 2 * LR
        jax_, port = stepped["jax"][i], stepped["port"][i]
        _assert_trees_close(port["params"], jax_["params"], 1e-4, atol, f"step {i} params")
        _assert_trees_close(port["ema"], jax_["ema"], 1e-4, atol / 5, f"step {i} ema")
        _assert_trees_close(port["batch_stats"], jax_["batch_stats"], 1e-3, 1e-5,
                            f"step {i} batch_stats")
        for s, (jhc, thc) in enumerate(zip(jax_["lstm"], port["lstm"])):
            for name, a, b in zip("hc", thc, jhc):
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                           err_msg=f"step {i} stage {s} {name}")


def test_captured_body_keeps_its_storage_and_count(stepped):
    """The CPU runs the body eagerly (nothing captured); the LSTM states,
    the batch buffers, the optimizer's count and moments, the EMA copy and
    the weights keep their storage over the steps; the host's count and the
    card's count both read 3."""
    run, state = stepped["run"], stepped["state"]
    assert not run.run.graph and run.run.schedule is None
    assert stepped["storage"][0] == stepped["storage"][1] == stepped["storage"][2]
    assert state.optimizer.count == STEPS and float(state.optimizer.adamw.count) == STEPS


def test_captured_eval_body_matches_jax(stepped):
    """``CapturedEvalStep`` over two batches, the LSTM states carried in its
    buffers, against JAX's jitted ``eval_step`` on the initial variables:
    validity and classes exact, boxes and scores within 1e-4 (slates as sets
    ordered by box), the carried states within 1e-4 / 1e-5."""
    jcfg, tcfg = stepped["cfgs"]
    batches = stepped["batches"][:2]
    B = batches[0]["ev_repr"].shape[1]
    jeval = jax.jit(j_steps.make_eval_step(stepped["jmodel"], jcfg))
    variables = jax.tree.map(jnp.asarray, stepped["variables0"])
    tmodel = load_jax_variables(YoloXDetector(tcfg.model, sparse_kernel=stepped["sparse"]),
                                stepped["variables0"])
    run = t_steps.CapturedEvalStep({"eval": t_steps.make_eval_step(tmodel, tcfg)}, tmodel, tcfg,
                                   "cpu")
    jstates = j_zero_states(jcfg.model.backbone, B)

    def by_box(d):
        d = {k: np.asarray(v) for k, v in d.items()}
        order = [np.lexsort(np.round(b, 2).T[::-1]) for b in d["boxes"]]
        return {k: np.stack([lane[o] for lane, o in zip(v, order)]) for k, v in d.items()}

    for batch in batches:
        with _interpret_pallas():
            jstates, jdets = jeval(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jstates)
        tdets = run(split_device_batch(batch)[0])
        jd, td = by_box(jdets), by_box(tdets)
        for k in ("valid", "classes"):
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=1e-4, err_msg=k)
        for (th, tc), (jh, jc) in zip(run.states, jstates):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)


def test_rate_and_count_are_tensors_that_follow_optax():
    """The count is a 0-d fp32 tensor on the parameters' device, incremented
    by the update there; the rate of each update is the schedule of that
    tensor before the increment, computed there: bit for bit the host's
    fp32 value and optax's, across the warm-up's end and past the last
    step. The parameters follow optax's over the steps (rtol 1e-5)."""
    import optax

    sched = dict(use=True, total_steps=10, pct_start=0.2, div_factor=25.0,
                 final_div_factor=1e4)
    jcfg = j_test_config().training
    jcfg = dataclasses.replace(jcfg, learning_rate=3e-3, weight_decay=0.05,
                               lr_scheduler=dataclasses.replace(jcfg.lr_scheduler, **sched))
    tcfg = get_test_config().training
    tcfg = dataclasses.replace(tcfg, learning_rate=3e-3, weight_decay=0.05,
                               lr_scheduler=dataclasses.replace(tcfg.lr_scheduler, **sched))
    rng = np.random.RandomState(5)
    p0 = {"a": rng.randn(7, 5).astype(np.float32), "b": rng.randn(11).astype(np.float32)}
    tx = j_optimizer.build_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = t_optimizer.build_optimizer(tcfg, tp.values())
    j_sched = j_optimizer.build_schedule(jcfg)
    for i in range(13):
        count = opt.adamw.count
        assert count.dtype == torch.float32 and count.dim() == 0 and float(count) == i
        on_card = opt.schedule.on_card(count.clone())
        want = np.float32(j_sched(i))
        assert on_card.numpy().view(np.int32) == want.view(np.int32), (i, float(on_card), want)
        assert np.float32(opt.schedule(i)).view(np.int32) == want.view(np.int32)
        g = {k: (rng.randn(*v.shape) * 2).astype(np.float32) for k, v in p0.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        assert np.float32(opt.step()) == want
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert opt.count == 13 and float(opt.adamw.count) == 13


def _tiny_trainer(tmp_path, name, **kw):
    return Trainer(_cfg(get_test_config), str(tmp_path / name), device="cpu", **kw)


def test_a_checkpoint_of_the_torch_adamw_layout_resumes(tmp_path):
    """A checkpoint whose optimizer is ``torch.optim.AdamW``'s state dict
    (the layout saved before the update moved onto the device: a step per
    parameter on the host) resumes: the host count, the card's count and
    the moments bit for bit, into the tensors the step already holds; the
    next step then equals that of a trainer resumed from the same state
    saved in the current layout."""
    cfg = _cfg(get_test_config)
    batches = _three_batches(cfg)
    resumed = _tiny_trainer(tmp_path, "run")
    resumed.fit(batches[:1], max_steps=1)  # the step's state exists before the resume
    held = resumed.state.optimizer.tensors()
    clones = [p.detach().clone().requires_grad_() for p in resumed.state.optimizer.params]
    adamw = torch.optim.AdamW(clones, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=cfg.training.weight_decay)
    rng = np.random.RandomState(1)
    for p in clones:
        p.grad = torch.from_numpy((rng.randn(*p.shape) * 1e-2).astype(np.float32))
    adamw.step()
    old = adamw.state_dict()
    assert all(s["step"].device.type == "cpu" for s in old["state"].values())
    torch.save({"step": 1, "model": resumed.model.state_dict(),
                "optimizer": {"count": 1, "adamw": old}, "ema": resumed.state.ema_params,
                "metrics": None}, resumed.ckpt.path(1))

    resumed.maybe_resume(True)
    assert [t.data_ptr() for t in resumed.state.optimizer.tensors()] == [t.data_ptr() for t in held]
    assert resumed.state.optimizer.count == 1 and float(resumed.state.optimizer.adamw.count) == 1
    adam = resumed.state.optimizer.adamw.state
    for i, p in enumerate(resumed.state.optimizer.params):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(adam[p][k], old["state"][i][k]), (i, k)

    resumed.ckpt.save(1, resumed.state)  # the same state in the current layout
    current = _tiny_trainer(tmp_path, "run")
    current.maybe_resume(True)
    for trainer in (resumed, current):
        trainer.fit(batches[1:2], max_steps=2)
    assert resumed.state.step == current.state.step == 2
    for (name, a), (_, b) in zip(resumed.model.named_parameters(),
                                 current.model.named_parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(resumed.state.optimizer.tensors(), current.state.optimizer.tensors()):
        assert torch.equal(a, b)


def test_the_state_keeps_its_storage_across_fit_calls_and_a_resume(tmp_path):
    """``fit`` through the captured step's body: the LSTM states, the batch
    buffers, the optimizer's tensors, the EMA copy and the weights stay in
    one storage over two ``fit`` calls and a full resume between them; the
    steps equal the step function called on its own (``train_step``), bit
    for bit."""
    cfg = _cfg(get_test_config)
    batches = _three_batches(cfg)
    trainer = _tiny_trainer(tmp_path, "run")
    trainer.fit(batches[:2], max_steps=2)
    before = _storage(trainer._train, trainer.state)
    trainer.maybe_resume(True)
    trainer.fit(batches[2:], max_steps=3)
    assert _storage(trainer._train, trainer.state) == before and trainer.state.step == 3

    ref = _tiny_trainer(tmp_path, "ref")
    from sast_tpu_torch.data.batch import to_device

    for i, batch in enumerate(batches):
        lstm = ref._zero_states(2) if i in (0, 2) else lstm  # fit starts from zero states
        ref.state, lstm, _ = ref.train_step(ref.state, to_device(batch, "cpu"), lstm)
    for (name, a), (_, b) in zip(trainer.model.named_parameters(), ref.model.named_parameters()):
        assert torch.equal(a, b), name


def _choosing(attention):
    cfg = get_test_config()
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, **attention))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))


@pytest.mark.parametrize("attention, sparse, switch", [
    (dict(gather_budget=0.5), False, "attention.gather_budget=0.5"),
    (dict(pallas_density_threshold=0.5), True, "attention.pallas_density_threshold=0.5"),
    (dict(gather_budget=1.0), False, None),
    (dict(), True, None),
], ids=["gather", "threshold", "gather-1.0", "threshold-1.0"])
def test_graph_takes_a_configuration_that_chooses_on_the_card(attention, sparse, switch,
                                                              monkeypatch):
    """A layer that chooses its branch on the card in training is captured
    with its choice: ``refuse_capture`` refuses nothing without a gloo
    world, and building the captured train step on a card refuses nothing.
    The body a card captures (eager here) takes every choice through
    ``graphs.choose``, forward and backward, labelled by the layer's switch,
    and trains to finite metrics; a gather budget of 1 and the default
    threshold choose nothing."""
    cfg = _choosing(attention)
    model = build_detector(cfg.model, seed=0, device="cpu", sparse_kernel=sparse)
    t_steps.refuse_capture()
    state = t_steps.train_state_for(model, cfg)
    fns = {"train": t_steps.make_train_step(model, cfg), "eval": t_steps.make_eval_step(model, cfg)}
    t_steps.CapturedTrainStep(fns, state, cfg, "cuda", graph=True)
    labels = []
    choose = graphs.choose

    def spy(pred, true_fn, false_fn, operands, label="a choice"):
        labels.append(label)
        return choose(pred, true_fn, false_fn, operands, label)

    monkeypatch.setattr(graphs, "choose", spy)
    run = t_steps.CapturedTrainStep(fns, state, cfg, "cpu", graph=True)
    metrics = run(split_device_batch(_batches(cfg)[0])[0])
    assert np.isfinite(float(metrics["loss"])) and state.optimizer.count == 1
    if switch is None:
        assert labels == []
    else:
        assert set(labels) == {switch, f"the backward of {switch}"}
        assert labels.count(switch) == 2 * labels.count(f"the backward of {switch}") > 0


def test_graph_refuses_a_gloo_world(tmp_path):
    """A world over gloo stages its all-reduces through the host: a captured
    train step refuses it by the backend's name at its first call;
    ``graph=False`` takes it."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = dp.make_mesh("cpu")
        cfg = _cfg(get_test_config)
        model = build_detector(cfg.model, seed=0, device="cpu")
        state = t_steps.train_state_for(model, cfg)
        fns = {"train": t_steps.make_train_step(model, cfg, mesh)}
        run = t_steps.CapturedTrainStep(fns, state, cfg, "cuda", graph=True, mesh=mesh)
        with pytest.raises(ValueError, match="gloo.*graph=False"):
            run(split_device_batch(_batches(cfg)[0])[0])
        assert run.step is None
        t_steps.CapturedTrainStep(fns, state, cfg, "cuda", graph=False, mesh=mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_dropout_masks_from_the_card_count():
    """The masks of a key whose step is the card's count tensor equal those
    of the same step given as an integer; two ranks of a world of two draw
    the global batch's rows; a second draw (the recomputation) repeats; the
    next count draws other masks; the share kept is the keep rate."""
    count = torch.full((), 7.0)
    key = DropoutKey(seed=5, step=7, t=1, counter=count)
    m = key.keep_mask(3, (8, 16, 4), 0.75, "cpu")
    assert torch.equal(m, DropoutKey(seed=5, step=7, t=1).keep_mask(3, (8, 16, 4), 0.75, "cpu"))
    assert torch.equal(m, key.keep_mask(3, (8, 16, 4), 0.75, "cpu"))
    halves = [dataclasses.replace(key, rank=r, world=2).keep_mask(3, (4, 16, 4), 0.75, "cpu")
              for r in range(2)]
    assert torch.equal(torch.cat(halves), m)
    count.add_(1.0)  # the update's increment: the next step's masks
    assert not torch.equal(m, key.keep_mask(3, (8, 16, 4), 0.75, "cpu"))
    assert torch.equal(key.keep_mask(3, (8, 16, 4), 0.75, "cpu"),
                       DropoutKey(seed=5, step=8, t=1).keep_mask(3, (8, 16, 4), 0.75, "cpu"))
    share = DropoutKey(seed=0, step=0, t=0).keep_mask(0, (1000, 100), 0.75, "cpu").float().mean()
    assert abs(float(share) - 0.75) < 5 * (0.75 * 0.25 / 1e5) ** 0.5


def test_regularized_fit_equals_its_step_function(tmp_path):
    """Every rate at 0.1: ``fit`` through the step's body draws the masks of
    the step function called on its own, step for step (the count on the
    device names them), bit for bit."""
    cfg = _cfg(get_test_config)
    bb = cfg.model.backbone
    bb = dataclasses.replace(
        bb, attention=dataclasses.replace(bb.attention, drop_path=0.1, drop_mlp=0.1),
        lstm=dataclasses.replace(bb.lstm, drop_cell_update=0.1))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))
    batches = _batches(cfg, 2)
    runs = [Trainer(cfg, str(tmp_path / f"r{i}"), device="cpu") for i in range(2)]
    runs[0].fit(batches, max_steps=2)
    from sast_tpu_torch.data.batch import to_device

    lstm = runs[1]._zero_states(2)
    for batch in batches:
        runs[1].state, lstm, _ = runs[1].train_step(runs[1].state, to_device(batch, "cpu"), lstm)
    for (name, a), (_, b) in zip(runs[0].model.named_parameters(), runs[1].model.named_parameters()):
        assert torch.equal(a, b), name


def test_bumped_versions_refresh_the_compute_copies():
    """A replay writes the weights without moving their version; the train
    step's caller moves it (``graphs.bump_versions``), so that a no-grad
    forward after it reads copies rebuilt from the new weights: the bits of
    a fresh model on those weights (bf16)."""
    cfg = get_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    model = build_detector(cfg.model, seed=0, device="cpu")
    other = build_detector(cfg.model, seed=1, device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).poisson(0.3, (1, *cfg.model.backbone.in_res_hw,
                                                                20)).clip(0, 255).astype(np.uint8))
    with torch.no_grad():
        model(x)
        for p, q in zip(model.parameters(), other.parameters()):
            p.data.copy_(q)  # written as a replay writes: the version stays
        stale = model(x)
        want = other(x)
        graphs.bump_versions(list(model.parameters()))
        got = model(x)
    leaves = torch.utils._pytree.tree_leaves
    assert not all(torch.equal(a, b) for a, b in zip(leaves(stale), leaves(want)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))


def test_the_cache_gathers_into_the_step_buffer(dataset_root, tmp_path):
    """``fit`` on the card-resident cache's stream: from the second batch on
    the stream gathers each clip straight into the captured step's
    ``ev_repr`` buffer (one copy of the clip); three steps equal three on
    the host ``DataModule``'s batches, bit for bit."""
    from tests.test_torch_validate import _cfg as data_cfg

    cfg = data_cfg(dataset_root)

    def flip_only(aug):  # what the cache's gather does of the host's augmentation
        return dataclasses.replace(aug, prob_hflip=0.5, rotate_prob=0.0,
                                   zoom=dataclasses.replace(aug.zoom, prob=0.0))

    ds = cfg.dataset
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
        ds, data_augmentation_stream=flip_only(ds.data_augmentation_stream)))
    stream = device_cache.DeviceCachedTrainStream(cfg, seed=4, device="cpu")
    seen = []

    def recorded():
        for batch in stream:
            seen.append(batch["ev_repr"].data_ptr())
            yield batch

    class Fed:
        def __iter__(self):
            return recorded()

        def gather_into(self, buffer):
            stream.gather_into(buffer)

    cached = Trainer(cfg, str(tmp_path / "cached"), device="cpu")
    cached.fit(Fed(), max_steps=3)
    buffer = cached._train.buffers.tensors["ev_repr"].data_ptr()
    assert seen[0] != buffer and seen[1:3] == [buffer, buffer]
    host = Trainer(cfg, str(tmp_path / "host"), device="cpu")
    host.fit(DataModule(cfg).train_batches(seed=4, prefetch=False), max_steps=3)
    for (name, a), (_, b) in zip(cached.model.named_parameters(), host.model.named_parameters()):
        assert torch.equal(a, b), name
