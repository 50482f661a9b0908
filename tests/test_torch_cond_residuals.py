"""The choice under grad differentiates the taken branch from the residuals
that its forward recorded, as JAX's ``cond`` does under ``linearize``
(sast_tpu/models/sast.py, inside the ``jax.checkpoint`` timestep of
sast_tpu/training/steps.py): no choosing layer runs a branch's forward in
its backward.

- A tiny trainer of each choosing configuration (the setup of
  tests/test_torch_cond_grad.py) under ``remat_policy`` "none", "dots" and
  "full": spies on the layers' branch functions count one branch forward
  per layer and timestep without checkpointing and two with it (the
  forward and the recomputation), none inside a choice's backward; the
  choice itself is made at each of those forwards and once more in the
  backward. The three policies take the same step bit for bit.
- ``FlopCounterMode`` over one choosing layer's forward and backward counts
  exactly what the taken branch counts under plain autograd.
- Under "full" nothing that a branch creates in the first forward, its
  input included, is alive once the forward is done: the residuals come
  from the recomputation, and no activation is held across the scan.
"""

import collections
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from sast_tpu_torch import graphs
from sast_tpu_torch.config import AttentionConfig, get_test_config
from sast_tpu_torch.data.batch import split_device_batch
from sast_tpu_torch.data.synthetic import synthetic_train_batch
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import build_detector
from sast_tpu_torch.models.sast import MaskedSparseAttention, _layernorm, gather_size
from sast_tpu_torch.training import steps as t_steps

BRANCHES = ("masked", "gathered", "kernel")
SWITCHES = {"gather": (dict(gather_budget=0.5), False),
            "threshold": (dict(pallas_density_threshold=0.5), True)}
B, N, HW, C, DH = 2, 5, 6, 32, 16  # one layer: M = 10 windows


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(attention, remat_policy="full"):
    cfg = get_test_config()
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, ls_init_value=0.3,
                                                               **attention))
    tr = dataclasses.replace(cfg.training, remat_policy=remat_policy, seed=0)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb),
                               training=tr)


class _Spy:
    """Counts the calls of every layer's branch functions, by whether they
    came from inside a choice's backward (``graphs.choose`` with a backward
    label), and the choices by kind."""

    def __init__(self, monkeypatch, on_branch=None):
        self.calls = collections.Counter()
        self.choices = collections.Counter()
        self.in_backward = 0
        choose = graphs.choose

        def spy_choose(pred, true_fn, false_fn, operands, label="a choice"):
            backward = label.startswith("the backward of")
            self.choices["backward" if backward else "forward"] += 1
            self.in_backward += backward
            try:
                return choose(pred, true_fn, false_fn, operands, label)
            finally:
                self.in_backward -= backward

        monkeypatch.setattr(graphs, "choose", spy_choose)
        for name in BRANCHES:
            def branch(layer, *args, _orig=getattr(MaskedSparseAttention, name), **kw):
                self.calls["backward" if self.in_backward else "forward"] += 1
                if on_branch is not None:
                    return on_branch(_orig, layer, *args, **kw)
                return _orig(layer, *args, **kw)
            monkeypatch.setattr(MaskedSparseAttention, name, branch)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_branches_run_once_per_forward_and_never_in_the_backward(switch, monkeypatch):
    """One train step of a tiny choosing trainer per remat policy: each
    layer's branches run once per timestep under "none" and twice under
    "dots" and "full" (the forward and the recomputation), never inside a
    choice's backward; the choice is made at each forward and once in the
    backward (three times per layer and timestep under "full"). The three
    policies give the same metrics, parameters and gradients bit for
    bit."""
    attention, sparse = SWITCHES[switch]
    batch = synthetic_train_batch(_cfg(attention), np.random.RandomState(0))
    T = batch["ev_repr"].shape[0]
    results = {}
    for policy, forwards in (("none", 1), ("dots", 2), ("full", 2)):
        cfg = _cfg(attention, policy)
        model = build_detector(cfg.model, seed=0, device="cpu", sparse_kernel=sparse)
        layers = [m for m in model.modules() if isinstance(m, MaskedSparseAttention)]
        assert layers and all(m.chooses_in_training() for m in layers)
        state = t_steps.train_state_for(model, cfg)
        run = t_steps.CapturedTrainStep({"train": t_steps.make_train_step(model, cfg)}, state,
                                        cfg, "cpu")
        with monkeypatch.context() as mp:
            spy = _Spy(mp)
            metrics = run(split_device_batch(batch)[0])
        per = T * len(layers)
        assert spy.calls == {"forward": forwards * per}, (policy, spy.calls)
        assert spy.choices == {"forward": forwards * per, "backward": per}, (policy, spy.choices)
        results[policy] = ({k: float(v) for k, v in metrics.items()},
                           [p.detach().clone() for p in model.parameters()],
                           [p.grad.clone() for p in model.parameters()])
    for policy in ("none", "dots"):
        assert results[policy][0] == results["full"][0], policy
        for what, i in (("parameters", 1), ("gradients", 2)):
            bad = [j for j, (a, b) in enumerate(zip(results[policy][i], results["full"][i]))
                   if not torch.equal(a, b)]
            assert not bad, (policy, what, bad)


def _layer_case(switch, kept):
    """One choosing layer with seeded weights and exactly ``kept`` of its 10
    windows kept; its input, the gradient of its output, the masks."""
    attention, sparse = SWITCHES[switch]
    rng = np.random.RandomState(3)
    torch.manual_seed(3)
    acfg = AttentionConfig(partition_size=(2, 3), dim_head=DH, ls_init_value=0.5, **attention)
    layer = MaskedSparseAttention(C, acfg, sparse_kernel=sparse)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape) * 0.2 + (1.0 if p.dim() == 1 else 0.0))
    win = np.zeros(B * N, bool)
    win[rng.permutation(B * N)[:kept]] = True
    win = win.reshape(B, N)
    tok = (rng.rand(B, N, HW) > 0.4) & win[..., None]
    tok[..., 0] |= win
    x = torch.from_numpy(rng.randn(B, N, HW, C).astype(np.float32))
    up = torch.from_numpy(rng.randn(B, N, HW, C).astype(np.float32))
    return layer, x, up, torch.from_numpy(tok), torch.from_numpy(win)


# switch, kept windows of M = 10, the branch taken
FLOP_CASES = {"gather-kept-5": ("gather", 5, "gathered"), "gather-kept-6": ("gather", 6, "masked"),
              "threshold-kept-4": ("threshold", 4, "kernel"),
              "threshold-kept-6": ("threshold", 6, "masked")}


@pytest.mark.parametrize("case", list(FLOP_CASES))
def test_choice_flops_are_the_taken_branch_under_plain_autograd(case, monkeypatch):
    """``FlopCounterMode`` over one choosing layer's forward and backward
    counts exactly what its taken branch, run on the layer's first norm by
    plain autograd, counts; the gradients are the same bits."""
    switch, kept, taken = FLOP_CASES[case]
    layer, x, up, tok, win = _layer_case(switch, kept)
    spy = _Spy(monkeypatch)
    xt = x.clone().requires_grad_(True)
    with FlopCounterMode(display=False) as choice:
        (layer(xt, tok, win) * up).sum().backward()
    assert spy.calls == {"forward": 1}
    got = [xt.grad] + [p.grad for p in layer.parameters()]
    layer.zero_grad(set_to_none=True)
    monkeypatch.undo()

    fn = getattr(layer, taken)
    if taken == "gathered":
        fn = lambda *a: layer.gathered(*a, k=gather_size(0.5, B * N))  # noqa: E731
    xp = x.clone().requires_grad_(True)
    with FlopCounterMode(display=False) as plain:
        (fn(_layernorm(xp, layer.norm1, layer.eps), tok, win) * up).sum().backward()
    want = [xp.grad] + [p.grad for p in layer.parameters()]
    assert plain.get_total_flops() > 0
    assert choice.get_total_flops() == plain.get_total_flops()
    assert choice.get_flop_counts()["Global"] == plain.get_flop_counts()["Global"]
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_a_layer_chained_on_itself_differentiates_each_choice(switch):
    """One choosing layer applied to its own output (the chain of
    scripts/bench_sparse_layer_torch.py): each choice's backward stops at
    its own input, so the gradients of the input and of the shared
    parameters are those of the two taken branches composed by plain
    autograd, bit for bit."""
    layer, x, up, tok, win = _layer_case(switch, 5)
    xt = x.clone().requires_grad_(True)
    (layer(layer(xt, tok, win), tok, win) * up).sum().backward()
    got = [xt.grad] + [p.grad for p in layer.parameters()]
    layer.zero_grad(set_to_none=True)
    taken = {"gather": lambda *a: layer.gathered(*a, k=gather_size(0.5, B * N)),
             "threshold": layer.kernel}[switch]
    xp = x.clone().requires_grad_(True)
    once = taken(_layernorm(xp, layer.norm1, layer.eps), tok, win)
    (taken(_layernorm(once, layer.norm1, layer.eps), tok, win) * up).sum().backward()
    want = [xp.grad] + [p.grad for p in layer.parameters()]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


class _Created(TorchDispatchMode):
    """Weak references to every tensor an operator returns."""

    def __init__(self, refs):
        super().__init__()
        self.refs = refs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.refs.append((str(func), weakref.ref(t)))
        return out


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_first_forward_holds_nothing_of_a_branch(switch, monkeypatch):
    """The backbone scan of a tiny choosing model under ``remat_policy``
    "full": every tensor that a branch creates in the first forward, and
    its input, is dead once the forward's loss is computed, before
    ``backward()``; the backward then recomputes the residuals and runs
    (every parameter's gradient is finite)."""
    attention, sparse = SWITCHES[switch]
    cfg = _cfg(attention)
    model = build_detector(cfg.model, seed=0, device="cpu", sparse_kernel=sparse)
    batch = synthetic_train_batch(cfg, np.random.RandomState(0))
    refs, phase = [], {"first": True}

    def watched(orig, layer, y, *args, **kw):
        if not phase["first"]:
            return orig(layer, y, *args, **kw)
        refs.append(("input", weakref.ref(y)))
        with _Created(refs):
            return orig(layer, y, *args, **kw)

    spy = _Spy(monkeypatch, watched)
    in_stages, padder, token_mask = t_steps._step_constants(cfg, torch.device("cpu"))
    ev = torch.from_numpy(batch["ev_repr"])
    T, lanes = ev.shape[:2]
    states = zero_states(cfg.model.backbone, lanes, torch.float32, "cpu")
    _, feats, _ = t_steps._backbone_scan(model, ev, states, in_stages, deterministic=True,
                                         padder=padder,
                                         num_channels=cfg.model.backbone.input_channels,
                                         token_mask=token_mask, remat_policy="full")
    loss = sum(f.square().mean() for f in feats)
    phase["first"] = False
    gc.collect()
    layers = sum(isinstance(m, MaskedSparseAttention) for m in model.modules())
    assert spy.calls == {"forward": T * layers}
    assert len(refs) > T * layers
    alive = collections.Counter(name for name, ref in refs if ref() is not None)
    assert not alive, alive
    loss.backward()
    assert spy.calls == {"forward": 2 * T * layers}
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
