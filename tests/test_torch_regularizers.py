"""The stochastic regularizers of the port: ``DropPath`` (``attention.drop_path``),
the MLP dropout (``attention.drop_mlp``) and the ConvLSTM cell-update
dropout (``lstm.drop_cell_update``), with their masks drawn from
``DropoutKey`` (CPU, tiny config, fp32).

The port cannot draw JAX's masks: JAX draws threefry bits from
``fold_in(PRNGKey(seed), step)`` split per timestep, the port draws from a
``torch.Generator`` seeded from (seed, step, timestep, layer). The two
follow the same distribution, not the same values, so nothing here compares
masks with JAX's; the port's deterministic step is held against JAX by
``tests/test_torch_training.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data.batch import to_device
from sast_tpu_torch.data.synthetic import synthetic_train_batch
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import YoloXDetector, init_weights
from sast_tpu_torch.models.layers import DropoutKey, DropPath, Dropout
from sast_tpu_torch.models.sast import MaskedSparseAttention
from sast_tpu_torch.ops import fused_block, sparse_block
from sast_tpu_torch.training import steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(rate=0.0, **attention):
    cfg = get_test_config()
    bb = cfg.model.backbone
    bb = dataclasses.replace(
        bb, attention=dataclasses.replace(bb.attention, ls_init_value=0.3, drop_path=rate,
                                          drop_mlp=rate, **attention),
        lstm=dataclasses.replace(bb.lstm, drop_cell_update=rate))
    tr = dataclasses.replace(cfg.training, seed=3, remat_policy="full")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb),
                               training=tr)


def _step(cfg, sparse_kernel=False):
    """One train step from seeded weights; the model (gradients on its
    parameters) and the metrics."""
    model = YoloXDetector(cfg.model, sparse_kernel=sparse_kernel)
    init_weights(model, torch.Generator().manual_seed(1))
    state = steps.train_state_for(model, cfg)
    batch = to_device(synthetic_train_batch(cfg, np.random.RandomState(0)), "cpu")
    B = batch["ev_repr"].shape[1]
    _, _, metrics = steps.make_train_step(model, cfg)(state, batch,
                                                      zero_states(cfg.model.backbone, B))
    return model, metrics


def test_rates_of_zero_draw_no_mask(monkeypatch):
    """Every rate at 0: the step builds no key and draws no mask (the
    regularizers' modules return their input), so it computes what it
    computed before they were ported."""
    def refuse(*args, **kwargs):
        raise AssertionError("a mask was drawn")

    monkeypatch.setattr(DropoutKey, "keep_mask", refuse)
    for sparse_kernel in (False, True):
        _, metrics = _step(_cfg(0.0), sparse_kernel)
        assert np.isfinite(float(metrics["loss"]))
    x = torch.randn(3, 4)
    assert DropPath(0.0)(x, DropoutKey(0, 0, 0)) is x and Dropout(0.5)(x, None) is x


def test_drop_path_keeps_a_binomial_share_scaled_by_one_over_keep():
    rate, n = 0.3, 20_000
    x = torch.rand(n, 2, 3) + 0.5
    y = DropPath(rate)(x, DropoutKey(seed=0, step=1, t=2))
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | ~kept.any(1)).all())  # whole samples, kept or dropped
    share, sd = float(kept.all(1).float().mean()), (rate * (1 - rate) / n) ** 0.5
    assert abs(share - (1 - rate)) < 5 * sd
    rows = kept.all(1)
    assert torch.equal(y[rows], x[rows] / (1 - rate))
    # Element-wise dropout: one draw per element.
    z = Dropout(rate)(x, DropoutKey(seed=0, step=1, t=2))
    sd = (rate * (1 - rate) / z.numel()) ** 0.5
    assert abs(float((z != 0).float().mean()) - (1 - rate)) < 5 * sd
    assert not bool(((z != 0).flatten(1).all(1) | (z == 0).flatten(1).all(1)).all())


def test_masks_depend_on_seed_step_timestep_and_layer_and_split_over_ranks():
    key = DropoutKey(seed=5, step=7, t=1)
    m = key.keep_mask(3, (8, 16), 0.5, "cpu")
    assert torch.equal(m, key.keep_mask(3, (8, 16), 0.5, "cpu"))
    for other in (dataclasses.replace(key, seed=6), dataclasses.replace(key, step=8),
                  dataclasses.replace(key, t=2)):
        assert not torch.equal(m, other.keep_mask(3, (8, 16), 0.5, "cpu"))
    assert not torch.equal(m, key.keep_mask(4, (8, 16), 0.5, "cpu"))
    # Two ranks of four rows each draw the rows of the global batch's mask.
    halves = [dataclasses.replace(key, rank=r, world=2).keep_mask(3, (4, 16), 0.5, "cpu")
              for r in range(2)]
    assert torch.equal(torch.cat(halves), m)
    # Every regularizer of the backbone has its own layer number.
    ids = [mod.layer_id for mod in YoloXDetector(_cfg(0.1).model).modules()
           if isinstance(mod, Dropout)]
    assert sorted(ids) == list(range(len(ids))) and len(ids) > 3


def test_remat_full_draws_the_masks_of_remat_none(monkeypatch):
    """The checkpointed timestep draws its masks again in the backward, the
    same ones: the step under ``remat_policy="full"`` gives the gradients of
    ``"none"``, which keeps its forward."""
    drawn = []
    keep_mask = DropoutKey.keep_mask

    def recorded(self, layer, shape, keep, device):
        m = keep_mask(self, layer, shape, keep, device)
        drawn.append((self.step, self.t, layer, m))
        return m

    monkeypatch.setattr(DropoutKey, "keep_mask", recorded)
    full_model, full = _step(_cfg(0.1))
    full_draws, drawn[:] = list(drawn), []
    none_model, none = _step(dataclasses.replace(
        _cfg(0.1), training=dataclasses.replace(_cfg(0.1).training, remat_policy="none")))
    assert len(full_draws) == 2 * len(drawn)  # forward and recomputation
    by_key = {(step, t, layer): m for step, t, layer, m in drawn}
    for step, t, layer, m in full_draws:
        assert torch.equal(m, by_key[(step, t, layer)])
    assert float(full["loss"]) == float(none["loss"])
    for (name, a), (_, b) in zip(full_model.named_parameters(), none_model.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6, msg=name)
    _, base = _step(_cfg(0.0))
    assert float(full["loss"]) != float(base["loss"])  # the regularizers act


def _count(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("path", ["sparse", "fused", "gather"])
def test_kernel_and_gather_paths_fall_back_to_the_masked_path(path, monkeypatch):
    """Under training with a non-zero rate the window-skipping, fused and
    gather paths run the masked torch ops (the kernels implement neither
    regularizer): no call reaches a kernel's plain version or a gathered
    layout, where with rates of 0 they do. The evaluation step keeps its
    path whatever the rates."""
    attention = {"fused": dict(fused_block=True), "gather": dict(gather_budget=1.0)}.get(path, {})
    calls, layouts = {}, []
    for module, name in ((sparse_block, "sparse_window_block_plain"),
                         (sparse_block, "sparse_block_mlp_bwd_plain"),
                         (fused_block, "fused_block_plain")):
        _count(monkeypatch, module, name, calls)
    block_math = MaskedSparseAttention.block_math

    def recorded(self, y, token_keep, dropout=None):
        layouts.append(y.shape[0])
        return block_math(self, y, token_keep, dropout)

    monkeypatch.setattr(MaskedSparseAttention, "block_math", recorded)
    B = get_test_config().training.batch_size_train

    def uses_its_path():
        if path == "gather":
            return 1 in layouts and B > 1
        name = "sparse_window_block_plain" if path == "sparse" else "fused_block_plain"
        return calls.get(name, 0) > 0

    _step(_cfg(0.0, **attention), sparse_kernel=path == "sparse")
    assert uses_its_path()
    calls.clear(), layouts.clear()
    _step(_cfg(0.1, **attention), sparse_kernel=path == "sparse")
    assert calls == {} and layouts and set(layouts) == {B}
    calls.clear(), layouts.clear()
    model = YoloXDetector(_cfg(0.1, **attention).model, sparse_kernel=path == "sparse")
    batch = to_device(synthetic_train_batch(_cfg(0.1), np.random.RandomState(0)), "cpu")
    eval_step = steps.make_eval_step(model, _cfg(0.1, **attention))
    eval_step(batch, zero_states(model.config.backbone, B))
    assert uses_its_path()


def test_the_regularized_step_repeats_bit_for_bit():
    """The same seed and step twice: the same masks, the same bits."""
    for sparse_kernel in (False, True):
        a_model, a = _step(_cfg(0.1), sparse_kernel)
        b_model, b = _step(_cfg(0.1), sparse_kernel)
        assert float(a["loss"]) == float(b["loss"])
        for (name, p), (_, q) in zip(a_model.named_parameters(), b_model.named_parameters()):
            assert torch.equal(p.grad, q.grad), name
