"""Port vs JAX package: which branch an attention layer takes where its
choice depends on the scene (fault 3e).

JAX decides on the device, in float32: ``mean(win_keep.astype(f32)) <=
pallas_threshold`` for the sparse kernel and ``n_win <= K`` for the gather
path (sast_tpu/models/sast.py). At M = 10 windows with 3 kept and a
threshold of 0.3 the float32 density 0.3 equals the float32 threshold, so
JAX takes the kernel; a test in float64 on the host would not. Here the
port's ``MaskedSparseAttention`` and JAX's (its Pallas kernel in interpret
mode, as tests/test_torch_paths.py runs it) take the same branch at the
tie and on either side of it, and compute the same block.
"""

from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sast_tpu.models.sast import MaskedSparseAttention as JMSA
from sast_tpu_torch.config import AttentionConfig
from sast_tpu_torch.models.sast import MaskedSparseAttention, branch_predicate, density_limit
from sast_tpu_torch.ops import sparse_block

B, N, HW, C, DH = 2, 5, 6, 32, 16  # M = 10 windows

# name -> (JAX switches, port switches, sparse_kernel, kept windows, JAX takes its first branch)
CASES = {
    "threshold-0.3-kept-2": (dict(use_pallas=True, pallas_threshold=0.3),
                             dict(pallas_density_threshold=0.3), True, 2, True),
    "threshold-0.3-kept-3": (dict(use_pallas=True, pallas_threshold=0.3),
                             dict(pallas_density_threshold=0.3), True, 3, True),
    "threshold-0.3-kept-4": (dict(use_pallas=True, pallas_threshold=0.3),
                             dict(pallas_density_threshold=0.3), True, 4, False),
    "gather-0.5-kept-5": (dict(gather_budget=0.5), dict(gather_budget=0.5), False, 5, True),
    "gather-0.5-kept-6": (dict(gather_budget=0.5), dict(gather_budget=0.5), False, 6, False),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _masks(kept, seed):
    """Exactly ``kept`` of the M windows kept, each with at least one kept
    token; no token kept outside them."""
    rng = np.random.RandomState(seed)
    win = np.zeros(B * N, bool)
    win[rng.permutation(B * N)[:kept]] = True
    win = win.reshape(B, N)
    tok = (rng.rand(B, N, HW) > 0.4) & win[..., None]
    tok[..., 0] |= win
    return win, tok


@pytest.mark.parametrize("case", list(CASES))
def test_branch_is_the_jax_branch(case, monkeypatch):
    """The port takes the branch that JAX's ``lax.cond`` takes (a spy on
    JAX's predicate; on the port's side a spy on the kernel wrapper, the
    gather path's ``block_math`` call on K windows and the masked path's on
    all), and the two layers agree to rtol 2e-4, atol 2e-5 (fp32)."""
    j_kw, t_kw, sparse_kernel, kept, jax_first = CASES[case]
    monkeypatch.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
    preds = []
    cond = jax.lax.cond

    def spy_cond(pred, *args, **kw):
        preds.append(bool(pred))
        return cond(pred, *args, **kw)

    monkeypatch.setattr(jax.lax, "cond", spy_cond)
    rng = np.random.RandomState(5)
    x = rng.randn(B, N, HW, C).astype(np.float32)
    win, tok = _masks(kept, 6)
    assert win.sum() == kept
    args = (jnp.asarray(x), jnp.asarray(tok), jnp.asarray(win))
    v = jax.device_get(JMSA(dim=C, dim_head=DH, ls_init_value=0.5, dtype=jnp.float32).init(
        jax.random.PRNGKey(1), *args))
    yj = np.asarray(JMSA(dim=C, dim_head=DH, ls_init_value=0.5, dtype=jnp.float32,
                         **j_kw).apply(v, *args))
    assert preds == [jax_first]

    from sast_tpu_torch.weights import load_jax_variables

    acfg = AttentionConfig(partition_size=(2, 3), dim_head=DH, ls_init_value=0.5, **t_kw)
    tm = load_jax_variables(MaskedSparseAttention(C, acfg, sparse_kernel=sparse_kernel), v)
    calls = {"kernel": 0, "windows": []}
    run, math_ = sparse_block.sparse_window_block, MaskedSparseAttention.block_math

    def spy_kernel(*a, **kw):
        calls["kernel"] += 1
        return run(*a, **kw)

    def spy_math(self, y, token_keep, *a, **kw):
        calls["windows"].append(y.shape[0] * y.shape[1])
        return math_(self, y, token_keep, *a, **kw)

    monkeypatch.setattr(sparse_block, "sparse_window_block", spy_kernel)
    monkeypatch.setattr(MaskedSparseAttention, "block_math", spy_math)
    with torch.no_grad():
        yt = tm(torch.from_numpy(x), torch.from_numpy(tok), torch.from_numpy(win)).numpy()
    if not jax_first:
        expect = {"kernel": 0, "windows": [B * N]}
    elif sparse_kernel:
        expect = {"kernel": 1, "windows": []}
    else:
        expect = {"kernel": 0, "windows": [5]}
    assert calls == expect
    np.testing.assert_allclose(yt, yj, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("M_range", [(1, 33), (33, 65)])
def test_density_limit_is_the_float32_test(M_range):
    """``n <= density_limit(t, M)`` is JAX's float32 ``mean(win_keep) <= t``
    for every count n of every M in the range, at every tie ``t = n' / M``
    and at the thresholds 0.1, 0.25, 0.3, 0.4, 0.5 and 0.7 (the mean by
    ``jnp.mean`` of a bool mask with n kept; a Python threshold is cast to
    float32, as the layer's is)."""
    test = jax.jit(jax.vmap(jax.vmap(lambda w, t: jnp.mean(w.astype(jnp.float32)) <= t,
                                     (0, None)), (None, 0)))
    for M in range(*M_range):
        masks = np.arange(M)[None, :] < np.arange(M + 1)[:, None]  # row n keeps n
        thresholds = [n / M for n in range(M + 1)] + [0.1, 0.25, 0.3, 0.4, 0.5, 0.7]
        jax_says = np.asarray(test(jnp.asarray(masks), jnp.asarray(thresholds, jnp.float32)))
        for t, says in zip(thresholds, jax_says):
            limit = density_limit(t, M)
            np.testing.assert_array_equal(np.arange(M + 1) <= limit, says, err_msg=f"M {M} t {t}")
            got = [bool(branch_predicate(torch.from_numpy(m), limit)) for m in masks]
            np.testing.assert_array_equal(got, says, err_msg=f"M {M} t {t}")


@pytest.mark.parametrize("switches", [dict(gather_budget=1.0), dict(pallas_density_threshold=1.0)],
                         ids=["gather-1.0", "threshold-1.0"])
def test_static_choices_have_no_predicate(switches, monkeypatch):
    """At a gather budget of 1 (K == M) and a density threshold of 1 the
    branch is known from the shapes, as in JAX: the eager layer computes no
    predicate (no host read) and its export holds no ``torch.cond``."""
    from sast_tpu_torch.models import sast

    calls = []
    predicate = sast.branch_predicate
    monkeypatch.setattr(sast, "branch_predicate", lambda *a: calls.append(a) or predicate(*a))
    acfg = AttentionConfig(partition_size=(2, 3), dim_head=DH, ls_init_value=0.5, **switches)
    layer = MaskedSparseAttention(C, acfg, sparse_kernel="pallas_density_threshold" in switches)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    win, tok = _masks(3, 6)
    args = (torch.randn(B, N, HW, C, generator=g), torch.from_numpy(tok), torch.from_numpy(win))

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = layer

        def forward(self, x, t, w):
            return self.layer(x, t, w)

    with torch.no_grad():
        y = Wrap()(*args)
        program = torch.export.export(Wrap(), args, strict=False)
    assert not calls
    assert not any(n.target is torch.ops.higher_order.cond for n in program.graph.nodes)
    assert torch.equal(program.module()(*args), y)
