"""Port vs JAX package: the window-block functions behind the block kernels.

On the CPU the port's wrappers run their plain versions; the JAX package's
Pallas kernels run in interpret mode, patched in the way its own
tests/test_model.py does it (``pl.pallas_call`` with ``interpret=True`` for
the duration of a test; nothing in ``sast_tpu`` changes). Inputs and weights
come from a seeded numpy generator and go to both packages. fp32 throughout:
rtol 2e-4, atol 2e-5 (other summation order, other exp/tanh); tokens that
pass through are exact.
"""

from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sast_tpu.ops.pallas.fused_block as jfb
import sast_tpu.ops.pallas.sparse_block as jsb
from sast_tpu.models.sast import MaskedSparseAttention as JMSA
from sast_tpu_torch.config import AttentionConfig
from sast_tpu_torch.models.sast import MaskedSparseAttention
from sast_tpu_torch.ops import block, fused_block, sparse_block
from sast_tpu_torch.weights import load_jax_variables

RTOL, ATOL = 2e-4, 2e-5
M, HW, C, DH = 5, 6, 16, 8
HEADS = C // DH
INNER = 32
EPS = 1e-5


@pytest.fixture
def interpret():
    """Run every Pallas call of the JAX package in interpret mode."""
    orig = pl.pallas_call
    pl.pallas_call = partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


def _case(seed=0):
    """Window 0 fully kept, window 1 one kept token, window 2 skipped (with
    token flags that must be ignored), the rest random."""
    rng = np.random.RandomState(seed)
    y = rng.randn(M, HW, C).astype(np.float32)
    tok = rng.rand(M, HW) > 0.5
    tok[0] = True
    tok[1] = False
    tok[1, 3] = True
    win = np.array([True, True, False, True, True])
    tok[3, 0] = True
    tok[4, 1] = True
    tok &= win[:, None]

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    def v(n, shift=0.0):
        return (shift + 0.1 * rng.randn(n)).astype(np.float32)

    params = {
        "ln2_scale": v(C, 1.0), "ln2_bias": v(C),
        "wqkv": w(C, 3 * C), "bqkv": v(3 * C),
        "wproj": w(C, C), "bproj": v(C), "ls1": v(C, 0.7),
        "wglu": w(C, 2 * INNER), "bglu": v(2 * INNER),
        "wout": w(INNER, C), "bout": v(C), "ls2": v(C, 0.7),
    }
    return y, tok, win, params


def _both(params):
    return ({k: jnp.asarray(a) for k, a in params.items()},
            {k: torch.from_numpy(a) for k, a in params.items()})


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("save_h1", [False, True], ids=["out", "out+h1"])
def test_sparse_window_block_matches_jax(interpret, save_h1):
    y, tok, win, params = _case()
    pj, pt = _both(params)
    args_j = (jnp.asarray(y), jnp.asarray(tok), jnp.asarray(win), pj, HEADS, DH, EPS)
    args_t = (torch.from_numpy(y), torch.from_numpy(tok), torch.from_numpy(win), pt, HEADS, DH, EPS)
    if save_h1:
        out_j, h1_j = jsb._sparse_window_block_impl(*args_j, save_h1=True)
        out_t, h1_t = sparse_block.sparse_window_block(*args_t, save_h1=True)
        _close(h1_t.numpy(), np.asarray(h1_j)[:, :, :C], "h1")  # JAX keeps h1 lane-padded
        np.testing.assert_array_equal(h1_t.numpy()[2], y[2])
    else:
        out_j = jsb.sparse_window_block(*args_j)
        out_t = sparse_block.sparse_window_block(*args_t)
    _close(out_t.numpy(), out_j, "out")
    np.testing.assert_array_equal(out_t.numpy()[~tok], y[~tok])
    assert np.abs(out_t.numpy()[tok] - y[tok]).max() > 0.1


def test_block_window_plain_matches_jax_on_kept_windows(interpret):
    """The plain block on all windows equals the JAX kernel wherever the
    window is kept (the kernel skips the others)."""
    y, tok, win, params = _case(1)
    pj, pt = _both(params)
    out_j, h1_j = jsb._sparse_window_block_impl(
        jnp.asarray(y), jnp.asarray(tok), jnp.asarray(win), pj, HEADS, DH, EPS, save_h1=True)
    out_t, h1_t = block.block_window_plain(
        torch.from_numpy(y), torch.from_numpy(tok), pt, HEADS, DH, EPS, return_h1=True)
    _close(out_t.numpy()[win], np.asarray(out_j)[win], "out")
    _close(h1_t.numpy()[win], np.asarray(h1_j)[win][:, :, :C], "h1")


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_fused_window_block_matches_jax(interpret, reference):
    y, tok, win, params = _case(2)
    pj, pt = _both(params)
    fn = jfb._fused_fwd if reference == "pallas" else jfb.fused_block_xla
    out_j = fn(jnp.asarray(y), jnp.asarray(tok), pj, HEADS, DH, EPS)
    out_t = fused_block.fused_window_block(torch.from_numpy(y), torch.from_numpy(tok), pt,
                                           HEADS, DH, EPS)
    _close(out_t.numpy(), out_j, "out")
    np.testing.assert_array_equal(out_t.numpy()[~tok], y[~tok])


def test_fused_block_is_the_sparse_block_on_every_window():
    """Kernel D runs kernel E's launches with every window on the work list,
    so their functions must agree there: ``fused_block_plain`` against
    ``sparse_window_block_plain`` with ``win_keep`` all true, and both
    against JAX ``fused_block_xla``. Window 2 keeps no token: its output is
    ``y`` and finite."""
    y, tok, _, params = _case(5)
    assert not tok[2].any()
    pj, pt = _both(params)
    out_j = np.asarray(jfb.fused_block_xla(jnp.asarray(y), jnp.asarray(tok), pj, HEADS, DH, EPS))
    yt, tt = torch.from_numpy(y), torch.from_numpy(tok)
    out_d = fused_block.fused_block_plain(yt, tt, pt, HEADS, DH, EPS)
    out_e = sparse_block.sparse_window_block_plain(yt, tt, torch.ones(M, dtype=torch.bool), pt,
                                                   HEADS, DH, EPS)
    _close(out_d.numpy(), out_e.numpy(), "fused vs sparse")
    _close(out_d.numpy(), out_j, "fused vs fused_block_xla")
    _close(out_e.numpy(), out_j, "sparse vs fused_block_xla")
    for out in (out_d, out_e):
        assert torch.isfinite(out).all()
        np.testing.assert_array_equal(out.numpy()[~tok], y[~tok])
        np.testing.assert_array_equal(out.numpy()[2], y[2])


def _looped_case(density, hw, seed=3):
    """``_case``'s weights with windows of ``hw`` tokens (60 and 80 are the
    kernels' two core tilings, 4 and 5 row tiles of 16) at window density
    ``density``: none, some (window 0 kept, window 1 skipped) or all kept."""
    y, tok, win, params = _case(seed)
    rng = np.random.RandomState(seed + 10)
    y = rng.randn(M, hw, C).astype(np.float32)
    win = rng.rand(M) < density
    if 0.0 < density < 1.0:
        win[0], win[1] = True, False
    tok = (rng.rand(M, hw) > 0.5) & win[:, None]
    tok[0, 0] = win[0]
    return y, tok, win, params


@pytest.mark.parametrize("hw", [60, 80])
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_sparse_window_block_looped_matches_jax(interpret, density, hw):
    y, tok, win, params = _looped_case(density, hw)
    pj, pt = _both(params)
    out_j = jsb.sparse_window_block_looped(
        jnp.asarray(y), jnp.asarray(tok), jnp.asarray(win), pj, HEADS, DH, EPS)
    yt = torch.from_numpy(y.copy())
    out_t = sparse_block.sparse_window_block_looped(
        yt, torch.from_numpy(tok), torch.from_numpy(win), pt, HEADS, DH, EPS)
    _close(out_t.numpy(), out_j, "out")
    np.testing.assert_array_equal(out_t.numpy()[~tok], y[~tok])
    np.testing.assert_array_equal(yt.numpy(), y)  # the caller's tokens are left alone


def test_all_keys_masked_gives_finite_h1():
    """A kept window without a kept token: uniform softmax, finite h1, and
    the output is y."""
    y, tok, win, params = _case(4)
    tok[0] = False
    _, pt = _both(params)
    out, h1 = sparse_block.sparse_window_block(
        torch.from_numpy(y), torch.from_numpy(tok), torch.from_numpy(win), pt, HEADS, DH, EPS,
        save_h1=True)
    assert torch.isfinite(h1).all()
    np.testing.assert_array_equal(out.numpy()[0], y[0])


@pytest.mark.parametrize("bias,dtype", [(True, "float32"), (False, "float32"), (True, "bfloat16")],
                         ids=["bias-f32", "nobias-f32", "bias-bf16"])
def test_kernel_params_match_the_jax_module_key_by_key(bias, dtype):
    """``kernel_params`` of a port module loaded from a JAX init against the
    dict the JAX module builds (sast_tpu/models/sast.py, ``kernel_params``):
    matrices (in, out) in the compute dtype, vectors as stored, zeros for
    absent biases. Cached per module, rebuilt when a weight is written."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x = jnp.zeros((1, 2, HW, C), jnp.float32)
    jm = JMSA(dim=C, dim_head=DH, use_bias=bias, mlp_bias=bias, dtype=jdt)
    p = jax.device_get(jm.init(jax.random.PRNGKey(3), x, jnp.ones((1, 2, HW), bool)))["params"]
    acfg = AttentionConfig(partition_size=(2, 3), dim_head=DH, attention_bias=bias, mlp_bias=bias)
    tm = load_jax_variables(MaskedSparseAttention(C, acfg, tdt), {"params": p})
    inner = p["mlp"]["Dense_0"]["kernel"].shape[0]

    def b(tree, n):
        return tree["bias"] if bias else np.zeros((n,), np.float32)

    expected = {
        "ln2_scale": p["norm2"]["scale"], "ln2_bias": p["norm2"]["bias"],
        "wqkv": jnp.asarray(p["qkv"]["kernel"]).astype(jdt), "bqkv": b(p["qkv"], 3 * C),
        "wproj": jnp.asarray(p["proj"]["kernel"]).astype(jdt), "bproj": b(p["proj"], C),
        "ls1": p["ls1"]["gamma"], "ls2": p["ls2"]["gamma"],
        "wglu": jnp.asarray(p["mlp"]["GLU_0"]["Dense_0"]["kernel"]).astype(jdt),
        "bglu": b(p["mlp"]["GLU_0"]["Dense_0"], 2 * inner),
        "wout": jnp.asarray(p["mlp"]["Dense_0"]["kernel"]).astype(jdt),
        "bout": b(p["mlp"]["Dense_0"], C),
    }
    got = block.kernel_params(tm)
    assert set(got) == set(expected) == set(block.PARAM_KEYS)
    for key, ref in expected.items():
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        assert got[key].dtype == (tdt if key in block.MATRICES else torch.float32), key
        np.testing.assert_array_equal(got[key].float().numpy(), ref, err_msg=key)
    for key in block.MATRICES:  # the (out, in) tensor under the view is contiguous
        assert got[key].t().is_contiguous(), key
    assert block.kernel_params(tm) is got
    with torch.no_grad():
        tm.proj.kernel.mul_(2.0)
    np.testing.assert_array_equal(
        block.kernel_params(tm)["wproj"].float().numpy(),
        (tm.proj.kernel.detach().to(tdt).float().numpy()).T)
