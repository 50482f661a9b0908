"""Port vs JAX package: the backward of the block kernels and of the stem.

Inputs come from numpy seeds, fp32, tiny shapes. The JAX side differentiates
its own functions with ``jax.grad`` (its Pallas kernels in interpret mode, as
tests/test_model.py runs them); the port's wrappers get CPU tensors, so their
``torch.autograd.Function``s run the kernels' plain versions: for the sparse
block that is ``sparse_window_block_bwd_plain``, the hand-written backward's
arithmetic step by step.
"""

from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sast_tpu.ops.pallas import fused_block as j_fused
from sast_tpu.ops.pallas import sparse_block as j_sparse
from sast_tpu.ops.pallas import stem_conv as j_stem
from sast_tpu_torch.ops import block, fused_block, sparse_block, stem_conv

M, HW, C, DH, INNER = 5, 8, 16, 8, 32
HEADS = C // DH
MATRICES = block.MATRICES


@pytest.fixture
def interpret(monkeypatch):
    """Run every Pallas call of the JAX package in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", partial(orig, interpret=True))
    monkeypatch.setattr(j_stem, "_pallas_call", partial(orig, interpret=True))


def _case(seed, windows):
    """Tokens, masks (kept windows as given, ~60% of their tokens kept, one
    window with a single kept token), a cotangent-shaping weight and the 12
    block parameters in the JAX layout (matrices ``(in, out)``)."""
    rng = np.random.RandomState(seed)
    y = rng.randn(M, HW, C).astype(np.float32)
    win = np.asarray(windows, bool)
    tok = (rng.rand(M, HW) > 0.4) & win[:, None]
    if win.any():
        first = int(np.argmax(win))
        tok[first] = False
        tok[first, 3] = True
    win = win & tok.any(-1)
    w = rng.randn(M, HW, C).astype(np.float32)

    def r(*shape, scale=0.3, shift=0.0):
        return (shift + scale * rng.randn(*shape)).astype(np.float32)

    params = {
        "ln2_scale": r(C, scale=0.1, shift=1.0), "ln2_bias": r(C, scale=0.1),
        "wqkv": r(C, 3 * C), "bqkv": r(3 * C, scale=0.1),
        "wproj": r(C, C), "bproj": r(C, scale=0.1), "ls1": r(C, scale=0.1, shift=0.5),
        "wglu": r(C, 2 * INNER), "bglu": r(2 * INNER, scale=0.1),
        "wout": r(INNER, C), "bout": r(C, scale=0.1), "ls2": r(C, scale=0.1, shift=0.5),
    }
    return y, tok, win, w, params


def _jax_grads(fn, y, tok, win, w, params):
    """``jax.grad`` of ``sum(fn(...) * w)`` wrt y and the params dict."""
    def loss(yy, pp):
        return jnp.sum(fn(yy, pp) * w)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    gy, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(y), jp)
    return np.asarray(gy), {k: np.asarray(v) for k, v in gp.items()}


def _torch_params(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def _leaves(params):
    """The parameters in the port's layout (matrices ``(out, in)``), as
    leaves that require grad, in ``PARAM_KEYS`` order."""
    return [torch.from_numpy(np.ascontiguousarray(params[k].T) if k in MATRICES else params[k].copy())
            .requires_grad_() for k in block.PARAM_KEYS]


CASES = {"three-of-five": (1, [1, 0, 1, 1, 0]), "all": (2, [1] * 5), "one": (3, [0, 0, 0, 1, 0])}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_grad(interpret, case):
    """``sparse_window_block_bwd_plain`` (dy and all 12 parameter gradients)
    against ``jax.grad`` of the JAX ``sparse_window_block``, whose backward is
    its two Pallas kernels. rtol 2e-4 / atol 1e-5, the tolerance
    tests/test_model.py holds those kernels to against XLA autodiff."""
    seed, windows = CASES[case]
    y, tok, win, w, params = _case(seed, windows)
    fn = lambda yy, pp: j_sparse.sparse_window_block(
        yy, jnp.asarray(tok), jnp.asarray(win), pp, num_heads=HEADS, dim_head=DH)
    gy, gp = _jax_grads(fn, y, tok, win, w, params)

    tp = _torch_params(params)
    ty, ttok, twin = torch.from_numpy(y), torch.from_numpy(tok), torch.from_numpy(win)
    out, h1 = sparse_block.sparse_window_block_plain(ty, ttok, twin, tp, HEADS, DH, save_h1=True)
    dy, dp = sparse_block.sparse_window_block_bwd_plain(
        ty, ttok, twin, tp, h1, torch.from_numpy(w), HEADS, DH)
    np.testing.assert_allclose(dy.numpy(), gy, rtol=2e-4, atol=1e-5)
    assert set(dp) == set(block.PARAM_KEYS)
    for key in block.PARAM_KEYS:
        np.testing.assert_allclose(dp[key].numpy(), gp[key], rtol=2e-4, atol=1e-5, err_msg=key)
        assert np.abs(gp[key]).max() > 1e-3, key  # the case exercises every parameter


def _jax_bwd_kernel_io(monkeypatch, case):
    """``jax.grad`` of the JAX ``sparse_window_block`` on ``CASES[case]``
    with every Pallas call in interpret mode, capturing each kernel's
    arguments and outputs as numpy arrays by kernel name; returns them with
    the case's inputs."""
    captured = {}
    orig = pl.pallas_call

    def spy(kernel, **kw):
        fn = orig(kernel, interpret=True, **kw)
        name = getattr(kernel, "func", kernel).__name__

        def call(*args):
            out = fn(*args)
            captured[name] = ([np.asarray(a) for a in args], [np.asarray(o) for o in out])
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", spy)
    seed, windows = CASES[case]
    y, tok, win, w, params = _case(seed, windows)
    fn = lambda yy, pp: j_sparse.sparse_window_block(
        yy, jnp.asarray(tok), jnp.asarray(win), pp, num_heads=HEADS, dim_head=DH)
    _jax_grads(fn, y, tok, win, w, params)
    return captured, (y, tok, win, params)


@pytest.mark.parametrize("case", list(CASES))
def test_mlp_branch_plain_matches_jax_mlp_bwd_kernel(monkeypatch, case):
    """Kernel G's plain version alone against the JAX ``_mlp_bwd_kernel``
    (interpret mode): the same h1 and cotangent that the JAX kernel got, and
    its raw fp32 outputs (gh1, the two matrix and three vector gradients).
    rtol 2e-4 / atol 1e-5 as above."""
    captured, (y, tok, win, params) = _jax_bwd_kernel_io(monkeypatch, case)
    args, outs = captured["_mlp_bwd_kernel"]
    h1 = torch.from_numpy(args[2][..., :C].copy())  # ids, n_win, h1, keep, g, ...
    g = torch.from_numpy(args[4][..., :C].copy())
    ttok, twin = torch.from_numpy(tok), torch.from_numpy(win)
    gh1, acc = sparse_block.sparse_block_mlp_bwd_plain(
        h1, ttok, block.work_list(twin), _torch_params(params), g)
    jgh1, dwglu, dbglu, dwout, dbout, dls2 = outs
    np.testing.assert_allclose(gh1.numpy(), jgh1[..., :C], rtol=2e-4, atol=1e-5)
    want = dict(wglu=dwglu, bglu=dbglu[0], wout=dwout, bout=dbout[0], ls2=dls2[0])
    assert set(acc) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(acc[key].numpy(), ref, rtol=2e-4, atol=1e-5, err_msg=key)
        assert np.abs(ref).max() > 1e-3, key


@pytest.mark.parametrize("case", list(CASES))
def test_attn_branch_plain_matches_jax_attn_bwd_kernel(monkeypatch, case):
    """Kernel H's plain version alone against the JAX ``_attn_bwd_kernel``
    (interpret mode): the same ``gh1`` that the JAX MLP-branch kernel handed
    it, and its raw fp32 outputs (dy, the two matrix and five vector
    gradients). rtol 2e-4 / atol 1e-5 as above."""
    captured, (y, tok, win, params) = _jax_bwd_kernel_io(monkeypatch, case)
    args, outs = captured["_attn_bwd_kernel"]
    gh1 = torch.from_numpy(args[4][..., :C].copy())  # ids, n_win, y, keep, gh1, ...
    ty, ttok, twin = torch.from_numpy(y), torch.from_numpy(tok), torch.from_numpy(win)
    dy, acc = sparse_block.sparse_block_attn_bwd_plain(
        ty, ttok, block.work_list(twin), _torch_params(params), gh1, HEADS, DH)
    jdy, dwqkv, dbqkv, dwproj, dbproj, dls1, ds2, db2 = outs
    np.testing.assert_allclose(dy.numpy(), jdy[..., :C], rtol=2e-4, atol=1e-5)
    want = dict(wqkv=dwqkv[:C], bqkv=dbqkv[0], wproj=dwproj, bproj=dbproj[0], ls1=dls1[0],
                ln2_scale=ds2[0], ln2_bias=db2[0])
    assert set(acc) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(acc[key].numpy(), ref, rtol=2e-4, atol=1e-5, err_msg=key)
        assert np.abs(ref).max() > 1e-3, key


@pytest.mark.parametrize("case", list(CASES))
def test_sparse_block_function_matches_jax_grad(interpret, case):
    """The ``autograd.Function`` behind ``sparse_window_block`` under grad
    mode: gradients land on the leaves in the port's ``(out, in)`` layout."""
    seed, windows = CASES[case]
    y, tok, win, w, params = _case(seed, windows)
    fn = lambda yy, pp: j_sparse.sparse_window_block(
        yy, jnp.asarray(tok), jnp.asarray(win), pp, num_heads=HEADS, dim_head=DH)
    gy, gp = _jax_grads(fn, y, tok, win, w, params)

    leaves = _leaves(params)
    ty = torch.from_numpy(y).requires_grad_()
    out = sparse_block.sparse_window_block(
        ty, torch.from_numpy(tok), torch.from_numpy(win), _torch_params(params), HEADS, DH,
        leaves=leaves)
    assert out.grad_fn is not None
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [ty] + leaves)
    np.testing.assert_allclose(grads[0].numpy(), gy, rtol=2e-4, atol=1e-5)
    for key, g in zip(block.PARAM_KEYS, grads[1:]):
        ref = gp[key].T if key in MATRICES else gp[key]
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=1e-5, err_msg=key)


def test_backward_with_no_window_kept(interpret):
    """Zero kept windows: dy is the cotangent and every parameter gradient
    is exactly zero, in the plain backward and through the Function."""
    y, tok, win, w, params = _case(4, [0] * 5)
    assert not win.any() and not tok.any()
    tp = _torch_params(params)
    ty, ttok, twin = torch.from_numpy(y), torch.from_numpy(tok), torch.from_numpy(win)
    out, h1 = sparse_block.sparse_window_block_plain(ty, ttok, twin, tp, HEADS, DH, save_h1=True)
    assert torch.equal(out, ty)
    dy, dp = sparse_block.sparse_window_block_bwd_plain(
        ty, ttok, twin, tp, h1, torch.from_numpy(w), HEADS, DH)
    assert torch.equal(dy, torch.from_numpy(w))
    assert all(not dp[k].any() for k in block.PARAM_KEYS)

    leaves = _leaves(params)
    ty.requires_grad_()
    out = sparse_block.sparse_window_block(ty, ttok, twin, tp, HEADS, DH, leaves=leaves)
    grads = torch.autograd.grad(out.sum(), [ty] + leaves)
    assert torch.equal(grads[0], torch.ones_like(ty))
    assert all(not g.any() for g in grads[1:])


def test_sparse_block_function_without_leaves_and_with_absent_biases():
    """Only ``y`` takes a gradient when no leaves are given; a ``None`` leaf
    (a Dense without bias) takes none."""
    y, tok, win, w, params = _case(5, [1, 1, 0, 1, 0])
    for k in ("bqkv", "bproj", "bglu", "bout"):
        params[k] = np.zeros_like(params[k])
    tp = _torch_params(params)
    args = (torch.from_numpy(tok), torch.from_numpy(win), tp, HEADS, DH)
    ty = torch.from_numpy(y).requires_grad_()
    (gy,) = torch.autograd.grad((sparse_block.sparse_window_block(ty, *args)
                                 * torch.from_numpy(w)).sum(), [ty])
    leaves = [None if k.startswith("b") else t for k, t in zip(block.PARAM_KEYS, _leaves(params))]
    ty2 = torch.from_numpy(y).requires_grad_()
    out = sparse_block.sparse_window_block(ty2, *args, leaves=leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [ty2] + [t for t in leaves if t is not None])
    assert torch.equal(grads[0], gy)
    assert len(grads) == 1 + 8 and all(g.abs().max() > 0 for g in grads)
    with pytest.raises(ValueError, match="save_h1"):
        sparse_block.sparse_window_block(ty, *args, save_h1=True)
    with pytest.raises(RuntimeError, match="no backward"):
        sparse_block.sparse_window_block_looped(ty, *args)


def test_fused_block_function_matches_jax_grad(interpret):
    """Kernel D's Function (plain forward on the CPU, backward by autograd of
    the plain block) against ``jax.grad`` of the JAX ``fused_window_block``
    (Pallas forward in interpret mode, XLA VJP). Same tolerance."""
    y, tok, win, w, params = _case(6, [1] * 5)
    fn = lambda yy, pp: j_fused.fused_window_block(yy, jnp.asarray(tok), pp, HEADS, DH, 1e-5)
    gy, gp = _jax_grads(fn, y, tok, win, w, params)
    leaves = _leaves(params)
    ty = torch.from_numpy(y).requires_grad_()
    out = fused_block.fused_window_block(ty, torch.from_numpy(tok), _torch_params(params),
                                         HEADS, DH, leaves=leaves)
    assert type(out.grad_fn).__name__.startswith("_FusedBlockFn")
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [ty] + leaves)
    np.testing.assert_allclose(grads[0].numpy(), gy, rtol=2e-4, atol=1e-5)
    for key, g in zip(block.PARAM_KEYS, grads[1:]):
        ref = gp[key].T if key in MATRICES else gp[key]
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("with_density", [False, True])
def test_stem_function_matches_jax_grad(interpret, with_density):
    """Kernel A's Function: the weight gradient for a uint8 input against
    ``jax.grad`` of ``stem_conv(_density)_raw_7x4`` wrt w. 5e-4 of
    max|grad|: fp32 sums over B * 16 * 24 outputs in another order."""
    rng = np.random.RandomState(7)
    B, H, W, Cin, Cout = 2, 64, 96, 20, 32
    x = rng.poisson(0.25, (B, H, W, Cin)).clip(0, 255).astype(np.uint8)
    w = (rng.randn(7, 7, Cin, Cout) * 0.05).astype(np.float32)
    cot = rng.randn(B, H // 4, W // 4, Cout).astype(np.float32)

    def loss(ww):
        if with_density:
            yj, _ = j_stem.stem_conv_density_raw_7x4(jnp.asarray(x), ww)
        else:
            yj = j_stem.stem_conv_raw_7x4(jnp.asarray(x), ww)
        return jnp.sum(yj * cot)

    gw = np.asarray(jax.grad(loss)(jnp.asarray(w)))  # HWIO
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    out = stem_conv.stem_conv7x4(torch.from_numpy(x), tw, with_density=with_density)
    yt = out[0] if with_density else out
    assert type(yt.grad_fn).__name__.startswith("_StemFn")
    if with_density:
        assert not out[1].requires_grad
    (g,) = torch.autograd.grad((yt * torch.from_numpy(cot)).sum(), [tw])
    scale = float(np.abs(gw).max())
    np.testing.assert_allclose(g.numpy().transpose(2, 3, 1, 0), gw, rtol=0, atol=5e-4 * scale)

