"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package, so on a machine with a card and
without JAX it runs alone (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sast_tpu_torch.ops import block, density, fused_block, nms_keep, sparse_block, stem_conv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _events(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.poisson(0.3, shape).clip(0, 255).astype(np.uint8)
    x[0, : shape[1] // 3] = 0
    x[-1, :, -5:] = 255
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((2, 64, 96, 20), 32), ((1, 32, 64, 8), 128), ((2, 64, 96, 20), 48), ((2, 64, 96, 20), 96),
    ((12, 384, 640, 20), 64), ((1, 32, 32, 32), 128)])
def test_stem_kernel_matches_plain(dev, dtype, shape, cout):
    """fp32: other summation order (1e-5 of max|y|); bf16: both round an
    fp32 sum to bf16 (two bf16 ulps at max|y|). Density ratio exact. The
    shapes cover a ragged last tile (W 96), Cout in one and two slices, the
    training step's 12 lanes, and weights streamed per kernel row (C 32)."""
    x = _events(shape, 0).to(dev)
    w = (torch.randn(cout, shape[-1], 7, 7, generator=torch.Generator().manual_seed(0))
         * 0.05).to(dev, dtype)
    n = stem_conv.stem_conv7x4.launches
    y, r = stem_conv.stem_conv7x4(x, w, with_density=True)
    yp, rp = stem_conv.stem_conv7x4_plain(x, w, with_density=True)
    torch.cuda.synchronize()
    assert stem_conv.stem_conv7x4.launches == n + 1
    scale = yp.float().abs().max().item()
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * scale
    assert (y.float() - yp.float()).abs().max().item() <= tol
    assert torch.equal(r, rp)


def test_density_kernel_matches_plain_exactly(dev):
    x = _events((3, 96, 64, 12), 1).to(dev)
    n = density.density_ratio.launches
    assert torch.equal(density.density_ratio(x), density.density_ratio_plain(x))
    assert density.density_ratio.launches == n + 1


def _density_input(name, shape):
    """Kernel B's edges: all zero, every value non-zero, or zero but for one
    event at each corner of one 32x32 tile (each in its own channel) in the
    last image; ``events`` as ``_events``."""
    B, H, W, C = shape
    if name == "events":
        return _events(shape, 2)
    if name == "zeros":
        return torch.zeros(shape, dtype=torch.uint8)
    if name == "nonzero":
        return torch.randint(1, 256, shape, dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(3))
    x = torch.zeros(shape, dtype=torch.uint8)
    for i, (r, c) in enumerate([(32, 32), (32, 63), (63, 32), (63, 63)]):
        x[-1, r, c, (3 * i) % C] = 1 + i
    return x


@pytest.mark.parametrize("name", ["events", "zeros", "nonzero", "corners"])
@pytest.mark.parametrize("shape", [(1, 64, 96, 20), (3, 64, 96, 20), (2, 96, 64, 4),
                                   (1, 64, 64, 32), (4, 384, 640, 20), (12, 384, 640, 20)],
                         ids=lambda s: "x".join(map(str, s)))
def test_density_kernel_edge_inputs(dev, shape, name):
    """Kernel B bit-equal to its plain version on its edges: one and three
    images, C of 4, 20 and 32, and the stem inputs of the serving (b4) and
    training (B 12) steps; twice in a row, since the kernel's per-image
    tickets must be back at 0 after each call."""
    x = _density_input(name, shape).to(dev)
    ref = density.density_ratio_plain(x)
    for _ in range(2):
        assert torch.equal(density.density_ratio(x), ref)


def _candidates(rng, n, k, spread):
    """Score-sorted candidates in clusters of width ``spread`` (long
    suppression chains), the last eighth invalid."""
    centers = rng.rand(n, 6, 2) * 300
    xy = centers[np.arange(n)[:, None], rng.randint(0, 6, (n, k))] + rng.randn(n, k, 2) * spread
    wh = 5 + rng.rand(n, k, 2) * 40
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.rand(n, k).astype(np.float32), -1)[:, ::-1].copy()
    scores[:, k - k // 8:] = 0.0
    return boxes, scores


def _greedy_case(name):
    """(boxes, scores, threshold): random boxes (3 x 1500), clustered ones
    at the serving step's and ``eval_step``'s frame counts and at the
    largest K, and the edges of the kernel's 64-candidate words and of its
    arithmetic (as tests/test_torch_kernels.py holds the plain version to
    JAX on them)."""
    rng = np.random.RandomState(2)
    if name == "random":  # more candidates than threads had the first design
        n, k = 3, 1500
        xy = rng.rand(n, k, 2) * 300
        wh = 5 + rng.rand(n, k, 2) * 40
        boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
        scores = np.sort(rng.rand(n, k).astype(np.float32), -1)[:, ::-1].copy()
        scores[:, -200:] = 0.0
    elif name.startswith("N"):
        n, k = map(int, name[1:].split("xK"))
        boxes, scores = _candidates(rng, n, k, 15.0)
    elif name.startswith("K"):
        boxes, scores = _candidates(rng, 2, int(name[1:]), 15.0)
    else:
        boxes, scores = _candidates(rng, 2, 130, 15.0)
    if name == "all-scores-zero":
        scores[:] = 0.0
    elif name == "duplicates":
        boxes[:, 1::2] = boxes[:, 0::2]
    elif name == "zero-area":
        boxes[:, ::3, 2] = boxes[:, ::3, 0]
    elif name == "invalid-between-valid":
        scores[:, 10:20] = 0.0
    elif name == "iou-at-threshold":
        boxes = np.array([[[0, 0, 2, 1], [0, 0, 1, 1], [0, 0, 1, 1]]], np.float32)
        scores = np.array([[0.9, 0.8, 0.7]], np.float32)
        return boxes, scores, 0.5
    return boxes, scores, 0.45


@pytest.mark.parametrize("case", [
    "random", "N1xK1000", "N4xK1000", "N36xK1000", "N1xK4096", "K1", "K63", "K64", "K65", "K200",
    "all-scores-zero", "duplicates", "iou-at-threshold", "zero-area", "invalid-between-valid"])
def test_greedy_keep_kernel_matches_plain_exactly(dev, case):
    """Kernel C (the suppression bitmask, then one warp per image) bit-equal
    to its plain version, one launch counted."""
    boxes, scores, thr = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                          for a in _greedy_case(case))
    n = nms_keep.greedy_keep.launches
    got = nms_keep.greedy_keep(boxes.to(dev), scores.to(dev), thr).cpu()
    assert nms_keep.greedy_keep.launches == n + 1
    assert torch.equal(got, nms_keep.greedy_keep_plain(boxes, scores, thr))


def _block_case(M, hw, C, dim_head, ydt, wdt, density, seed, dev):
    """Seeded tokens, masks and weights of one block-kernel case: window
    density ``density``, token density 0.5 inside kept windows, one kept
    window with a single kept token, LayerScale of order 1 so that the
    attention and the MLP really move the output."""
    rng = np.random.RandomState(seed)
    inner = max(32, C * 4 * 2 // 3 // 32 * 32)
    win = rng.rand(M) < density
    win[0] = True
    tok = (rng.rand(M, hw) < 0.5) & win[:, None]
    tok[0] = False
    tok[0, hw // 2] = True
    win &= tok.any(-1)

    def mat(k, n):  # (out, in) storage, handed over as the (in, out) view
        return torch.from_numpy((rng.randn(n, k) / np.sqrt(k)).astype(np.float32)).to(dev, wdt).t()

    def vec(n, scale, shift=0.0):
        return torch.from_numpy((shift + scale * rng.randn(n)).astype(np.float32)).to(dev)

    params = {
        "ln2_scale": vec(C, 0.1, 1.0), "ln2_bias": vec(C, 0.1),
        "wqkv": mat(C, 3 * C), "bqkv": vec(3 * C, 0.1),
        "wproj": mat(C, C), "bproj": vec(C, 0.1), "ls1": vec(C, 0.1, 1.0),
        "wglu": mat(C, 2 * inner), "bglu": vec(2 * inner, 0.1),
        "wout": mat(inner, C), "bout": vec(C, 0.1), "ls2": vec(C, 0.1, 1.0),
    }
    y = torch.from_numpy(rng.randn(M, hw, C).astype(np.float32)).to(dev, ydt)
    return y, torch.from_numpy(tok).to(dev), torch.from_numpy(win).to(dev), params


def _block_tol(ref, wdt):
    """fp32: the interpret-mode tolerance of the JAX package's own kernel
    test (rtol 2e-4, atol 2e-5 x max|ref|; other summation order, expf and
    tanhf ulps). bf16 weights: two bf16 ulps at max|ref| (operands rounded
    to bf16 at other values once sums differ in the last fp32 bits)."""
    scale = ref.float().abs().max().item()
    if wdt == torch.float32:
        return 2e-4, 2e-5 * scale
    return 0.0, 2 ** -7 * scale


BLOCK_SHAPES = [  # M, hw, C, dim_head: small, gen1-like rows, a wide stage
    (6, 60, 64, 32), (5, 80, 128, 32), (3, 12, 32, 16), (2, 60, 512, 32),
]
BLOCK_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16)]
TRAIN_STAGE4 = (48, 60, 512, 32)  # the last stage of the gen4-base B = 12 training step


@pytest.mark.parametrize("ydt,wdt", BLOCK_DTYPES, ids=["f32", "bf16", "f32-bf16w"])
@pytest.mark.parametrize("shape", BLOCK_SHAPES + [TRAIN_STAGE4],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", ["fused", "sparse", "sparse_h1", "looped"])
def test_block_kernels_match_plain(dev, kernel, shape, ydt, wdt):
    """Kernels D, E (with and without h1) and F against the plain block at
    window density 0.5, also at a stage shape of the B = 12 training step,
    where E's h1 is the residual the backward reads. Unkept tokens and
    skipped windows bit-equal to y."""
    M, hw, C, dh = shape
    y, tok, win, params = _block_case(M, hw, C, dh, ydt, wdt, 0.5, 0, dev)
    heads = C // dh
    h1 = h1_ref = None
    if kernel == "fused":
        tok = tok | ~win[:, None] & (torch.arange(hw, device=dev) % 3 == 0)  # no window skipped
        wrapper = fused_block.fused_window_block
        n = wrapper.launches
        got = wrapper(y, tok, params, heads, dh)
        ref = fused_block.fused_block_plain(y, tok, params, heads, dh)
    elif kernel == "looped":
        wrapper = sparse_block.sparse_window_block_looped
        n = wrapper.launches
        y0 = y.clone()
        got = wrapper(y, tok, win, params, heads, dh)
        assert torch.equal(y, y0)  # the caller's y is untouched
        ref = sparse_block.sparse_window_block_plain(y, tok, win, params, heads, dh)
    else:
        wrapper = sparse_block.sparse_window_block
        n = wrapper.launches
        save = kernel == "sparse_h1"
        got = wrapper(y, tok, win, params, heads, dh, save_h1=save)
        ref = sparse_block.sparse_window_block_plain(y, tok, win, params, heads, dh, save_h1=save)
        if save:
            (got, h1), (ref, h1_ref) = got, ref
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1
    rtol, atol = _block_tol(ref, wdt)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    assert torch.equal(got[~tok], y[~tok])
    if h1 is not None:
        assert torch.isfinite(h1).all()
        rtol, atol = _block_tol(h1_ref, wdt)
        torch.testing.assert_close(h1[win], h1_ref[win], rtol=rtol, atol=atol)
        assert torch.equal(h1[~win], y[~win].float())


B4_STAGES = [(1024, 60, 64, 32), (256, 60, 128, 32), (64, 60, 256, 32), (16, 60, 512, 32)]


@pytest.mark.parametrize("density", [0.0, 0.4, 1.0, "none"])
@pytest.mark.parametrize("ydt,wdt", BLOCK_DTYPES[:2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", B4_STAGES, ids=lambda s: "x".join(map(str, s)))
def test_looped_kernel_is_the_sparse_kernel(dev, shape, ydt, wdt, density):
    """Kernel F (one cooperative launch) against kernel E (six launches) at
    the four gen4-base b4 stage shapes: F runs E's device routines in E's
    order, so the same bits, and the same bits again on a second launch.
    Density 0 keeps one window with one kept token; "none" keeps no window
    (every token passes through)."""
    M, hw, C, dh = shape
    y, tok, win, params = _block_case(M, hw, C, dh, ydt, wdt, 0.0 if density == "none" else density,
                                      5, dev)
    if density == "none":
        win, tok = torch.zeros_like(win), torch.zeros_like(tok)
    n = sparse_block.sparse_window_block_looped.launches
    with torch.no_grad():
        got = sparse_block.sparse_window_block_looped(y, tok, win, params, C // dh, dh)
        again = sparse_block.sparse_window_block_looped(y, tok, win, params, C // dh, dh)
        e = sparse_block.sparse_window_block(y, tok, win, params, C // dh, dh)
    ref = sparse_block.sparse_window_block_plain(y, tok, win, params, C // dh, dh)
    torch.cuda.synchronize()
    assert sparse_block.sparse_window_block_looped.launches == n + 2
    assert torch.equal(got, e)
    assert torch.equal(got, again)
    rtol, atol = _block_tol(ref, wdt)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    assert torch.equal(got[~tok], y[~tok])


def test_looped_kernel_raises_on_a_refused_launch(dev, monkeypatch):
    """A cooperative grid larger than the card holds at once is refused by
    the launch: the wrapper raises and counts no launch."""
    y, tok, win, params = _block_case(4, 60, 64, 32, torch.float32, torch.float32, 0.5, 1, dev)
    monkeypatch.setattr(sparse_block, "LOOPED_BLOCKS", 1 << 20)
    n = sparse_block.sparse_window_block_looped.launches
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA error"):
        sparse_block.sparse_window_block_looped(y, tok, win, params, 2, 32)
    assert sparse_block.sparse_window_block_looped.launches == n


@pytest.mark.parametrize("ydt,wdt", BLOCK_DTYPES[:2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(7, 52, 64, 32), (3, 60, 512, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_kernel_windows_without_kept_tokens(dev, shape, ydt, wdt):
    """Kernel D on kernel E's launches over every window, where M x hw is
    not a multiple of the GEMMs' 64-row tile (364, 180 rows) and windows
    keep no token: those run through the core with every key masked, and
    their output must be y, bit for bit and finite."""
    M, hw, C, dh = shape
    y, tok, win, params = _block_case(M, hw, C, dh, ydt, wdt, 0.5, 7, dev)
    tok[1] = False
    n = fused_block.fused_window_block.launches
    got = fused_block.fused_window_block(y, tok, params, C // dh, dh)
    ref = fused_block.fused_block_plain(y, tok, params, C // dh, dh)
    torch.cuda.synchronize()
    assert fused_block.fused_window_block.launches == n + 1
    assert not bool(tok.any(-1).all())
    rtol, atol = _block_tol(ref, wdt)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got[~tok], y[~tok])


def _bwd_tol(ref, wdt):
    """fp32: as the forward (other summation order, atomics in any order).
    bf16 weights: the products g W^T round their first operand to bf16, and
    a sum that differs in its last fp32 bits flips such a rounding, so four
    bf16 ulps at max|ref| (the matrix gradients are themselves rounded to
    bf16 at the end)."""
    scale = ref.float().abs().max().item()
    if wdt == torch.float32:
        return 2e-4, 2e-5 * scale
    return 0.0, 2 ** -6 * scale


@pytest.mark.parametrize("ydt,wdt", BLOCK_DTYPES, ids=["f32", "bf16", "f32-bf16w"])
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_kernels_match_plain(dev, shape, ydt, wdt):
    """Kernels G and H (``sparse_window_block_bwd``) against the plain
    backward: dy and the 12 parameter gradients; skipped windows' dy is the
    cotangent itself."""
    M, hw, C, dh = shape
    y, tok, win, params = _block_case(M, hw, C, dh, ydt, wdt, 0.5, 0, dev)
    heads = C // dh
    g = torch.from_numpy(np.random.RandomState(5).randn(M, hw, C).astype(np.float32)).to(dev, ydt)
    _, h1 = sparse_block.sparse_window_block(y, tok, win, params, heads, dh, save_h1=True)
    n = (sparse_block.sparse_block_mlp_bwd.launches, sparse_block.sparse_block_attn_bwd.launches)
    dy, dp = sparse_block.sparse_window_block_bwd(y, tok, win, params, h1, g, heads, dh)
    torch.cuda.synchronize()
    assert (sparse_block.sparse_block_mlp_bwd.launches,
            sparse_block.sparse_block_attn_bwd.launches) == (n[0] + 1, n[1] + 1)
    dy_ref, dp_ref = sparse_block.sparse_window_block_bwd_plain(
        y, tok, win, params, h1, g, heads, dh)
    rtol, atol = _bwd_tol(dy_ref, wdt)
    torch.testing.assert_close(dy.float(), dy_ref.float(), rtol=rtol, atol=atol)
    assert torch.equal(dy[~win], g[~win])
    for key in block.PARAM_KEYS:
        assert dp[key].dtype == params[key].dtype and dp[key].shape == params[key].shape
        rtol, atol = _bwd_tol(dp_ref[key], wdt)
        torch.testing.assert_close(dp[key].float(), dp_ref[key].float(), rtol=rtol, atol=atol,
                                   msg=lambda m, key=key: f"{key}: {m}")


@pytest.mark.parametrize("ydt,wdt", BLOCK_DTYPES[:2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [BLOCK_SHAPES[0], BLOCK_SHAPES[3], (3072, 60, 64, 32)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("density", [0.5, 1.0])
def test_attn_bwd_kernel_is_deterministic(dev, density, shape, ydt, wdt):
    """Kernel H adds no float atomics: two launches on the same inputs give
    bit-equal dy and gradients, also with every window kept and at the
    first stage of the B = 12 training step (the most partials per
    reduction)."""
    M, hw, C, dh = shape
    y, tok, win, params = _block_case(M, hw, C, dh, ydt, wdt, density, 4, dev)
    gh1 = torch.from_numpy(np.random.RandomState(6).randn(M, hw, C).astype(np.float32)).to(dev)
    work = block.work_list(win)
    first = sparse_block.sparse_block_attn_bwd(y, tok, work, params, gh1, C // dh, dh)
    second = sparse_block.sparse_block_attn_bwd(y, tok, work, params, gh1, C // dh, dh)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for key in sparse_block.ATTN_KEYS:
        assert torch.equal(first[1][key], second[1][key]), key
        assert first[1][key].abs().max() > 0, key


@pytest.mark.parametrize("ydt,wdt", BLOCK_DTYPES[:2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [BLOCK_SHAPES[0], BLOCK_SHAPES[3], (3072, 60, 64, 32)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("density", [0.5, 1.0])
def test_mlp_bwd_kernel_is_deterministic(dev, density, shape, ydt, wdt):
    """Kernel G adds no float atomics: two launches on the same inputs give
    bit-equal gh1 and gradients, as for kernel H above."""
    M, hw, C, dh = shape
    y, tok, win, params = _block_case(M, hw, C, dh, ydt, wdt, density, 4, dev)
    _, h1 = sparse_block.sparse_window_block(y, tok, win, params, C // dh, dh, save_h1=True)
    g = torch.from_numpy(np.random.RandomState(6).randn(M, hw, C).astype(np.float32)).to(dev, ydt)
    work = block.work_list(win)
    first = sparse_block.sparse_block_mlp_bwd(h1, tok, work, params, g, C // dh, dh)
    second = sparse_block.sparse_block_mlp_bwd(h1, tok, work, params, g, C // dh, dh)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for key in sparse_block.MLP_KEYS:
        assert torch.equal(first[1][key], second[1][key]), key
        assert first[1][key].abs().max() > 0, key


def test_bwd_kernels_no_window_kept(dev):
    """With no kept window dy is the cotangent and every parameter gradient
    is exactly zero; kernel G, which writes its gradients whole into fresh
    memory, gives exactly zero on its own."""
    y, tok, win, params = _block_case(4, 60, 64, 32, torch.float32, torch.float32, 0.5, 2, dev)
    tok, win = torch.zeros_like(tok), torch.zeros_like(win)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(0)).to(dev)
    _, h1 = sparse_block.sparse_window_block(y, tok, win, params, 2, 32, save_h1=True)
    dy, dp = sparse_block.sparse_window_block_bwd(y, tok, win, params, h1, g, 2, 32)
    assert torch.equal(dy, g)
    assert all(not dp[key].any() for key in block.PARAM_KEYS)
    gh1, acc = sparse_block.sparse_block_mlp_bwd(h1, tok, block.work_list(win), params, g, 2, 32)
    assert torch.equal(gh1, g)
    assert set(acc) == set(sparse_block.MLP_KEYS) and all(not v.any() for v in acc.values())


@pytest.mark.parametrize("shape", [(6, 60, 64, 32), (3, 60, 256, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sparse_block_function_matches_autograd_of_plain(dev, shape):
    """The ``autograd.Function`` (kernel E forward, kernels G and H backward)
    against ``torch.autograd`` of the plain block, fp32: gradients of y and of
    every leaf in the port's ``(out, in)`` layout."""
    M, hw, C, dh = shape
    y, tok, win, params = _block_case(M, hw, C, dh, torch.float32, torch.float32, 0.5, 3, dev)
    heads = C // dh
    leaves = [params[k].t().contiguous() if k in block.MATRICES else params[k].clone()
              for k in block.PARAM_KEYS]
    for t in leaves:
        t.requires_grad_()
    y.requires_grad_()
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    detached = block.params_from_leaves([t.detach() for t in leaves], torch.float32)
    out = sparse_block.sparse_window_block(y, tok, win, detached, heads, dh, leaves=leaves)
    got = torch.autograd.grad((out * w).sum(), [y] + leaves)
    ref_out = sparse_block.sparse_window_block_plain(
        y, tok, win, block.params_from_leaves(leaves, torch.float32), heads, dh)
    ref = torch.autograd.grad((ref_out * w).sum(), [y] + leaves)
    for name, a, b in zip(["y"] + list(block.PARAM_KEYS), got, ref):
        rtol, atol = _bwd_tol(b, torch.float32)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_block_kernels_refuse_grad_and_bad_shapes(dev):
    y, tok, win, params = _block_case(2, 12, 32, 16, torch.float32, torch.float32, 1.0, 1, dev)
    with pytest.raises(RuntimeError, match="no backward"):
        sparse_block.sparse_window_block_looped(y.requires_grad_(), tok, win, params, 2, 16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiples of 16"):
            bad = dict(params, wqkv=params["wqkv"][:24, :72])
            fused_block.fused_window_block(y[..., :24].contiguous(), tok, bad, 3, 8)


# ---------------------------------------------------------------------------
# The serving step captured as CUDA graphs (``sast_tpu_torch/graphs.py``)
# against the eager step, on a tiny configuration: the geometry of
# tests/test_torch_serving.py (gen1 events at 240x304, model resolution
# 256x320, partition (4, 5)), confidence threshold 0 so that the slates
# are full.


def _graph_config(**attention):
    import dataclasses

    from sast_tpu_torch.config import get_test_config

    cfg = get_test_config()
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, in_res_hw=(256, 320), attention=dataclasses.replace(
        bb.attention, partition_size=(4, 5), **attention))
    pp = dataclasses.replace(cfg.model.postprocess, confidence_threshold=0.0)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb,
                                                              postprocess=pp))


def _graph_frames(n, seed=1, empty=()):
    """``n`` frames of two lanes of random events (frames in ``empty``
    hold none: few windows kept)."""
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(n):
        lanes = []
        for _ in range(2):
            k = 0 if i in empty else rng.randint(300, 4000)
            lanes.append(dict(x=rng.randint(0, 304, k), y=rng.randint(0, 240, k),
                              p=rng.randint(0, 2, k),
                              t=np.sort(rng.randint(0, 50_000, k)) + i * 50_000))
        frames.append(lanes)
    return frames


def _graph_run(det, frames):
    """Slates of each frame (a lane reset at frame 2) and the carried
    states after the last, on the host."""
    det.reset()
    outs = [det.process_batch(f, reset=[False, i == 2]) for i, f in enumerate(frames)]
    states = det.states if det.mesh is None else [hc for r in det.states for hc in r]
    return outs, [t.cpu() for hc in states for t in hc]


@pytest.fixture
def launched(monkeypatch):
    """Counts the calls of the conditional-graph library's launch entry
    (``csrc/cond.cu`` ``sast_cond_launch``, one ``cudaGraphLaunch`` each):
    the list's length."""
    from sast_tpu_torch import graphs

    real, calls = graphs._cond_library, []

    class Counting:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name)

        def sast_cond_launch(self, *args):
            calls.append(args)
            return self.lib.sast_cond_launch(*args)

    monkeypatch.setattr(graphs, "_cond_library", lambda device: Counting(real(device)))
    return calls


def _quiet_run(det, frames):
    """``_graph_run`` with every frame after the first (the warm-up and the
    capture) under the sync debug mode "error": a replay that read the
    host (a predicate, ``.item()``, a pageable copy) would raise."""
    det.reset()
    outs = [det.process_batch(frames[0], reset=[False, False])]
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs += [det.process_batch(f, reset=[False, i == 2]) for i, f in enumerate(frames)
                 if i > 0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    states = det.states if det.mesh is None else [hc for r in det.states for hc in r]
    return outs, [t.cpu() for hc in states for t in hc]


def _assert_same_bits(a, b):
    (outs_a, states_a), (outs_b, states_b) = a, b
    for i, (x, y) in enumerate(zip(outs_a, outs_b)):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"frame {i} {k}")
    for i, (x, y) in enumerate(zip(states_a, states_b)):
        assert torch.equal(x, y), f"state leaf {i}"


def _graph_detectors(cfg, seed=0, **kw):
    """An eager and a captured detector on one seeded model."""
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.serving import StreamingDetector

    model = build_detector(cfg.model, seed=seed, device="cuda")
    return [StreamingDetector(cfg, model, max_events=4000, num_streams=2, graph=g, **kw)
            for g in (False, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["default", "sparse", "fused", "masked"])
def test_captured_step_is_the_eager_step(dev, path, dtype):
    """Slates and carried states bit for bit over 5 frames, one graph per
    step, and the launches that the replays ran counted."""
    import dataclasses

    cfg = _graph_config(fused_block=path == "fused")
    bb = cfg.model.backbone
    if path == "masked":
        bb = dataclasses.replace(bb, stem_pallas=False, ratio_pallas=False,
                                 fuse_stem_density=False)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb,
                                                             compute_dtype=dtype))
    eager, captured = _graph_detectors(cfg, sparse_kernel=path == "sparse")
    frames = _graph_frames(5)
    _assert_same_bits(_graph_run(eager, frames), _graph_run(captured, frames))
    run = captured.steps[0].run
    assert run.replays == 4 and len(run.schedule.items) == 1
    assert run.replayed["greedy_keep"] == 4


def test_captured_mesh_is_the_eager_mesh(dev):
    """Two replicas on one card, each captured on its own: the same bits as
    the eager mesh."""
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.serving import StreamingDetector

    cfg = _graph_config()
    dets = [StreamingDetector(cfg, build_detector(cfg.model, seed=0, device="cuda"),
                              max_events=4000, num_streams=2, mesh=("cuda:0", "cuda:0"),
                              graph=g) for g in (False, True)]
    frames = _graph_frames(4)
    _assert_same_bits(_graph_run(dets[0], frames), _graph_run(dets[1], frames))
    assert [s.run.replays for s in dets[1].steps] == [3, 3]


UPLOAD_COUNTS = [(700, 4000), (4000, 20), (0, 900), (300, 0), (0, 0), (1200, 4000)]
UPLOAD_RESETS = [[False, False], [True, False], [False, False], [False, True], [False, False],
                 [True, True]]


def _counted_frames(counts, seed=2):
    """Frames of two lanes with the given event counts, in a camera
    decoder's types (x, y uint16, p uint8, t int64)."""
    rng = np.random.RandomState(seed)
    return [[dict(x=rng.randint(0, 304, n).astype(np.uint16),
                  y=rng.randint(0, 240, n).astype(np.uint16),
                  p=rng.randint(0, 2, n).astype(np.uint8),
                  t=np.sort(rng.randint(0, 50_000, n)).astype(np.int64) + i * 50_000)
             for n in lanes] for i, lanes in enumerate(counts)]


def test_captured_step_replays_varying_uploads_as_the_eager_step(dev):
    """The captured detector's ``process_batch`` over batches whose lanes'
    counts shrink, grow, hit 0 and hit the budget (the compact upload's
    size changes at every replay) against the eager ``StreamingStep`` fed
    ``pack_event_batch``'s (S, E, 4) directly: slates and carried states
    bit for bit."""
    from sast_tpu_torch.packing import pack_event_batch

    eager, captured = _graph_detectors(_graph_config())
    step = eager.replicas[0]
    states = [tuple(t.clone() for t in hc) for hc in eager.states]
    frames = _counted_frames(UPLOAD_COUNTS)
    captured.reset()
    for i, (f, reset) in enumerate(zip(frames, UPLOAD_RESETS)):
        got = captured.process_batch(f, reset=reset)
        packed, n = pack_event_batch(f, 2, 4000)
        with torch.no_grad():
            dets, states, tel = step(states, torch.from_numpy(packed).to(dev),
                                     torch.from_numpy(n).to(dev), torch.tensor(reset, device=dev))
        for k, v in dets.items():
            np.testing.assert_array_equal(got[k], v.cpu().numpy(), err_msg=f"frame {i} {k}")
        np.testing.assert_array_equal(got["selected_tokens"], tel.cpu().numpy())
    for a, b in zip((t for hc in captured.states for t in hc), (t for hc in states for t in hc)):
        assert torch.equal(a, b)
    assert captured.steps[0].run.replays == len(UPLOAD_COUNTS) - 1


def test_artifact_process_batch_is_the_live_detector(dev):
    """A loaded artifact's ``process_batch``, captured on the card, against
    its live detector's over the same varying uploads: slates and carried
    states bit for bit."""
    from sast_tpu_torch import export

    def run(det):
        det.reset()
        outs = [det.process_batch(f, reset=r) for f, r in zip(frames, UPLOAD_RESETS)]
        return outs, [t.cpu() for hc in det.states for t in hc]

    _, live = _graph_detectors(_graph_config())
    frames = _counted_frames(UPLOAD_COUNTS, seed=3)
    want = run(live)
    # Exported after the live detector stepped, as a deployment exports
    # one: its sine embeddings are then constants on the card.
    art = export.ExportedStreamingDetector(export.export_streaming_detector(live))
    _assert_same_bits(want, run(art))
    assert art._step.run.replays == len(UPLOAD_COUNTS) - 1


def _spy_branches(names):
    """Record which of the attention layer's branches ``names`` ran, in
    order; returns the log and a function that takes the spies out."""
    from sast_tpu_torch.models.sast import MaskedSparseAttention

    taken = []
    originals = {b: getattr(MaskedSparseAttention, b) for b in names}

    def spy(branch):
        def run(self, *args, **kw):
            taken.append(branch)
            return originals[branch](self, *args, **kw)
        return run

    for b in originals:
        setattr(MaskedSparseAttention, b, spy(b))

    def restore():
        for b, fn in originals.items():
            setattr(MaskedSparseAttention, b, fn)
    return taken, restore


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("switch", ["gather", "threshold"])
def test_captured_choice_takes_both_branches(dev, launched, switch, dtype):
    """``gather_budget`` 0.5, or the sparse kernel below a density
    threshold of 0.5: empty frames keep few windows (the first branch), full
    ones every window (the masked branch). The captured step is one graph:
    a segment per choosing layer and one more, each choice a conditional
    node over its two branches; every replay is one launch that reads
    nothing on the host (the sync debug mode "error"), and it equals the
    eager step bit for bit; the eager run took both branches, and so did
    the replays by the counters on the card."""
    import dataclasses

    from sast_tpu_torch.models.sast import MaskedSparseAttention

    cfg = _graph_config(**({"gather_budget": 0.5} if switch == "gather"
                           else {"pallas_density_threshold": 0.5}))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    eager, captured = _graph_detectors(cfg, sparse_kernel=switch == "threshold")
    frames = _graph_frames(6, empty=(0, 3))
    first = "gathered" if switch == "gather" else "kernel"
    taken, restore = _spy_branches((first, "masked"))
    try:
        ref = _graph_run(eager, frames)
    finally:
        restore()
    assert set(taken) == {first, "masked"}
    _assert_same_bits(ref, _quiet_run(captured, frames))
    run = captured.steps[0].run
    layers = sum(isinstance(m, MaskedSparseAttention) for m in captured.model.modules())
    kinds = [item[0] for item in run.schedule.items]
    assert kinds.count("choose") == layers and kinds.count("run") == layers + 1
    assert run.replays == len(launched) == 5
    counts = run.schedule.taken.cpu()
    assert counts.sum() == 5 * layers and counts[:, 0].sum() > 0 and counts[:, 1].sum() > 0


def test_branch_counters_are_the_eager_choices(dev):
    """The counters on the card of a captured gather-0.5 step, per choosing
    layer and branch, equal the branches the eager step took over the same
    frames after the first (the warm-up's); the launches the replays ran
    (``replayed``) are the segments' counts times the replays plus each
    branch's times its counter."""
    import collections

    from sast_tpu_torch import graphs

    cfg = _graph_config(gather_budget=0.5)
    eager, captured = _graph_detectors(cfg)
    frames = _graph_frames(6, empty=(1, 4))
    _graph_run(captured, frames)
    taken = []
    choose = graphs.choose

    def spy(pred, *args, **kw):
        taken.append(bool(pred))
        return choose(pred, *args, **kw)

    eager.reset()
    eager.process_batch(frames[0], reset=[False, False])
    graphs.choose = spy
    try:
        for i, f in enumerate(frames[1:], 1):
            eager.process_batch(f, reset=[False, i == 2])
    finally:
        graphs.choose = choose
    run = captured.steps[0].run
    layers = run.schedule.taken.shape[0]
    assert len(taken) == 5 * layers
    per_layer = np.zeros((layers, 2), np.int64)
    for j, first in enumerate(taken):
        per_layer[j % layers, 0 if first else 1] += 1
    np.testing.assert_array_equal(run.schedule.taken.cpu().numpy(), per_layer)
    want = collections.Counter()
    i = 0
    for item in run.schedule.items:
        if item[0] == "run":
            want.update({k: n * run.replays for k, n in item[2].items()})
            continue
        for (_, counts), times in zip(item[2:4], per_layer[i]):
            want.update({k: n * int(times) for k, n in counts.items()})
        i += 1
    assert run.replayed == +want and run.replayed["greedy_keep"] == run.replays


def test_refused_conditional_node_raises_by_name(dev, monkeypatch):
    """A conditional node that the CUDA driver refuses (here a ``cond.cu``
    entry that reports CUDA error 801, ``cudaErrorNotSupported``, for the
    conditional node) makes the capture raise, naming the node and the
    configuration; nothing is replayed, and the next call captures again
    and raises again: there is no replay through host reads."""
    from sast_tpu_torch import graphs

    real = graphs._cond_library

    class Refusing:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name)

        @staticmethod
        def sast_cond_add_choice(graph, tail, pred, counts, first, second, stage):
            stage._obj.value = 3
            return 801

    monkeypatch.setattr(graphs, "_cond_library", lambda device: Refusing(real(device)))
    _, captured = _graph_detectors(_graph_config(gather_budget=0.5))
    frames = _graph_frames(2, empty=(0,))
    captured.reset()
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"conditional \(IF\) node of the choice 0 "
                           r"\(attention\.gather_budget=0\.5.*CUDA error 801"):
            captured.process_batch(frames[0], reset=[False, False])
        run = captured.steps[0].run
        assert run.schedule is None and run.replays == 0


def test_captured_step_sees_new_weights(dev):
    """Weights written in place after the capture (bf16: the compute copies
    are rewritten in place) reach the replays: the detector then equals a
    fresh one built on the new weights, without a second capture."""
    import dataclasses

    from sast_tpu_torch.models.detector import build_detector

    cfg = _graph_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             compute_dtype="bfloat16"))
    _, captured = _graph_detectors(cfg)
    frames = _graph_frames(4)
    _graph_run(captured, frames)
    schedule = captured.steps[0].run.schedule
    other = build_detector(cfg.model, seed=1, device="cpu")
    captured.model.load_state_dict(other.state_dict())
    _, fresh = _graph_detectors(cfg, seed=1)
    _assert_same_bits(_graph_run(captured, frames), _graph_run(fresh, frames))
    assert captured.steps[0].run.schedule is schedule


def test_captured_mesh_interleaves_choices(dev, launched):
    """``gather_budget`` 0.5 over two replicas on one card: each replica's
    replay is one launch of its own graph, both enqueued before any slate is
    read, with no host read (the sync debug mode "error"), and the same bits
    as the eager mesh."""
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.serving import StreamingDetector

    cfg = _graph_config(gather_budget=0.5)
    dets = [StreamingDetector(cfg, build_detector(cfg.model, seed=0, device="cuda"),
                              max_events=4000, num_streams=2, mesh=("cuda:0", "cuda:0"),
                              graph=g) for g in (False, True)]
    frames = _graph_frames(5, empty=(0, 3))
    _assert_same_bits(_graph_run(dets[0], frames), _quiet_run(dets[1], frames))
    assert [s.run.replays for s in dets[1].steps] == [4, 4]
    assert len(launched) == 8
    assert all("choose" in [item[0] for item in s.run.schedule.items] for s in dets[1].steps)


def test_captured_step_follows_the_looped_switch(dev):
    """The sparse path captured under kernel E, then stepped under kernel F
    (``looped_kernel``): captured again, its replays run F, and it equals
    the eager step under F."""
    from sast_tpu_torch.utils.benchmark import looped_kernel

    cfg = _graph_config()
    eager, captured = _graph_detectors(cfg, sparse_kernel=True)
    frames = _graph_frames(3)
    _graph_run(captured, frames)
    run = captured.steps[0].run
    first = run.schedule
    assert run.replayed["sparse_window_block"] > 0
    with looped_kernel(True):
        ref = _graph_run(eager, frames)
        got = _graph_run(captured, frames)
    _assert_same_bits(ref, got)
    assert run.schedule is not first and run.replayed["sparse_window_block_looped"] > 0


# The train and eval steps captured as CUDA graphs (``training/steps.
# CapturedTrainStep`` and ``CapturedEvalStep`` through ``Trainer(graph=)``)
# against the same bodies run eagerly, on the tiny test configuration.


@pytest.fixture
def deterministic(dev):
    """cuDNN and torch in their deterministic modes: the masked path's
    index and upsampling backwards add with atomics otherwise, and two runs
    of one step then differ in their last bits."""
    import torch.utils.deterministic

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    yield dev
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = fill
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _train_config(dtype="float32", **training):
    import dataclasses

    from sast_tpu_torch.config import get_test_config

    cfg = get_test_config()
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, ls_init_value=0.3))
    tr = dataclasses.replace(cfg.training, **dict(dict(ema_decay=0.9, weight_decay=0.01, seed=0,
                                                       remat_policy="full"), **training))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb,
                                                              compute_dtype=dtype), training=tr)


def _train_batches(cfg, n, seed=0):
    """``n`` synthetic batches; lane 0 carries its state from the second
    on, lane 1 starts a sequence every other batch."""
    from sast_tpu_torch.data.synthetic import synthetic_train_batch

    rng = np.random.RandomState(seed)
    out = [synthetic_train_batch(cfg, rng) for _ in range(n)]
    for i, b in enumerate(out):
        b["is_first"] = np.array([i == 0, i % 2 == 0])
    return out


def _written(trainer):
    """Everything the train step writes, on the host: parameters and
    BatchNorm statistics, the EMA copy, the optimizer's count and moments,
    the carried LSTM states."""
    state = trainer.state
    out = [t.detach().cpu() for t in state.model.state_dict().values()]
    out += [t.cpu() for t in (state.ema_params or {}).values()]
    out += [t.cpu() for t in state.optimizer.tensors()]
    return out + [t.cpu() for hc in trainer._train.states for t in hc]


def _logged(workdir):
    """The metrics ``fit`` logged at every step, less the host's clock."""
    import json
    import os

    rows = [json.loads(line) for line in open(os.path.join(workdir, "metrics.jsonl"))]
    return [{k: v for k, v in r.items() if k not in ("time", "train/step_time_s")} for r in rows]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["sparse", "masked"])
def test_captured_train_step_is_the_eager_step(deterministic, tmp_path, path, dtype):
    """``fit`` over 4 steps with ``graph`` on and off from one seed (the
    deterministic modes): every logged metric, the parameters, statistics, EMA copy, optimizer state and
    LSTM states bit for bit; the first step is the warm-up, the other three
    replays, which ran kernels E, G and H on the sparse path."""
    from sast_tpu_torch.training.loop import Trainer

    cfg = _train_config(dtype)
    batches = _train_batches(cfg, 4)
    runs = [Trainer(cfg, str(tmp_path / f"g{g}"), log_every=1, sparse_kernel_train=path == "sparse",
                    graph=g) for g in (False, True)]
    for trainer in runs:
        trainer.fit(batches, max_steps=4)
    assert _logged(tmp_path / "gFalse") == _logged(tmp_path / "gTrue")
    for i, (a, b) in enumerate(zip(_written(runs[0]), _written(runs[1]))):
        assert torch.equal(a, b), f"tensor {i}"
    run = runs[1]._train.run
    assert run.replays == 3 and not runs[0]._train.run.graph
    if path == "sparse":
        assert all(run.replayed[k] == 3 * run.recorded[k] > 0 for k in
                   ("sparse_window_block", "sparse_block_mlp_bwd", "sparse_block_attn_bwd"))


def test_captured_eval_after_captured_train_steps(deterministic, tmp_path):
    """bf16 without an EMA copy: an eval step captured before training, then
    two captured train steps (a replay writes the weights without moving
    their versions; the trainer moves them), then the eval step replayed:
    the detections and carried states of a fresh model holding the trained
    weights, bit for bit."""
    from sast_tpu_torch.data.batch import split_device_batch
    from sast_tpu_torch.models.detector import YoloXDetector
    from sast_tpu_torch.training.loop import Trainer
    from sast_tpu_torch.training.steps import CapturedEvalStep, make_eval_step

    cfg = _train_config("bfloat16", ema_decay=0.0)
    batches = _train_batches(cfg, 3)
    trainer = Trainer(cfg, str(tmp_path / "run"), sparse_kernel_train=True)
    trainer.fit(batches[:1], max_steps=1)
    batch = split_device_batch(batches[2])[0]
    run = trainer._eval_run()
    run(batch)
    run(batch)  # captured, then replayed on the trained weights of step 1
    trainer.fit(batches[1:], max_steps=3)
    assert trainer._train.run.replays == 2
    run.zero_states()
    got = {k: v.cpu() for k, v in run(batch).items()}
    assert run.run.replays == 2
    fresh = YoloXDetector(cfg.model, sparse_kernel=True).to("cuda")
    fresh.load_state_dict(trainer.model.state_dict())
    ref_run = CapturedEvalStep({"eval": make_eval_step(fresh, cfg)}, fresh, cfg, "cuda",
                               graph=False)
    want = ref_run(batch)
    for k in want:
        assert torch.equal(got[k], want[k].cpu()), k
    for a, b in zip([t for hc in run.states for t in hc], [t for hc in ref_run.states for t in hc]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("switch", ["gather", "threshold"])
def test_choosing_trainer_trains_captured_bit_for_bit(deterministic, launched, tmp_path, switch,
                                                      dtype):
    """A gather budget of 0.5, or the sparse kernel below a density
    threshold of 0.5 (their layers choose on the card), in fp32 and bf16
    (whose weights' compute copies the warm-up's update leaves stale before
    the capture): ``fit`` over 4 steps
    with ``graph`` on equals ``graph`` off bit for bit (every logged metric,
    parameters, statistics, EMA, optimizer state and LSTM states), the
    forward's and the backward's choices conditional nodes of one graph,
    each replay one launch; the batches without events keep few windows, so
    the replays took both branches (the counters on the card). Its eval
    step, captured after training, equals the eager eval step: the
    detections and the carried states."""
    import dataclasses

    from sast_tpu_torch.data.batch import split_device_batch
    from sast_tpu_torch.training.loop import Trainer
    from sast_tpu_torch.training.steps import CapturedEvalStep

    cfg = _train_config(dtype)
    bb = cfg.model.backbone
    att = {"gather_budget": 0.5} if switch == "gather" else {"pallas_density_threshold": 0.5}
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, **att))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))
    batches = _train_batches(cfg, 4)
    for b in batches[1::2]:
        b["ev_repr"] = np.zeros_like(b["ev_repr"])
    runs = [Trainer(cfg, str(tmp_path / f"g{g}"), log_every=1,
                    sparse_kernel_train=switch == "threshold", graph=g) for g in (False, True)]
    for trainer in runs:
        trainer.fit(batches, max_steps=4)
    assert _logged(tmp_path / "gFalse") == _logged(tmp_path / "gTrue")
    for i, (a, b) in enumerate(zip(_written(runs[0]), _written(runs[1]))):
        assert torch.equal(a, b), f"tensor {i}"
    run = runs[1]._train.run
    assert run.replays == len(launched) == 3
    kinds = [item[0] for item in run.schedule.items]
    assert kinds.count("choose") > 0 and kinds.count("run") == kinds.count("choose") + 1
    counts = run.schedule.taken.cpu()
    assert counts[:, 0].sum() > 0 and counts[:, 1].sum() > 0
    if switch == "threshold":
        assert all(run.replayed[k] > 0 for k in
                   ("sparse_window_block", "sparse_block_mlp_bwd", "sparse_block_attn_bwd"))
    trainer = runs[1]
    run = trainer._eval_run()
    ref_run = CapturedEvalStep(trainer._fns, trainer.model, cfg, "cuda", graph=False)
    for batch in batches[:3]:
        batch = split_device_batch(batch)[0]
        got, want = run(batch), ref_run(batch)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for a, b in zip([t for hc in run.states for t in hc], [t for hc in ref_run.states for t in hc]):
        assert torch.equal(a, b)
    assert run.run.replays == len(launched) - 3 == 2


def test_captured_fit_resumes_bit_for_bit(deterministic, tmp_path):
    """``fit`` over 4 steps, against ``fit`` over 2 saved at step 2 and a
    fresh trainer resumed from that checkpoint for steps 3 and 4 (the third
    batch starts every lane, as a resumed ``fit`` starts from zero LSTM
    states): the same bits, every step captured but each trainer's first."""
    from sast_tpu_torch.training.loop import Trainer

    cfg = _train_config()
    batches = _train_batches(cfg, 4)
    batches[2]["is_first"] = np.array([True, True])
    whole = Trainer(cfg, str(tmp_path / "whole"), sparse_kernel_train=True)
    whole.fit(batches, max_steps=4)
    first = Trainer(cfg, str(tmp_path / "split"), ckpt_every=2, sparse_kernel_train=True)
    first.fit(batches[:2], max_steps=2)
    resumed = Trainer(cfg, str(tmp_path / "split"), sparse_kernel_train=True)
    resumed.maybe_resume(True)
    assert resumed.state.step == 2
    resumed.fit(batches[2:], max_steps=4)
    assert resumed.state.step == whole.state.step == 4
    for i, (a, b) in enumerate(zip(_written(whole), _written(resumed))):
        assert torch.equal(a, b), f"tensor {i}"
    assert whole._train.run.replays == 3 and resumed._train.run.replays == 1


def test_serve_spans_share_the_cards_clock(dev, tmp_path):
    """Under the profiler, a replayed gen4-base step of 2 lanes of up to
    200,000 events: the upload's first copy to the card begins inside the
    program's ``serve.launch`` span, and the step's last kernel ends before
    ``serve.wait`` ends. The spans lie on the clock of the card's work."""
    import json

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.serving import StreamingDetector

    cfg = get_config("gen4", "base")
    det = StreamingDetector(cfg, build_detector(cfg.model, seed=0, device="cuda"),
                            max_events=200_000, num_streams=2)
    rng = np.random.RandomState(0)
    h, w = cfg.dataset.resolution_hw

    def frames():
        return [dict(x=rng.randint(0, w, n), y=rng.randint(0, h, n), p=rng.randint(0, 2, n),
                     t=np.sort(rng.randint(0, 50_000, n))) for n in (100_000, 150_000)]

    for _ in range(2):  # the warm-up and capture, then a replay
        det.process_batch(frames())
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        det.process_batch(frames())
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("serve.")}
    assert set(spans) == {"serve.batch", "serve.pack", "serve.launch", "serve.wait"}
    uploads = [e["ts"] for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    kernels = [e["ts"] + e["dur"] for e in events if e.get("cat") == "kernel"]
    assert uploads and kernels
    launch, wait = spans["serve.launch"], spans["serve.wait"]
    assert launch[0] <= min(uploads) <= launch[1], (launch, sorted(uploads))
    assert max(kernels) <= wait[1], (wait, max(kernels))
