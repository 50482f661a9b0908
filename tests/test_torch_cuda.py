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
@pytest.mark.parametrize("shape,cout", [((2, 64, 96, 20), 32), ((1, 32, 64, 8), 128)])
def test_stem_kernel_matches_plain(dev, dtype, shape, cout):
    """fp32: other summation order (1e-5 of max|y|); bf16: both round an
    fp32 sum to bf16 (two bf16 ulps at max|y|). Density ratio exact."""
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
    assert torch.equal(density.density_ratio(x), density.density_ratio_plain(x))


def test_greedy_keep_kernel_matches_plain_exactly(dev):
    rng = np.random.RandomState(2)
    n, k = 3, 1500  # more candidates than threads
    xy = rng.rand(n, k, 2) * 300
    wh = 5 + rng.rand(n, k, 2) * 40
    boxes = torch.from_numpy(np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32))
    scores = torch.from_numpy(np.sort(rng.rand(n, k).astype(np.float32), -1)[:, ::-1].copy())
    scores[:, -200:] = 0
    got = nms_keep.greedy_keep(boxes.to(dev), scores.to(dev), 0.45).cpu()
    assert torch.equal(got, nms_keep.greedy_keep_plain(boxes, scores, 0.45))


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


@pytest.mark.parametrize("ydt,wdt", BLOCK_DTYPES, ids=["f32", "bf16", "f32-bf16w"])
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", ["fused", "sparse", "sparse_h1", "looped"])
def test_block_kernels_match_plain(dev, kernel, shape, ydt, wdt):
    """Kernels D, E (with and without h1) and F against the plain block at
    window density 0.5. Unkept tokens and skipped windows bit-equal to y."""
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
        assert torch.equal(y, y0)  # the wrapper clones; the caller's y is untouched
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


def test_block_kernels_refuse_grad_and_bad_shapes(dev):
    y, tok, win, params = _block_case(2, 12, 32, 16, torch.float32, torch.float32, 1.0, 1, dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        sparse_block.sparse_window_block(y.requires_grad_(), tok, win, params, 2, 16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiples of 16"):
            bad = dict(params, wqkv=params["wqkv"][:24, :72])
            fused_block.fused_window_block(y[..., :24].contiguous(), tok, bad, 3, 8)
