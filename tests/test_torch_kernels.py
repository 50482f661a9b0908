"""Port vs JAX package: the three kernels of the serving path, the
tensorization and the partitions.

The JAX side runs its Pallas kernels in interpret mode (the module-local
``_pallas_call`` patched, as tests/test_sparse.py and tests/test_nms.py do);
the port's wrappers get CPU tensors and so run their plain versions. Inputs
come from numpy seeds and go to both packages as numpy arrays.
"""

from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sast_tpu_torch.data.representations import stacked_histogram
from sast_tpu_torch.ops import nms_keep as t_nms_keep
from sast_tpu_torch.ops.density import density_ratio, density_supported, non_zero_ratio_plain
from sast_tpu_torch.ops.partition import (
    grid_partition,
    grid_reverse,
    window_partition,
    window_reverse,
)
from sast_tpu_torch.ops.posemb import position_embedding_sine
from sast_tpu_torch.ops.stem_conv import stem_conv7x4, stem_supported


def _events_u8(rng, shape, lam=0.25):
    """Poisson counts with ragged content: an empty band and a dense block."""
    x = rng.poisson(lam, shape).clip(0, 255).astype(np.uint8)
    x[0, : shape[1] // 4] = 0
    x[-1, -8:, -40:] = rng.randint(1, 12, (8, 40, shape[-1]))
    return x


@pytest.fixture
def interpret(monkeypatch):
    """Run every JAX Pallas kernel of the serving path in interpret mode."""
    import sast_tpu.ops.pallas.density as jd
    import sast_tpu.ops.pallas.nms_keep as jn
    import sast_tpu.ops.pallas.stem_conv as js

    for mod in (js, jd, jn):
        monkeypatch.setattr(mod, "_pallas_call", partial(pl.pallas_call, interpret=True))
    return js, jd, jn


@pytest.mark.parametrize("with_density", [False, True])
def test_stem_plain_matches_pallas(interpret, with_density):
    """Kernel A's plain version vs stem_conv(_density)_raw_7x4. Tolerance
    5e-4 of max|y|, as tests/test_sparse.py holds the Pallas kernel to the
    XLA conv: fp32 sums of 980 products taken in another order."""
    js, _, _ = interpret
    rng = np.random.RandomState(3)
    B, H, W, C, Cout = 2, 64, 96, 20, 32
    x = _events_u8(rng, (B, H, W, C))
    w = (rng.randn(7, 7, C, Cout) * 0.05).astype(np.float32)
    w_oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    assert stem_supported(x.shape, torch.uint8, Cout)
    launches = stem_conv7x4.launches
    if with_density:
        yj, rj = jax.jit(js.stem_conv_density_raw_7x4)(jnp.asarray(x), jnp.asarray(w))
        yt, rt = stem_conv7x4(torch.from_numpy(x), w_oihw, with_density=True)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-6)
    else:
        yj = jax.jit(js.stem_conv_raw_7x4)(jnp.asarray(x), jnp.asarray(w))
        yt = stem_conv7x4(torch.from_numpy(x), w_oihw)
    scale = float(np.abs(np.asarray(yj)).max())
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=5e-4 * scale)
    assert stem_conv7x4.launches == launches  # CPU tensors never launch


def test_density_plain_matches_pallas(interpret):
    """Kernel B's plain version vs density_ratio_tpu: both are integer
    counts over a power-of-two cell count, so 1e-6 is rounding of the
    final division only."""
    _, jd, _ = interpret
    rng = np.random.RandomState(5)
    x = _events_u8(rng, (2, 64, 96, 20), lam=0.05)
    assert density_supported(x.shape, torch.uint8)
    rj = jax.jit(jd.density_ratio_tpu)(jnp.asarray(x))
    rt = density_ratio(torch.from_numpy(x))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-6)


def test_non_zero_ratio_plain_signed_and_odd_extents():
    """The general plain pooling (signed values, odd extents) vs the JAX
    package's XLA formulation: the same counts divided by the same numbers,
    so exact."""
    from sast_tpu.ops.sparse import non_zero_ratio as j_ratio

    rng = np.random.RandomState(6)
    x = rng.randint(-1, 2, (2, 70, 100, 6)).astype(np.int8)
    rj = j_ratio(jnp.asarray(x), use_pallas=False)
    rt = non_zero_ratio_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def _clustered_candidates(rng, n, k):
    """Score-sorted candidate sets with heavy overlap (long suppression
    chains) and an invalid tail, as in tests/test_nms.py."""
    centers = rng.rand(n, 6, 2) * 200
    idx = rng.randint(0, 6, (n, k))
    xy = centers[np.arange(n)[:, None], idx] + rng.randn(n, k, 2) * 8
    wh = 10 + rng.rand(n, k, 2) * 30
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1).astype(np.float32)
    scores = np.sort(rng.rand(n, k).astype(np.float32), axis=-1)[:, ::-1].copy()
    scores[:, -k // 8 :] = 0.0
    return boxes, scores


def test_greedy_keep_plain_matches_pallas_exactly(interpret):
    """Kernel C's plain version vs the Pallas greedy_keep and the XLA scan:
    the same rounded fp32 operations, so the masks agree bit for bit."""
    from sast_tpu.ops.nms import batched_greedy_keep

    _, _, jn = interpret
    rng = np.random.RandomState(0)
    boxes, scores = _clustered_candidates(rng, 4, 300)
    kj = jax.jit(partial(jn.greedy_keep, iou_threshold=0.45))(
        jnp.asarray(boxes), jnp.asarray(scores)
    )
    ks = batched_greedy_keep(jnp.asarray(boxes), jnp.asarray(scores), 0.45, use_pallas=False)
    kt = t_nms_keep.greedy_keep(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(ks))
    assert 0 < kt.sum() < (scores > 0).sum()  # suppression happened


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """No fallback: a tensor on neither the CPU nor a card is refused."""
    x = torch.zeros((1, 32, 32, 20), dtype=torch.uint8, device="meta")
    w = torch.zeros((32, 20, 7, 7), device="meta")
    with pytest.raises(ValueError):
        stem_conv7x4(x, w)
    with pytest.raises(ValueError):
        density_ratio(x)
    with pytest.raises(ValueError):
        t_nms_keep.greedy_keep(
            torch.zeros((1, 8, 4), device="meta"), torch.zeros((1, 8), device="meta"), 0.5
        )


def test_kernel_gates():
    assert stem_supported((4, 384, 640, 20), torch.uint8, 64)  # gen4-base
    assert stem_supported((8, 256, 320, 20), torch.uint8, 64)  # gen1-base
    assert not stem_supported((4, 384, 640, 20), torch.float32, 64)
    assert not stem_supported((4, 384, 640, 20), torch.int8, 64)
    assert not stem_supported((4, 384, 636, 20), torch.uint8, 64)  # W % 32
    assert not stem_supported((4, 380, 640, 20), torch.uint8, 64)  # H % 32
    assert not stem_supported((4, 384, 640, 40), torch.uint8, 64)  # C > 32
    assert not stem_supported((4, 384, 640, 18), torch.uint8, 64)  # C % 4
    assert not stem_supported((4, 384, 640, 20), torch.uint8, 24)  # Cout % 16
    assert density_supported((4, 384, 640, 20), torch.uint8)
    assert not density_supported((4, 384, 640, 20), torch.int8)


@pytest.mark.parametrize("cin,cout", [(20, 64), (20, 48), (20, 96), (8, 128), (4, 16), (32, 32)])
def test_stem_weight_tiles_rebuild_conv(cin, cout):
    """The bf16 stem kernel's implicit GEMM, written out on the CPU: one A
    row per output pixel and kernel row is the input bytes from pixel
    4 ox - 3 on, read 7 C bytes and past them up to the padded depth (the
    next pixel's channels, as the kernel reads them), times the weight
    tiles that the kernel's first launch gathers through
    ``stem_weight_index``. In float64 every product of a uint8 and a bf16
    value and every partial sum is exact, so it must equal ``F.conv2d`` of
    the replicate-padded input bit for bit; the padding rows must be zero."""
    import torch.nn.functional as F

    from sast_tpu_torch.ops.stem_conv import stem_weight_index

    rng = np.random.RandomState(cin + cout)
    B, H, W = 2, 32, 64
    x = torch.from_numpy(rng.randint(0, 256, (B, H, W, cin)).astype(np.uint8))
    w = torch.from_numpy((rng.randn(cout, cin, 7, 7) * 0.05).astype(np.float32))
    idx = stem_weight_index(cin, cout)
    S = -(-7 * cin // 16)
    assert idx.shape == (7 * S * cout * 16,) and idx.dtype == torch.int32
    # arrange_kernel: wt[e] = w[idx[e]], or zero where idx[e] < 0.
    wt = torch.where(idx >= 0, w.to(torch.bfloat16).reshape(-1)[idx.clamp(min=0).long()], 0)
    wt = wt.reshape(7, S, cout, 16)
    mat = wt.permute(0, 1, 3, 2).reshape(7, S * 16, cout).double()  # [kh][k][n]
    assert not mat[:, 7 * cin:].any()

    # Replicate pad 3, plus one more column on the right for the overrun.
    xp = F.pad(x.double().permute(0, 3, 1, 2), (3, 4, 3, 3), mode="replicate")
    xp = xp.permute(0, 2, 3, 1)  # (B, H + 6, W + 7, C)
    Ho, Wo = H // 4, W // 4
    y = torch.zeros(B, Ho, Wo, cout, dtype=torch.float64)
    for kh in range(7):
        rows = xp[:, kh:kh + 4 * Ho:4]  # (B, Ho, W + 7, C)
        a = torch.stack([rows[:, :, 4 * ox:4 * ox + 8].reshape(B, Ho, -1)[..., :S * 16]
                         for ox in range(Wo)], dim=2)  # (B, Ho, Wo, S * 16)
        y += a @ mat[kh]
    wb = w.to(torch.bfloat16).double()
    ref = F.conv2d(F.pad(x.double().permute(0, 3, 1, 2), (3, 3, 3, 3), mode="replicate"), wb,
                   stride=4).permute(0, 2, 3, 1)
    assert torch.equal(y, ref)


def _random_events(rng, n, h, w, t0):
    return dict(
        x=rng.randint(0, w, n), y=rng.randint(0, h, n), p=rng.randint(0, 2, n),
        t=np.sort(rng.randint(0, 50_000, n)) + t0,
    )


def test_stacked_histogram_matches_jax_exactly():
    """Same fp32 time binning, integer counts: identical uint8 output,
    including an empty lane, a one-event lane and padded rows."""
    from sast_tpu.data.representations import stacked_histogram_jax
    from sast_tpu_torch.packing import pack_event_batch

    rng = np.random.RandomState(0)
    h, w, bins = 40, 56, 10
    frames = [
        _random_events(rng, 3000, h, w, 0),
        dict(x=np.zeros(0, int), y=np.zeros(0, int), p=np.zeros(0, int), t=np.zeros(0, int)),
        _random_events(rng, 1, h, w, 77),
        _random_events(rng, 5000, h, w, 123_456),
    ]
    frames[3]["x"][:200] = 3  # pile-up above the count cutoff
    frames[3]["y"][:200] = 4
    packed, n = pack_event_batch(frames, 4, 6000)

    def one(pk, ne):
        return stacked_histogram_jax(
            pk[:, 0], pk[:, 1], pk[:, 2], pk[:, 3], ne,
            bins=bins, height=h, width=w, count_cutoff=10,
        )

    rj = jax.jit(jax.vmap(one))(jnp.asarray(packed), jnp.asarray(n))
    rt = stacked_histogram(torch.from_numpy(packed), torch.from_numpy(n), bins, h, w, 10)
    assert rt.dtype == torch.uint8 and rt.shape == (4, h, w, 2 * bins)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert rt[3].max() == 10 and rt[1].max() == 0


def test_partitions_and_posemb_match_jax_exactly():
    """Pure data movement and a numpy constant: exact."""
    from sast_tpu.ops import partition as jp
    from sast_tpu.ops.posemb import position_embedding_sine as j_pos

    x = np.random.RandomState(1).randn(2, 12, 20, 8).astype(np.float32)
    p = (3, 5)
    xt = torch.from_numpy(x)
    for j_fn, t_fn in ((jp.window_partition, window_partition), (jp.grid_partition, grid_partition)):
        np.testing.assert_array_equal(t_fn(xt, p).numpy(), np.asarray(j_fn(jnp.asarray(x), p)))
    win = window_partition(xt, p)
    np.testing.assert_array_equal(
        window_reverse(win, p, (12, 20)).numpy(),
        np.asarray(jp.window_reverse(jnp.asarray(win.numpy()), p, (12, 20))),
    )
    grd = grid_partition(xt, p)
    np.testing.assert_array_equal(grid_reverse(grd, p, (12, 20)).numpy(), x)
    np.testing.assert_array_equal(
        grid_reverse(grd, p, (12, 20)).numpy(),
        np.asarray(jp.grid_reverse(jnp.asarray(grd.numpy()), p, (12, 20))),
    )
    np.testing.assert_array_equal(position_embedding_sine(6, 10, 16), j_pos(6, 10, 16))
