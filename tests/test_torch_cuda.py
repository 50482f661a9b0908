"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package, so on a machine with a card and
without JAX it runs alone (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sast_tpu_torch.ops import density, nms_keep, stem_conv

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
