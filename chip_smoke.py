#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sast_tpu_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit: ``python3 chip_smoke.py``. Phases, each fatal on failure:

1. Print the card's name and power limit; build the six kernels (five
   libraries) from ``sast_tpu_torch/csrc`` (one nvcc per source, all started
   together).
2. Hold each kernel against its plain PyTorch version on the card, TF32
   off, at the gen4-base b4 serving shapes, and time kernel, plain version,
   bound and library call. The three block kernels (fused, sparse, looped)
   run at the four stage shapes, in bf16 and fp32, at window densities 0.1,
   0.4 and 1.0, beside the masked torch-op path and the gather path.
3. Drive the port's main path: ``StreamingDetector`` at gen4-base width
   (384x640 model resolution, 20 channels, dims 64/128/256/512, bf16),
   ``num_streams=4``, seeded random weights, 8 frames of seeded synthetic
   events with one lane reset midway; the launch counters must show the
   stem and NMS kernels on every frame. Then the same weights with the
   stem/density fusion off, which puts the density kernel on the path and
   must give the same detections. Steady-state ms/step with CUDA events.
   Then the same weights and frames on the sparse-kernel, looped-kernel,
   fused-kernel and budget-gather attention paths: 8 block-kernel launches
   per step, the kept-window share per stage, ms/step of each.
4. Hold the whole path on the card (kernels, fp32, TF32 off) on the masked,
   sparse, fused and gather attention paths against the same port on the
   CPU (plain versions, masked path) at gen4-base B=1 for 2 frames.

Prints the kernel table as one JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. Longer output (build
logs, profiler table, all measurements) goes to ``chiprun_out/``.
Exits non-zero, printing no result, without a card or outside a checkout.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
DEVICE = "cuda"
KERNEL_SHAPE = (4, 384, 640, 20)  # the stem input of the gen4-base b4 step
FRAMES = 8
PATH_FRAMES = 4  # frames driven on each of the other attention paths
STREAMS = 4
# (M windows, C, heads) of one attention layer per stage of the gen4-base b4
# step; hw = 60 tokens per window, dim_head 32.
BLOCK_SHAPES = ((1024, 64, 2), (256, 128, 4), (64, 256, 8), (16, 512, 16))
BLOCK_HW = 60
BLOCK_DENSITIES = (0.1, 0.4, 1.0)
BLOCK_TABLE_DENSITY = 0.4  # the density whose times go into the kernels line
LAYER_SCALE = 0.05  # LayerScale of the CPU-parity model
EVENTS_PER_FRAME = 200_000  # StreamingDetector's default budget
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


_AHEAD = []


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3, ahead: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` calls between two CUDA events. A
    call that launches several short kernels is paced by the host, and the
    events then measure the host. With ``ahead`` a long matrix product
    (about 40 ms) is queued first, so that every launch of the ``iters``
    calls waits in the stream before the card reaches the first event: the
    difference of the events is then the card's time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        if not _AHEAD:
            _AHEAD.append(torch.randn(8192, 8192, device=DEVICE))
        for _ in range(2):
            _AHEAD[0] @ _AHEAD[0]
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_events(rng, n, h, w, frame):
    t = rng.randint(0, 50_000, n)
    t.sort()
    return dict(
        x=rng.randint(0, w, n), y=rng.randint(0, h, n), p=rng.randint(0, 2, n),
        t=t + frame * 50_000,
    )


def clustered_events(np, rng, n, h, w, frame, lane):
    """A sparse scene: every event of the lane falls in one of three blobs
    (sigma 30 px, centres fixed per lane, drifting 4 px a frame), so that the
    window selection leaves part of the windows unkept."""
    centers = np.random.RandomState(100 + lane).uniform(0.15, 0.85, (3, 2)) * (w, h) + 4.0 * frame
    xy = centers[rng.randint(0, 3, n)] + rng.randn(n, 2) * 30.0
    t = rng.randint(0, 50_000, n)
    t.sort()
    return dict(
        x=xy[:, 0].clip(0, w - 1).astype(np.int64), y=xy[:, 1].clip(0, h - 1).astype(np.int64),
        p=rng.randint(0, 2, n), t=t + frame * 50_000,
    )


def kernel_inputs(torch, np):
    """Two (4, 384, 640, 20) uint8 inputs at the main path's shape: Poisson
    counts at the serving protocol's ~90% zeros, and a ragged one (empty
    except a dense band, edge columns and corner tiles up to 255)."""
    rng = np.random.RandomState(0)
    shape = KERNEL_SHAPE
    main = rng.poisson(0.1, shape).clip(0, 10).astype(np.uint8)
    ragged = np.zeros(shape, np.uint8)
    B, H, W, C = shape
    ragged[0, H // 4 : H // 4 + 40] = rng.randint(0, 3, (40, W, C))
    ragged[1, :, :3] = 255
    ragged[2, -32:, -32:] = rng.randint(0, 256, (32, 32, C))
    ragged[3, :7, :] = rng.poisson(2.0, (7, W, C)).clip(0, 255)
    return [torch.from_numpy(a).to(DEVICE) for a in (main, ragged)]


def phase_kernels(torch, np):
    import torch.nn.functional as F

    from sast_tpu_torch.ops import density, nms_keep, stem_conv

    results = {}
    xs = kernel_inputs(torch, np)
    B, H, W, C = xs[0].shape
    gen = torch.Generator().manual_seed(1)
    w32 = (torch.randn(64, C, 7, 7, generator=gen) * 0.05).to(DEVICE)

    # Kernel A: both dtypes, with and without density, both inputs.
    for dt in (torch.float32, torch.bfloat16):
        w = w32.to(dt)
        for with_density in (False, True):
            for i, x in enumerate(xs):
                got = stem_conv.stem_conv7x4(x, w, with_density)
                ref = stem_conv.stem_conv7x4_plain(x, w, with_density)
                y, yr = (got[0], ref[0]) if with_density else (got, ref)
                scale = yr.float().abs().max().item()
                err = (y.float() - yr.float()).abs().max().item()
                # fp32: 980-term fp32 sums in another order; bf16: both
                # round an fp32 sum to bf16, so up to two bf16 ulps at max|y|.
                tol = (1e-5 if dt == torch.float32 else 2 ** -7) * max(scale, 1.0)
                if not err <= tol:
                    fail(f"stem kernel {dt} density={with_density} input {i}: "
                         f"max err {err} > {tol}")
                if with_density and not torch.equal(got[1], ref[1]):
                    fail(f"stem kernel density ratio differs ({dt}, input {i})")
                log(f"kernel stem_conv7x4 {dt} density={with_density} input {i}: "
                    f"max_abs_err {err:.3e} (max|y| {scale:.3f}, tol {tol:.3e})")
                results[f"stem_err_{dt}_{with_density}_{i}"] = err
    x = xs[0]
    wb = w32.to(torch.bfloat16)
    ms = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x, wb, True))
    plain = cuda_ms(torch, lambda: stem_conv.stem_conv7x4_plain(x, wb, True), iters=5)
    ms_nd = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x, wb, False))
    ms_fp32 = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x, w32, True))
    xp = F.pad(x.to(torch.bfloat16).permute(0, 3, 1, 2), (3, 3, 3, 3), mode="replicate")
    lib = cuda_ms(torch, lambda: F.conv2d(xp, wb, stride=4))
    y_bytes = B * (H // 4) * (W // 4) * 64
    a_bytes = x.numel() + wb.numel() * 2 + y_bytes * 2 + B * 4 * C * 4
    a_flops = 2.0 * y_bytes * 7 * 7 * C
    a_bound, a_by = bound_ms(a_bytes, a_flops, "bf16")
    err_a = max(v for k, v in results.items() if k.startswith("stem_err_torch.bfloat16"))
    log(f"kernel stem_conv7x4 bf16+density {ms:.4f} ms, no density {ms_nd:.4f} ms, "
        f"fp32+density {ms_fp32:.4f} ms, plain {plain:.4f} ms, F.conv2d {lib:.4f} ms, "
        f"bound {a_bound:.4f} ms ({a_by}: {a_bytes / 1e6:.1f} MB, {a_flops / 1e9:.2f} GFLOP)")
    stem = dict(name="stem_conv7x4", route="cuda", source="sast_tpu_torch/csrc/stem_conv.cu",
                replaces="sast_tpu/ops/pallas/stem_conv.py:604", launches=None,
                max_abs_err=err_a, ms=ms, plain_ms=plain, bound_ms=a_bound, bound_by=a_by,
                library_ms=lib, ms_no_density=ms_nd, ms_fp32=ms_fp32)

    # Kernel B.
    for i, xi in enumerate(xs):
        if not torch.equal(density.density_ratio(xi), density.density_ratio_plain(xi)):
            fail(f"density kernel differs from its plain version on input {i}")
    ms_b = cuda_ms(torch, lambda: density.density_ratio(x))
    plain_b = cuda_ms(torch, lambda: density.density_ratio_plain(x), iters=5)
    b_bound, b_by = bound_ms(x.numel() + B * 4 * C * 4, 2.0 * x.numel(), "fp32")
    log(f"kernel density_ratio {ms_b:.4f} ms, plain {plain_b:.4f} ms, "
        f"bound {b_bound:.4f} ms ({b_by}); exact on both inputs")
    dens = dict(name="density_ratio", route="cuda", source="sast_tpu_torch/csrc/density.cu",
                replaces="sast_tpu/ops/pallas/density.py:168", launches=None,
                max_abs_err=0.0, ms=ms_b, plain_ms=plain_b, bound_ms=b_bound,
                bound_by=b_by, library_ms=None)

    # Kernel C: (4, 1000) clustered, score-sorted candidates.
    rng = np.random.RandomState(2)
    n, k = 4, 1000
    centers = rng.rand(n, 12, 2) * 600
    idx = rng.randint(0, 12, (n, k))
    xy = centers[np.arange(n)[:, None], idx] + rng.randn(n, k, 2) * 15
    wh = 10 + rng.rand(n, k, 2) * 60
    boxes = torch.from_numpy(
        np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)).to(DEVICE)
    sc = np.sort(rng.rand(n, k).astype(np.float32), axis=-1)[:, ::-1].copy()
    sc[:, -100:] = 0.0
    scores = torch.from_numpy(sc).to(DEVICE)
    keep = nms_keep.greedy_keep(boxes, scores, 0.45)
    keep_ref = nms_keep.greedy_keep_plain(boxes, scores, 0.45)
    if not torch.equal(keep, keep_ref):
        fail(f"greedy keep kernel differs at {int((keep != keep_ref).sum())} candidates")
    ms_c = cuda_ms(torch, lambda: nms_keep.greedy_keep(boxes, scores, 0.45))
    plain_c = cuda_ms(torch, lambda: nms_keep.greedy_keep_plain(boxes, scores, 0.45),
                      iters=3, warmup=1)
    # Work this data needs: one IoU test (about 12 fp32 ops) per kept
    # earlier box for every valid candidate.
    kept_before = torch.cumsum(keep_ref.int(), dim=1) - keep_ref.int()
    tests = float((kept_before * (scores > 0)).sum())
    c_bound, c_by = bound_ms(boxes.numel() * 4 + scores.numel() * 4 + keep.numel(),
                             12.0 * tests, "fp32")
    log(f"kernel greedy_keep {ms_c:.4f} ms, plain {plain_c:.4f} ms, bound {c_bound:.6f} ms "
        f"({c_by}); exact; kept {int(keep.sum())} of {int((scores > 0).sum())}")
    nmsk = dict(name="greedy_keep", route="cuda", source="sast_tpu_torch/csrc/nms_keep.cu",
                replaces="sast_tpu/ops/pallas/nms_keep.py:79", launches=None,
                max_abs_err=0.0, ms=ms_c, plain_ms=plain_c, bound_ms=c_bound,
                bound_by=c_by, library_ms=None)
    return [stem, dens, nmsk]


def attn_cfg(C, heads):
    from sast_tpu_torch.config import AttentionConfig

    return AttentionConfig(partition_size=(6, 10), dim_head=C // heads)


def block_case(torch, np, M, C, heads, dtype, density, seed):
    """One attention layer's worth of block-kernel inputs: a port
    ``MaskedSparseAttention`` with seeded weights (LayerScale of order 1, so
    that attention and MLP really move the output), its ``kernel_params``,
    norm1-ed tokens, and masks at window density ``density`` with token
    density 0.5 inside kept windows and one window with a single kept token."""
    from sast_tpu_torch.models.sast import MaskedSparseAttention
    from sast_tpu_torch.ops.block import kernel_params

    rng = np.random.RandomState(seed)
    hw = BLOCK_HW
    attn = MaskedSparseAttention(C, attn_cfg(C, heads), dtype)
    with torch.no_grad():
        for name, p in attn.named_parameters():
            if p.dim() == 2:
                v = rng.randn(*p.shape) / np.sqrt(p.shape[1])
            elif name.endswith(("scale", "gamma")):
                v = 1.0 + 0.1 * rng.randn(*p.shape)
            else:
                v = 0.1 * rng.randn(*p.shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    attn = attn.to(DEVICE).eval()
    win = rng.rand(M) < density
    win[0] = True
    tok = (rng.rand(M, hw) < 0.5) & win[:, None]
    tok[0] = False
    tok[0, hw // 2] = True
    win &= tok.any(-1)
    y = torch.from_numpy(rng.randn(M, hw, C).astype(np.float32)).to(DEVICE, dtype)
    return (attn, kernel_params(attn), y, torch.from_numpy(tok).to(DEVICE),
            torch.from_numpy(win).to(DEVICE))


def block_bound(M_run, M, C, inner, dtype_bytes, kind):
    """Least time for the block on ``M_run`` of ``M`` windows: tokens of the
    computed windows read and written once, masks, work list and weights
    read once; operations of ``_fwd_window`` per computed window."""
    hw = BLOCK_HW
    n_bytes = (2 * M_run * hw * C * dtype_bytes + M * hw + 4 * M
               + (4 * C * C + 3 * C * inner) * dtype_bytes + (8 * C + 2 * inner) * 4)
    flops = M_run * (2.0 * hw * C * 3 * C + 4.0 * hw * hw * C + 2.0 * hw * C * C
                     + 2.0 * hw * C * 2 * inner + 2.0 * hw * inner * C)
    return bound_ms(n_bytes, flops, kind)


def phase_block_kernels(torch, np):
    """Kernels D (fused), E (sparse, with and without h1) and F (looped)
    against the plain block, and their times beside the masked torch-op path
    and the gather path, per stage shape, dtype and window density."""
    from sast_tpu_torch.ops import block, fused_block, sparse_block

    hw = BLOCK_HW
    names = ("fused_window_block", "sparse_window_block", "sparse_window_block_looped")
    worst = dict.fromkeys(names, 0.0)
    table = []
    totals = {n: dict(ms=0.0, call=0.0, plain=0.0, bound=0.0, masked=0.0, by={}) for n in names}
    for si, (M, C, heads) in enumerate(BLOCK_SHAPES):
        dh = C // heads
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            for density in BLOCK_DENSITIES:
                attn, params, y, tok, win = block_case(
                    torch, np, M, C, heads, dtype, density, 100 + si)
                inner = params["wout"].shape[0]
                n_win = int(win.sum())
                ref, h1_ref = block.block_window_plain(y, tok, params, heads, dh, return_h1=True)
                ref = torch.where(win[:, None, None], ref, y)
                scale = ref.float().abs().max().item()
                # fp32: the tolerance of the JAX package's interpret-mode
                # kernel test (other summation order, expf/tanhf ulps);
                # bf16: two bf16 ulps at max|out|.
                rtol, atol = (2e-4, 2e-5 * scale) if dtype == torch.float32 else (0.0, 2 ** -7 * scale)
                got_d = fused_block.fused_window_block(y, tok, params, heads, dh)
                got_e = sparse_block.sparse_window_block(y, tok, win, params, heads, dh)
                got_e1, h1 = sparse_block.sparse_window_block(
                    y, tok, win, params, heads, dh, save_h1=True)
                got_f = sparse_block.sparse_window_block_looped(y, tok, win, params, heads, dh)
                torch.cuda.synchronize()
                where = f"stage {si + 1} {kind} density {density}"
                for name, got in (("fused_window_block", got_d), ("sparse_window_block", got_e),
                                  ("sparse_window_block", got_e1),
                                  ("sparse_window_block_looped", got_f)):
                    err = (got.float() - ref.float()).abs()
                    if not bool((err <= atol + rtol * ref.float().abs()).all()):
                        fail(f"{name} {where}: max err {err.max().item()} (atol {atol}, rtol {rtol})")
                    if not torch.equal(got[~tok], y[~tok]):
                        fail(f"{name} {where}: unkept tokens are not bit-equal to y")
                    worst[name] = max(worst[name], err.max().item())
                if not bool(torch.isfinite(h1).all()):
                    fail(f"sparse_window_block {where}: h1 is not finite")
                h1_err = (h1[win] - h1_ref[win]).abs()
                h1_scale = h1_ref.abs().max().item()
                h1_atol = 2e-5 * h1_scale if dtype == torch.float32 else 2 ** -7 * h1_scale
                if not bool((h1_err <= h1_atol + rtol * h1_ref[win].abs()).all()) \
                        or not torch.equal(h1[~win], y[~win].float()):
                    fail(f"sparse_window_block {where}: h1 differs (max {h1_err.max().item()})")

                # Times. The masked and gather paths are the port's own
                # torch-op paths on the same tokens (after norm1).
                y4, tok4, win4 = y[None], tok[None], win[None]
                gather = type(attn)(C, dataclasses.replace(
                    attn_cfg(C, heads), gather_budget=max(n_win, 1) / M), dtype).to(DEVICE).eval()
                gather.load_state_dict(attn.state_dict())
                calls = dict(
                    fused_window_block=lambda: fused_block.fused_window_block(
                        y, tok, params, heads, dh),
                    sparse_window_block=lambda: sparse_block.sparse_window_block(
                        y, tok, win, params, heads, dh),
                    sparse_window_block_looped=lambda: sparse_block.sparse_window_block_looped(
                        y, tok, win, params, heads, dh),
                    masked=lambda: attn.run_block(y4, tok4, win4),
                    gather=lambda: gather.run_block(y4, tok4, win4),
                )
                with torch.no_grad():
                    # Card time alone (launches queued ahead), then the time
                    # of the call as the eager caller paces it.
                    t = {k: cuda_ms(torch, fn, iters=10, ahead=True) for k, fn in calls.items()}
                    t.update({k + "_call": cuda_ms(torch, fn) for k, fn in calls.items()})
                    t["plain_all"] = cuda_ms(torch, lambda: block.block_window_plain(
                        y, tok, params, heads, dh), iters=5, warmup=1)
                    t["plain_kept"] = cuda_ms(
                        torch, lambda: sparse_block.sparse_window_block_plain(
                            y, tok, win, params, heads, dh), iters=5, warmup=1)
                nb = 2 if dtype == torch.bfloat16 else 4
                b_all, by_all = block_bound(M, M, C, inner, nb, kind)
                b_kept, by_kept = block_bound(n_win, M, C, inner, nb, kind)
                row = dict(stage=si + 1, M=M, C=C, dtype=kind, density=density, n_win=n_win,
                           bound_all_ms=b_all, bound_kept_ms=b_kept, bound_by=by_kept, **t)
                table.append(row)
                log(f"block {where} ({n_win}/{M} windows), card ms (call ms): " + " ".join(
                    f"{short} {t[k]:.4f} ({t[k + '_call']:.4f})" for short, k in (
                        ("fused", "fused_window_block"), ("sparse", "sparse_window_block"),
                        ("looped", "sparse_window_block_looped"), ("masked", "masked"),
                        ("gather", "gather")))
                    + f"; plain {t['plain_all']:.4f}/{t['plain_kept']:.4f}; "
                    f"bound {b_all:.5f}/{b_kept:.5f} ({by_kept})")
                if kind == "bf16" and density == BLOCK_TABLE_DENSITY:
                    for name in names:
                        dense = name == "fused_window_block"
                        tot = totals[name]
                        tot["ms"] += t[name]
                        tot["call"] += t[name + "_call"]
                        tot["plain"] += t["plain_all" if dense else "plain_kept"]
                        tot["masked"] += t["masked"]
                        b, by = (b_all, by_all) if dense else (b_kept, by_kept)
                        tot["bound"] += b
                        tot["by"][by] = tot["by"].get(by, 0.0) + b
    (OUT_DIR / "block_kernels.json").write_text(json.dumps(table, indent=1))
    sources = dict(
        fused_window_block=("sast_tpu_torch/csrc/fused_block.cu",
                            "sast_tpu/ops/pallas/fused_block.py:270"),
        sparse_window_block=("sast_tpu_torch/csrc/sparse_block.cu",
                             "sast_tpu/ops/pallas/sparse_block.py:285"),
        sparse_window_block_looped=("sast_tpu_torch/csrc/sparse_block.cu",
                                    "sast_tpu/ops/pallas/sparse_block.py:903"),
    )
    out = []
    for name in names:
        tot = totals[name]
        log(f"kernel {name}: sum over the 4 stage shapes, bf16, density {BLOCK_TABLE_DENSITY}: "
            f"{tot['ms']:.4f} ms on the card ({tot['call']:.4f} ms per eager call), plain "
            f"{tot['plain']:.4f} ms, masked torch ops "
            f"{tot['masked']:.4f} ms, bound {tot['bound']:.5f} ms; worst error {worst[name]:.3e}")
        out.append(dict(name=name, route="cuda", source=sources[name][0],
                        replaces=sources[name][1], launches=None, max_abs_err=worst[name],
                        ms=tot["ms"], plain_ms=tot["plain"], bound_ms=tot["bound"],
                        bound_by=max(tot["by"], key=tot["by"].get), library_ms=None,
                        call_ms=tot["call"], masked_torch_ops_ms=tot["masked"]))
    return out



def reset_counters():
    from sast_tpu_torch.ops import density, fused_block, nms_keep, sparse_block, stem_conv

    stem_conv.stem_conv7x4.launches = 0
    density.density_ratio.launches = 0
    nms_keep.greedy_keep.launches = 0
    fused_block.fused_window_block.launches = 0
    sparse_block.sparse_window_block.launches = 0
    sparse_block.sparse_window_block_looped.launches = 0


def read_counters():
    from sast_tpu_torch.ops import density, fused_block, nms_keep, sparse_block, stem_conv

    return dict(stem_conv7x4=stem_conv.stem_conv7x4.launches,
                density_ratio=density.density_ratio.launches,
                greedy_keep=nms_keep.greedy_keep.launches,
                fused_window_block=fused_block.fused_window_block.launches,
                sparse_window_block=sparse_block.sparse_window_block.launches,
                sparse_window_block_looped=sparse_block.sparse_window_block_looped.launches)


def phase_serving(torch, np, card):
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.models.detector import YoloXDetector, build_detector
    from sast_tpu_torch.serving import StreamingDetector

    cfg = get_config("gen4", "base")
    bb = cfg.model.backbone
    log(f"gen4-base: model {bb.in_res_hw}, native {cfg.dataset.resolution_hw}, dims "
        f"{bb.stage_dims}, partition {bb.attention.partition_size}, "
        f"{cfg.model.compute_dtype}, {STREAMS} streams")
    model = build_detector(cfg.model, seed=0, device=DEVICE)
    det = StreamingDetector(cfg, model, max_events=EVENTS_PER_FRAME, num_streams=STREAMS,
                            device=DEVICE)
    h, w = cfg.dataset.resolution_hw
    rng = np.random.RandomState(7)
    frames = [[clustered_events(np, rng, EVENTS_PER_FRAME - 1000 * s, h, w, f, s)
               for s in range(STREAMS)] for f in range(FRAMES)]
    resets = [np.array([f == FRAMES // 2 and s == 2 for s in range(STREAMS)])
              for f in range(FRAMES)]
    pp = cfg.model.postprocess

    reset_counters()
    outs = [det.process_batch(frames[f], reset=resets[f]) for f in range(FRAMES)]
    torch.cuda.synchronize()
    counts = read_counters()
    log(f"main path launches over {FRAMES} frames: {counts}")
    if counts["stem_conv7x4"] < FRAMES or counts["greedy_keep"] < FRAMES:
        fail(f"main path did not launch the stem and NMS kernels on every frame: {counts}")
    for f, out in enumerate(outs):
        for key, shape in (("boxes", (STREAMS, pp.max_detections, 4)),
                           ("scores", (STREAMS, pp.max_detections)),
                           ("valid", (STREAMS, pp.max_detections))):
            if out[key].shape != shape:
                fail(f"frame {f} {key} shape {out[key].shape} != {shape}")
        if out["valid"].dtype != bool or not np.isfinite(out["boxes"]).all() \
                or not np.isfinite(out["scores"]).all():
            fail(f"frame {f}: non-finite outputs or a non-bool valid mask")
        if (out["scores"][~out["valid"]] != 0).any() or (out["classes"][~out["valid"]] != -1).any():
            fail(f"frame {f}: invalid slots are not zeroed")
        log(f"frame {f}: valid per lane {out['valid'].sum(1).tolist()}, "
            f"selected tokens {out['selected_tokens'].tolist()}")

    # The density kernel on the path: fusion off, same weights, same frames.
    cfg_nf = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(bb, fuse_stem_density=False)))
    model_nf = YoloXDetector(cfg_nf.model)
    model_nf.load_state_dict(model.state_dict())
    det_nf = StreamingDetector(cfg_nf, model_nf, max_events=EVENTS_PER_FRAME,
                               num_streams=STREAMS, device=DEVICE)
    det.reset()
    reset_counters()
    outs_nf = [det_nf.process_batch(frames[f]) for f in range(2)]
    torch.cuda.synchronize()
    counts_nf = read_counters()
    log(f"fusion-off launches over 2 frames: {counts_nf}")
    if counts_nf["density_ratio"] < 2 or counts_nf["stem_conv7x4"] < 2:
        fail(f"fusion-off path did not launch the density and stem kernels: {counts_nf}")
    for f in range(2):
        ref = det.process_batch(frames[f])
        for key in ("boxes", "scores", "classes", "valid", "selected_tokens"):
            if not np.array_equal(ref[key], outs_nf[f][key]):
                fail(f"fused and standalone density paths differ at frame {f} {key}")
    log("fused and standalone density paths give identical detections")

    # Steady state: the device step alone (CUDA events) and the whole
    # process_batch (host packing, upload, step, download).
    from sast_tpu_torch.packing import pack_event_batch

    packed, n = pack_event_batch(frames[0], STREAMS, EVENTS_PER_FRAME)
    pk, nk = torch.from_numpy(packed).to(DEVICE), torch.from_numpy(n).to(DEVICE)
    no_reset = torch.zeros(STREAMS, dtype=torch.bool, device=DEVICE)
    step_ms = cuda_ms(torch, lambda: det.step(pk, nk, no_reset), iters=30, warmup=5)
    t0 = time.perf_counter()
    for f in range(FRAMES):
        det.process_batch(frames[f])
    e2e_ms = (time.perf_counter() - t0) / FRAMES * 1e3
    log(f"serving step gen4-base b{STREAMS} on {card}: device step {step_ms:.3f} ms/step "
        f"({STREAMS * 1e3 / step_ms:.1f} frames/s); process_batch {e2e_ms:.3f} ms/step "
        f"({STREAMS * 1e3 / e2e_ms:.1f} frames/s)")

    # Every timing comes before the first profiler trace, so that no
    # tracing overhead can leak into a step time.
    paths = phase_attention_paths(torch, np, cfg, model, det, frames, outs, pk, nk)

    # Where the device time goes (torch.profiler over a short window).
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            det.step(pk, nk, no_reset)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (OUT_DIR / "serving_profile.txt").write_text(table)
    log("profile (top rows; full table in chiprun_out/serving_profile.txt):")
    for line in table.splitlines()[:16]:
        log("  " + line)
    return dict(counts=counts, counts_fusion_off=counts_nf, step_ms=step_ms, e2e_ms=e2e_ms,
                frames_per_s=STREAMS * 1e3 / step_ms, paths=paths)


def with_attention(cfg, **switches):
    """``cfg`` with switches of ``model.backbone.attention`` replaced."""
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, **switches))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))


# The attention paths beside the masked one: name -> (attention switches,
# sparse_kernel, looped kernel on the sparse path, the block kernel whose
# counter must show 8 launches per step).
ATTENTION_PATHS = {
    "sparse": (dict(), True, False, "sparse_window_block"),
    "looped": (dict(), True, True, "sparse_window_block_looped"),
    "fused": (dict(fused_block=True), False, False, "fused_window_block"),
    "gather": (dict(gather_budget=0.5), False, False, None),
}


def path_detector(cfg, model, name, max_events, num_streams):
    """A ``StreamingDetector`` on attention path ``name`` with ``model``'s
    weights."""
    from sast_tpu_torch.models.detector import YoloXDetector
    from sast_tpu_torch.serving import StreamingDetector

    switches, sparse_kernel, _, _ = ATTENTION_PATHS[name]
    cfg_p = with_attention(cfg, **switches)
    model_p = YoloXDetector(cfg_p.model)
    model_p.load_state_dict(model.state_dict())
    return StreamingDetector(cfg_p, model_p, max_events=max_events, num_streams=num_streams,
                             device=DEVICE, sparse_kernel=sparse_kernel)


def phase_attention_paths(torch, np, cfg, model, det_masked, frames, masked_outs, pk, nk):
    """The 4-stream step on the sparse, looped, fused and gather attention
    paths: same weights and frames as the masked run. The launch counters
    must show 8 block-kernel launches per step (4 stages x window + grid
    layer); outputs must be finite and of the slate's shape; bf16 rounds at
    other places on each path, so detection counts are printed beside the
    masked path's and compared in fp32 by phase 4. Step times of all five
    paths are taken in turns, two rounds, since the eager step is paced by
    the host and host speed drifts."""
    from sast_tpu_torch.models.sast import MaskedSparseAttention
    from sast_tpu_torch.ops import sparse_block

    results, dets = {}, {}
    for name, (_, _, looped, kernel) in ATTENTION_PATHS.items():
        det = dets[name] = path_detector(cfg, model, name, EVENTS_PER_FRAME, STREAMS)
        sparse_block.MODEL_USES_LOOPED, default = looped, sparse_block.MODEL_USES_LOOPED
        try:
            shares = []
            if name == "sparse":
                # Kept-window share per attention layer, read on one frame
                # outside the counted and timed runs.
                hooks = [m.register_forward_pre_hook(
                    lambda _m, args: shares.append(float(args[2].float().mean())))
                    for m in det.model.modules() if isinstance(m, MaskedSparseAttention)]
                det.process_batch(frames[0])
                for h in hooks:
                    h.remove()
                det.reset()
                log(f"kept-window share per attention layer (stage 1 window, grid, ...): "
                    f"{[round(v, 3) for v in shares]}")
                if min(shares) >= 1.0:
                    fail("every window is kept in every layer: the sparse path skips nothing")
            reset_counters()
            outs = [det.process_batch(frames[f]) for f in range(PATH_FRAMES)]
            torch.cuda.synchronize()
            counts = read_counters()
        finally:
            sparse_block.MODEL_USES_LOOPED = default
        if kernel is not None and counts[kernel] != 8 * PATH_FRAMES:
            fail(f"{name} path: {counts[kernel]} launches of {kernel} over {PATH_FRAMES} "
                 f"frames, expected {8 * PATH_FRAMES}: {counts}")
        if counts["stem_conv7x4"] < PATH_FRAMES or counts["greedy_keep"] < PATH_FRAMES:
            fail(f"{name} path did not launch the stem and NMS kernels every frame: {counts}")
        for f, out in enumerate(outs):
            if out["boxes"].shape != masked_outs[f]["boxes"].shape \
                    or not np.isfinite(out["boxes"]).all() or not np.isfinite(out["scores"]).all():
                fail(f"{name} path frame {f}: bad slate shape or non-finite outputs")
        valid = [int(o["valid"].sum()) for o in outs]
        log(f"path {name}: launches over {PATH_FRAMES} frames {counts}; detections per frame "
            f"{valid} (masked {[int(o['valid'].sum()) for o in masked_outs[:PATH_FRAMES]]}); "
            f"selected tokens frame 0 {outs[0]['selected_tokens'].tolist()} "
            f"(masked {masked_outs[0]['selected_tokens'].tolist()})")
        results[name] = dict(counts=counts, valid=valid, window_share=shares, step_ms_rounds=[])

    no_reset = torch.zeros(STREAMS, dtype=torch.bool, device=DEVICE)
    dets = {"masked": det_masked, **dets}
    results["masked"] = dict(step_ms_rounds=[])
    for _ in range(2):
        for name, det in dets.items():
            looped = name in ATTENTION_PATHS and ATTENTION_PATHS[name][2]
            sparse_block.MODEL_USES_LOOPED, default = looped, sparse_block.MODEL_USES_LOOPED
            try:
                results[name]["step_ms_rounds"].append(
                    cuda_ms(torch, lambda: det.step(pk, nk, no_reset), iters=20, warmup=3))
            finally:
                sparse_block.MODEL_USES_LOOPED = default
    # Kernel time on the card per step (profiler, 3 steps): unlike the step
    # time it does not depend on how fast the host dispatches.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, det in dets.items():
        looped = name in ATTENTION_PATHS and ATTENTION_PATHS[name][2]
        sparse_block.MODEL_USES_LOOPED, default = looped, sparse_block.MODEL_USES_LOOPED
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    det.step(pk, nk, no_reset)
                torch.cuda.synchronize()
        finally:
            sparse_block.MODEL_USES_LOOPED = default
        # Kernel rows only: an operator's row repeats its kernels' time.
        busy_us = sum(getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if busy_us <= 0:
            fail(f"path {name}: the profiler saw no kernel time on the card")
        results[name]["card_ms"] = busy_us / 3 / 1e3
    for name, res in results.items():
        res["step_ms"] = sum(res["step_ms_rounds"]) / 2
    for name, res in results.items():
        log(f"path {name}: device step {res['step_ms']:.3f} ms/step (rounds "
            f"{[round(v, 3) for v in res['step_ms_rounds']]}), "
            f"{res['step_ms'] / results['masked']['step_ms']:.3f}x masked; kernel time on the "
            f"card {res['card_ms']:.3f} ms/step, idle share "
            f"{1 - res['card_ms'] / res['step_ms']:.3f}")
    return results


def phase_cpu_parity(torch, np):
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.representations import stacked_histogram
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.models.head import inference_outputs
    from sast_tpu_torch.packing import pack_event_batch
    from sast_tpu_torch.serving import StreamingDetector
    from sast_tpu_torch.utils.padding import InputPadder

    cfg = get_config("gen4", "base")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    h, w = cfg.dataset.resolution_hw
    rng = np.random.RandomState(11)
    frames = [synthetic_events(rng, 100_000, h, w, f) for f in range(2)]
    model_cpu = build_detector(cfg.model, seed=3, device="cpu")
    # At random init every score sits at the prior (1e-4) within about
    # 0.3%, closer together than the card and the CPU can agree on, so the
    # order of candidates would be noise. Spread the prediction logits (a
    # stand-in for trained weights) so that the comparison means something.
    with torch.no_grad():
        for k in range(len(model_cpu.head.strides)):
            for name, gain in (("cls_pred", 1000.0), ("obj_pred", 1000.0), ("reg_pred", 100.0)):
                conv = getattr(model_cpu.head, f"{name}{k}")
                conv.kernel.mul_(gain)
                conv.bias.zero_()
        # LayerScale starts at 1e-5, where the attention block barely moves
        # its input and every attention path would agree trivially; 0.05
        # stands in for trained values.
        for name, p in model_cpu.named_parameters():
            if name.endswith(("ls1.gamma", "ls2.gamma")):
                p.fill_(LAYER_SCALE)
    model_gpu = copy.deepcopy(model_cpu).to(DEVICE)

    # A confidence threshold in the widest score gap around rank 100 of the
    # first frame, so that about 100 candidates reach NMS and no score sits
    # near the threshold.
    packed, n = pack_event_batch([frames[0]], 1, 100_000)
    with torch.no_grad():
        rep = stacked_histogram(torch.from_numpy(packed), torch.from_numpy(n), 10, h, w, 10)
        ev = InputPadder(cfg.model.backbone.in_res_hw).pad_tensor_ev_repr(rep)
        feats, _, _ = model_cpu.forward_backbone(ev)
        preds = inference_outputs(model_cpu.forward_detect(feats)["preds"])[0]
    s = (preds[:, 4] * preds[:, 5:].max(dim=-1).values).sort(descending=True).values
    gaps = s[80:120] / s[81:121]
    r = 80 + int(gaps.argmax())
    thr = float((s[r] * s[r + 1]).sqrt())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, postprocess=dataclasses.replace(cfg.model.postprocess, confidence_threshold=thr)))
    log(f"cpu parity: confidence threshold {thr:.6e} between ranks {r + 1} and {r + 2} "
        f"(relative gap {float(gaps.max()):.6f})")

    det_cpu = StreamingDetector(cfg, model_cpu, max_events=100_000, device="cpu")
    dets_gpu = {"masked": StreamingDetector(cfg, model_gpu, max_events=100_000, device=DEVICE)}
    for name in ("sparse", "fused", "gather"):
        dets_gpu[name] = path_detector(cfg, model_gpu, name, 100_000, 1)
    worst = {name: [0.0, 0.0] for name in dets_gpu}  # box px, score relative
    reset_counters()
    for f, fr in enumerate(frames):
        oc = det_cpu.process_events(**fr)
        nc = int(oc["valid"].sum())
        bc, cc, scc = (oc[k][oc["valid"]] for k in ("boxes", "classes", "scores"))
        for name, det in dets_gpu.items():
            og = det.process_events(**fr)
            ng = int(og["valid"].sum())
            if nc != ng or nc == 0:
                fail(f"cpu parity frame {f} {name}: {ng} detections on the card, {nc} on the CPU")
            bg, cg, scg = (og[k][og["valid"]] for k in ("boxes", "classes", "scores"))
            # Match each CPU detection to the card's nearest box of its class
            # (the two may order near-equal scores differently).
            for i in range(nc):
                same = np.flatnonzero(cg == cc[i])
                if same.size == 0:
                    fail(f"cpu parity frame {f} {name}: class {cc[i]} missing on the card")
                d = np.abs(bg[same] - bc[i]).max(axis=1)
                j = same[d.argmin()]
                worst[name][0] = max(worst[name][0], float(d.min()))
                worst[name][1] = max(worst[name][1], abs(float(scg[j] - scc[i])) / float(scc[i]))
            if sorted(cc.tolist()) != sorted(cg.tolist()):
                fail(f"cpu parity frame {f} {name}: classes differ")
            log(f"cpu parity frame {f} {name}: {nc} detections match; selected tokens cpu "
                f"{oc['selected_tokens'].tolist()} card {og['selected_tokens'].tolist()}")
    counts = read_counters()
    if counts["sparse_window_block"] != 8 * len(frames) \
            or counts["fused_window_block"] != 8 * len(frames):
        fail(f"cpu parity: the sparse and fused paths did not launch their kernels: {counts}")
    # fp32 on both sides; the card sums convolutions and matmuls in other
    # orders: boxes are pixels up to ~700 px, scores relative.
    for name, (box, score) in worst.items():
        if box > 0.05 or score > 1e-3:
            fail(f"cpu parity {name}: box diff {box} px, score rel diff {score}")
        log(f"cpu parity {name} path on the card vs the CPU masked path: max box diff "
            f"{box:.3e} px (tol 0.05), max score rel diff {score:.3e} (tol 1e-3)")
    return dict(box_diff_px=worst["masked"][0], score_rel_diff=worst["masked"][1],
                threshold=thr, paths={k: dict(box_diff_px=v[0], score_rel_diff=v[1])
                                      for k, v in worst.items()})


def main() -> None:
    if not (ROOT / "sast_tpu_torch" / "csrc").is_dir():
        fail("sast_tpu_torch/ not found beside chip_smoke.py: run it from a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from sast_tpu_torch import build

    t0 = time.perf_counter()
    logs = build.build()
    (OUT_DIR / "build_log.txt").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc log in chiprun_out/build_log.txt)")

    t0 = time.perf_counter()
    kernels = phase_kernels(torch, np) + phase_block_kernels(torch, np)
    log(f"phase 2: kernels hold against their plain versions ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    serving = phase_serving(torch, np, smi)
    # Launches on the path that runs each kernel: the stem and NMS kernels
    # on the default (fused) serving path, the density kernel on the
    # fusion-off path; each counted from 0 over its own run.
    # The block kernels on the attention path that runs each (fused, sparse;
    # the looped kernel on the sparse path switched to it).
    block_path = dict(fused_window_block="fused", sparse_window_block="sparse",
                      sparse_window_block_looped="looped")
    for k in kernels:
        if k["name"] in block_path:
            k["launches"] = serving["paths"][block_path[k["name"]]]["counts"][k["name"]]
            continue
        path = "counts_fusion_off" if k["name"] == "density_ratio" else "counts"
        k["launches"] = serving[path][k["name"]]
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched on its path")
    log(f"phase 3: serving main path ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    parity = phase_cpu_parity(torch, np)
    log(f"phase 4: card matches the CPU plain path ({time.perf_counter() - t0:.1f} s)")

    record = dict(card=smi, kernels=kernels, serving=serving, cpu_parity=parity,
                  seconds=time.perf_counter() - t_start)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
