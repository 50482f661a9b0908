#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sast_tpu_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit: ``python3 chip_smoke.py``. Phases, each fatal on failure:

1. Print the card's name and power limit; build the eight kernels (eight
   libraries) from ``sast_tpu_torch/csrc`` (one nvcc per source, all started
   together), and log the registers and spills of kernels A, E, G and H.
2. Hold each kernel against its plain PyTorch version on the card, TF32
   off, at the gen4-base b4 serving shapes, and time kernel, plain version,
   bound and library call; the stem kernel also at the training step's 12
   lanes and the NMS kernel at the 36 frames of its ``eval_step``. Kernel A
   (redesigned: an implicit GEMM on the tensor cores) is timed against
   ``F.conv2d`` in turns (library, kernel, kernel, library) and its share of
   the bound is logged. The three block kernels (fused, sparse, looped)
   run at the four stage shapes, in bf16 and fp32, at window densities 0.1,
   0.4 and 1.0, beside the masked torch-op path and the gather path; the
   sparse kernel E (redesigned: launches over the kept tokens) is timed in
   turns with the looped kernel F (the same function on E's first design,
   one block per window) and the masked torch ops, with its share of the
   bound and its time per launch.
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
   Then, at the four stage shapes of the gen4-base B = 12 training step,
   bf16 and fp32, window densities 0.1, 0.4, 1.0 and no kept window: the
   sparse forward kernel (output and saved h1) and the two backward kernels
   (MLP branch G and attention branch H, both redesigned as tensor-core
   launches without float atomics and checked to give the same bits twice)
   against their plain versions, and the
   whole ``autograd.Function`` against ``torch.autograd`` of the plain
   block; time per layer beside autograd through the masked torch-op block.
4. Hold the whole path on the card (kernels, fp32, TF32 off) on the masked,
   sparse, fused and gather attention paths against the same port on the
   CPU (plain versions, masked path) at gen4-base B=1 for 2 frames.
5. Train: ``Trainer.fit`` for 4 steps at gen4-base width (B 12, T 5, L 3,
   bf16, remat ``full``) on the sparse-kernel path and on the masked path
   from one seed and the same batches (synthetic at sparsity 0.9, then
   clustered scenes that leave windows unkept): finite losses and
   gradients, the launch counters of the forward and both backward kernels,
   first-step losses of the two paths compared, ms/step, kernel time per
   step and peak memory of both. Then two fp32 steps on the card (sparse
   path, kernels) against the same steps on the CPU (plain versions) and on
   the masked path at a cut size, gradients compared leaf by leaf; the
   first step again under remat ``none`` and ``dots``; ``infer_step``
   against ``eval_step``.

Prints the kernel table as one JSON line (the rows of kernels redesigned
since their first port carry ``redesigned``, the change that did it; the
first versions' times are in PERF.md), then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. Longer output (build
logs, profiler table, all measurements) goes to ``chiprun_out/``.
Exits non-zero, printing no result, without a card or outside a checkout.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
DEVICE = "cuda"
KERNEL_SHAPE = (4, 384, 640, 20)  # the stem input of the gen4-base b4 step
TRAIN_KERNEL_SHAPE = (12, 384, 640, 20)  # the stem input of the B = 12 training step
NMS_FRAMES = (4, 36)  # frames per NMS launch: the b4 step; eval_step at B 12, L 3
FRAMES = 6
PATH_FRAMES = 3  # frames driven on each of the other attention paths
STREAMS = 4
# (M windows, C, heads) of one attention layer per stage of the gen4-base b4
# step; hw = 60 tokens per window, dim_head 32.
BLOCK_SHAPES = ((1024, 64, 2), (256, 128, 4), (64, 256, 8), (16, 512, 16))
BLOCK_HW = 60
# The same layers in the gen4-base training step: B = 12 lanes.
TRAIN_BLOCK_SHAPES = tuple((3 * M, C, heads) for M, C, heads in BLOCK_SHAPES)
BWD_DENSITIES = (0.1, 0.4, 1.0, 0.0)
TRAIN_STEPS = 4
BLOCK_DENSITIES = (0.1, 0.4, 1.0)
BLOCK_TABLE_DENSITY = 0.4  # the density whose times go into the kernels line
LAYER_SCALE = 0.05  # LayerScale of the CPU-parity model
EVENTS_PER_FRAME = 200_000  # StreamingDetector's default budget
# Kernels redesigned since their first port, with the change that did it.
REDESIGNED = {"stem_conv7x4": "PR 4", "sparse_block_attn_bwd": "PR 4",
              "sparse_window_block": "PR 5", "sparse_block_mlp_bwd": "PR 5"}
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def ptxas_lines(logs, names=("stem_conv", "sparse_fwd", "mlp_bwd", "attn_bwd")):
    """Registers and spills of each kernel the nvcc logs of ``names`` list
    (``-Xptxas=-v``), one line per instantiation."""
    out = []
    pat = re.compile(r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads\nptxas info\s+: Used (\d+) registers", re.S)
    for name in names:
        for fn, stores, loads, regs in pat.findall(logs.get(name, "")):
            short = re.sub(r"^_ZN\w*?_GLOBAL__N__\w+?_cu_\w{8}", "", fn)
            out.append(f"{name}: {short}: {regs} registers, spill stores {stores} B, "
                       f"loads {loads} B")
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    """Print a line, and keep it in ``chiprun_out/chip_smoke_log.txt``."""
    print(msg, flush=True)
    if OUT_DIR.is_dir():
        with open(OUT_DIR / "chip_smoke_log.txt", "a") as f:
            f.write(msg + "\n")


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


def launch_us(torch, fn, namespace: str, calls: int = 3):
    """Card time per call of each kernel of ``namespace`` (its source's
    namespace, e.g. ``ab`` for kernel H) that ``fn`` launches, in us, from
    the profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and re.search(rf"\b{namespace}::", e.key):
            short = re.search(r"(\w+_kernel(?:<[^>]*>)?)", e.key).group(1)
            per[short] = per.get(short, 0.0) + (getattr(e, "self_device_time_total", 0)
                                                or getattr(e, "self_cuda_time_total", 0)) / calls
    return ", ".join(f"{k} {v:.1f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1]))


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
    # The training step gives the kernel 12 lanes per timestep.
    x12 = torch.from_numpy(np.random.RandomState(3).poisson(0.1, TRAIN_KERNEL_SHAPE)
                           .clip(0, 10).astype(np.uint8)).to(DEVICE)
    for dt in (torch.float32, torch.bfloat16):
        got = stem_conv.stem_conv7x4(x12, w32.to(dt), True)
        ref = stem_conv.stem_conv7x4_plain(x12, w32.to(dt), True)
        scale = ref[0].float().abs().max().item()
        err = (got[0].float() - ref[0].float()).abs().max().item()
        tol = (1e-5 if dt == torch.float32 else 2 ** -7) * max(scale, 1.0)
        if not err <= tol or not torch.equal(got[1], ref[1]):
            fail(f"stem kernel {dt} at the training shape {TRAIN_KERNEL_SHAPE}: max err {err} "
                 f"> {tol}, or the density ratio differs")
        log(f"kernel stem_conv7x4 {dt} density=True at {TRAIN_KERNEL_SHAPE}: max_abs_err "
            f"{err:.3e} (max|y| {scale:.3f}, tol {tol:.3e}); density ratio exact")
        results[f"stem_err_{dt}_train"] = err
    w12 = w32.to(torch.bfloat16)
    ms_b12 = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x12, w12, True), ahead=True)
    ms_b12_call = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x12, w12, True))
    xp12 = F.pad(x12.to(torch.bfloat16).permute(0, 3, 1, 2), (3, 3, 3, 3), mode="replicate")
    lib_b12 = cuda_ms(torch, lambda: F.conv2d(xp12, w12, stride=4), ahead=True)
    del x12, xp12
    x = xs[0]
    wb = w32.to(torch.bfloat16)
    # Kernel A against cuDNN's bf16 convolution of the pre-padded input, in
    # turns in one process (library, kernel, kernel, library), card time
    # alone (launches queued ahead): the counts' zeroing, the weight
    # arrangement, the kernel and the ratio's division are all in the
    # kernel's time. Then both per eager call (the host's pace included).
    xp = F.pad(x.to(torch.bfloat16).permute(0, 3, 1, 2), (3, 3, 3, 3), mode="replicate")
    kernel_call = lambda: stem_conv.stem_conv7x4(x, wb, True)
    library_call = lambda: F.conv2d(xp, wb, stride=4)
    turns = [cuda_ms(torch, fn, ahead=True)
             for fn in (library_call, kernel_call, kernel_call, library_call)]
    lib, ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    ms_call = cuda_ms(torch, kernel_call)
    lib_call = cuda_ms(torch, library_call)
    plain = cuda_ms(torch, lambda: stem_conv.stem_conv7x4_plain(x, wb, True), iters=5)
    ms_nd = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x, wb, False), ahead=True)
    ms_fp32 = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x, w32, True), ahead=True)
    y_bytes = B * (H // 4) * (W // 4) * 64
    a_bytes = x.numel() + wb.numel() * 2 + y_bytes * 2 + B * 4 * C * 4
    a_flops = 2.0 * y_bytes * 7 * 7 * C
    a_bound, a_by = bound_ms(a_bytes, a_flops, "bf16")
    err_a = max(v for k, v in results.items() if k.startswith("stem_err_torch.bfloat16"))
    log(f"kernel stem_conv7x4 bf16+density {ms:.4f} ms (turns: F.conv2d {turns[0]:.4f}, kernel "
        f"{turns[1]:.4f}, kernel {turns[2]:.4f}, F.conv2d {turns[3]:.4f}; {lib / ms:.2f}x "
        f"F.conv2d's time; per eager call {ms_call:.4f} ms, F.conv2d {lib_call:.4f} ms), "
        f"no density {ms_nd:.4f} ms, "
        f"fp32+density {ms_fp32:.4f} ms, plain {plain:.4f} ms, bound {a_bound:.4f} ms ({a_by}: "
        f"{a_bytes / 1e6:.1f} MB, {a_flops / 1e9:.2f} GFLOP), share of the bound "
        f"{a_bound / ms:.3f}; at the B = 12 training shape {ms_b12:.4f} ms ({ms_b12_call:.4f} "
        f"ms per eager call), F.conv2d {lib_b12:.4f} ms")
    stem = dict(name="stem_conv7x4", route="cuda", source="sast_tpu_torch/csrc/stem_conv.cu",
                replaces="sast_tpu/ops/pallas/stem_conv.py:604", launches=None,
                max_abs_err=err_a, ms=ms, plain_ms=plain, bound_ms=a_bound, bound_by=a_by,
                library_ms=lib, ms_no_density=ms_nd, ms_fp32=ms_fp32, ms_b12=ms_b12,
                call_ms_b12=ms_b12_call,
                library_ms_b12=lib_b12, call_ms=ms_call, bound_share=a_bound / ms,
                library_call_ms=lib_call, turns_ms=turns,
                redesigned=REDESIGNED["stem_conv7x4"])

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

    # Kernel C: (n, 1000) clustered, score-sorted candidates, for the frame
    # count of the serving step (timed) and that of eval_step in training.
    k = 1000
    for n in NMS_FRAMES[::-1]:
        rng = np.random.RandomState(2)
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
            fail(f"greedy keep kernel differs at {int((keep != keep_ref).sum())} candidates "
                 f"of {n} frames")
        log(f"kernel greedy_keep ({n}, {k}, 4): exact; kept {int(keep.sum())} of "
            f"{int((scores > 0).sum())}")
    ms_c = cuda_ms(torch, lambda: nms_keep.greedy_keep(boxes, scores, 0.45))
    plain_c = cuda_ms(torch, lambda: nms_keep.greedy_keep_plain(boxes, scores, 0.45),
                      iters=3, warmup=1)
    # Work this data needs: one IoU test (about 12 fp32 ops) per kept
    # earlier box for every valid candidate.
    kept_before = torch.cumsum(keep_ref.int(), dim=1) - keep_ref.int()
    tests = float((kept_before * (scores > 0)).sum())
    c_bound, c_by = bound_ms(boxes.numel() * 4 + scores.numel() * 4 + keep.numel(),
                             12.0 * tests, "fp32")
    log(f"kernel greedy_keep ({n}, {k}, 4) {ms_c:.4f} ms, plain {plain_c:.4f} ms, bound "
        f"{c_bound:.6f} ms ({c_by})")
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
    win[0] = density > 0.0
    tok = (rng.rand(M, hw) < 0.5) & win[:, None]
    tok[0] = False
    tok[0, hw // 2] = density > 0.0
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
                    # Card time alone (launches queued ahead): kernel E in
                    # turns with F (its first design's routine) and the
                    # masked torch ops, F E masked masked E F; then the time
                    # of each call as the eager caller paces it.
                    order = ("sparse_window_block_looped", "sparse_window_block", "masked")
                    turns = {k: [] for k in order}
                    for k in order + order[::-1]:
                        turns[k].append(cuda_ms(torch, calls[k], iters=10, ahead=True))
                    t = {k: sum(v) / len(v) for k, v in turns.items()}
                    t.update({k: cuda_ms(torch, calls[k], iters=10, ahead=True)
                              for k in ("fused_window_block", "gather")})
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
                    f"bound {b_all:.5f}/{b_kept:.5f} ({by_kept}); E's share of the bound "
                    f"{b_kept / t['sparse_window_block']:.4f}")
                if kind == "bf16" and density == BLOCK_TABLE_DENSITY:
                    with torch.no_grad():
                        log(f"block {where}: kernel E per call, us by launch: "
                            + launch_us(torch, calls["sparse_window_block"], "sf"))
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
        sparse_window_block=("sast_tpu_torch/csrc/sparse_fwd.cu",
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
            f"{tot['masked']:.4f} ms, bound {tot['bound']:.5f} ms (share {tot['bound'] / tot['ms']:.4f}); "
            f"worst error {worst[name]:.3e}")
        out.append(dict(name=name, route="cuda", source=sources[name][0],
                        replaces=sources[name][1], launches=None, max_abs_err=worst[name],
                        ms=tot["ms"], plain_ms=tot["plain"], bound_ms=tot["bound"],
                        bound_by=max(tot["by"], key=tot["by"].get), library_ms=None,
                        call_ms=tot["call"], masked_torch_ops_ms=tot["masked"],
                        bound_share=tot["bound"] / tot["ms"],
                        **({"redesigned": REDESIGNED[name]} if name in REDESIGNED else {})))
    return out


def bwd_bounds(M_run, M, C, inner, y_bytes, w_bytes, kind):
    """Least times of the two backward kernels on ``M_run`` kept of ``M``
    windows. MLP kernel: recompute (u, mlp) plus dWout, g_m, dWglu, g_h1 =
    18 hw C I operations per kept window; h1 of the kept windows and g of all
    windows read, gh1 of all windows written, the two matrices read in both
    layouts, their fp32 gradients written. Attention kernel: recompute (qkv,
    logits, P v, proj) plus dWproj, g_ao, dP, gq, gk, gv, dWqkv, g_z =
    24 hw C^2 + 12 hw^2 C per kept window; y of the kept windows and gh1 of
    all read, dy of all written, wqkv and wproj in both layouts, gradients."""
    hw = BLOCK_HW
    tok = hw * C
    mlp_bytes = (M_run * tok * 4 + M * tok * (y_bytes + 4) + M * hw + 4 * M
                 + 2 * 3 * C * inner * w_bytes + 3 * C * inner * 4 + (4 * C + 6 * inner) * 4)
    mlp_flops = M_run * 18.0 * hw * C * inner
    attn_bytes = (M_run * tok * y_bytes + M * tok * (4 + y_bytes) + M * hw + 4 * M
                  + 2 * 4 * C * C * w_bytes + 4 * C * C * 4 + 20 * C * 4)
    attn_flops = M_run * (24.0 * hw * C * C + 12.0 * hw * hw * C)
    return bound_ms(mlp_bytes, mlp_flops, kind), bound_ms(attn_bytes, attn_flops, kind)


def close_enough(got, ref, rtol, atol):
    err = (got.float() - ref.float()).abs()
    return bool((err <= atol + rtol * ref.float().abs()).all()), err.max().item()


def phase_bwd_kernels(torch, np):
    """Kernels G (``sparse_block_mlp_bwd``) and H (``sparse_block_attn_bwd``)
    against their plain versions, and the ``autograd.Function`` of
    ``sparse_window_block`` against ``torch.autograd`` of the plain block on
    the kept windows, per stage shape of the B = 12 training step, dtype and
    window density; then their times beside autograd through the masked
    torch-op block."""
    from sast_tpu_torch.ops import block, sparse_block

    names = ("sparse_block_mlp_bwd", "sparse_block_attn_bwd")
    worst = dict.fromkeys(names, 0.0)      # largest absolute error of any output
    worst_rel = dict.fromkeys(names, 0.0)  # largest error over max|ref| of its tensor
    worst_fn = {"bf16": 0.0, "fp32": 0.0}
    worst_fwd = {"bf16": 0.0, "fp32": 0.0}  # the forward kernel at these shapes
    # Cases where each backward kernel gave the same bits twice.
    deterministic = {n: {"bf16": 0, "fp32": 0} for n in names}
    problems = []  # every violation of the phase, reported together
    totals = {n: dict(ms=0.0, call=0.0, plain=0.0, bound=0.0, by={}) for n in names}
    totals["function"] = dict(fwd_bwd=0.0, bwd=0.0, masked_fwd_bwd=0.0, masked_bwd=0.0)
    table = []
    for si, (M, C, heads) in enumerate(TRAIN_BLOCK_SHAPES):
        dh = C // heads
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            for density in BWD_DENSITIES:
                attn, params, y, tok, win = block_case(
                    torch, np, M, C, heads, dtype, density, 200 + si)
                inner = params["wout"].shape[0]
                n_win = int(win.sum())
                where = f"stage {si + 1} {kind} density {density}"
                g = torch.randn(y.shape, generator=torch.Generator().manual_seed(si)).to(
                    DEVICE, dtype)
                work = block.work_list(win)
                with torch.no_grad():
                    fwd, h1 = sparse_block.sparse_window_block(
                        y, tok, win, params, heads, dh, save_h1=True)
                    fwd_ref, h1_ref = sparse_block.sparse_window_block_plain(
                        y, tok, win, params, heads, dh, save_h1=True)
                    gh1, acc_g = sparse_block.sparse_block_mlp_bwd(
                        h1, tok, work, params, g, heads, dh)
                    gh1_2, acc_g2 = sparse_block.sparse_block_mlp_bwd(
                        h1, tok, work, params, g, heads, dh)
                    gh1_ref, acc_g_ref = sparse_block.sparse_block_mlp_bwd_plain(
                        h1, tok, work, params, g)
                    dy, acc_h = sparse_block.sparse_block_attn_bwd(
                        y, tok, work, params, gh1_ref, heads, dh)
                    dy2, acc_h2 = sparse_block.sparse_block_attn_bwd(
                        y, tok, work, params, gh1_ref, heads, dh)
                    dy_ref, acc_h_ref = sparse_block.sparse_block_attn_bwd_plain(
                        y, tok, work, params, gh1_ref, heads, dh)
                torch.cuda.synchronize()
                # The forward kernel at this shape, whose h1 both backward
                # versions take: the forward tolerances of the serving shapes
                # (fp32 rtol 2e-4 + atol 2e-5 max|ref|; bf16 two bf16 ulps at
                # max|ref|; unkept tokens and skipped windows bit-equal).
                rtol_f, rel_f = (2e-4, 2e-5) if dtype == torch.float32 else (0.0, 2 ** -7)

                def hold_forward(what, got_out, got_h1=None):
                    pairs = [("out", got_out, fwd_ref)]
                    if got_h1 is not None:
                        pairs.append(("h1", got_h1, h1_ref))
                    for key, a, b in pairs:
                        scale = b.float().abs().max().item()
                        ok, err = close_enough(a, b, rtol_f, rel_f * scale)
                        if not ok or not bool(torch.isfinite(a.float()).all()):
                            problems.append(f"{what} {where} {key}: max err {err} at max|ref| "
                                            f"{scale}")
                        worst_fwd[kind] = max(worst_fwd[kind], err / max(scale, 1e-30))
                    if not torch.equal(got_out[~tok], y[~tok]) or (
                            got_h1 is not None and not torch.equal(got_h1[~win], y[~win].float())):
                        problems.append(f"{what} {where}: unkept tokens or skipped windows are "
                                        "not bit-equal to y")

                hold_forward("sparse_window_block", fwd, h1)
                # fp32: the forward kernels' tolerance (other summation order,
                # atomics in any order). bf16: the products g W^T round their
                # first operand to bf16, and a sum that differs in its last
                # fp32 bits flips such a rounding: four bf16 ulps at max|ref|.
                rtol, rel = (2e-4, 2e-5) if dtype == torch.float32 else (0.0, 2 ** -6)
                checks = [("sparse_block_mlp_bwd", "gh1", gh1, gh1_ref)]
                checks += [("sparse_block_mlp_bwd", k, acc_g[k], acc_g_ref[k]) for k in acc_g_ref]
                checks += [("sparse_block_attn_bwd", "dy", dy, dy_ref)]
                checks += [("sparse_block_attn_bwd", k, acc_h[k], acc_h_ref[k]) for k in acc_h_ref]
                for name, what, got, ref in checks:
                    scale = ref.float().abs().max().item()
                    ok, err = close_enough(got, ref, rtol, rel * scale)
                    if not ok or not bool(torch.isfinite(got.float()).all()):
                        problems.append(f"{name} {where} {what}: max err {err} at max|ref| {scale}")
                    worst[name] = max(worst[name], err)
                    worst_rel[name] = max(worst_rel[name], err / max(scale, 1e-30))
                # Neither backward kernel adds float atomics: a second launch
                # on the same inputs gives the same bits.
                for name, (a, acc_a), (b, acc_b) in (
                        ("sparse_block_mlp_bwd", (gh1, acc_g), (gh1_2, acc_g2)),
                        ("sparse_block_attn_bwd", (dy, acc_h), (dy2, acc_h2))):
                    if torch.equal(a, b) and all(torch.equal(acc_a[k], acc_b[k]) for k in acc_a):
                        deterministic[name][kind] += 1
                    else:
                        problems.append(f"{name} {where}: two launches differ")
                if not torch.equal(gh1[~win], g[~win].float()) \
                        or not torch.equal(dy[~win], gh1_ref[~win].to(dtype)):
                    problems.append(f"backward kernels {where}: skipped windows do not pass g on")
                if n_win == 0 and any(bool(v.any()) for v in (*acc_g.values(), *acc_h.values())):
                    problems.append(f"backward kernels {where}: a parameter gradient is not 0")

                # The Function (kernel E forward, G and H backward) against
                # torch.autograd of the plain block on the kept windows.
                leaves = [t.detach().clone().requires_grad_() for t in block.kernel_leaves(attn)]
                yg = y.detach().clone().requires_grad_()
                out = sparse_block.sparse_window_block(yg, tok, win, params, heads, dh,
                                                       leaves=leaves)
                hold_forward("sparse_window_block Function forward", out.detach())
                got = torch.autograd.grad(out, [yg] + leaves, g, retain_graph=True)
                ref_out = sparse_block.sparse_window_block_plain(
                    yg, tok, win, block.params_from_leaves(leaves, dtype), heads, dh)
                ref = torch.autograd.grad(ref_out, [yg] + leaves, g, allow_unused=True)
                ref = [torch.zeros_like(a) if b is None else b for a, b in zip(got, ref)]
                # bf16: autograd of the plain block also rounds every
                # cotangent that crosses a cast to bf16, which the kernels
                # keep in fp32: eight bf16 ulps at max|ref|.
                rel_fn = 2e-5 if dtype == torch.float32 else 2 ** -5
                for key, a, b in zip(("y",) + block.PARAM_KEYS, got, ref):
                    scale = b.float().abs().max().item()
                    ok, err = close_enough(a, b, rtol, rel_fn * scale)
                    if not ok:
                        problems.append(f"sparse_window_block Function {where} d{key}: max err "
                                        f"{err} at max|ref| {scale}")
                    worst_fn[kind] = max(worst_fn[kind], err / max(scale, 1e-30))
                if density == 0.0:
                    log(f"bwd {where}: dy == g, every parameter gradient exactly zero")
                    continue

                # Times: each kernel's wrapper alone; backward only and
                # forward + backward of the Function and of the masked
                # torch-op block under autograd.
                y4, tok4, win4 = yg[None], tok[None], win[None]
                out_m = attn.run_block(y4, tok4, win4)
                mparams = [p for p in attn.parameters() if p.requires_grad]

                def masked_fwd_bwd():
                    o = attn.run_block(y4, tok4, win4)
                    torch.autograd.grad(o, [yg] + mparams, g[None], allow_unused=True)

                def fn_fwd_bwd():
                    o = sparse_block.sparse_window_block(yg, tok, win, params, heads, dh,
                                                         leaves=leaves)
                    torch.autograd.grad(o, [yg] + leaves, g)

                calls = dict(
                    mlp=lambda: sparse_block.sparse_block_mlp_bwd(h1, tok, work, params, g, heads, dh),
                    attn=lambda: sparse_block.sparse_block_attn_bwd(
                        y, tok, work, params, gh1_ref, heads, dh),
                    fn_bwd=lambda: torch.autograd.grad(out, [yg] + leaves, g, retain_graph=True),
                    fn_fwd_bwd=fn_fwd_bwd,
                    masked_bwd=lambda: torch.autograd.grad(
                        out_m, [yg] + mparams, g[None], retain_graph=True, allow_unused=True),
                    masked_fwd_bwd=masked_fwd_bwd,
                )
                t = {k: cuda_ms(torch, fn, iters=5, warmup=2, ahead=True) for k, fn in calls.items()}
                # Each backward kernel also per eager call (the host's pace included).
                t.update({k + "_call": cuda_ms(torch, calls[k], iters=5, warmup=2) for k in ("mlp", "attn")})
                with torch.no_grad():
                    t["mlp_plain"] = cuda_ms(torch, lambda: sparse_block.sparse_block_mlp_bwd_plain(
                        h1, tok, work, params, g), iters=3, warmup=1)
                    t["attn_plain"] = cuda_ms(torch, lambda: sparse_block.sparse_block_attn_bwd_plain(
                        y, tok, work, params, gh1_ref, heads, dh), iters=3, warmup=1)
                nb = 2 if dtype == torch.bfloat16 else 4
                (bg, bg_by), (bh, bh_by) = bwd_bounds(n_win, M, C, inner, nb, nb, kind)
                table.append(dict(stage=si + 1, M=M, C=C, dtype=kind, density=density,
                                  n_win=n_win, mlp_bound_ms=bg, attn_bound_ms=bh,
                                  mlp_bound_by=bg_by, attn_bound_by=bh_by, **t))
                log(f"bwd {where} ({n_win}/{M} windows), card ms (call ms): G {t['mlp']:.4f} "
                    f"({t['mlp_call']:.4f}; plain {t['mlp_plain']:.3f}, bound {bg:.5f} {bg_by}) H "
                    f"{t['attn']:.4f} ({t['attn_call']:.4f}; plain {t['attn_plain']:.3f}, bound "
                    f"{bh:.5f} {bh_by}); Function bwd "
                    f"{t['fn_bwd']:.4f}, fwd+bwd {t['fn_fwd_bwd']:.4f}; masked autograd bwd "
                    f"{t['masked_bwd']:.4f}, fwd+bwd {t['masked_fwd_bwd']:.4f}")
                if kind == "bf16" and density == BLOCK_TABLE_DENSITY:
                    # Kernels G and H are short sequences of launches: where
                    # their time goes, per launch.
                    log(f"bwd {where}: kernel G per call, us by launch: "
                        + launch_us(torch, calls["mlp"], "mb"))
                    log(f"bwd {where}: kernel H per call, us by launch: "
                        + launch_us(torch, calls["attn"], "ab"))
                    for name, key, b, by in (("sparse_block_mlp_bwd", "mlp", bg, bg_by),
                                             ("sparse_block_attn_bwd", "attn", bh, bh_by)):
                        tot = totals[name]
                        tot["ms"] += t[key]
                        tot["call"] += t[key + "_call"]
                        tot["plain"] += t[key + "_plain"]
                        tot["bound"] += b
                        tot["by"][by] = tot["by"].get(by, 0.0) + b
                    f = totals["function"]
                    f["bwd"] += t["fn_bwd"]
                    f["fwd_bwd"] += t["fn_fwd_bwd"]
                    f["masked_bwd"] += t["masked_bwd"]
                    f["masked_fwd_bwd"] += t["masked_fwd_bwd"]
                del out, out_m, ref_out, got, ref, dy2, acc_h2, gh1_2, acc_g2
    (OUT_DIR / "bwd_kernels.json").write_text(json.dumps(table, indent=1))
    log(f"backward kernels: worst error over max|ref| of its tensor: {worst_rel}; Function "
        f"against autograd of the plain block: {worst_fn}; the forward kernel (out, h1) "
        f"against its plain version at these shapes: {worst_fwd}; bit-equal over two launches "
        f"in {deterministic} cases")
    if problems:
        fail("backward-kernel phase:\n  " + "\n  ".join(problems))
    replaces = dict(sparse_block_mlp_bwd="sast_tpu/ops/pallas/sparse_block.py:572",
                    sparse_block_attn_bwd="sast_tpu/ops/pallas/sparse_block.py:606")
    f = totals["function"]
    log(f"sparse_window_block under autograd, sum over the 4 B=12 stage shapes, bf16, density "
        f"{BLOCK_TABLE_DENSITY}: backward {f['bwd']:.4f} ms, forward + backward "
        f"{f['fwd_bwd']:.4f} ms; masked torch ops under autograd: backward "
        f"{f['masked_bwd']:.4f} ms, forward + backward {f['masked_fwd_bwd']:.4f} ms")
    out = []
    for name in names:
        tot = totals[name]
        log(f"kernel {name}: sum over the 4 B=12 stage shapes, bf16, density "
            f"{BLOCK_TABLE_DENSITY}: {tot['ms']:.4f} ms on the card ({tot['call']:.4f} ms per eager "
            f"call), plain {tot['plain']:.4f} ms, "
            f"bound {tot['bound']:.5f} ms; worst absolute error {worst[name]:.3e}, "
            f"{worst_rel[name]:.3e} of max|ref|")
        source = ("sast_tpu_torch/csrc/attn_bwd.cu" if name == "sparse_block_attn_bwd"
                  else "sast_tpu_torch/csrc/mlp_bwd.cu")
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces[name], launches=None, max_abs_err=worst[name],
                        ms=tot["ms"], plain_ms=tot["plain"], bound_ms=tot["bound"],
                        bound_by=max(tot["by"], key=tot["by"].get), library_ms=None,
                        rel_err=worst_rel[name], forward_rel_err=worst_fwd,
                        bit_equal_cases=deterministic[name], bound_share=tot["bound"] / tot["ms"],
                        call_ms=tot["call"],
                        masked_autograd_bwd_ms=f["masked_bwd"],
                        function_bwd_ms=f["bwd"], function_fwd_bwd_ms=f["fwd_bwd"],
                        masked_autograd_fwd_bwd_ms=f["masked_fwd_bwd"],
                        **({"redesigned": REDESIGNED[name]} if name in REDESIGNED else {})))
    return out


def reset_counters():
    from sast_tpu_torch.ops import density, fused_block, nms_keep, sparse_block, stem_conv

    stem_conv.stem_conv7x4.launches = 0
    density.density_ratio.launches = 0
    nms_keep.greedy_keep.launches = 0
    fused_block.fused_window_block.launches = 0
    sparse_block.sparse_window_block.launches = 0
    sparse_block.sparse_window_block_looped.launches = 0
    sparse_block.sparse_block_mlp_bwd.launches = 0
    sparse_block.sparse_block_attn_bwd.launches = 0


def read_counters():
    from sast_tpu_torch.ops import density, fused_block, nms_keep, sparse_block, stem_conv

    return dict(stem_conv7x4=stem_conv.stem_conv7x4.launches,
                density_ratio=density.density_ratio.launches,
                greedy_keep=nms_keep.greedy_keep.launches,
                fused_window_block=fused_block.fused_window_block.launches,
                sparse_window_block=sparse_block.sparse_window_block.launches,
                sparse_window_block_looped=sparse_block.sparse_window_block_looped.launches,
                sparse_block_mlp_bwd=sparse_block.sparse_block_mlp_bwd.launches,
                sparse_block_attn_bwd=sparse_block.sparse_block_attn_bwd.launches)


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


def clustered_train_batch(torch, np, cfg, rng, step, batch_size=None, seq_len=None):
    """A training batch whose scenes leave windows unkept: the labels of
    ``synthetic_train_batch``, and as events three blobs per lane
    (``clustered_events``), tensorized on the device by the serving path's
    ``stacked_histogram`` at the dataset's native resolution (the train step
    pads to the model's)."""
    from sast_tpu_torch.data.representations import stacked_histogram
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.packing import pack_event_batch

    batch = synthetic_train_batch(cfg, rng, batch_size=batch_size, seq_len=seq_len)
    T, B = batch["ev_repr"].shape[:2]
    h, w = cfg.dataset.resolution_hw
    bins = cfg.model.backbone.input_channels // 2
    frames = []
    for t in range(T):
        lanes = [clustered_events(np, rng, EVENTS_PER_FRAME, h, w, step * T + t, b)
                 for b in range(B)]
        packed, n = pack_event_batch(lanes, B, EVENTS_PER_FRAME)
        rep = stacked_histogram(torch.from_numpy(packed).to(DEVICE),
                                torch.from_numpy(n).to(DEVICE), bins, h, w, 10)
        frames.append(rep.reshape(B, h, -1).cpu().numpy())
    batch["ev_repr"] = np.stack(frames)
    return batch


def phase_training(torch, np, card):
    """``Trainer.fit`` at gen4-base width on the sparse-kernel and the masked
    path, then fp32 steps on the card against the CPU at a cut size."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import to_device
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.models.sast import MaskedSparseAttention
    from sast_tpu_torch.training.loop import Trainer

    cfg = get_config("gen4", "base")
    tr = cfg.training
    B, T, L = tr.batch_size_train, cfg.dataset.sequence_length, tr.max_labeled_frames_per_lane
    log(f"training gen4-base: B {B}, T {T}, L {L}, {cfg.model.compute_dtype}, remat "
        f"{tr.remat_policy}, max_gt {cfg.model.head.max_gt}, simota_topk "
        f"{cfg.model.head.simota_topk}, lr {tr.learning_rate}")
    rng = np.random.RandomState(21)
    batches = [synthetic_train_batch(cfg, rng, sparsity=0.9) for _ in range(2)]
    batches += [clustered_train_batch(torch, np, cfg, rng, i) for i in range(TRAIN_STEPS - 2)]
    for i, b in enumerate(batches):
        b["is_first"] = np.full((B,), i == 0)
    dev_batches = [to_device(b, DEVICE) for b in batches]
    layers = 8  # 4 stages x (window layer + grid layer)
    results = {}
    for name, sparse in (("sparse", True), ("masked", False)):
        workdir = OUT_DIR / f"train_{name}"
        (workdir / "metrics.jsonl").unlink(missing_ok=True)
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, str(workdir), log_every=1, sparse_kernel_train=sparse,
                          device=DEVICE)
        reset_counters()
        t0 = time.perf_counter()
        trainer.fit(iter(batches), max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counters()
        rows = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train/loss"] for r in rows]
        if len(rows) != TRAIN_STEPS or not all(np.isfinite(v) for v in losses):
            fail(f"training {name}: {len(rows)} logged steps, losses {losses}")
        if not all(np.isfinite(r["train/grad_norm"]) for r in rows):
            fail(f"training {name}: a gradient norm is not finite")
        bad = [n for n, p in trainer.model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if bad:
            fail(f"training {name}: parameters without a finite gradient: {bad[:5]}")
        per_step = layers * T
        expect = dict(sparse_window_block=2 * per_step * TRAIN_STEPS if sparse else 0,
                      sparse_block_mlp_bwd=per_step * TRAIN_STEPS if sparse else 0,
                      sparse_block_attn_bwd=per_step * TRAIN_STEPS if sparse else 0,
                      stem_conv7x4=2 * T * TRAIN_STEPS)
        for k, v in expect.items():
            if counts[k] != v:
                fail(f"training {name}: {counts[k]} launches of {k} over {TRAIN_STEPS} steps, "
                     f"expected {v} (forward and recomputation): {counts}")
        peak = torch.cuda.max_memory_allocated()

        # One evaluation step (backbone over the clip, detection at the
        # labeled frames, NMS kernel) on the path this trainer trains on.
        trainer.sparse_kernel_eval = sparse
        reset_counters()
        _, dets = trainer.eval_step(dev_batches[-1], trainer.lstm_states)
        eval_counts = read_counters()
        if tuple(dets["boxes"].shape[:1]) != (B * L,) or not bool(
                torch.isfinite(dets["boxes"][dets["valid"]]).all()):
            fail(f"training {name}: eval_step detections malformed")
        if eval_counts["greedy_keep"] != 1 or eval_counts["sparse_window_block"] != (
                per_step if sparse else 0):
            fail(f"training {name}: eval_step launches {eval_counts}")
        log(f"training {name}: eval_step on {B * L} labeled frames, "
            f"{int(dets['valid'].sum())} detections, launches greedy_keep "
            f"{eval_counts['greedy_keep']}, sparse_window_block "
            f"{eval_counts['sparse_window_block']}")

        # Steady state: more steps on batches already on the card, host
        # clock around work that ends in a synchronise; then kernel time on
        # the card from the profiler over one step.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in dev_batches[2:]:
            trainer.state, trainer.lstm_states, _ = trainer.train_step(
                trainer.state, b, trainer.lstm_states)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / len(dev_batches[2:]) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(trainer.state, dev_batches[-1], trainer.lstm_states)
            torch.cuda.synchronize()
        rows_k = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0) for e in rows_k)
        if busy_us <= 0:
            fail(f"training {name}: the profiler saw no kernel time on the card")
        ours = {}
        launches_of = {"sf": "sparse_fwd (E, all launches)", "mb": "mlp_bwd (G, all launches)",
                       "ab": "attn_bwd (H, all launches)"}
        for e in rows_k:
            # The launches of kernels E, G and H (by their sources'
            # namespaces) are summed under one name each.
            ns = re.search(r"\b(sf|mb|ab)::", e.key)
            key = launches_of[ns.group(1)] if ns else e.key[:60]
            if ns or "window_block_kernel" in key or "stem" in key:
                ours[key] = ours.get(key, 0.0) + (getattr(e, "self_device_time_total", 0)
                                                  or getattr(e, "self_cuda_time_total", 0)) / 1e3
        if name == "sparse":
            table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
            (OUT_DIR / "training_profile.txt").write_text(table)
        results[name] = dict(losses=losses, first_step=rows[0],
                             grad_norms=[r["train/grad_norm"] for r in rows],
                             selected_tokens=[r["train/SN"] for r in rows], counts=counts,
                             fit_seconds=fit_s, step_ms=step_ms, card_ms=busy_us / 1e3,
                             idle_share=1 - busy_us / 1e3 / step_ms, peak_bytes=peak,
                             hand_written_kernels_ms=ours)
        log(f"training {name} on {card}: losses {[round(v, 4) for v in losses]}, grad norms "
            f"{[round(r['train/grad_norm'], 3) for r in rows]}; launches {counts}")
        log(f"training {name}: {step_ms:.1f} ms/step on batches on the card ({fit_s:.1f} s for "
            f"the {TRAIN_STEPS} logged steps with upload), kernel time on the card "
            f"{busy_us / 1e3:.1f} ms/step, idle share {1 - busy_us / 1e3 / step_ms:.3f}, peak "
            f"memory {peak / 2 ** 30:.2f} GiB; hand-written kernels ms/step: "
            f"{ {k: round(v, 2) for k, v in ours.items()} }")
        if name == "sparse":
            # Kept-window share per attention layer on one clustered timestep.
            shares = []
            hooks = [m.register_forward_pre_hook(
                lambda _m, args: shares.append(float(args[2].float().mean())))
                for m in trainer.model.modules() if isinstance(m, MaskedSparseAttention)]
            with torch.no_grad():
                x = dev_batches[-1]["ev_repr"][0]
                x = x.reshape(x.shape[0], x.shape[1], -1, cfg.model.backbone.input_channels)
                trainer.model.forward_backbone(torch.nn.functional.pad(
                    x, (0, 0, 0, 0, 0, cfg.model.backbone.in_res_hw[0] - x.shape[1])))
            for h in hooks:
                h.remove()
            log(f"training: kept-window share per attention layer on a clustered timestep: "
                f"{[round(v, 3) for v in shares]}")
            if min(shares) >= 1.0:
                fail("training: every window is kept in every layer of the clustered batch")
            results[name]["window_share"] = shares
        del trainer
        torch.cuda.empty_cache()
    # Same seed, same batches: the two paths compute one function and round
    # at other places in bf16 (the block kernels keep activations in fp32).
    # At a random init every candidate's SimOTA cost is nearly tied, so such
    # rounding moves a few of the ~70 foreground assignments, and every loss
    # term is divided by their count: 5% covers that, and the foreground
    # count per ground truth is printed beside the loss to show it. The
    # selected-token count comes from fp32 scores of the same input on both
    # paths and must agree to 1e-3. The fp32 steps below hold the two paths
    # to 1e-4.
    first = {name: results[name]["first_step"] for name in ("sparse", "masked")}
    a, b = first["sparse"]["train/loss"], first["masked"]["train/loss"]
    rel = abs(a - b) / abs(b)
    sn_rel = abs(first["sparse"]["train/SN"] - first["masked"]["train/SN"]) / first["masked"]["train/SN"]
    for name, row in first.items():
        log(f"training {name}, first step: loss {row['train/loss']:.5f} = iou "
            f"{row['train/iou_loss']:.5f} + conf {row['train/conf_loss']:.5f} + cls "
            f"{row['train/cls_loss']:.5f}; foreground per ground truth "
            f"{row['train/num_fg']:.5f}; selected tokens {row['train/SN']:.1f}; gradient norm "
            f"{row['train/grad_norm']:.3f}")
    log(f"training: first-step loss sparse {a:.5f} masked {b:.5f}, relative difference "
        f"{rel:.3e} (tol 5e-2); selected tokens relative difference {sn_rel:.3e} (tol 1e-3)")
    if rel > 5e-2 or sn_rel > 1e-3:
        fail(f"training: first step of the two paths differs: loss {rel}, selected tokens "
             f"{sn_rel}")
    results["first_step_loss_rel_diff"] = rel
    results["cut_fp32"] = training_cpu_parity(torch, np)
    return results


CUT_STEPS = 2  # fp32 train steps of the cut-size comparison


def worst_leaf(named_a, named_b):
    """Largest ``|a - b|`` over ``max|b|`` of its leaf, and that leaf's name,
    over two lists of ``(name, tensor)`` in the same order."""
    worst, where = 0.0, ""
    for (name, a), (_, b) in zip(named_a, named_b):
        rel = (a.cpu() - b.cpu()).abs().max().item() / max(b.abs().max().item(), 1e-12)
        if rel > worst:
            worst, where = rel, name
    return worst, where


def training_cpu_parity(torch, np):
    """Two fp32 train steps at gen4-base width, B 2, T 2, L 1, LayerScale
    0.05, clustered batches, the second step after an optimizer update and
    with carried LSTM states: the sparse-kernel path on the card (kernels)
    against the same steps on the CPU (plain versions) and against the masked
    path on the card; loss, selected tokens, gradients and carried states
    after each step. Then the first step again on the
    card under ``remat_policy`` ``none`` and ``dots`` against ``full``, and
    ``infer_step`` over the clip against ``eval_step`` at its last frame."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import to_device
    from sast_tpu_torch.models.backbone import zero_states
    from sast_tpu_torch.models.detector import build_detector, set_sparse_kernel
    from sast_tpu_torch.training.steps import (
        make_eval_step, make_inference_step, make_train_step, train_state_for)

    cfg = get_config("gen4", "base")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="float32",
            # Scores sit at the prior (1e-4) at a random init: let them through.
            postprocess=dataclasses.replace(cfg.model.postprocess, confidence_threshold=1e-6)),
        dataset=dataclasses.replace(cfg.dataset, sequence_length=2),
        training=dataclasses.replace(cfg.training, batch_size_train=2,
                                     max_labeled_frames_per_lane=1))
    T = cfg.dataset.sequence_length
    model_cpu = build_detector(cfg.model, seed=5, device="cpu", sparse_kernel=True)
    with torch.no_grad():
        for name, p in model_cpu.named_parameters():
            if name.endswith(("ls1.gamma", "ls2.gamma")):
                p.fill_(LAYER_SCALE)
    model_gpu = copy.deepcopy(model_cpu).to(DEVICE)
    model_masked = copy.deepcopy(model_gpu)
    set_sparse_kernel(model_masked, False)
    remat_models = {policy: copy.deepcopy(model_gpu) for policy in ("none", "dots")}
    rng = np.random.RandomState(31)
    batches = [clustered_train_batch(torch, np, cfg, rng, i) for i in range(CUT_STEPS)]
    for i, batch in enumerate(batches):
        batch["is_first"] = np.full((2,), i == 0)

    def run(model, device, run_cfg, steps):
        """``steps`` train steps from zero states; per step the metrics, the
        gradients and the carried states."""
        state = train_state_for(model, run_cfg)
        step = make_train_step(model, run_cfg)
        states = zero_states(run_cfg.model.backbone, 2, device=device)
        record = []
        t0 = time.perf_counter()
        for batch in batches[:steps]:
            state, states, metrics = step(state, to_device(batch, device), states)
            record.append(dict(
                loss=float(metrics["loss"]), P=float(metrics["P"]),
                grad_norm=float(metrics["grad_norm"]),
                grads=[(n, p.grad.detach().clone()) for n, p in model.named_parameters()],
                states=[(f"stage{i}.{hc}", s) for i, pair in enumerate(states)
                        for hc, s in zip("hc", pair)]))
        return record, (time.perf_counter() - t0) / steps

    reset_counters()
    rec_cpu, cpu_s = run(model_cpu, "cpu", cfg, CUT_STEPS)
    rec_card, _ = run(model_gpu, DEVICE, cfg, CUT_STEPS)
    counts = read_counters()
    rec_masked, _ = run(model_masked, DEVICE, cfg, CUT_STEPS)
    per_step = 8 * T  # 8 attention layers per timestep
    if counts["sparse_window_block"] != 2 * per_step * CUT_STEPS \
            or counts["sparse_block_mlp_bwd"] != per_step * CUT_STEPS \
            or counts["sparse_block_attn_bwd"] != per_step * CUT_STEPS:
        fail(f"fp32 train steps on the card did not launch the block kernels: {counts}")

    # fp32 on both sides; convolutions, products and atomics sum in other
    # orders, through two timesteps of recurrence and their recomputation.
    # The second step starts from parameters that one AdamW update has moved
    # by about +-lr (1.7e-5) each, with the sign of a gradient that is
    # rounding noise where it is tiny: the updated parameters themselves are
    # therefore not compared. A leaf is compared at its own max.
    out = dict(cpu_step_seconds=cpu_s, steps=[])
    for what, ref_name, ref in (("card (kernels) vs CPU (plain)", "cpu", rec_cpu),
                                ("sparse-kernel vs masked path on the card", "masked",
                                 rec_masked)):
        for i, (got, want) in enumerate(zip(rec_card, ref)):
            loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            p_rel = abs(got["P"] - want["P"]) / want["P"]
            grad, grad_at = worst_leaf(got["grads"], want["grads"])
            st, st_at = worst_leaf(got["states"], want["states"])
            log(f"fp32 train step {i + 1}, {what}: loss {got['loss']:.6f} vs {want['loss']:.6f} "
                f"(rel {loss_rel:.2e}, tol 1e-4), selected tokens {got['P']} vs "
                f"{want['P']} (tol 1e-3), worst gradient leaf {grad_at}: {grad:.3e} of its max "
                f"(tol 1e-2), worst carried state {st_at}: {st:.3e} (tol 1e-3)")
            out["steps"].append(dict(step=i + 1, against=ref_name, loss=got["loss"],
                                     ref_loss=want["loss"], loss_rel_diff=loss_rel,
                                     P_rel_diff=p_rel, worst_grad_rel_diff=grad,
                                     worst_grad_leaf=grad_at,
                                     worst_state_rel_diff=st))
            if loss_rel > 1e-4 or p_rel > 1e-3 or grad > 1e-2 or st > 1e-3:
                fail(f"fp32 train step {i + 1}: {what} disagree")

    # The other two remat policies on the card: the same forward kernels, so
    # the same loss to fp32 rounding of one sum; gradients differ by the
    # order of the atomics. ``none`` recomputes nothing: one forward launch
    # per layer and timestep.
    for policy, model in remat_models.items():
        cfg_p = dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, remat_policy=policy))
        reset_counters()
        rec, _ = run(model, DEVICE, cfg_p, 1)
        c = read_counters()
        loss_rel = abs(rec[0]["loss"] - rec_card[0]["loss"]) / abs(rec_card[0]["loss"])
        grad, grad_at = worst_leaf(rec[0]["grads"], rec_card[0]["grads"])
        log(f"fp32 train step, remat {policy} vs full on the card: loss rel {loss_rel:.2e} "
            f"(tol 1e-6), worst gradient leaf {grad_at}: {grad:.3e} of its max (tol 1e-3); "
            f"launches forward {c['sparse_window_block']}, backward "
            f"{c['sparse_block_mlp_bwd']} + {c['sparse_block_attn_bwd']}")
        forward = per_step if policy == "none" else 2 * per_step
        if loss_rel > 1e-6 or grad > 1e-3 or c["sparse_window_block"] != forward \
                or c["sparse_block_mlp_bwd"] != per_step or c["sparse_block_attn_bwd"] != per_step:
            fail(f"fp32 train step under remat {policy} disagrees with remat full: {c}")
        out[f"remat_{policy}"] = dict(loss_rel_diff=loss_rel, worst_grad_rel_diff=grad)

    # Streaming inference, frame by frame with carried states, against
    # eval_step over the same clip with every lane labeled at its last frame:
    # the same kernels on the same values, so the slates must agree.
    batch = to_device(batches[0], DEVICE)
    batch["frame_tidx"] = torch.full_like(batch["frame_tidx"], T - 1)
    batch["frame_valid"] = torch.ones_like(batch["frame_valid"])
    zeros = zero_states(cfg.model.backbone, 2, device=DEVICE)
    reset_counters()
    _, want = make_eval_step(model_gpu, cfg)(batch, zeros)
    infer_step = make_inference_step(model_gpu, cfg)
    states = zeros
    for t in range(T):
        x = batch["ev_repr"][t]
        x = x.reshape(x.shape[0], x.shape[1], -1, cfg.model.backbone.input_channels)
        got, states, _ = infer_step(x, states)
    c = read_counters()
    n = int(want["valid"].sum())
    same = torch.equal(got["valid"], want["valid"]) and torch.equal(got["classes"], want["classes"])
    box = (got["boxes"] - want["boxes"]).abs().max().item()
    score = ((got["scores"] - want["scores"]).abs() / want["scores"].clamp_min(1e-12)).max().item()
    log(f"infer_step over {T} frames vs eval_step at the last frame, fp32, sparse-kernel path: "
        f"{n} detections, valid and classes {'equal' if same else 'DIFFER'}, max box diff "
        f"{box:.3e} px (tol 1e-3), max score rel diff {score:.3e} (tol 1e-5); launches "
        f"sparse_window_block {c['sparse_window_block']}, greedy_keep {c['greedy_keep']}")
    if n == 0 or not same or box > 1e-3 or score > 1e-5 \
            or c["sparse_window_block"] != 2 * per_step or c["greedy_keep"] != 1 + T:
        fail("infer_step disagrees with eval_step on the card")
    out["infer_step"] = dict(detections=n, box_diff_px=box, score_rel_diff=score)
    return out


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
    (OUT_DIR / "chip_smoke_log.txt").unlink(missing_ok=True)
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from sast_tpu_torch import build

    t0 = time.perf_counter()
    logs = build.build()
    ptxas = ptxas_lines(logs)
    (OUT_DIR / "build_log.txt").write_text(
        "== registers and spills of kernels A, E, G and H\n" + "\n".join(ptxas) + "\n"
        + "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc log in chiprun_out/build_log.txt)")
    for line in ptxas:
        log("  ptxas " + line)

    t0 = time.perf_counter()
    kernels = phase_kernels(torch, np) + phase_block_kernels(torch, np)
    log(f"phase 2: kernels hold against their plain versions ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    bwd_kernels = phase_bwd_kernels(torch, np)
    log(f"phase 2: backward kernels hold against their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

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

    t0 = time.perf_counter()
    training = phase_training(torch, np, smi)
    # The backward kernels' launches: the sparse-kernel training run.
    for k in bwd_kernels:
        k["launches"] = training["sparse"]["counts"][k["name"]]
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched by the training step")
    kernels += bwd_kernels
    log(f"phase 5: training step ok ({time.perf_counter() - t0:.1f} s)")

    record = dict(card=smi, kernels=kernels, serving=serving, cpu_parity=parity,
                  training=training, seconds=time.perf_counter() - t_start)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("redesigned",)  # kernels redesigned since their first port
    print(json.dumps({"kernels": [{k: kern[k] for k in keys + extra if k in kern}
                                  for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
