#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sast_tpu_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit: ``python3 chip_smoke.py``. Phases, each fatal on failure:

1. Print the card's name and power limit; build the eight kernels (six
   libraries: kernel D runs kernel E's launches, and kernel F is the second
   entry point of E's library) and the conditional-graph library
   (``csrc/cond.cu``) from ``sast_tpu_torch/csrc`` (one nvcc per source,
   all started together), and log the registers and spills of kernels A,
   B, C, E, F, G and H.
2. Hold each kernel against its plain PyTorch version on the card, TF32
   off, at the gen4-base b4 serving shapes, and time kernel, plain version,
   bound and library call; the stem kernel also at the training step's 12
   lanes. Kernel A (redesigned: an implicit GEMM on the tensor cores) is
   timed against ``F.conv2d`` in turns (library, kernel, kernel, library)
   and its share of the bound is logged. The density kernel B (redesigned:
   one launch from the input to the ratio) is held bit for bit, twice, and
   timed on the card and per eager call, with its launches listed. The NMS
   kernel C (redesigned: a
   suppression bitmask over the card, then one warp per image) is held bit
   for bit and timed at the 4 frames of the serving step and the 36 of
   ``eval_step``, on the card and per eager call, beside its operations
   bound and its latency bound. The three block kernels (fused, sparse,
   looped) run at the four stage shapes, in bf16 and fp32, at window
   densities 0.1, 0.4 and 1.0, beside the masked torch-op path and the
   gather path; the fused kernel D (redesigned: E's launches over every
   window), the sparse kernel E (redesigned: launches over the kept tokens)
   and the looped kernel F (redesigned: E's steps as phases of one
   persistent cooperative launch, held to E's output bit for bit) are
   timed in turns with the masked torch ops (D E F masked masked F E D),
   with their shares of the bound and their time per launch.
3. Drive the port's main path: ``StreamingDetector`` at gen4-base width
   (384x640 model resolution, 20 channels, dims 64/128/256/512, bf16),
   ``num_streams=4``, seeded random weights, 8 frames of seeded synthetic
   events with one lane reset midway, the step captured as CUDA graphs at
   the first frame and replayed (the detector's default on a card); the
   launches the card ran (the wrappers' counts less those recorded into
   the graphs, plus the replays') must show the stem and NMS kernels on
   every frame. Then the same weights with the
   stem/density fusion off, which puts the density kernel on the path and
   must give the same detections. Steady-state ms/step with CUDA events.
   Then the same weights and frames, on eager detectors (``graph=False``),
   on the sparse-kernel, looped-kernel,
   fused-kernel and budget-gather attention paths: 8 block-kernel launches
   per step, the kept-window share per stage, ms/step of each, and the card
   time per step of each path and of its hand-written kernels.
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
6. Train, validate, checkpoint and resume at gen4-base full width (B 4,
   T 5, L 3, bf16, EMA on): clips made in memory in the reader's format,
   assembled by the port's ``assemble_batch`` and ``Prefetcher``;
   ``Trainer.fit`` with ``val_every=2`` for 4 steps on the sparse-kernel
   path (kernels A, E, G and H; C through ``eval_step``'s NMS) must
   validate twice, save at steps 2 and 4 and report JAX's metric keys;
   a fresh trainer resumed from the directory must hold the same bits
   (parameters, statistics, AdamW moments and count, EMA, best val/AP),
   and one more step on both must too; a weights-only resume keeps count 0
   and best -1; ``validation_torch.main`` on a reference-style ``.ckpt``
   must load what the converter and the weight bridge give on the host,
   bit for bit. ``fit`` must write ``viz/gradflow.png`` at each of its two
   validations, and ``validate(save_viz=1)`` one panel ``viz/val_0000.png``;
   both must decode as PNGs. Times: ms per train step and per validation
   batch, checkpoint save and restore seconds and bytes.
7. Train as ``train.py`` trains, at gen4-base full width. (a) Data
   parallel: two ranks over gloo on the one card, each on 2 lanes of a
   4-lane batch (fp32, sparse-kernel path, 2 steps), against one process on
   the 4 lanes at a constant rate of 1e-5: each step's summed gradients,
   each parameter's change, BatchNorm statistics, EMA and AdamW moments
   element by element within rtol 1e-4 + atol 1e-6 but for at most 4 times
   as many elements as the floor leaves outside (the one process with its
   lanes in three other orders, and without cuDNN), by at most 4 times the
   floor's worst error; half the update must fail that check; the ranks'
   states bit-equal; a world of one over NCCL bit
   for bit against no process group; ``Trainer.validate`` of 2 batches over
   the two ranks equal to one process over the same frames (kernel C); ms
   per step and all-reduce ms per step (the ranks run beside the one
   process's and the floor's runs, so these are readings side by side). (b)
   The regularizers at 0.1 on the sparse-kernel config (B 12, bf16): no
   launch of E, G or H (the masked path), the same bits twice; every rate 0
   gives phase 5's first step bit for bit. (c) The card-resident cache from
   in-memory sequences (360x640, 20 channels, T 5, B 4) bit-equal to the
   host ``DataModule`` in the stream, random (weighted) and mixed modes and
   for evaluation; bytes resident, ms per gathered batch and per host
   assembly plus upload. (d) ``fit(profile_steps=(2, 3))`` writes a trace
   that holds those steps and names kernel E's launches; it is removed
   afterwards.
8. Serve as a deployment serves, at gen4-base full width, 4 lanes,
   confidence threshold 0 and stand-in trained weights (phase 4's spread
   logits and LayerScale), 8 frames with lane 2 reset at frame 4. (a)
   ``export.export_streaming_detector`` on four configurations (the default
   path: kernels A and C; the density fusion off on the sparse-kernel path:
   A, B, E, C; the fused path: A, D, C; the looped path: A, F, C): the live
   detector the same bits after its export as before; a fresh process that
   imports ``sast_tpu_torch.export`` alone (and no model, training or data
   module) loads each artifact and runs the frames, the same bits as the
   live detector (detections, telemetry, carried states), with its launch
   counters showing each kernel inside the artifact (that process runs
   beside phases 12c-12e, ``run_fresh``); export seconds, artifact bytes,
   and ms/step of artifact and live in turns. The artifacts live in a
   temporary directory under ``chiprun_out/``, removed afterwards.
   (b) ``StreamingDetector(mesh=("cuda:0", "cuda:0"), num_streams=4)``: the
   same bits as two 2-lane detectors; against one 4-lane detector, the
   largest differences and any mismatch of valid or classes; ms/step of both
   in turns.
9. Measure and inspect, at gen4-base, B 4, sparsity 0.9, bf16. (a)
   ``utils/benchmark.compute_fps`` on the default (kernels A, C), sparse
   (A, E, C), looped (A, F, C) and fused (A, D, C) paths with short chunks
   (L 10 and 20, 2 blocks): the launch counters must advance by the
   chunks' frames times each path's launches per frame (8 block-kernel
   launches a frame), and a 3-frame chunk's carried states must equal the
   same frames stepped one by one through ``model(...)``, bit for bit;
   ms/frame and frames/s are logged, not checked. (b) ``compute_flops`` at
   batch 1 must read one GFLOP/frame on the masked, default, sparse,
   looped and fused paths. (c) ``utils/timers.DeviceTimer`` around 5 steps
   must read at least their CUDA-event time; the timer registry is emptied.
   (d) ``StackedHistogram`` and ``MixedDensityEventStack`` on the card
   must equal the CPU, bit for bit, at gen4's raw 720x1280 with 2M events
   and an event at each power-of-two fraction of the window; ms per
   construct on each.
10. Choose the attention branch on the card, and measure with the CLIs. (a)
   At phase 8's configuration, weights and clustered frames, with empty
   and uniform scenes between them (8 frames): artifacts of the gather path
   at ``attention.gather_budget`` 0.5 and of the sparse kernel at
   ``attention.pallas_density_threshold`` 0.5, whose every attention layer
   chooses its branch with a ``torch.cond`` in the exported graph (one node
   per layer). The live detector must take both branches at every layer
   over the frames (logged per layer); a fresh process (beside phases
   12c-12e) loads each artifact and steps it, the same bits as the live
   detector, with kernel E
   launched inside the threshold artifact as often as the live detector
   took the kernel branch. (b) Each measuring CLI but the loader's
   (``scripts/{bench_serving,bench_sparse_layer,bench_train_sparsity,
   profile_inference,profile_train,roofline_inference,model_info}_torch.py``)
   with short arguments on the card; the rows each printed are logged.
   (b) runs in a process of its own beside phases 12c-12e
   (``chip_smoke.py --clis WORK OUT``): its rows, and the step times that
   12c-12e log, are readings of runs side by side on one card.

11. Serve as JAX's jitted step serves, at phase 8's configuration, weights
   and 8 frames (lane 2 reset at frame 4). (a) On nine paths (default,
   fusion off, sparse, looped, fused, masked, and the three that choose on
   the card: gather 0.5, the sparse kernel below a density threshold of
   0.5, and kernel F below it), in fp32 (TF32 off) and bf16: the captured
   step (``graphs.py``: one graph, each choice a conditional node) against
   the eager step, bit for bit (slates, telemetry, carried states); no
   parameter cast recorded into the graphs. The choosing paths run over
   phase 10a's frames: each replay one graph launch under the sync debug
   mode "error", every choice both branches by the counters on the card,
   the replays' launches the eager step's. In bf16 the profiler rows of
   one replay must name the hand-written kernels that the replay ran, and
   the step times eager and captured in turns, each one's card time and
   idle share, and ``process_batch`` on the host clock are logged. (b) The
   captured mesh of two replicas on the one card against the eager mesh;
   artifacts of the default, the gather and the threshold configuration,
   loaded and captured, against the captured live detector (the default
   artifact with no parameter cast left in its graph; the two choosing
   ones one launch a replay, both branches at every choice), and timed in
   turns with it; new weights loaded into a captured detector that has
   stepped, against a fresh detector on them.

12. Train and validate as JAX's jitted and donated steps do
   (``Trainer(graph=True)``, ``training/steps.CapturedTrainStep`` and
   ``CapturedEvalStep``), at gen4-base full width. (a) ``fit`` over 4
   steps (B 12, T 5, L 3, remat full) on the sparse-kernel path (A, E, G, H
   inside the graphs) and the masked path, in fp32 and bf16, captured
   against eager in the deterministic modes, and on the two
   configurations whose layers choose on the card (gather 0.5, threshold
   0.5; batches without events between phase 5's, so that every choice
   takes both branches; one graph launch a step, the forward's, the
   recomputation's and the backward's choices conditional nodes): every
   logged metric, parameters, BatchNorm statistics, EMA copy, optimizer
   count and moments, LSTM states bit for bit; then in bf16 ms/step eager and
   captured in turns (CUDA events and the host clock), each one's card
   time (the eager step's from phase 5's profile of the same step) and
   idle share, peak memory, capture seconds; and the captured
   eval step after captured train steps against a fresh model holding
   the trained weights. (b) The eval step captured against eager on the
   default, sparse (E), looped (F), fused (D) and fusion-off (B) paths and
   the two choosing configurations, bit for bit, one graph launch a
   replay, ms per batch in turns. (c) Phase 6's configuration with
   ``fit`` captured: validation every 2 steps over 4 (captured), a trace
   of steps 3-4, and a resume from the step-2 checkpoint bit-equal to the
   uninterrupted run. (d) The card cache gathering into the captured step's
   buffer against the host's batches, bit for bit. (e) Every regularizer
   at 0.1, and a world of one over NCCL (its all-reduces captured), each
   captured against eager, bit for bit.

13. RVT-B (``MaxViTRNN``) on kernel D's RVT variant
   (``ops/fused_block.rvt_window_block``). (a) The variant at the four
   stage shapes of the gen4 serving step at 16 lanes (4096, 1024, 256 and
   64 windows of 60 tokens, C 64-512, bf16, LayerScale 1) against its plain
   version on the same inputs, on the update relative to its size (4e-3;
   the plain version with float8 matrices must read above it), bit-equal to
   its own second launch; timed beside the plain version, the port's
   torch-op layer and the library version (``F.linear``,
   ``F.scaled_dot_product_attention``), with its bound and its time per
   launch. (b) The captured serving step of gen4 RVT-B at 16 lanes through
   ``process_batch``: 8 launches of the variant a frame (the counters reset
   just before), replays with no host read (sync debug mode "error"),
   every token slot reported as attended, ms/step. Its row joins the kernel
   table last (``launches``: those of (b)).

Prints the kernel table as one JSON line (the rows of kernels redesigned
since their first port carry ``redesigned``, what the redesign made of
them; the first versions' times are in PERF.md; ``launches_artifact`` counts
phase 8's launches inside the artifacts, ``launches_benchmark`` phase 9a's
in the timed chunks, ``launches_cond_artifact`` phase 10a's inside the two
artifacts, ``launches_cli`` phase 10b's in the CLIs' runs, ``launches_captured``
phase 11a's by the captured steps, the warm-ups' and the replays', ``launches_captured_train``
phase 12's by the captured train and eval steps, the warm-ups' and the replays'), then the
nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line; the timer registry is
emptied before, so that nothing is printed after it. Longer output (build
logs, profiler table, all measurements) goes to ``chiprun_out/``.
Exits non-zero, printing no result, without a card or outside a checkout.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
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
# (M windows, C) of one attention layer per stage of the gen4 RVT-B serving
# step at the benchmark cell's 16 lanes; hw = 60, dim_head 32.
RVT_LANES = 16
RVT_SHAPES = ((4096, 64), (1024, 128), (256, 256), (64, 512))
# Kernel D's RVT variant against its plain version, on the update relative
# to its size. The two round at the same points and sum in another order,
# which flips bf16 roundings: the gap grows with C, as the plain version
# summed in fp64 against fp32 shows on the CPU (4.5e-4 at C 64 to 1.5e-3 at
# C 512); the variant read 3.4e-4 to 2.0e-3 on an H100. The plain version
# with float8 matrices reads about 0.06.
RVT_GAP = 4e-3
BWD_DENSITIES = (0.1, 0.4, 1.0, 0.0)
TRAIN_STEPS = 4
BLOCK_DENSITIES = (0.1, 0.4, 1.0)
BLOCK_TABLE_DENSITY = 0.4  # the density whose times go into the kernels line
LAYER_SCALE = 0.05  # LayerScale of the CPU-parity model
EVENTS_PER_FRAME = 200_000  # StreamingDetector's default budget
# Kernels redesigned since their first port, with what the redesign made of
# them (PERF.md section 6 names the change that did it).
REDESIGNED = {"stem_conv7x4": "implicit GEMM on the tensor cores",
              "sparse_block_attn_bwd": "tensor-core launches over the kept tokens",
              "sparse_window_block": "tensor-core launches over the kept tokens",
              "sparse_block_mlp_bwd": "tensor-core launches over the kept tokens",
              "greedy_keep": "suppression bitmask, then one warp per image",
              "fused_window_block": "the sparse kernel's launches over every window",
              "sparse_window_block_looped": "the sparse kernel's steps in one cooperative launch",
              "density_ratio": "one launch from the input to the ratio"}
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
# Cycles of one dependent step of the NMS scan (a shared-memory load and two
# logic operations), the unit of kernel C's latency bound.
SCAN_STEP_CYCLES = 20


def ptxas_lines(logs, names=("stem_conv", "density", "nms_keep", "sparse_fwd", "mlp_bwd",
                             "attn_bwd")):
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


_START = time.perf_counter()
_LOG_PREFIX = ""  # "10b: " in the CLIs' own process


def log(msg: str) -> None:
    """Print a line, and keep it in ``OUT_DIR / "chip_smoke_log.txt"`` after
    the seconds since the script started."""
    msg = _LOG_PREFIX + msg
    print(msg, flush=True)
    if OUT_DIR.is_dir():
        with open(OUT_DIR / "chip_smoke_log.txt", "a") as f:
            f.write(f"[{time.perf_counter() - _START:7.1f} s] {msg}\n")


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


def launch_us(torch, fn, namespace, calls: int = 3):
    """Card time per call of each kernel of ``namespace`` (its source's
    namespace, e.g. ``ab`` for kernel H; None: every kernel on the card)
    that ``fn`` launches, in us, from the profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and (
                namespace is None or re.search(rf"\b{namespace}::", e.key)):
            found = re.search(r"(\w+_kernel(?:<[^>]*>)?)", e.key)
            short = found.group(1) if found else e.key[:48]
            per[short] = per.get(short, 0.0) + (getattr(e, "self_device_time_total", 0)
                                                or getattr(e, "self_cuda_time_total", 0)) / calls
    return ", ".join(f"{k} {v:.1f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1]))


LOOPED_PHASES = ("work list", "prep", "QKV", "core", "proj", "GLU", "out")


def looped_phase_us(torch, sparse_block, fn, calls: int = 3):
    """Kernel F's time per phase, in us, from its phase clock
    (``sparse_block.LOOPED_STAMPS``), the mean over ``calls`` calls of
    ``fn``; each phase's grid barrier is counted in it."""
    stamps = torch.zeros(8, dtype=torch.int64, device=DEVICE)
    sparse_block.LOOPED_STAMPS, tot = stamps, [0.0] * len(LOOPED_PHASES)
    try:
        for _ in range(calls):
            stamps.zero_()
            fn()
            t = stamps.tolist()
            for k in range(len(LOOPED_PHASES)):
                tot[k] += (t[k + 1] - t[k]) / 1e3 / calls
    finally:
        sparse_block.LOOPED_STAMPS = None
    return dict(zip(LOOPED_PHASES, tot))


def sm_clocks_hz():
    """The card's maximum and current SM clock, in Hz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    top, now = (float(v) * 1e6 for v in out.split(","))
    return top, now


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

    # Kernel B: bit-equal on both inputs, twice (its per-image tickets must
    # be back at 0 after a call); card time alone (launches queued ahead),
    # per eager call, and every kernel one call puts on the card.
    for i, xi in enumerate(xs):
        ref = density.density_ratio_plain(xi)
        for _ in range(2):
            if not torch.equal(density.density_ratio(xi), ref):
                fail(f"density kernel differs from its plain version on input {i}")
    call_b = lambda: density.density_ratio(x)
    ms_b = cuda_ms(torch, call_b, ahead=True)
    call_ms_b = cuda_ms(torch, call_b)
    per_launch_b = launch_us(torch, call_b, None)
    plain_b = cuda_ms(torch, lambda: density.density_ratio_plain(x), iters=5)
    b_bound, b_by = bound_ms(x.numel() + B * 4 * C * 4, 2.0 * x.numel(), "fp32")
    log(f"kernel density_ratio {ms_b:.4f} ms on the card, {call_ms_b:.4f} ms per eager call "
        f"(us per launch: {per_launch_b}), plain {plain_b:.4f} ms, bound {b_bound:.4f} ms "
        f"({b_by}), share of the bound {b_bound / ms_b:.3f}; exact on both inputs, twice")
    dens = dict(name="density_ratio", route="cuda", source="sast_tpu_torch/csrc/density.cu",
                replaces="sast_tpu/ops/pallas/density.py:168", launches=None,
                max_abs_err=0.0, ms=ms_b, plain_ms=plain_b, bound_ms=b_bound,
                bound_by=b_by, library_ms=None, call_ms=call_ms_b, bound_share=b_bound / ms_b,
                per_launch_us=per_launch_b, redesigned=REDESIGNED["density_ratio"])

    # Kernel C: (n, 1000) clustered, score-sorted candidates, at the frame
    # counts of the serving step and of eval_step in training: bit-equal to
    # the plain version; card time alone (launches queued ahead), per eager
    # call and per launch.
    k = 1000
    clock_hz, clock_now = sm_clocks_hz()
    rows = {}
    for n in NMS_FRAMES:
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
        call = lambda: nms_keep.greedy_keep(boxes, scores, 0.45)
        keep = call()
        keep_ref = nms_keep.greedy_keep_plain(boxes, scores, 0.45)
        if not torch.equal(keep, keep_ref):
            fail(f"greedy keep kernel differs at {int((keep != keep_ref).sum())} candidates "
                 f"of {n} frames")
        ms_c = cuda_ms(torch, call, ahead=True)
        call_c = cuda_ms(torch, call)
        plain_c = cuda_ms(torch, lambda: nms_keep.greedy_keep_plain(boxes, scores, 0.45),
                          iters=3, warmup=1)
        per_launch = launch_us(torch, call, "nk")
        # Operations this data needs: one IoU test (about 12 fp32 ops) per
        # kept earlier box for every valid candidate. Latency: the images
        # run side by side, and the slowest one's chain is one dependent
        # step per valid candidate (a scan over every candidate), or per
        # kept candidate (this kernel's scan skips the others).
        valid = scores > 0
        kept_before = torch.cumsum(keep_ref.int(), dim=1) - keep_ref.int()
        tests = float((kept_before * valid).sum())
        c_bound, c_by = bound_ms(boxes.numel() * 4 + scores.numel() * 4 + keep.numel(),
                                 12.0 * tests, "fp32")
        n_valid, n_kept = int(valid.sum(1).max()), int(keep_ref.sum(1).max())
        lat_valid = n_valid * SCAN_STEP_CYCLES / clock_hz * 1e3
        lat_kept = n_kept * SCAN_STEP_CYCLES / clock_hz * 1e3
        log(f"kernel greedy_keep ({n}, {k}, 4): exact; kept {int(keep.sum())} of "
            f"{int(valid.sum())} valid; {ms_c:.4f} ms on the card, {call_c:.4f} ms per eager "
            f"call (us per launch: {per_launch}), plain {plain_c:.4f} ms; operations bound "
            f"{c_bound:.6f} ms ({c_by}, {tests:.0f} IoU tests); latency bound at "
            f"{SCAN_STEP_CYCLES} cycles a step and {clock_hz / 1e6:.0f} MHz (clock now "
            f"{clock_now / 1e6:.0f} MHz): {n_valid} valid candidates of the slowest image "
            f"{lat_valid:.6f} ms, {n_kept} kept {lat_kept:.6f} ms")
        rows[n] = dict(ms=ms_c, call_ms=call_c, plain_ms=plain_c, bound_ms=c_bound, bound_by=c_by,
                       latency_bound_valid_ms=lat_valid, latency_bound_kept_ms=lat_kept,
                       per_launch_us=per_launch, kept=int(keep.sum()), valid=int(valid.sum()))
    main = rows[NMS_FRAMES[0]]
    nmsk = dict(name="greedy_keep", route="cuda", source="sast_tpu_torch/csrc/nms_keep.cu",
                replaces="sast_tpu/ops/pallas/nms_keep.py:79", launches=None,
                max_abs_err=0.0, library_ms=None, frames={str(n): r for n, r in rows.items()},
                sm_clock_mhz=clock_hz / 1e6, redesigned=REDESIGNED["greedy_keep"], **main)
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
    """Kernels D (fused: E's launches over every window), E (sparse, with
    and without h1) and F (looped) against the plain block, and their times
    beside the masked torch-op path and the gather path, per stage shape,
    dtype and window density."""
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
                got_f2 = sparse_block.sparse_window_block_looped(y, tok, win, params, heads, dh)
                torch.cuda.synchronize()
                where = f"stage {si + 1} {kind} density {density}"
                # F runs E's routines in E's order: the same bits, every launch.
                if not torch.equal(got_f, got_e) or not torch.equal(got_f, got_f2):
                    fail(f"sparse_window_block_looped {where}: not bit-equal to kernel E "
                         "or to its own second launch")
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
                    # Card time alone (launches queued ahead): kernels D, E
                    # and F in turns with the masked torch ops, D E F masked
                    # masked F E D; then the time of each call as the eager
                    # caller paces it.
                    order = ("fused_window_block", "sparse_window_block",
                             "sparse_window_block_looped", "masked")
                    turns = {k: [] for k in order}
                    for k in order + order[::-1]:
                        turns[k].append(cuda_ms(torch, calls[k], iters=10, ahead=True))
                    t = {k: sum(v) / len(v) for k, v in turns.items()}
                    t["gather"] = cuda_ms(torch, calls["gather"], iters=10, ahead=True)
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
                    f"bound {b_all:.5f}/{b_kept:.5f} ({by_kept}); shares of the bound: D "
                    f"{b_all / t['fused_window_block']:.4f}, E "
                    f"{b_kept / t['sparse_window_block']:.4f}, F "
                    f"{b_kept / t['sparse_window_block_looped']:.4f}; F bit-equal to E")
                if kind == "bf16" and density == BLOCK_TABLE_DENSITY:
                    with torch.no_grad():
                        for short, name in (("D", "fused_window_block"), ("E", "sparse_window_block"),
                                            ("F", "sparse_window_block_looped")):
                            log(f"block {where}: kernel {short} per call, us by launch: "
                                + launch_us(torch, calls[name], "sf"))
                        # F's phases on its own grid (as many blocks as the
                        # card holds at once) and on one block per SM.
                        row["looped_phase_us"] = looped_phase_us(
                            torch, sparse_block, calls["sparse_window_block_looped"])
                        sms = torch.cuda.get_device_properties(0).multi_processor_count
                        sparse_block.LOOPED_BLOCKS = sms
                        try:
                            row["looped_ms_1_per_sm"] = cuda_ms(
                                torch, calls["sparse_window_block_looped"], iters=10, ahead=True)
                            row["looped_phase_us_1_per_sm"] = looped_phase_us(
                                torch, sparse_block, calls["sparse_window_block_looped"])
                        finally:
                            sparse_block.LOOPED_BLOCKS = 0
                    for key, label in (("looped_phase_us", "its own grid"),
                                       ("looped_phase_us_1_per_sm", f"{sms} blocks")):
                        log(f"block {where}: kernel F on {label}, us by phase (barrier "
                            "included): " + ", ".join(f"{k} {v:.1f}" for k, v in row[key].items()))
                    log(f"block {where}: kernel F on {sms} blocks {row['looped_ms_1_per_sm']:.4f} "
                        f"ms on the card (own grid {t['sparse_window_block_looped']:.4f})")
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
        fused_window_block=("sast_tpu_torch/csrc/sparse_fwd.cu",
                            "sast_tpu/ops/pallas/fused_block.py:270"),
        sparse_window_block=("sast_tpu_torch/csrc/sparse_fwd.cu",
                             "sast_tpu/ops/pallas/sparse_block.py:285"),
        sparse_window_block_looped=("sast_tpu_torch/csrc/sparse_fwd.cu",
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
    fused_block.rvt_window_block.launches = 0
    sparse_block.sparse_window_block.launches = 0
    sparse_block.sparse_window_block_looped.launches = 0
    sparse_block.sparse_block_mlp_bwd.launches = 0
    sparse_block.sparse_block_attn_bwd.launches = 0


def read_counters():
    from sast_tpu_torch.graphs import launch_counts

    return launch_counts()


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
    wrappers = read_counters()
    counts = executed_launches(wrappers, [det])
    log(f"main path (captured) launches run over {FRAMES} frames: {counts} (the wrappers' "
        f"counts {wrappers}, {det.steps[0].run.replays} replays)")
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
    counts_nf = executed_launches(read_counters(), [det_nf])
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
    # tracing overhead can leak into a step time. The attention paths run
    # eagerly here, as in earlier PRs (phase 11 runs them captured).
    det_eager = StreamingDetector(cfg, model, max_events=EVENTS_PER_FRAME, num_streams=STREAMS,
                                  device=DEVICE, graph=False)
    paths = phase_attention_paths(torch, np, cfg, model, det_eager, frames, outs, pk, nk)

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
                             device=DEVICE, sparse_kernel=sparse_kernel, graph=False)


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
    from torch.profiler import ProfilerActivity, profile

    from sast_tpu_torch.utils.profiling import kernel_table

    for name, det in dets.items():
        looped = name in ATTENTION_PATHS and ATTENTION_PATHS[name][2]
        sparse_block.MODEL_USES_LOOPED, default = looped, sparse_block.MODEL_USES_LOOPED
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    det.step(pk, nk, no_reset)
                torch.cuda.synchronize()
        finally:
            sparse_block.MODEL_USES_LOOPED = default
        table = kernel_table(prof, steps=3)
        if table["kernel_ms"] <= 0:
            fail(f"path {name}: the profiler saw no kernel time on the card")
        results[name]["card_ms"] = table["kernel_ms"]
        results[name]["hand_written_kernels_ms"] = table["hand_written"]
    for name, res in results.items():
        res["step_ms"] = sum(res["step_ms_rounds"]) / 2
    for name, res in results.items():
        log(f"path {name}: device step {res['step_ms']:.3f} ms/step (rounds "
            f"{[round(v, 3) for v in res['step_ms_rounds']]}), "
            f"{res['step_ms'] / results['masked']['step_ms']:.3f}x masked; kernel time on the "
            f"card {res['card_ms']:.3f} ms/step, idle share "
            f"{1 - res['card_ms'] / res['step_ms']:.3f}; hand-written kernels ms/step "
            f"{ {k: round(v, 4) for k, v in res['hand_written_kernels_ms'].items()} }")
    return results


def reference_state_dict(torch, np, variables, model_cfg):
    """A state_dict in the layout of the reference implementation's
    Lightning checkpoints ('mdl.' prefix, the head under 'yolox_head.') that
    ``checkpoint/torch_convert.convert_state_dict`` turns back into
    ``variables`` (the flax-layout tree of ``weights.to_jax_variables``):
    every transform of the converter inverted, at any model config."""
    from sast_tpu_torch.checkpoint.torch_convert import _qkv_permutation

    sd = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))

    def conv(key, kernel):  # (kH, kW, I, O) -> (O, I, kH, kW)
        put(key, np.transpose(kernel, (3, 2, 0, 1)))

    def base_conv(prefix, p, s):
        conv(f"{prefix}.conv.weight", p["Conv_0"]["kernel"])
        put(f"{prefix}.bn.weight", p["BatchNorm_0"]["scale"])
        put(f"{prefix}.bn.bias", p["BatchNorm_0"]["bias"])
        put(f"{prefix}.bn.running_mean", s["BatchNorm_0"]["mean"])
        put(f"{prefix}.bn.running_var", s["BatchNorm_0"]["var"])

    def csp(prefix, p, s):
        for i, name in enumerate(("conv1", "conv2", "conv3")):
            base_conv(f"{prefix}.{name}", p[f"BaseConv_{i}"], s[f"BaseConv_{i}"])
        j = 0
        while f"Bottleneck_{j}" in p:
            bp, bs = p[f"Bottleneck_{j}"], s[f"Bottleneck_{j}"]
            base_conv(f"{prefix}.m.{j}.conv1", bp["BaseConv_0"], bs["BaseConv_0"])
            if "DWConv_0" in bp:
                for k, part in enumerate(("dconv", "pconv")):
                    base_conv(f"{prefix}.m.{j}.conv2.{part}", bp["DWConv_0"][f"BaseConv_{k}"],
                              bs["DWConv_0"][f"BaseConv_{k}"])
            else:
                base_conv(f"{prefix}.m.{j}.conv2", bp["BaseConv_1"], bs["BaseConv_1"])
            j += 1

    def dense(prefix, p):
        put(f"{prefix}.weight", np.transpose(p["kernel"]))
        if "bias" in p:
            put(f"{prefix}.bias", p["bias"])

    def ms_wsa(prefix, p, dim, dim_head):
        inv = np.argsort(_qkv_permutation(dim, dim_head))
        put(f"{prefix}.qkv.weight", np.transpose(p["qkv"]["kernel"][:, inv]))
        if "bias" in p["qkv"]:
            put(f"{prefix}.qkv.bias", p["qkv"]["bias"][inv])
        dense(f"{prefix}.proj", p["proj"])
        for n in ("norm1", "norm2"):
            put(f"{prefix}.{n}.weight", p[n]["scale"])
            put(f"{prefix}.{n}.bias", p[n]["bias"])
        put(f"{prefix}.ls1.gamma", p["ls1"]["gamma"])
        put(f"{prefix}.ls2.gamma", p["ls2"]["gamma"])
        dense(f"{prefix}.mlp.net.0.proj", p["mlp"]["GLU_0"]["Dense_0"])
        dense(f"{prefix}.mlp.net.2", p["mlp"]["Dense_0"])

    params, stats = variables["params"], variables["batch_stats"]
    bb = model_cfg.backbone
    for i in range(bb.num_stages):
        sp, st = f"mdl.backbone.stages.{i}", params["backbone"][f"stage{i}"]
        conv(f"{sp}.downsample_cf2cl.conv.weight", st["downsample"]["Conv_0"]["kernel"])
        put(f"{sp}.downsample_cf2cl.norm.weight", st["downsample"]["LayerNorm_0"]["scale"])
        put(f"{sp}.downsample_cf2cl.norm.bias", st["downsample"]["LayerNorm_0"]["bias"])
        conv(f"{sp}.lstm.conv1x1.weight", st["lstm"]["Conv_0"]["kernel"])
        put(f"{sp}.lstm.conv1x1.bias", st["lstm"]["Conv_0"]["bias"])
        if "mask_token" in st:
            put(f"{sp}.mask_token", st["mask_token"])
        for j in range(bb.num_blocks[i]):
            bp, blk = f"{sp}.att_blocks.{j}.att", st[f"block{j}"]
            for name in ("win_attn", "grid_attn"):
                ms_wsa(f"{bp}.{name}", blk[name], bb.stage_dims[i], bb.attention.dim_head)
            if j == 0:
                dense(f"{bp}.to_scores", blk["to_scores"])
                put(f"{bp}.to_controls.weight", np.transpose(blk["to_controls"]["weight"]))
    fpn_p, fpn_s = params["fpn"], stats["fpn"]
    for name in ("lateral_conv0", "reduce_conv1", "bu_conv2", "bu_conv1"):
        base_conv(f"mdl.fpn.{name}", fpn_p[name], fpn_s[name])
    for name in ("C3_p4", "C3_p3", "C3_n3", "C3_n4"):
        csp(f"mdl.fpn.{name}", fpn_p[name], fpn_s[name])
    head_p, head_s = params["head"], stats["head"]
    for k in range(len(model_cfg.fpn.in_stages)):
        base_conv(f"mdl.yolox_head.stems.{k}", head_p[f"stem{k}"], head_s[f"stem{k}"])
        for c in range(2):
            for kind in ("cls", "reg"):
                base_conv(f"mdl.yolox_head.{kind}_convs.{k}.{c}", head_p[f"{kind}_conv{k}_{c}"],
                          head_s[f"{kind}_conv{k}_{c}"])
        for kind in ("cls", "reg", "obj"):
            p = head_p[f"{kind}_pred{k}"]
            conv(f"mdl.yolox_head.{kind}_preds.{k}.weight", p["kernel"])
            put(f"mdl.yolox_head.{kind}_preds.{k}.bias", p["bias"])
    return sd


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


_MADE = {}  # host data that more than one phase uses, made once


def training_batches(torch, np, cfg):
    """Phase 5's batches (also phase 12's): two synthetic at sparsity 0.9,
    then clustered scenes that leave windows unkept; every lane starts at
    the first. Made once."""
    from sast_tpu_torch.data.synthetic import synthetic_train_batch

    if "training_batches" not in _MADE:
        B = cfg.training.batch_size_train
        rng = np.random.RandomState(21)
        batches = [synthetic_train_batch(cfg, rng, sparsity=0.9) for _ in range(2)]
        batches += [clustered_train_batch(torch, np, cfg, rng, i) for i in range(TRAIN_STEPS - 2)]
        for i, b in enumerate(batches):
            b["is_first"] = np.full((B,), i == 0)
        _MADE["training_batches"] = batches
    return _MADE["training_batches"]


def flop_count(torch):
    """A dispatch mode that sums, in ``.total``, the FLOPs of the operators
    it sees by ``FlopCounterMode``'s formulas (``torch.utils.flop_counter.
    flop_registry``, where the kernels' operators register theirs): the
    same count without ``FlopCounterMode``'s tracking of modules, which
    costs about a B 12 eager step's time again."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class FlopCount(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **kwargs, out_val=out)
            return out

    return FlopCount()


def phase_training(torch, np, card):
    """``Trainer.fit`` at gen4-base width on the sparse-kernel and the masked
    path, then fp32 steps on the card against the CPU at a cut size."""
    from torch.profiler import ProfilerActivity, profile

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import to_device
    from sast_tpu_torch.models.sast import MaskedSparseAttention
    from sast_tpu_torch.training.loop import Trainer

    from sast_tpu_torch.utils.profiling import kernel_table

    cfg = get_config("gen4", "base")
    tr = cfg.training
    B, T, L = tr.batch_size_train, cfg.dataset.sequence_length, tr.max_labeled_frames_per_lane
    log(f"training gen4-base: B {B}, T {T}, L {L}, {cfg.model.compute_dtype}, remat "
        f"{tr.remat_policy}, max_gt {cfg.model.head.max_gt}, simota_topk "
        f"{cfg.model.head.simota_topk}, lr {tr.learning_rate}")
    batches = training_batches(torch, np, cfg)
    dev_batches = [to_device(b, DEVICE) for b in batches]
    layers = 8  # 4 stages x (window layer + grid layer)
    results = {}
    for name, sparse in (("sparse", True), ("masked", False)):
        workdir = OUT_DIR / f"train_{name}"
        (workdir / "metrics.jsonl").unlink(missing_ok=True)
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, str(workdir), log_every=1, sparse_kernel_train=sparse,
                          device=DEVICE, graph=False)
        reset_counters()
        t0 = time.perf_counter()
        trainer.fit(iter(batches), max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counters()
        # ``fit`` ends with a checkpoint (phase 6 checks them); the output
        # directory keeps only the metrics.
        shutil.rmtree(workdir / "ckpts")
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
        # labeled frames, NMS kernel) on the path this trainer trains on;
        # ``fit`` keeps no state, so from zero states.
        trainer.sparse_kernel_eval = sparse
        reset_counters()
        lstm = trainer._zero_states(B)
        _, dets = trainer.eval_step(dev_batches[-1], lstm)
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
            trainer.state, lstm, _ = trainer.train_step(trainer.state, b, lstm)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / len(dev_batches[2:]) * 1e3
        # The card's activity only: recording the host's operators too takes
        # about 10 s of an eager B 12 step, and only kernel rows are read.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_step(trainer.state, dev_batches[-1], lstm)
            torch.cuda.synchronize()
        table = kernel_table(prof)
        busy_us, ours = table["kernel_ms"] * 1e3, table["hand_written"]
        if busy_us <= 0:
            fail(f"training {name}: the profiler saw no kernel time on the card")
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
        del trainer, lstm  # nothing of this path stays on the card into the next one's peak
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


def stand_in_trained(torch, model):
    """``model`` with its prediction logits spread and its LayerScale raised,
    in place: a stand-in for trained weights. At random init every score
    sits at the prior (1e-4) within about 0.3%, closer together than two
    computations can agree on, so the order of candidates would be noise;
    and LayerScale starts at 1e-5, where the attention block barely moves
    its input and every attention path would agree trivially (0.05 here)."""
    with torch.no_grad():
        for k in range(len(model.head.strides)):
            for name, gain in (("cls_pred", 1000.0), ("obj_pred", 1000.0), ("reg_pred", 100.0)):
                conv = getattr(model.head, f"{name}{k}")
                conv.kernel.mul_(gain)
                conv.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith(("ls1.gamma", "ls2.gamma")):
                p.fill_(LAYER_SCALE)
    return model


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
    model_cpu = stand_in_trained(torch, build_detector(cfg.model, seed=3, device="cpu"))
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
    dets_gpu = {"masked": StreamingDetector(cfg, model_gpu, max_events=100_000, device=DEVICE,
                                            graph=False)}
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


def memory_clip(np, cfg, rng, clip, is_first):
    """One clip in the format ``SequenceReader``/``ClipIterator`` yield, made
    in memory: (T, H, W, C) uint8 events at the dataset's resolution, one
    ``FrameLabels`` (or None) per timestep with a few boxes at its scale, the
    timestamps past the evaluator's first 0.5 s, two labeled timesteps."""
    from sast_tpu_torch.data.labels import FrameLabels
    from sast_tpu_torch.data.synthetic import sparse_event_input

    T = cfg.dataset.sequence_length
    h, w = cfg.dataset.resolution_hw
    C = cfg.model.backbone.input_channels
    labels = [None] * T
    for t in sorted(rng.choice(T, size=2, replace=False)):
        n = rng.randint(1, 6)
        bw, bh = rng.uniform(30, 160, n), rng.uniform(30, 120, n)
        rows = np.stack([np.full(n, (20 + clip * T + t) * 50_000), rng.uniform(0, w - bw),
                         rng.uniform(0, h - bh), bw, bh, rng.randint(0, cfg.model.head.num_classes, n),
                         np.ones(n)], 1)
        labels[t] = FrameLabels(rows, (h, w))
    return {"ev_repr": sparse_event_input(rng, (T, h, w, C), 0.9), "labels": labels,
            "is_first": is_first, "is_real_mask": np.ones((T,), bool)}


FIT_LANES = 4
FIT_STEPS = 4
FIT_VAL_EVERY = 2
FIT_EVAL_BATCHES = 2
VAL_KEYS = {"val/AP", "val/AP_50", "val/AP_75", "val/AP_S", "val/AP_M", "val/AP_L"}  # JAX's


def png_decodes(np, path):
    """The (H, W, 3) uint8 image of an 8-bit RGB PNG at ``path``, or None
    where the file is missing or does not decode (signature, chunk CRCs,
    IHDR, one filter byte per row)."""
    import struct
    import zlib

    if not Path(path).is_file():
        return None
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(tag + body):
            return None
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    if b"IHDR" not in chunks or b"IDAT" not in chunks or b"IEND" not in chunks:
        return None
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    raw = zlib.decompress(chunks[b"IDAT"])
    if depth != 8 or color != 2 or len(raw) != h * (1 + 3 * w):
        return None
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():  # filter type 0 only
        return None
    return rows[:, 1:].reshape(h, w, 3)


def _clock(torch, fn, times, device=None):
    """``fn`` with its host-clock seconds, to the device's end (``DEVICE``
    unless given), appended to ``times``."""
    from sast_tpu_torch.utils.profiling import sync

    device = device or DEVICE

    def timed(*args, **kwargs):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(device)
        times.append(time.perf_counter() - t0)
        return out
    return timed


def _states_differ(torch, a, b):
    """Names of what differs between two ``TrainState``s: parameters and
    statistics, AdamW moments and step tensors, count, EMA copy."""
    bad = [k for k, v in a.model.state_dict().items() if not torch.equal(v, b.model.state_dict()[k])]
    if a.optimizer.count != b.optimizer.count:
        bad.append("optimizer count")
    sa, sb = a.optimizer.adamw.state_dict()["state"], b.optimizer.adamw.state_dict()["state"]
    if set(sa) != set(sb):
        bad.append("AdamW state keys")
    bad += [f"AdamW {i} {k}" for i in sa for k, v in sa[i].items()
            if k not in sb.get(i, {}) or not torch.equal(v, sb[i][k])]
    if (a.ema_params is None) != (b.ema_params is None):
        bad.append("EMA presence")
    elif a.ema_params is not None:
        bad += [f"EMA {k}" for k, v in a.ema_params.items() if not torch.equal(v, b.ema_params[k])]
    return bad


def fit_clips(np, cfg):
    """Phase 6's clips (also phase 12c's), made once: ``FIT_STEPS + 1``
    train batches and ``FIT_EVAL_BATCHES`` evaluation batches of
    ``FIT_LANES`` clips, every lane starting at the first of each."""
    if "fit_clips" not in _MADE:
        rng = np.random.RandomState(8)
        train = [[memory_clip(np, cfg, rng, s * FIT_LANES + b, s == 0) for b in range(FIT_LANES)]
                 for s in range(FIT_STEPS + 1)]
        evals = [[memory_clip(np, cfg, rng, 100 + s * FIT_LANES + b, s == 0)
                  for b in range(FIT_LANES)] for s in range(FIT_EVAL_BATCHES)]
        _MADE["fit_clips"] = (train, evals)
    return _MADE["fit_clips"]


def phase_fit_validate(torch, np, card):
    """Train, validate, checkpoint and resume on the card at gen4-base full
    width, from in-memory clips assembled by the port's data pipeline; then
    the validation CLI on a reference-style ``.ckpt``."""
    import tempfile

    import validation_torch
    from sast_tpu_torch.checkpoint.torch_convert import convert_state_dict
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import Prefetcher, assemble_batch, to_device
    from sast_tpu_torch.models.detector import YoloXDetector, init_weights
    from sast_tpu_torch.training import loop
    from sast_tpu_torch.training.loop import Trainer
    from sast_tpu_torch.weights import load_jax_variables, to_jax_variables

    # gen4-base as the dataset's users train it, with an EMA copy so that
    # validation swaps it in and the checkpoints carry it.
    cfg = get_config("gen4", "base", **{"training.ema_decay": 0.999})
    tr, T = cfg.training, cfg.dataset.sequence_length
    L, G = tr.max_labeled_frames_per_lane, cfg.model.head.max_gt
    log(f"fit/validate gen4-base: B {FIT_LANES}, T {T}, L {L}, "
        f"{cfg.dataset.resolution_hw} -> {cfg.model.backbone.in_res_hw}, "
        f"{cfg.model.backbone.input_channels} channels, {cfg.model.compute_dtype}, "
        f"ema {tr.ema_decay}")
    t0 = time.perf_counter()
    train_clips, eval_clips = fit_clips(np, cfg)
    log(f"fit/validate: {FIT_STEPS + 1 + FIT_EVAL_BATCHES} batches of clips made on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    def batches(clips):
        return Prefetcher(assemble_batch(c, L, G) for c in clips)

    evals = []

    def eval_loader():
        evals.append(1)
        return batches(eval_clips)

    work = Path(tempfile.mkdtemp(prefix="fit_validate_", dir=OUT_DIR))
    pngs = []  # every file the trainer writes through utils/viz.save_png
    save_png = loop.save_png

    def recorded_png(path, img):
        pngs.append(Path(path).name)
        return save_png(path, img)

    loop.save_png = recorded_png
    try:
        trainer = Trainer(cfg, str(work / "run"), log_every=1, val_every=FIT_VAL_EVERY,
                          sparse_kernel_train=True, sparse_kernel_eval=True, device=DEVICE,
                          graph=False)
        step_s, val_s, save_s, saved = [], [], [], []
        trainer.train_step = _clock(torch, trainer.train_step, step_s)
        trainer.validate = _clock(torch, trainer.validate, val_s)
        save = trainer.ckpt.save

        def recorded_save(step, state, metrics=None):
            saved.append(step)
            return save(step, state, metrics)

        trainer.ckpt.save = _clock(torch, recorded_save, save_s)
        reset_counters()
        metrics = trainer.fit(batches(train_clips[:FIT_STEPS]), eval_loader_fn=eval_loader,
                              max_steps=FIT_STEPS, eval_max_batches=FIT_EVAL_BATCHES)
        counts = read_counters()
        fit_step_s = list(step_s)
        per_step = 8 * T  # attention layers x timesteps
        n_val = FIT_STEPS // FIT_VAL_EVERY
        expect = dict(stem_conv7x4=2 * T * FIT_STEPS + T * FIT_EVAL_BATCHES * n_val,
                      sparse_window_block=2 * per_step * FIT_STEPS
                      + per_step * FIT_EVAL_BATCHES * n_val,
                      sparse_block_mlp_bwd=per_step * FIT_STEPS,
                      sparse_block_attn_bwd=per_step * FIT_STEPS,
                      greedy_keep=FIT_EVAL_BATCHES * n_val)
        if {k: counts[k] for k in expect} != expect:
            fail(f"fit/validate: launches {counts}, expected {expect}")
        val = {k for k in metrics if k.startswith("val/")}
        rows = [json.loads(line) for line in (work / "run" / "metrics.jsonl").read_text().splitlines()]
        val_steps = [r["step"] for r in rows if "val/AP" in r]
        if len(evals) != n_val or val_steps != [2, 4] or val != VAL_KEYS:
            fail(f"fit/validate: validations {len(evals)} at steps {val_steps}, keys {sorted(val)}")
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        if len(losses) != FIT_STEPS or not all(np.isfinite(losses)):
            fail(f"fit/validate: losses {losses}")
        retained = trainer.ckpt.all_steps()
        if saved != [2, 4] or retained[-1] != 4 or trainer.ckpt.best_step() not in retained:
            fail(f"fit/validate: saves at {saved}, retained {retained}")
        ckpt_bytes = (work / "run" / "ckpts" / "step_4.pt").stat().st_size
        log(f"fit/validate: {FIT_STEPS} steps, validations at steps {val_steps}, "
            f"{ {k: round(v, 5) for k, v in sorted(metrics.items()) if k.startswith('val/')} }, "
            f"best val/AP {trainer.best_val_ap}, checkpoints saved at {saved}, retained "
            f"{retained}; launches {counts}")
        # The figures: the gradient flow at each validation, then one
        # prediction | label panel.
        viz = work / "run" / "viz"
        if pngs != ["gradflow.png"] * n_val or png_decodes(np, viz / "gradflow.png") is None:
            fail(f"fit/validate: fit wrote {pngs}, expected gradflow.png {n_val} times")
        trainer.validate(eval_loader(), max_batches=FIT_EVAL_BATCHES, save_viz=1)
        panel = png_decodes(np, viz / "val_0000.png")
        if pngs[n_val:] != ["val_0000.png"] or panel is None:
            fail(f"fit/validate: validate(save_viz=1) wrote {pngs[n_val:]}")
        log(f"fit/validate: fit wrote viz/gradflow.png at each of its {n_val} validations "
            f"({png_decodes(np, viz / 'gradflow.png').shape}), validate(save_viz=1) one panel "
            f"viz/val_0000.png {panel.shape}; both decode")

        # Resume: a fresh trainer from the same directory holds the first
        # one's bits; one more step on both from the same batch (cuDNN and
        # torch in their deterministic modes) gives the same bits again.
        resumed = Trainer(cfg, str(work / "run"), sparse_kernel_train=True,
                          sparse_kernel_eval=True, device=DEVICE, graph=False)
        restore_s = []
        _clock(torch, resumed.maybe_resume, restore_s)(True)
        bad = _states_differ(torch, trainer.state, resumed.state)
        if bad or resumed.state.step != FIT_STEPS or resumed.best_val_ap != trainer.best_val_ap:
            fail(f"fit/validate: resume differs in {bad[:5]}, step {resumed.state.step}, best "
                 f"{resumed.best_val_ap} against {trainer.best_val_ap}")
        extra = to_device({k: v for k, v in assemble_batch(train_clips[-1], L, G).items()
                           if not k.startswith("_")}, DEVICE)
        det_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.utils.deterministic.fill_uninitialized_memory = False  # as the steps before
        try:
            for t in (trainer, resumed):
                t.train_step(t.state, extra, t._zero_states(FIT_LANES))
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det_flags
        bad = _states_differ(torch, trainer.state, resumed.state)
        if bad:
            fail(f"fit/validate: the step after resume differs in {bad[:5]}")
        fine_tune = Trainer(cfg, str(work / "run"), device=DEVICE, graph=False)
        fine_tune.maybe_resume(True, weights_only=True)
        best = torch.load(trainer.ckpt.path(trainer.ckpt.best_step()), map_location="cpu",
                          weights_only=True)
        bad = [k for k, v in fine_tune.model.state_dict().items()
               if not torch.equal(v.cpu(), best["model"][k])]
        if fine_tune.state.step != 0 or fine_tune.best_val_ap != -1.0 or bad:
            fail(f"fit/validate: weights-only resume: step {fine_tune.state.step}, best "
                 f"{fine_tune.best_val_ap}, differs in {bad[:5]}")
        log(f"fit/validate: resume bit-equal (parameters, statistics, AdamW moments and count "
            f"{resumed.state.optimizer.count}, EMA, best val/AP), and so is the step after it; "
            f"weights-only resume: count 0, best -1, the best step's weights")
        del trainer, resumed, fine_tune, extra

        # A reference-style Lightning checkpoint of seeded random weights and
        # statistics through the validation CLI, against the converter and
        # the weight bridge on the host.
        src = YoloXDetector(cfg.model)
        g = torch.Generator().manual_seed(9)
        init_weights(src, g)
        with torch.no_grad():
            for name, buf in src.named_buffers():
                buf.copy_(torch.rand(buf.shape, generator=g) + (0.5 if name.endswith("var") else -0.5))
        sd = reference_state_dict(torch, np, to_jax_variables(src), cfg.model)
        path = work / "reference.ckpt"
        torch.save({"state_dict": sd, "epoch": 0}, path)
        metrics_ref, val_trainer = validation_torch.main(
            ["--dataset", "gen4", "--size", "base", "--data", "unused", "--ckpt", str(path),
             "--max-batches", "1", "--sparse-kernel", "--device", DEVICE,
             "--workdir", str(work / "validation")], eval_batches=batches(eval_clips))
        params, stats = convert_state_dict(sd, cfg.model)
        ref = load_jax_variables(YoloXDetector(cfg.model), {"params": params, "batch_stats": stats})
        got = val_trainer.model.state_dict()
        bad = [k for k, v in ref.state_dict().items() if not torch.equal(got[k].cpu(), v)]
        if bad or set(metrics_ref) != VAL_KEYS:
            fail(f"fit/validate: reference checkpoint differs in {bad[:5]}; metrics {metrics_ref}")
        log(f"fit/validate: reference .ckpt ({len(sd)} tensors, {path.stat().st_size} bytes) "
            f"loaded by validation_torch.main bit-equal to convert_state_dict + "
            f"load_jax_variables on the host, BatchNorm statistics included; metrics "
            f"{ {k: round(v, 5) for k, v in sorted(metrics_ref.items())} }")
        del val_trainer
    finally:
        loop.save_png = save_png
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()

    res = dict(train_step_ms=[s * 1e3 for s in fit_step_s],
               validation_ms_per_batch=[s * 1e3 / FIT_EVAL_BATCHES for s in val_s],
               save_s=save_s, restore_s=restore_s[0], checkpoint_bytes=ckpt_bytes, launches=counts,
               metrics={k: v for k, v in metrics.items() if k.startswith("val/")})
    log(f"fit/validate on {card}: train step "
        f"{[round(v, 1) for v in res['train_step_ms']]} ms (B {FIT_LANES}, host clock to the "
        f"card's end, batches uploaded inside); validation "
        f"{[round(v, 1) for v in res['validation_ms_per_batch']]} ms per batch (B {FIT_LANES}, "
        f"NMS and the Prophesee evaluation included); checkpoint save "
        f"{[round(v, 3) for v in save_s]} s, restore {restore_s[0]:.3f} s, {ckpt_bytes} bytes")
    return res


# ---------------------------------------------------------------------------
# Phase 7: data parallelism, the stochastic regularizers, the card-resident
# clip cache and profiler traces.

DP_WORLD = 2
DP_LANES = 4  # the global batch; each of the two ranks takes 2 lanes
DP_STEPS = 2
# The peak rate of the data-parallel comparison, constant (no warm-up): each
# step moves every parameter by about the rate, 10 times DP_ATOL, so a world
# that applied another update than one process is caught.
DP_LR = 1e-5
DP_RTOL, DP_ATOL = 1e-4, 1e-6
# The floor: one process computing the same function in other orders, its
# lanes permuted and its convolutions without cuDNN. The world may leave at
# most DP_FLOOR_FACTOR times as many elements of a group outside rtol + atol
# as the worst floor run, by at most DP_FLOOR_FACTOR times its worst error.
DP_FLOOR_ORDERS = ((2, 3, 0, 1), (1, 0, 3, 2), (3, 2, 1, 0))
DP_FLOOR_FACTOR = 4
DP_DATA_SEED = 71
DP_LIMIT_S = 600  # the two-rank run, spawn to join
CACHE_SEQS = ((40, (6, 12, 19, 27, 33, 39)), (30, (4, 9, 15, 22, 29)))  # frames, labeled
CACHE_BATCHES = 4
PROFILE_WINDOW = (2, 3)


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN and torch in their deterministic modes for the duration."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def dp_config(warmup=False):
    """gen4-base at full width in fp32 with a global batch of 4 lanes, EMA
    on, the rate ``DP_LR`` (reached after the one-cycle warm-up of 3000
    steps from a twentieth of it with ``warmup``, else constant)."""
    from sast_tpu_torch.config import get_config

    return get_config("gen4", "base", **{
        "model.compute_dtype": "float32", "training.batch_size_train": DP_LANES,
        "training.ema_decay": 0.999, "training.learning_rate": DP_LR, "training.seed": 0,
        "training.lr_scheduler.use": warmup})


def dp_batches(np, cfg, order=None, seed=DP_DATA_SEED):
    """The global batches of the data-parallel comparison; ``order``
    permutes their lanes."""
    from sast_tpu_torch.data.synthetic import synthetic_train_batch

    rng = np.random.RandomState(seed)
    out = [synthetic_train_batch(cfg, rng, sparsity=0.9) for _ in range(DP_STEPS)]
    out[0]["is_first"] = np.ones(DP_LANES, bool)
    out[1]["is_first"] = np.array([False, True, False, True])
    if order is not None:
        order = np.asarray(order)
        out = [{k: (v[:, order] if k == "ev_repr" else v[order]) for k, v in b.items()}
               for b in out]
    return out


def lanes_of(batch, rank, world):
    """Rank ``rank``'s rows of a global batch (``ev_repr`` is (T, B, ...))."""
    n = batch["ev_repr"].shape[1] // world
    rows = slice(rank * n, (rank + 1) * n)
    return {k: (v[:, rows] if k == "ev_repr" else v[rows]) for k, v in batch.items()}


def with_ground_truth(torch, eval_step):
    """``eval_step`` whose detections are each frame's ground truth, moved
    and scored as functions of the box alone, and nothing else: the metrics
    then depend on which frames are evaluated, not on the batch they came
    in (random weights alone score an AP of 0)."""

    def step(batch, lstm):
        lstm, dets = eval_step(batch, lstm)
        G = batch["gt_boxes"].shape[2]
        gt = batch["gt_boxes"].reshape(-1, G, 4).float()
        dets["boxes"][:, :G] = (torch.cat([gt[..., :2] - gt[..., 2:] / 2, gt[..., :2]
                                           + gt[..., 2:] / 2], -1) + 2 * torch.sin(7 * gt)
                                ).to(dets["boxes"].dtype)
        dets["classes"][:, :G] = batch["gt_classes"].reshape(-1, G).to(dets["classes"].dtype)
        dets["cls_conf"][:, :G] = (0.5 + 0.4 * torch.cos(3 * gt[..., 0] + gt[..., 1])).to(
            dets["cls_conf"].dtype)
        dets["valid"][:, :G] = batch["gt_valid"].reshape(-1, G)
        dets["valid"][:, G:] = False
        return lstm, dets

    return step


def dp_eval_batches(np, cfg, rank, world):
    """Two evaluation batches of this rank's lanes of 4, clips made in
    memory at the dataset's resolution, timestamps unique per lane."""
    from sast_tpu_torch.data.batch import assemble_batch

    n = DP_LANES // world
    lanes = []
    for lane in range(rank * n, (rank + 1) * n):
        rng = np.random.RandomState(300 + lane)
        lanes.append([memory_clip(np, cfg, rng, 2 * lane + c, c == 0) for c in range(2)])
    return [assemble_batch([lane[c] for lane in lanes], cfg.training.max_labeled_frames_per_lane,
                           cfg.model.head.max_gt) for c in range(2)]


def _host(t):
    """A copy of ``t`` on the host (``.cpu()`` of a host tensor is itself)."""
    return t.detach().to("cpu", copy=True)


def dp_run(torch, np, cfg, device, mesh, workdir, order=None, seed=DP_DATA_SEED,
           validate=True):
    """``Trainer.fit`` for ``DP_STEPS`` steps on this process's lanes (all of
    them without ``mesh``) on the sparse-kernel path, then ``validate`` on
    two evaluation batches. Returns the compared tensors by group, on the
    host (each step's summed gradients, each parameter's change over the
    run, BatchNorm statistics, EMA copy, AdamW moments), step and all-reduce
    seconds, the launches of each part, the metrics."""
    import torch.distributed as dist

    from sast_tpu_torch.training.loop import Trainer
    from sast_tpu_torch.utils.profiling import sync

    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    trainer = Trainer(cfg, workdir, log_every=1, sparse_kernel_train=True,
                      sparse_kernel_eval=True, device=device, mesh=mesh, graph=False)
    params = trainer.state.optimizer.params
    init = [_host(p) for p in params]
    grads, step_s, reduce_s, metrics = [], [], [], []
    update, train_step = trainer.state.optimizer.step, trainer.train_step

    def recorded_update():
        grads.append([_host(p.grad) for p in params])
        return update()

    def recorded_step(state, batch, lstm):
        reduce_s.append(0.0)
        out = _clock(torch, train_step, step_s, device)(state, batch, lstm)
        metrics.append({k: float(v) for k, v in out[2].items()})
        return out

    all_reduce = dist.all_reduce

    def timed_all_reduce(*args, **kwargs):
        sync(device)
        t0 = time.perf_counter()
        out = all_reduce(*args, **kwargs)
        sync(device)
        if reduce_s:
            reduce_s[-1] += time.perf_counter() - t0
        return out

    trainer.state.optimizer.step, trainer.train_step = recorded_update, recorded_step
    dist.all_reduce = timed_all_reduce
    try:
        reset_counters()
        trainer.fit([lanes_of(b, rank, world) for b in dp_batches(np, cfg, order, seed)],
                    max_steps=DP_STEPS)
        fit_counts = read_counters()
        adam = trainer.state.optimizer.adamw.state
        groups = {f"step {s + 1} gradients": grads[s] for s in range(DP_STEPS)}
        groups.update({
            "parameter changes": [_host(p) - p0 for p, p0 in zip(params, init)],
            "BatchNorm statistics": [_host(b) for b in trainer.model.buffers()],
            "EMA copy": [_host(t) for t in trainer.state.ema_params.values()],
            "AdamW moments": [_host(adam[p][k]) for p in params
                              for k in ("exp_avg", "exp_avg_sq")],
        })
        res = dict(groups=groups, step_s=step_s, reduce_s=reduce_s, metrics=metrics,
                   fit_counts=fit_counts)
        if validate:
            trainer._eval_step = with_ground_truth(torch, trainer._eval_step)
            reset_counters()
            res["validation"] = trainer.validate(dp_eval_batches(np, cfg, rank, world))
            res["validate_counts"] = read_counters()
    finally:
        dist.all_reduce = all_reduce
    return res


def _digest(torch, tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_rank(rank, port, out_dir, cfg, device, seed):
    """One rank of the two-rank world: gloo over CUDA tensors on card 0."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sast_tpu_torch.parallel.mesh import make_mesh

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    store = dist.TCPStore("127.0.0.1", port, DP_WORLD, is_master=rank == 0)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=DP_WORLD)
    try:
        with deterministic(torch):
            res = dp_run(torch, np, cfg, device, make_mesh(device),
                         str(Path(out_dir) / f"run{rank}"), seed=seed)
        # Both ranks hold the same summed gradients and state; rank 0's
        # tensors stand for both, the digest shows that they agree.
        res["digest"] = _digest(torch, [t for g in res["groups"].values() for t in g])
        res["files"] = sorted(p.name for p in (Path(out_dir) / f"run{rank}").iterdir())
        if rank:
            res["groups"] = None
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    except BaseException:
        dist.destroy_process_group()
        raise
    leave_together(dist, store, DP_WORLD)


def leave_together(dist, store, world: int) -> None:
    """Tear a world down so that no rank leaves while another is still in
    it: a barrier, so that no collective is in flight when a rank closes its
    connections; then each rank destroys its process group and counts
    itself out on the store, and rank 0, whose process serves the store,
    keeps it until every rank has counted itself out."""
    rank = dist.get_rank()
    dist.barrier()
    dist.destroy_process_group()
    store.add("left", 1)
    while rank == 0 and store.add("left", 0) < world:
        time.sleep(0.01)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _outside(got, want):
    """(elements outside rtol ``DP_RTOL`` + atol ``DP_ATOL``, worst
    absolute error)."""
    n = sum(int(((a - b).abs() > DP_ATOL + DP_RTOL * b.abs()).sum()) for a, b in zip(got, want))
    return n, max(float((a - b).abs().max()) for a, b in zip(got, want))


def within_floor(got, want, floors):
    """``got`` against ``want`` beside the floor runs' tensors of the same
    group: (holds, readings)."""
    n, worst = _outside(got, want)
    floor = [_outside(f, want) for f in floors]
    n_floor, worst_floor = max(c for c, _ in floor), max(w for _, w in floor)
    holds = n <= DP_FLOOR_FACTOR * n_floor and (n == 0 or worst <= DP_FLOOR_FACTOR * worst_floor)
    return holds, dict(outside=n, worst=worst, floor_outside=[c for c, _ in floor],
                       floor_worst=[w for _, w in floor], elements=sum(t.numel() for t in want))


def phase_data_parallel(torch, np, card, work, warmup=False, seed=DP_DATA_SEED, checks=True):
    """7a: two gloo ranks on the card (B 2 each of a B 4 batch) against one
    process on the four lanes, beside the floor (the one process with its
    lanes in three other orders and with its convolutions without cuDNN);
    a world of one over NCCL against no process group, bit for bit;
    ``Trainer.validate`` over the two ranks. ``warmup`` and ``seed`` choose
    the rate's schedule and the data; ``checks=False`` runs the comparison
    alone, fails only where the world is beyond the floor, and reports
    whether half the update would have been caught."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from sast_tpu_torch.parallel.mesh import make_mesh

    cfg = dp_config(warmup)
    card0 = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)
    log(f"data parallel gen4-base: global B {DP_LANES} ({DP_WORLD} ranks x "
        f"{DP_LANES // DP_WORLD} lanes over gloo on card 0), T {cfg.dataset.sequence_length}, "
        f"fp32, sparse-kernel path, {DP_STEPS} steps, rate {DP_LR} "
        f"({'one-cycle warm-up' if warmup else 'constant'}), ema {cfg.training.ema_decay}, "
        f"data seed {seed}")
    work = work / "data_parallel"
    work.mkdir()
    # The world's two ranks run beside this process's own runs (the one
    # process and the floor), which compute the same bits alone or not: the
    # step and all-reduce times logged below are those of runs side by side.
    t0 = time.perf_counter()
    ctx = mp.start_processes(_dp_rank, args=(_free_port(), str(work), cfg, DEVICE, seed),
                             nprocs=DP_WORLD, join=False, start_method="spawn")
    try:
        with deterministic(torch):
            ref = dp_run(torch, np, cfg, DEVICE, None, str(work / "one"), seed=seed,
                         validate=checks)
            floors = {f"lanes {list(o)}": dp_run(torch, np, cfg, DEVICE, None,
                                                 str(work / "floor"), order=o, seed=seed,
                                                 validate=False)
                      for o in DP_FLOOR_ORDERS}
            torch.backends.cudnn.enabled = False  # PyTorch's own convolution kernels
            try:
                floors["no cuDNN"] = dp_run(torch, np, cfg, DEVICE, None, str(work / "floor"),
                                            seed=seed, validate=False)
            finally:
                torch.backends.cudnn.enabled = True
        torch.cuda.empty_cache()
        deadline = time.monotonic() + DP_LIMIT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
                if time.monotonic() > deadline:
                    fail(f"data parallel: the world of {DP_WORLD} did not end in {DP_LIMIT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        world_s = time.perf_counter() - t0
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
        if len({r["digest"] for r in ranks}) != 1:
            fail("data parallel: the ranks' states differ")
        readings, bad = {}, []
        for g, want in ref["groups"].items():
            holds, readings[g] = within_floor(ranks[0]["groups"][g], want,
                                              [f["groups"][g] for f in floors.values()])
            if not holds:
                bad.append(g)
        # The check can fail: half of one process's update is outside
        # nearly everywhere.
        change = ref["groups"]["parameter changes"]
        half_holds, half = within_floor([c / 2 for c in change], change,
                                        [f["groups"]["parameter changes"]
                                         for f in floors.values()])
        # The metrics within 1e-5 at step 1 (every run at the same
        # parameters); from step 2 on within 1e-5 or 4 times the floor's.
        def rel(run, s, k):
            a, b = run["metrics"][s][k], ref["metrics"][s][k]
            return abs(a - b) / max(abs(b), 1e-30)

        metric_rel, metrics_bad = {}, []
        for s in range(DP_STEPS):
            for k in ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg", "P", "grad_norm"):
                floor = max(rel(f, s, k) for f in floors.values())
                metric_rel[f"step {s + 1} {k}"] = (rel(ranks[0], s, k), floor)
                tol = 1e-5 if s == 0 else max(1e-5, DP_FLOOR_FACTOR * floor)
                if metric_rel[f"step {s + 1} {k}"][0] > tol:
                    metrics_bad.append(f"step {s + 1} {k}")
        update = max(float(c.abs().max()) for c in change)
        log(f"data parallel on {card}: world 2 against one process beside the floor runs "
            f"{list(floors)} (elements outside rtol {DP_RTOL} + atol {DP_ATOL}, worst error): "
            + "; ".join(f"{g} {r}" for g, r in readings.items())
            + f"; parameter change up to {update:.3g}; half the update leaves "
            f"{half['outside']} of {half['elements']} outside; metrics, relative error "
            f"(the floor's worst): {metric_rel}")
        if bad or metrics_bad:
            fail(f"data parallel: world 2 differs from one process beyond {DP_FLOOR_FACTOR} times "
                 f"the floor in {bad}, metrics {metrics_bad}")
        res = dict(comparison=readings, floor_runs=list(floors), parameter_change=update,
                   half_update_outside=half["outside"], half_update_caught=not half_holds,
                   metrics_relative=metric_rel)
        if not checks:
            return res
        if half_holds:
            fail(f"data parallel: the comparison cannot fail: half the update passes ({half})")
        if ranks[0]["validation"] != ref["validation"] or not ref["validation"].get("val/AP"):
            fail(f"data parallel: validate over two ranks {ranks[0]['validation']} against one "
                 f"process {ref['validation']}")
        for r in ranks:
            if not (r["fit_counts"]["stem_conv7x4"] and r["fit_counts"]["sparse_window_block"]
                    and r["fit_counts"]["sparse_block_mlp_bwd"]
                    and r["fit_counts"]["sparse_block_attn_bwd"]
                    and r["validate_counts"]["greedy_keep"]):
                fail(f"data parallel: launches {r['fit_counts']}, {r['validate_counts']}")
        if ranks[1]["files"] or "metrics.jsonl" not in ranks[0]["files"]:
            fail(f"data parallel: rank 0 wrote {ranks[0]['files']}, rank 1 {ranks[1]['files']}")
        step_ms = [[s * 1e3 for s in r["step_s"]] for r in ranks]
        reduce_ms = [[s * 1e3 for s in r["reduce_s"]] for r in ranks]
        log(f"data parallel on {card}: train step ms per rank {step_ms} (host clock to the card's "
            f"end, B 2 each), all-reduce ms per step per rank {reduce_ms} (gloo over CUDA "
            f"tensors; BatchNorm's, the loss's, the gradients' and the metrics'); one process at "
            f"B 4: {[round(s * 1e3, 1) for s in ref['step_s']]} ms; the world ran {world_s:.1f} s "
            f"from spawn to join; validate over two ranks {ranks[0]['validation']} equals one "
            f"process's")

        # A world of one over NCCL computes what no process group computes.
        backend = "nccl" if card0.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                world_size=1, **({"device_id": card0} if backend == "nccl" else {}))
        try:
            with deterministic(torch):
                nccl = dp_run(torch, np, cfg, DEVICE, make_mesh(card0), str(work / "nccl"),
                              seed=seed, validate=False)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        differ = [g for g, tensors in nccl["groups"].items()
                  if not all(torch.equal(a, b) for a, b in zip(tensors, ref["groups"][g]))]
        if differ or any(a != b for a, b in zip(nccl["metrics"], ref["metrics"])):
            fail(f"data parallel: a world of one over NCCL differs from no process group in "
                 f"{differ}")
        log(f"data parallel on {card}: a world of one over NCCL is bit-equal to no process group "
            f"(gradients, parameters, statistics, EMA, AdamW moments, metrics); train step "
            f"{[round(s * 1e3, 1) for s in nccl['step_s']]} ms, all-reduce "
            f"{[round(s * 1e3, 3) for s in nccl['reduce_s']]} ms per step")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return res | dict(rank_step_ms=step_ms, rank_all_reduce_ms=reduce_ms,
                      one_process_step_ms=[s * 1e3 for s in ref["step_s"]],
                      nccl_world_of_one_step_ms=[s * 1e3 for s in nccl["step_s"]],
                      nccl_world_of_one_all_reduce_ms=[s * 1e3 for s in nccl["reduce_s"]],
                      validation=ref["validation"], world_seconds=world_s,
                      launches={k: v for k, v in ranks[0]["fit_counts"].items() if v}
                      | {"greedy_keep": ranks[0]["validate_counts"]["greedy_keep"]})


def with_rates(cfg, rate):
    cfg = with_attention(cfg, drop_path=rate, drop_mlp=rate)
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, lstm=dataclasses.replace(bb.lstm, drop_cell_update=rate))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))


def phase_regularizers(torch, np, card, phase5_first, work):
    """7b: the sparse-kernel config of phase 5 (gen4-base, B 12, bf16) with
    every rate 0.1: the masked path (no launch of E, G or H), the same bits
    from the same seed and step twice; with every rate 0, phase 5's first
    step."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import to_device
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.training.loop import Trainer, state_tensors

    cfg = get_config("gen4", "base")
    B = cfg.training.batch_size_train
    batch = synthetic_train_batch(cfg, np.random.RandomState(21), sparsity=0.9)  # phase 5's first
    batch["is_first"] = np.ones(B, bool)
    batch = to_device(batch, DEVICE)
    out = {}
    for i, rate in enumerate((0.0, 0.1, 0.1)):
        trainer = Trainer(with_rates(cfg, rate), str(work / f"regularizers{i}"),
                          sparse_kernel_train=True, device=DEVICE, graph=False)
        reset_counters()
        step_s = []
        # Rates 0 run as phase 5 ran; the regularized steps in the
        # deterministic modes, so that two of them can give the same bits.
        with deterministic(torch) if rate else contextlib.nullcontext():
            _, _, metrics = _clock(torch, trainer.train_step, step_s)(
                trainer.state, batch, trainer._zero_states(B))
        counts = read_counters()
        metrics = {k: float(v) for k, v in metrics.items()}
        if rate == 0.0:
            keys = ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg")
            same = {k: metrics[k] == phase5_first[f"train/{k}"] for k in keys}
            same["SN"] = metrics["P"] == phase5_first["train/SN"]
            if not all(same.values()):
                fail(f"regularizers: rates 0 differ from phase 5's first step: {same}; "
                     f"{metrics} against {phase5_first}")
            log(f"regularizers: every rate 0 gives phase 5's first step bit for bit (loss "
                f"{metrics['loss']!r}, its terms, foreground count, selected tokens); gradient "
                f"norm {metrics['grad_norm']!r} against phase 5's "
                f"{phase5_first['train/grad_norm']!r}")
            out["rates0_step_ms"] = step_s[0] * 1e3
        else:
            if (counts["sparse_window_block"] or counts["sparse_block_mlp_bwd"]
                    or counts["sparse_block_attn_bwd"] or not counts["stem_conv7x4"]):
                fail(f"regularizers: rates {rate} on the sparse-kernel config launched {counts}")
            if not np.isfinite(metrics["loss"]):
                fail(f"regularizers: loss {metrics['loss']}")
            digest = _digest(torch, state_tensors(trainer.state))
            if "digest" in out and (out["digest"] != digest or out["loss"] != metrics["loss"]):
                fail("regularizers: the same seed and step twice gave other bits")
            out.update(digest=digest, loss=metrics["loss"], counts=counts,
                       rates_step_ms=out.get("rates_step_ms", []) + [step_s[0] * 1e3])
        del trainer
        torch.cuda.empty_cache()
    log(f"regularizers on {card}: drop_path = drop_mlp = drop_cell_update = 0.1 on the "
        f"sparse-kernel config: loss {out['loss']:.5f} twice bit-equal, launches "
        f"{out['counts']} (no E, G or H: the masked path); step ms "
        f"{[round(v, 1) for v in out['rates_step_ms']]} against {out['rates0_step_ms']:.1f} "
        f"at rates 0 (host clock, first step of a trainer, B {B})")
    out.pop("digest")
    return out


def cache_readers(np, cfg):
    """In-memory sequences at the dataset's resolution (u8, (N, H, W, C)),
    labels in the recording's pixels as ``labels.npz`` holds them; made once
    (phases 7c and 12d)."""
    from sast_tpu_torch.config import DATASET_RES_HW
    from sast_tpu_torch.data.sequence import MemorySequenceReader
    from sast_tpu_torch.data.synthetic import sparse_event_input

    if "cache_readers" in _MADE:
        return _MADE["cache_readers"]
    rng = np.random.RandomState(41)
    h, w = cfg.dataset.resolution_hw
    C = cfg.model.backbone.input_channels
    H, W = DATASET_RES_HW[cfg.dataset.name]
    readers = []
    for i, (n, labeled) in enumerate(CACHE_SEQS):
        rows, start = [], []
        for r in labeled:
            start.append(len(rows))
            for _ in range(rng.randint(1, 4)):
                bw, bh = rng.uniform(60, 300), rng.uniform(60, 200)
                rows.append((r * 50_000, rng.uniform(0, W - bw), rng.uniform(0, H - bh), bw, bh,
                             rng.randint(0, cfg.model.head.num_classes), 1.0))
        readers.append(MemorySequenceReader(
            f"seq{i}", sparse_event_input(rng, (n, h, w, C), 0.9), np.asarray(rows, np.float32),
            np.asarray(start), np.asarray(labeled), cfg.dataset.name,
            cfg.dataset.downsample_by_factor_2))
    _MADE["cache_readers"] = readers
    return readers


def phase_device_cache(torch, np, card):
    """7c: the card-resident cache against the host ``DataModule`` from the
    same in-memory sequences (360x640, 20 channels, T 5, B 4) in the stream,
    random (weighted) and mixed modes and for evaluation, bit for bit; bytes
    resident, ms per gathered batch, ms for host assembly plus upload."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import to_device
    from sast_tpu_torch.data.device_cache import DeviceCachedEvalStream, DeviceCachedTrainStream
    from sast_tpu_torch.data.module import DataModule

    base = get_config("gen4", "base", **{
        "training.batch_size_train": 4, "training.batch_size_eval": 4,
        "dataset.data_augmentation_random.zoom.prob": 0.0,
        "dataset.data_augmentation_stream.zoom.prob": 0.0, "dataset.weighted_sampling": True})
    t0 = time.perf_counter()
    readers = cache_readers(np, base)
    log(f"device cache: {len(readers)} sequences of {[n for n, _ in CACHE_SEQS]} frames at "
        f"{base.dataset.resolution_hw}, {base.model.backbone.input_channels} channels, made on the "
        f"host in {time.perf_counter() - t0:.1f} s")
    keys = ("is_first", "frame_tidx", "frame_valid", "gt_boxes", "gt_classes", "gt_valid")
    res = {}

    def check(got, ref, what):
        if not torch.equal(got["ev_repr"].cpu(), torch.from_numpy(np.asarray(ref["ev_repr"]))):
            fail(f"device cache {what}: ev_repr differs from the host's")
        for k in keys:
            if not np.array_equal(np.asarray(got[k]), np.asarray(ref[k])):
                fail(f"device cache {what}: {k} differs from the host's")

    def timed(fn):
        times = []
        out = _clock(torch, fn, times)()
        return out, times[0] * 1e3

    for mode in ("stream", "random", "mixed"):
        cfg = dataclasses.replace(base, dataset=dataclasses.replace(base.dataset,
                                                                    train_sampling=mode))
        stream = DeviceCachedTrainStream(cfg, seed=5, device=DEVICE, readers=readers)
        cached = iter(stream)
        host = iter(DataModule(cfg, readers={"train": readers}).train_batches(seed=5,
                                                                              prefetch=False))
        gather_ms, host_ms = [], []
        for i in range(CACHE_BATCHES):
            got, ms = timed(lambda: next(cached))
            gather_ms.append(ms)
            ref, ms = timed(lambda: next(host))
            up, ms_up = timed(lambda: to_device({k: ref[k] for k in ("ev_repr",)}, DEVICE))
            host_ms.append(ms + ms_up)
            check(got, ref, f"{mode} batch {i}")
        res[mode] = dict(gather_ms=gather_ms, host_assembly_upload_ms=host_ms,
                         bytes_resident=stream.nbytes)
        del stream, cached
        torch.cuda.empty_cache()
    ev_stream = DeviceCachedEvalStream(base, "test", device=DEVICE, readers=readers)
    host_eval = list(DataModule(base, readers={"test": readers}).eval_batches("test",
                                                                              prefetch=False))
    cached_eval = list(ev_stream)
    if len(cached_eval) != len(host_eval):
        fail(f"device cache eval: {len(cached_eval)} batches against {len(host_eval)}")
    for i, (got, ref) in enumerate(zip(cached_eval, host_eval)):
        check(got, ref, f"eval batch {i}")
    res["eval"] = dict(batches=len(cached_eval), bytes_resident=ev_stream.nbytes)
    del ev_stream, cached_eval
    torch.cuda.empty_cache()
    modes = ("stream", "random", "mixed")
    log(f"device cache on {card}: bit-equal to the host DataModule in the stream, random "
        f"(weighted) and mixed modes ({CACHE_BATCHES} batches each, B 4, T 5) and over the "
        f"{res['eval']['batches']} evaluation batches; {res['stream']['bytes_resident']} bytes "
        f"resident per split; ms per gathered batch "
        f"{ {m: [round(v, 3) for v in res[m]['gather_ms']] for m in modes} }, host assembly "
        f"plus upload of the same batch "
        f"{ {m: [round(v, 1) for v in res[m]['host_assembly_upload_ms']] for m in modes} }")
    return res


def phase_profile(torch, np, card, work):
    """7d: ``fit(profile_steps=(2, 3))`` at gen4-base (B 4, bf16, the
    sparse-kernel path) writes a trace that holds steps 2 and 3 and names
    kernel E's launches; the trace is removed afterwards."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.training.loop import Trainer

    cfg = get_config("gen4", "base", **{"training.batch_size_train": 4})
    rng = np.random.RandomState(61)
    batches = [synthetic_train_batch(cfg, rng, sparsity=0.9) for _ in range(3)]
    work = work / "profile"
    trainer = Trainer(cfg, str(work), log_every=1, sparse_kernel_train=True, device=DEVICE,
                      graph=False)
    reset_counters()
    trainer.fit(batches, max_steps=3, profile_steps=PROFILE_WINDOW)
    counts = read_counters()
    files = sorted((work / "trace").glob("*.pt.trace.json"))
    if len(files) != 1:
        fail(f"profiler: traces {files}")
    size = files[0].stat().st_size
    events = json.loads(files[0].read_text())["traceEvents"]
    steps = sorted({int(e["name"].split()[1]) for e in events
                    if str(e.get("name", "")).startswith("train_step ")})
    e_launches = sum(1 for e in events if e.get("cat") == "kernel" and "sf::" in e.get("name", ""))
    shutil.rmtree(work / "trace")
    if steps != list(range(PROFILE_WINDOW[0], PROFILE_WINDOW[1] + 1)) or not e_launches:
        fail(f"profiler: the trace holds steps {steps} and {e_launches} launches of kernel E")
    log(f"profiler on {card}: fit(profile_steps={PROFILE_WINDOW}) wrote one trace of {size} "
        f"bytes holding steps {steps} and {e_launches} launches of kernel E (sf::); the three "
        f"steps launched {counts['sparse_window_block']} in all; trace removed")
    del trainer
    torch.cuda.empty_cache()
    return dict(trace_bytes=size, steps=steps, kernel_e_launches_in_trace=e_launches,
                launches=counts)


def phase_seven(torch, np, card, phase5_first):
    """Phase 7, its scratch directory under ``chiprun_out/`` removed at the
    end (checkpoints that ``fit`` ends with, the trace)."""
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="phase7_", dir=OUT_DIR))
    out = {}
    try:
        for name, fn, args in (("data_parallel", phase_data_parallel, (work,)),
                               ("regularizers", phase_regularizers, (phase5_first, work)),
                               ("device_cache", phase_device_cache, ()),
                               ("profiler", phase_profile, (work,))):
            t0 = time.perf_counter()
            out[name] = fn(torch, np, card, *args)
            log(f"phase 7 {name}: ok ({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# Phase 8: the serving deployment. Artifacts of the serving step on four
# configurations, which between them launch kernels A-F from inside a loaded
# program: name -> (backbone switches, attention switches, sparse_kernel,
# looped kernel, the kernels whose counters must show launches in the
# artifact, with the launches each must show per frame).
EXPORT_PATHS = {
    "default": (dict(), dict(), False, False, dict(stem_conv7x4=1, greedy_keep=1)),
    "fusion_off_sparse": (dict(fuse_stem_density=False), dict(), True, False,
                          dict(stem_conv7x4=1, density_ratio=1, sparse_window_block=8,
                               greedy_keep=1)),
    "fused": (dict(), dict(fused_block=True), False, False,
              dict(stem_conv7x4=1, fused_window_block=8, greedy_keep=1)),
    "looped": (dict(), dict(), True, True,
               dict(stem_conv7x4=1, sparse_window_block_looped=8, greedy_keep=1)),
}
EXPORT_FRAMES = 8
MESH = ("cuda:0", "cuda:0")  # two replicas on the one card of the machine
# Mesh against one 4-lane detector in fp32 (TF32 off): largest box
# difference (px), relative score difference, telemetry (tokens per lane)
# and carried state, about 15 times what two half batches against one batch
# measured on the H100 (6.1e-5 px, 8.7e-7, 0, 3.0e-6 over 8 frames); the
# telemetry exact (no token selection moved).
MESH_TOL = dict(box_px=1e-3, score_rel=1e-5, tokens=0.0, state=5e-5)

# Run in a fresh process: load each artifact with ``sast_tpu_torch.export``
# alone, step it over the parent's frames, and save its outputs, carried
# states and launch counts beside the artifact.
ARTIFACT_RUNNER = r"""
import json, sys
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from sast_tpu_torch.export import ExportedStreamingDetector
work, names = sys.argv[1], sys.argv[2:]
ops = {k: sys.modules["sast_tpu_torch.ops." + m] for k, m in (
    ("stem_conv7x4", "stem_conv"), ("density_ratio", "density"), ("greedy_keep", "nms_keep"),
    ("fused_window_block", "fused_block"), ("sparse_window_block", "sparse_block"),
    ("sparse_window_block_looped", "sparse_block"))}
report = {}
for name in names:
    inputs = torch.load(f"{work}/{name}/inputs.pt", weights_only=True)
    det = ExportedStreamingDetector(f"{work}/{name}", graph=False)
    for k, m in ops.items():
        getattr(m, k).launches = 0
    outs = [det.step(*(t.to(det.device) for t in frame)) for frame in inputs]
    if det.device.type == "cuda":
        torch.cuda.synchronize()
    counts = {k: getattr(m, k).launches for k, m in ops.items()}
    torch.save(dict(outs=[({k: v.cpu() for k, v in d.items()}, p.cpu()) for d, p in outs],
                    states=[t.cpu() for hc in det.states for t in hc]),
               f"{work}/{name}/artifact_outputs.pt")
    conds = [n for n in det.program.graph.nodes if n.target is torch.ops.higher_order.cond]
    report[name] = dict(counts=counts, device=str(det.device), num_streams=det.num_streams,
                        max_events=det.max_events, cond_nodes=len(conds))
report["model_modules"] = sorted(m for m in sys.modules if m.startswith(
    ("sast_tpu_torch.models", "sast_tpu_torch.training", "sast_tpu_torch.data",
     "sast_tpu_torch.serving")))
print(json.dumps(report))
"""


_FRESH = []  # artifact runs in fresh processes, deferred to phase 12 (``run_fresh``)


def run_fresh(what, work, names, check):
    """Have a fresh process that imports ``sast_tpu_torch.export`` alone
    (``ARTIFACT_RUNNER``) run the artifacts ``names`` exported under
    ``work``, and ``check(report)`` its outputs: deferred to run beside
    phases 12c-12e, whose logged step times are then readings of runs side
    by side (``start_fresh``, ``finish_fresh``). ``work`` is removed at the end of the script."""
    atexit.register(shutil.rmtree, work, True)
    _FRESH.append(dict(what=what, work=work, names=names, check=check))


def start_fresh():
    """Start the deferred artifact processes (``run_fresh``), each its own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for job in _FRESH:
        job["printed"] = open(job["work"] / "runner_printed.txt", "w")
        job["proc"] = subprocess.Popen(
            [sys.executable, "-c", ARTIFACT_RUNNER, str(job["work"]), *job["names"]],
            stdout=job["printed"], stderr=subprocess.STDOUT, env=env)
        job["t0"] = time.perf_counter()


def finish_fresh():
    """Wait for the deferred artifact processes and check their outputs."""
    while _FRESH:
        job = _FRESH.pop(0)
        try:
            job["proc"].wait(timeout=max(600 - (time.perf_counter() - job["t0"]), 1))
        except subprocess.TimeoutExpired:
            job["proc"].kill()
            job["proc"].wait()
        job["printed"].close()
        text = (job["work"] / "runner_printed.txt").read_text()
        if job["proc"].returncode != 0:
            fail(f"{job['what']}: the artifact process failed:\n{text[-3000:]}")
        log(f"{job['what']}: a fresh process ran the {len(job['names'])} artifacts beside phases "
            f"12c-12e ({time.perf_counter() - job['t0']:.1f} s from its start)")
        job["check"](json.loads(text.strip().splitlines()[-1]))
        shutil.rmtree(job["work"], ignore_errors=True)


def stop_fresh():
    """End any deferred artifact process still running."""
    for job in _FRESH:
        if job.get("proc") is not None and job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()


def export_config(cfg, backbone, attention):
    """``cfg`` with switches of ``model.backbone`` and of its attention
    replaced."""
    bb = cfg.model.backbone
    bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention, **attention),
                             **backbone)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))


def serving_inputs(torch, np, cfg, frames, resets):
    """The step's device inputs of each frame: packed events, counts, resets."""
    from sast_tpu_torch.packing import pack_event_batch

    out = []
    for fr, reset in zip(frames, resets):
        packed, n = pack_event_batch(fr, STREAMS, EVENTS_PER_FRAME)
        out.append(tuple(torch.from_numpy(a).to(DEVICE) for a in (packed, n, reset)))
    return out


def run_steps(torch, det, inputs):
    """``det.step`` over the frames from zero states: per frame the slate
    and telemetry on the host, then the carried states' leaves."""
    det.reset()
    outs = [det.step(*frame) for frame in inputs]
    torch.cuda.synchronize()
    mesh = getattr(det, "mesh", None)  # an artifact has none
    states = det.states if mesh is None else [hc for replica in det.states for hc in replica]
    return ([({k: v.cpu() for k, v in d.items()}, p.cpu()) for d, p in outs],
            [t.cpu() for hc in states for t in hc])


def same_bits(torch, a, b):
    """Where two ``run_steps`` results differ, by frame and key (or state
    leaf); empty when they are the same bits."""
    (outs_a, states_a), (outs_b, states_b) = a, b
    bad = [f"frame {f} {k}" for f, ((da, pa), (db, pb)) in enumerate(zip(outs_a, outs_b))
           for k in list(da) + ["selected_tokens"]
           if not torch.equal(da.get(k, pa), db.get(k, pb))]
    bad += [f"state leaf {i}" for i, (x, y) in enumerate(zip(states_a, states_b))
            if x.dtype != y.dtype or not torch.equal(x, y)]
    return bad if len(outs_a) == len(outs_b) and len(states_a) == len(states_b) else ["length"]


def phase_export(torch, np, cfg, model, inputs, work):
    """(a) of phase 8: per configuration of ``EXPORT_PATHS``, the live
    detector's run, its export (seconds, bytes), its run again, the
    artifacts run by a fresh process that imports ``sast_tpu_torch.export``
    alone, and the artifact and the live step timed in turns here."""
    from sast_tpu_torch.export import ExportedStreamingDetector, export_streaming_detector
    from sast_tpu_torch.models.detector import YoloXDetector
    from sast_tpu_torch.ops import sparse_block
    from sast_tpu_torch.serving import StreamingDetector

    results, live_runs, dets = {}, {}, {}
    for name, (backbone, attention, sparse_kernel, looped, _) in EXPORT_PATHS.items():
        cfg_p = export_config(cfg, backbone, attention)
        model_p = YoloXDetector(cfg_p.model)
        model_p.load_state_dict(model.state_dict())
        det = dets[name] = StreamingDetector(cfg_p, model_p, max_events=EVENTS_PER_FRAME,
                                             num_streams=STREAMS, device=DEVICE,
                                             sparse_kernel=sparse_kernel, graph=False)
        sparse_block.MODEL_USES_LOOPED, default = looped, sparse_block.MODEL_USES_LOOPED
        try:
            live_runs[name] = run_steps(torch, det, inputs)
            t0 = time.perf_counter()
            blob = export_streaming_detector(det, path=str(work / name))
            export_s = time.perf_counter() - t0
            after = run_steps(torch, det, inputs)
        finally:
            sparse_block.MODEL_USES_LOOPED = default
        bad = same_bits(torch, after, live_runs[name])
        if bad:
            fail(f"export {name}: the live detector steps differently after the export: {bad[:4]}")
        torch.save(list(inputs), work / name / "inputs.pt")
        results[name] = dict(export_s=export_s, artifact_bytes=len(blob))
        _MADE[f"artifact_{name}"] = blob  # phase 11b loads it again, captured
        log(f"export {name}: {export_s:.1f} s, {len(blob)} bytes; the live detector after the "
            f"export is the same bits over {EXPORT_FRAMES} frames")

    def check(report):
        """The fresh process's runs (``run_fresh``) against the live ones."""
        if report["model_modules"]:
            fail(f"export: the artifact process imported {report['model_modules']}")
        for name, (_, _, _, _, want) in EXPORT_PATHS.items():
            got = torch.load(work / name / "artifact_outputs.pt", weights_only=True)
            bad = same_bits(torch, (got["outs"], got["states"]), live_runs[name])
            if bad:
                fail(f"export {name}: the artifact differs from the live detector: {bad[:4]}")
            counts, seen = report[name]["counts"], report[name]
            short = {k: n * EXPORT_FRAMES for k, n in want.items()
                     if counts[k] < n * EXPORT_FRAMES}
            described = (seen["device"], seen["num_streams"], seen["max_events"])
            if short or described != ("cuda:0", STREAMS, EVENTS_PER_FRAME):
                fail(f"export {name}: launches inside the artifact {counts}, expected at least "
                     f"{short}; device, lanes and event budget read from it {described}")
            results[name]["launches_artifact"] = counts
            log(f"export {name}: the artifact equals the live detector bit for bit over "
                f"{EXPORT_FRAMES} frames (detections, telemetry, states); launches inside it "
                f"{ {k: v for k, v in counts.items() if v} }; model modules the process "
                f"imported: {report['model_modules']}")

    run_fresh("export", work, list(EXPORT_PATHS), check)

    # The artifact and the live step in turns (live, artifact, artifact,
    # live), CUDA events over 10 steps each, on the first frame's inputs.
    no_reset = torch.zeros(STREAMS, dtype=torch.bool, device=DEVICE)
    pk, nk, _ = inputs[0]
    for name, (_, _, _, looped, _) in EXPORT_PATHS.items():
        art = ExportedStreamingDetector(str(work / name), graph=False)
        live = dets[name]
        sparse_block.MODEL_USES_LOOPED, default = looped, sparse_block.MODEL_USES_LOOPED
        try:
            turns = [cuda_ms(torch, lambda d=d: d.step(pk, nk, no_reset), iters=10, warmup=3)
                     for d in (live, art, art, live)]
        finally:
            sparse_block.MODEL_USES_LOOPED = default
        results[name].update(live_ms_turns=[turns[0], turns[3]], artifact_ms_turns=turns[1:3],
                             live_ms=(turns[0] + turns[3]) / 2, artifact_ms=(turns[1] + turns[2]) / 2)
        log(f"export {name}: ms/step live {results[name]['live_ms']:.3f} "
            f"(turns {turns[0]:.3f}, {turns[3]:.3f}), artifact {results[name]['artifact_ms']:.3f} "
            f"(turns {turns[1]:.3f}, {turns[2]:.3f})")
        del art
    return results


def slate_match(np, got, ref):
    """Two slates of one lane: None unless they hold the same number of
    valid detections with the same classes (as multisets); else the largest
    box difference (px) and relative score difference, each of ``ref``'s
    detections matched to ``got``'s nearest box of its class (near-equal
    scores may come in either order)."""
    vg, vr = got["valid"], ref["valid"]
    bg, cg, sg = (got[k][vg] for k in ("boxes", "classes", "scores"))
    br, cr, sr = (ref[k][vr] for k in ("boxes", "classes", "scores"))
    if len(cg) != len(cr) or sorted(cg.tolist()) != sorted(cr.tolist()):
        return None
    box = score = 0.0
    for i in range(len(cr)):
        same = np.flatnonzero(cg == cr[i])
        d = np.abs(bg[same] - br[i]).max(axis=1)
        j = same[d.argmin()]
        box, score = max(box, float(d.min())), max(score, abs(float(sg[j] - sr[i])) / float(sr[i]))
    return box, score


def phase_mesh(torch, np, cfg, model, inputs):
    """(b) of phase 8: ``StreamingDetector(mesh=MESH, num_streams=4)`` (two
    replicas of 2 lanes on the one card). In bf16 (the phase's config): the
    same bits as two 2-lane detectors; against one 4-lane detector the
    differences are logged (two half batches let cuDNN block its sums
    otherwise, and in bf16 that moves token selections and the order of the
    slates). In fp32 with a confidence threshold in a wide score gap (phase
    4's method): against one 4-lane detector, the same valid counts and
    classes, boxes, scores, states and telemetry within ``MESH_TOL``. ms/step
    of the bf16 mesh and 4-lane detector in turns."""
    from sast_tpu_torch.models.detector import YoloXDetector
    from sast_tpu_torch.serving import StreamingDetector

    def detector(cfg_d, lanes, **kw):
        """A detector of ``lanes`` lanes with ``model``'s weights, built for
        ``cfg_d``'s compute dtype."""
        m = YoloXDetector(cfg_d.model)
        m.load_state_dict(model.state_dict())
        return StreamingDetector(cfg_d, m, max_events=EVENTS_PER_FRAME, num_streams=lanes,
                                 graph=False, **kw)

    half = STREAMS // 2
    mesh = detector(cfg, STREAMS, mesh=MESH)
    pairs = [detector(cfg, half, device=DEVICE) for _ in range(2)]
    got = run_steps(torch, mesh, inputs)
    halves = [run_steps(torch, p, [tuple(t[r * half:(r + 1) * half] for t in frame)
                                   for frame in inputs]) for r, p in enumerate(pairs)]
    # The two detectors' runs as one: slates joined in lane order, the
    # telemetry the mean of their aggregates, the states replica by replica.
    joined = ([({k: torch.cat([h[0][f][0][k] for h in halves]) for k in halves[0][0][f][0]},
                torch.stack([h[0][f][1] for h in halves]).mean(dim=0))
               for f in range(len(inputs))], [t for h in halves for t in h[1]])
    bad = same_bits(torch, got, joined)
    if bad:
        fail(f"mesh: two replicas differ from two 2-lane detectors: {bad[:4]}")
    log(f"mesh {MESH}: two replicas of {half} lanes equal two {half}-lane detectors bit for bit "
        f"over {len(inputs)} frames (slates, telemetry, states)")
    del pairs

    def against_single(got, ref):
        """Differences of a mesh run against a 4-lane run: elementwise slots
        whose class differs, matched slates, telemetry and states."""
        out = dict(class_slots=0, unmatched=0, box_px=0.0, score_rel=0.0, tokens=0.0, state=0.0)
        for (dg, pg), (dr, pr) in zip(got[0], ref[0]):
            out["class_slots"] += int((dg["classes"] != dr["classes"]).sum())
            out["tokens"] = max(out["tokens"], float((pg - pr).abs().max()))
            for lane in range(STREAMS):
                m = slate_match(np, {k: v[lane].numpy() for k, v in dg.items()},
                                {k: v[lane].numpy() for k, v in dr.items()})
                if m is None:
                    out["unmatched"] += 1
                else:
                    out["box_px"], out["score_rel"] = (max(out["box_px"], m[0]),
                                                       max(out["score_rel"], m[1]))
        # Leaf i of replica r is got[1][r * n + i]; the 4-lane run's leaves
        # hold all lanes.
        n = len(ref[1])
        for i in range(n):
            both = torch.cat([got[1][i], got[1][n + i]]).float()
            out["state"] = max(out["state"], float((both - ref[1][i].float()).abs().max()))
        return out

    single = detector(cfg, STREAMS, device=DEVICE)
    bf16 = against_single(got, run_steps(torch, single, inputs))
    log(f"mesh vs one {STREAMS}-lane detector, bf16, threshold 0, {len(inputs)} frames "
        f"(logged): {bf16}")

    # fp32, with a threshold in the widest relative score gap of the first
    # frame's pooled slates between ranks 100 and 900 (of 4 x 300 at gen4).
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               compute_dtype="float32"))
    probe = detector(cfg32, STREAMS, device=DEVICE)
    dets, _ = probe.step(*inputs[0])
    sc = dets["scores"][dets["valid"]].sort(descending=True).values
    top = min(900, len(sc) - 1)
    gaps = sc[100:top] / sc[101:top + 1]
    r = 100 + int(gaps.argmax())
    thr = float((sc[r] * sc[r + 1]).sqrt())
    del probe
    cfg32 = dataclasses.replace(cfg32, model=dataclasses.replace(cfg32.model, postprocess=(
        dataclasses.replace(cfg32.model.postprocess, confidence_threshold=thr))))
    fp32 = against_single(run_steps(torch, detector(cfg32, STREAMS, mesh=MESH), inputs),
                          run_steps(torch, detector(cfg32, STREAMS, device=DEVICE), inputs))
    fp32["threshold"], fp32["gap"] = thr, float(gaps.max())
    log(f"mesh vs one {STREAMS}-lane detector, fp32, threshold {thr:.6e} (relative gap "
        f"{float(gaps.max()):.6f} between pooled ranks {r + 1} and {r + 2}), {len(inputs)} "
        f"frames: {fp32} (tolerances {MESH_TOL})")
    if fp32["unmatched"] or any(fp32[k] > MESH_TOL[k] for k in MESH_TOL):
        fail(f"mesh vs one {STREAMS}-lane detector in fp32 outside {MESH_TOL}: {fp32}")

    no_reset = torch.zeros(STREAMS, dtype=torch.bool, device=DEVICE)
    pk, nk, _ = inputs[0]
    turns = [cuda_ms(torch, lambda d=d: d.step(pk, nk, no_reset), iters=20, warmup=3)
             for d in (single, mesh, mesh, single)]
    log(f"mesh ms/step {(turns[1] + turns[2]) / 2:.3f} (turns {turns[1]:.3f}, {turns[2]:.3f}); "
        f"one {STREAMS}-lane detector {(turns[0] + turns[3]) / 2:.3f} "
        f"(turns {turns[0]:.3f}, {turns[3]:.3f})")
    return dict(bit_equal_to_pairs=True, vs_single_bf16=bf16, vs_single_fp32=fp32,
                mesh_ms=(turns[1] + turns[2]) / 2, single_ms=(turns[0] + turns[3]) / 2,
                turns_ms=turns)


def deployment_setup(torch, np):
    """Phase 8's configuration (gen4-base, confidence threshold 0), its
    stand-in trained weights on the host, and its 8 frames of clustered
    events per lane with lane 2 reset at frame 4."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.models.detector import build_detector

    cfg = get_config("gen4", "base", **{"model.postprocess.confidence_threshold": 0.0})
    model = stand_in_trained(torch, build_detector(cfg.model, seed=0, device="cpu"))
    h, w = cfg.dataset.resolution_hw
    rng = np.random.RandomState(8)
    frames = [[clustered_events(np, rng, EVENTS_PER_FRAME - 1000 * s, h, w, f, s)
               for s in range(STREAMS)] for f in range(EXPORT_FRAMES)]
    resets = [np.array([f == EXPORT_FRAMES // 2 and s == 2 for s in range(STREAMS)])
              for f in range(EXPORT_FRAMES)]
    return cfg, model, frames, resets


def phase_eight(torch, np):
    """Phase 8: the serving deployment at gen4-base, 4 lanes, confidence
    threshold 0 (NMS sees full candidate sets), stand-in trained weights:
    (a) exported artifacts, (b) the lanes over two replicas."""
    import tempfile

    cfg, model, frames, resets = deployment_setup(torch, np)
    inputs = serving_inputs(torch, np, cfg, frames, resets)
    work = Path(tempfile.mkdtemp(prefix="export_", dir=OUT_DIR))
    atexit.register(shutil.rmtree, work, True)
    t0 = time.perf_counter()
    exports = phase_export(torch, np, cfg, model, inputs, work)
    log(f"phase 8a: export ok ({time.perf_counter() - t0:.1f} s; the fresh process that runs "
        f"the artifacts runs beside phase 12)")
    t0 = time.perf_counter()
    mesh = phase_mesh(torch, np, cfg, model, inputs)
    log(f"phase 8b: mesh ok ({time.perf_counter() - t0:.1f} s)")
    return dict(exports=exports, mesh=mesh)



# ---------------------------------------------------------------------------
# Phase 9: the benchmark library on the card, the timers and the
# preprocessing representations.

BENCH_PATHS = ("default", "sparse", "looped", "fused")  # timed, in this order
BENCH_ITERS, BENCH_BLOCKS = 20, 2  # compute_fps' chunks: L 10 and 20, 2 blocks
BENCH_KERNEL = {"default": None, "sparse": "sparse_window_block",
                "looped": "sparse_window_block_looped", "fused": "fused_window_block"}
CHUNK_CHECK_FRAMES = 3  # frames of the chunk held against stepping one by one
FLOP_PATHS = ("masked", "default", "sparse", "looped", "fused")
REPR_EVENTS = 2_000_000  # events per window at gen4's raw 720x1280
REPR_HW = (720, 1280)


def phase_benchmark(torch, np, cfg):
    """9a: ``compute_fps`` on the four kernel paths, the launch counters
    holding the kernels of every timed frame; one chunk's carried states
    against the same frames stepped through ``model(...)``. 9b:
    ``compute_flops`` of every path equal."""
    import torch.utils._pytree as pytree

    from sast_tpu_torch.utils import benchmark as bench

    per_frame_blocks = 2 * sum(cfg.model.backbone.num_blocks)  # window + grid layer
    out = {}
    for path in BENCH_PATHS:
        reset_counters()
        res = bench.compute_fps(cfg, batch_size=STREAMS, sparsity=0.9, iters=BENCH_ITERS,
                                path=path, blocks=BENCH_BLOCKS, device=DEVICE, graph=False)
        torch.cuda.synchronize()
        counts = read_counters()
        n = res["frames"]
        expect = {k: 0 for k in counts} | dict(stem_conv7x4=n, greedy_keep=n)
        if BENCH_KERNEL[path]:
            expect[BENCH_KERNEL[path]] = per_frame_blocks * n
        if counts != expect:
            fail(f"benchmark {path}: launches {counts} over {n} frames, expected {expect}")
        # The chunk against the same frames one by one, outside the count.
        run_cfg, sparse_kernel, looped = bench.path_config(cfg, path)
        model, x, states = bench._build_model_and_inputs(run_cfg, STREAMS, 0.9, 0, DEVICE,
                                                         sparse_kernel)
        with bench.looped_kernel(looped), torch.inference_mode():
            chunk_states, _ = bench.streaming_chunk(model, CHUNK_CHECK_FRAMES)(x, states)
            st = states
            for _ in range(CHUNK_CHECK_FRAMES):
                _, st, _ = model(x, st)
        bad = [i for i, (a, b) in enumerate(zip(pytree.tree_leaves(chunk_states),
                                                pytree.tree_leaves(st)))
               if not torch.equal(a, b)]
        if bad:
            fail(f"benchmark {path}: the chunk's states differ from stepping at leaves {bad}")
        del model, x, states, chunk_states, st
        out[path] = dict(res, launches=counts)
        log(f"benchmark {path}: {res['step_ms']:.3f} ms/frame (slope of chunks "
            f"{res['chunk_lengths']}, {BENCH_BLOCKS} blocks; chunk overhead "
            f"{res['per_dispatch_overhead_ms']:.1f} ms), {res['fps']:.1f} frames/s; launches "
            f"over its {n} frames {counts}; a {CHUNK_CHECK_FRAMES}-frame chunk's states equal "
            f"stepping bit for bit")
    flops = {p: bench.compute_flops(cfg, batch_size=1, sparsity=0.9, path=p, device=DEVICE)
             for p in FLOP_PATHS}
    if len({f["gflops_total"] for f in flops.values()}) != 1:
        fail(f"benchmark: GFLOP/frame differs between paths: {flops}")
    log(f"benchmark: {flops['default']['gflops_total']:.4f} GFLOP/frame on every path "
        f"{FLOP_PATHS}; operator bytes (unfused bound) MB/frame "
        f"{ {p: round(f['bytes_accessed_mb'], 1) for p, f in flops.items()} }")
    return dict(paths=out, flops=flops)


def phase_timers(torch, np, cfg):
    """9c: ``DeviceTimer`` around 5 steps reads at least the CUDA-event time
    of those steps; the registry is emptied afterwards."""
    from sast_tpu_torch.utils import benchmark as bench
    from sast_tpu_torch.utils import timers

    model, x, states = bench._build_model_and_inputs(cfg, STREAMS, 0.9, 0, DEVICE)
    run = bench.streaming_chunk(model, 5, detect=True)
    run(x, states)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    held = {}
    with timers.DeviceTimer("chip_smoke 5 steps", block_on=held):
        start.record()
        held["states"], held["acc"] = run(x, states)
        end.record()
    event_ms = start.elapsed_time(end)
    timer_ms = timers.timer_stats()["chip_smoke 5 steps"]["total_s"] * 1e3
    if not timer_ms >= event_ms:
        fail(f"timers: DeviceTimer read {timer_ms:.3f} ms, the events {event_ms:.3f} ms")
    timers.reset()
    if timers.timer_stats():
        fail("timers: the registry is not empty after reset")
    log(f"timers: DeviceTimer {timer_ms:.3f} ms >= CUDA events {event_ms:.3f} ms over 5 "
        f"steps; registry emptied")
    return dict(device_timer_ms=timer_ms, event_ms=event_ms)


def repr_events(np, rng):
    """``REPR_EVENTS`` sorted events at gen4's raw resolution over 50 ms,
    the first at t 0 and the last at 2^20 us, with one event at each
    power-of-two fraction 2^-k of the span (k 1..20): the mixed stack's
    bin boundaries."""
    n = REPR_EVENTS - 22
    t = np.concatenate([[0, 1 << 20], [(1 << 20) >> k for k in range(1, 21)],
                        rng.randint(0, 1 << 20, n)]).astype(np.int64)
    t.sort(kind="stable")
    h, w = REPR_HW
    return (rng.randint(0, w, t.size), rng.randint(0, h, t.size), rng.randint(0, 2, t.size), t)


def phase_representations(torch, np):
    """9d: both preprocessing representations on the card equal the CPU,
    bit for bit, at gen4's raw resolution; ms per construct on each."""
    from sast_tpu_torch.data.representations import MixedDensityEventStack, StackedHistogram

    x, y, p, t = repr_events(np, np.random.RandomState(9))
    h, w = REPR_HW
    out = {}
    for cls, cutoff in ((StackedHistogram, 10), (MixedDensityEventStack, None)):
        got, ms = {}, {}
        for device in (DEVICE, "cpu"):
            rep = cls(10, h, w, count_cutoff=cutoff, device=device)
            rep.construct(x, y, p, t)  # warm-up
            t0 = time.perf_counter()
            got[device] = rep.construct(x, y, p, t)
            ms[device] = (time.perf_counter() - t0) * 1e3
        if got[DEVICE].dtype != got["cpu"].dtype or not np.array_equal(got[DEVICE], got["cpu"]):
            fail(f"representations: {cls.__name__} on the card differs from the CPU")
        out[cls.__name__] = dict(ms=ms, nonzero=int((got["cpu"] != 0).sum()))
        log(f"representations: {cls.__name__} ({len(t)} events, {h}x{w}, 10 bins) bit-equal on "
            f"the card and the CPU; ms per construct, host arrays in and out: card "
            f"{ms[DEVICE]:.1f}, CPU {ms['cpu']:.1f}")
    return out


def phase_nine(torch, np):
    """Phase 9 at gen4-base, B 4, sparsity 0.9, bf16."""
    from sast_tpu_torch.config import get_config

    cfg = get_config("gen4", "base")
    t0 = time.perf_counter()
    res = dict(benchmark=phase_benchmark(torch, np, cfg))
    log(f"phase 9ab: benchmark library ok ({time.perf_counter() - t0:.1f} s)")
    res["timers"] = phase_timers(torch, np, cfg)
    res["representations"] = phase_representations(torch, np)
    return res

# ---------------------------------------------------------------------------
# Phase 10: the attention branches chosen on the card inside exported
# artifacts, and the measuring CLIs.

# name -> (attention switches, sparse_kernel, the branch taken at or below
# the limit); each layer of both chooses with a ``torch.cond`` in the trace.
COND_EXPORTS = {"gather_0.5": (dict(gather_budget=0.5), False, "gathered"),
                "threshold_0.5": (dict(pallas_density_threshold=0.5), True, "kernel")}
# Which of phase 8's frames each of the 8 frames is: an index, or an empty
# scene (few windows kept: every layer's first branch), or uniform events
# over the sensor (every window kept: the masked branch).
COND_FRAMES = ("empty", 0, 1, "uniform", "empty", 2, 3, 4)
# The measuring CLIs, short: name -> arguments (``--device cuda`` added).
CLI_RUNS = {
    "bench_serving": ["--dataset", "gen4", "--size", "base", "--streams", "4", "--events",
                      "200000", "--clustered", "3", "--path", "sparse", "--L1", "10", "--L2", "40",
                      "--blocks", "2"],
    "bench_sparse_layer": ["--iters", "10", "--blocks", "2", "--densities", "0.1,0.6"],
    "bench_sparse_layer_grad": ["--grad", "--iters", "10", "--blocks", "2", "--densities",
                                "0.1,0.6"],
    "bench_train_sparsity": ["--dataset", "gen4", "--size", "base", "--batch", "2", "--seq", "3",
                             "--iters", "1", "--repeats", "1", "--sparsities", "0.9,0.99"],
    "profile_inference": ["--length", "10", "--top-k", "15", "--out", "{work}/inference"],
    "profile_train": ["--dataset", "gen4", "--size", "base", "--batch", "2", "--seq", "3", "--L1",
                      "1", "--L2", "2", "--repeats", "1", "--policies", "full,dots,none"],
    "roofline_inference": ["--L1", "10", "--L2", "40", "--blocks", "2"],
    "model_info": ["--flops"],
}


def cond_frames(np, cfg, frames):
    """Phase 8's frames with empty and uniform scenes in between
    (``COND_FRAMES``); phase 8's resets go with them."""
    h, w = cfg.dataset.resolution_hw
    rng = np.random.RandomState(10)
    empty = dict(x=np.zeros(0, np.int64), y=np.zeros(0, np.int64), p=np.zeros(0, np.int64),
                 t=np.zeros(0, np.int64))
    out = []
    for f, which in enumerate(COND_FRAMES):
        if which == "empty":
            out.append([empty] * STREAMS)
        elif which == "uniform":
            out.append([synthetic_events(rng, EVENTS_PER_FRAME, h, w, f) for _ in range(STREAMS)])
        else:
            out.append(frames[which])
    return out


def phase_cond_exports(torch, np, work):
    """10a: per configuration of ``COND_EXPORTS``, the live detector over
    the frames with the branch each attention layer took at each frame (a
    spy on the branch methods, which the layer's predicate picks), its
    export, and the artifact run by a fresh process (one ``torch.cond``
    node per layer in the graph it loaded): the same bits as the live
    detector, and in the threshold artifact kernel E launched as often as
    the live detector took the kernel branch."""
    from sast_tpu_torch.export import export_streaming_detector
    from sast_tpu_torch.models.detector import YoloXDetector
    from sast_tpu_torch.models.sast import MaskedSparseAttention
    from sast_tpu_torch.serving import StreamingDetector

    cfg, model, frames, resets = deployment_setup(torch, np)
    inputs = serving_inputs(torch, np, cfg, cond_frames(np, cfg, frames), resets)
    results, live_runs = {}, {}
    for name, (attention, sparse_kernel, first) in COND_EXPORTS.items():
        cfg_p = export_config(cfg, {}, attention)
        model_p = YoloXDetector(cfg_p.model)
        model_p.load_state_dict(model.state_dict())
        det = StreamingDetector(cfg_p, model_p, max_events=EVENTS_PER_FRAME, num_streams=STREAMS,
                                device=DEVICE, sparse_kernel=sparse_kernel, graph=False)
        names = {m: n.removeprefix("backbone.") for n, m in model_p.named_modules()
                 if isinstance(m, MaskedSparseAttention)}
        taken = {n: {} for n in names.values()}
        originals = {b: getattr(MaskedSparseAttention, b) for b in ("masked", "gathered", "kernel")}

        def spy(branch):
            def run(self, *args, **kw):
                taken[names[self]][branch] = taken[names[self]].get(branch, 0) + 1
                return originals[branch](self, *args, **kw)
            return run

        for branch in originals:
            setattr(MaskedSparseAttention, branch, spy(branch))
        reset_counters()
        try:
            live_runs[name] = run_steps(torch, det, inputs)
        finally:
            for branch, fn in originals.items():
                setattr(MaskedSparseAttention, branch, fn)
        live_counts = read_counters()
        one_way = {n: t for n, t in taken.items() if set(t) != {first, "masked"}}
        log(f"cond {name}: branches taken per layer over {len(COND_FRAMES)} frames {taken}")
        if one_way:
            fail(f"cond {name}: layers that did not take both branches: {one_way}")
        t0 = time.perf_counter()
        blob = export_streaming_detector(det, path=str(work / name))
        export_s = time.perf_counter() - t0
        torch.save(list(inputs), work / name / "inputs.pt")
        results[name] = dict(export_s=export_s, artifact_bytes=len(blob), layers=len(names),
                             branches=taken, launches_live=live_counts)
        _MADE[f"artifact_{name}"] = blob  # phase 11b loads it again, captured
        log(f"cond {name}: exported in {export_s:.1f} s, {len(blob)} bytes")
        del det, model_p

    def check(report):
        """The fresh process's runs (``run_fresh``) against the live ones."""
        check_cond_artifacts(torch, report, results, live_runs, work)

    run_fresh("cond", work, list(COND_EXPORTS), check)
    return results


def check_cond_artifacts(torch, report, results, live_runs, work):
    """10a's artifacts as a fresh process ran them (``report``) against the
    live detector's runs: the same bits, one cond node per attention layer,
    kernel E as often as the live detector took its branch."""
    for name, (_, sparse_kernel, first) in COND_EXPORTS.items():
        got = torch.load(work / name / "artifact_outputs.pt", weights_only=True)
        bad = same_bits(torch, (got["outs"], got["states"]), live_runs[name])
        if bad:
            fail(f"cond {name}: the artifact differs from the live detector: {bad[:4]}")
        conds = results[name]["cond_nodes"] = report[name]["cond_nodes"]
        if conds != results[name]["layers"]:
            fail(f"cond {name}: {conds} cond nodes in the loaded graph, "
                 f"{results[name]['layers']} attention layers")
        counts = report[name]["counts"]
        kernel_taken = sum(t.get("kernel", 0) for t in results[name]["branches"].values())
        if counts["stem_conv7x4"] < len(COND_FRAMES) or counts["greedy_keep"] < len(COND_FRAMES) \
                or counts["sparse_window_block"] != kernel_taken \
                or results[name]["launches_live"]["sparse_window_block"] != kernel_taken:
            fail(f"cond {name}: launches inside the artifact {counts}, live "
                 f"{results[name]['launches_live']}; the kernel branch taken {kernel_taken} times")
        results[name]["launches_artifact"] = counts
        log(f"cond {name}: the artifact ({conds} cond nodes) equals the live detector bit for "
            f"bit over {len(COND_FRAMES)} frames; launches inside it "
            f"{ {k: v for k, v in counts.items() if v} }")
    if not results["threshold_0.5"]["launches_artifact"]["sparse_window_block"]:
        fail("cond: kernel E was not launched inside the threshold artifact")


def phase_clis(torch, np, work):
    """10b: each measuring CLI but the loader's (no ``h5py`` here) in this
    process, short, on the card; its JSON lines logged and kept, and the
    kernels' launches during each run."""
    import importlib.util
    import io

    out = {}
    for run, argv in CLI_RUNS.items():
        name = run.removesuffix("_grad")
        spec = importlib.util.spec_from_file_location(f"_cli_{name}",
                                                      ROOT / "scripts" / f"{name}_torch.py")
        cli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cli)
        argv = [a.format(work=work) for a in argv] + ["--device", DEVICE]
        printed = io.StringIO()
        reset_counters()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                cli.main(argv)
        except SystemExit as e:
            fail(f"cli {run}: stopped: {e}\n{printed.getvalue()[-2000:]}")
        torch.cuda.synchronize()
        rows = [json.loads(line) for line in printed.getvalue().splitlines()
                if line.startswith("{")]
        if not rows:
            fail(f"cli {run}: printed no JSON row:\n{printed.getvalue()[-2000:]}")
        # The train CLIs time the captured step, the gather path's choices
        # conditional nodes of its graph.
        if run == "profile_train" and not all(r["captured"] for r in rows):
            fail(f"cli {run}: a policy was not timed captured: {rows}")
        if run == "bench_train_sparsity" and any(
                m != "captured" for r in rows for m in r["modes"].values()):
            fail(f"cli {run}: a path was not timed captured: {[r['modes'] for r in rows]}")
        launches = {k: v for k, v in read_counters().items() if v}
        out[run] = dict(argv=argv, rows=rows, launches=launches,
                        seconds=time.perf_counter() - t0)
        log(f"cli {run} ({out[run]['seconds']:.1f} s; launches {launches}):")
        for line in printed.getvalue().splitlines():
            if not line.startswith('{"metric": "profile_inference_kernel"'):
                log("  " + line[:400])
    return out


def phase_ten(torch, np):
    """Phase 10a: artifacts of the gather and the threshold configuration at
    gen4-base, 4 lanes. Phase 10b, the measuring CLIs, runs in a process of
    its own beside phases 12c-12e (``start_clis``)."""
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="phase10_", dir=OUT_DIR))
    atexit.register(shutil.rmtree, work, True)
    t0 = time.perf_counter()
    res = dict(cond=phase_cond_exports(torch, np, work))
    log(f"phase 10a: gather and threshold artifacts ok ({time.perf_counter() - t0:.1f} s; the "
        f"fresh process that runs them runs beside phase 12)")
    return res


CLI_LIMIT_S = 600  # phase 10b's process, start to end


def start_clis(work):
    """Phase 10b (``phase_clis``) in a process of its own (``chip_smoke.py
    --clis WORK OUT``), on the same card: started before phases 12c-12e,
    so that its short runs overlap them. Its rows, and the step times that
    12c-12e log, are readings of runs side by side on one card, not
    measurements. Returns what ``finish_clis`` takes."""
    out = work / "clis.json"
    printed = open(work / "clis_printed.txt", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--clis", str(work),
                             str(out)], stdout=printed, stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return proc, printed, out, time.perf_counter()


def finish_clis(started):
    """Wait for phase 10b's process (``start_clis``); its result."""
    proc, printed, out, t0 = started
    try:
        proc.wait(timeout=max(CLI_LIMIT_S - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    printed.close()
    text = Path(printed.name).read_text()
    if proc.returncode != 0 or not out.exists():
        fail(f"phase 10b: the CLIs' process ended with {proc.returncode}:\n{text[-3000:]}")
    log(f"phase 10b: measuring CLIs ok in their own process, beside phases 12c-12e "
        f"({time.perf_counter() - t0:.1f} s from its start)")
    return json.loads(out.read_text())


def clis_main(work: str, out: str) -> None:
    """``chip_smoke.py --clis WORK OUT``: phase 10b alone, its result written
    to ``OUT`` as JSON (the kernels are built already)."""
    global _LOG_PREFIX
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    _LOG_PREFIX = "10b: "
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = phase_clis(torch, np, Path(work))
    Path(out).write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# Phase 11: the serving step as captured CUDA graphs.

# name -> (backbone switches, attention switches, sparse_kernel, looped): the
# seven paths of the captured step; the last is two configurations whose
# layers choose their branch on the card.
GRAPH_PATHS = {
    "default": (dict(), dict(), False, False),
    "fusion_off": (dict(fuse_stem_density=False), dict(), False, False),
    "sparse": (dict(), dict(), True, False),
    "looped": (dict(), dict(), True, True),
    "fused": (dict(), dict(fused_block=True), False, False),
    "masked": (dict(stem_pallas=False, ratio_pallas=False, fuse_stem_density=False), dict(),
               False, False),
    "gather_0.5": (dict(), dict(gather_budget=0.5), False, False),
    "threshold_0.5": (dict(), dict(pallas_density_threshold=0.5), True, False),
    "looped_threshold_0.5": (dict(), dict(pallas_density_threshold=0.5), True, True),
}
# The paths whose layers choose their branch on the card: driven over phase
# 10a's frames (empty and uniform scenes between phase 8's), on which every
# choosing layer takes both branches, each replay under the sync debug mode
# "error" (a host read raises) and one launch of one graph.
CHOOSING_PATHS = ("gather_0.5", "threshold_0.5", "looped_threshold_0.5")
# The hand-written kernels (``utils/profiling.HAND_WRITTEN`` labels) that one
# replay must name, by the launch counter that says the path runs them.
GRAPH_KERNEL_LABELS = {"stem_conv7x4": "A stem_conv", "density_ratio": "B density",
                       "greedy_keep": "C nms_keep", "sparse_window_block": "D/E sparse_fwd",
                       "fused_window_block": "D/E sparse_fwd",
                       "sparse_window_block_looped": "F looped"}
GRAPH_ROUNDS = 1  # rounds of eager / captured step times in turns (E C C E each)


def executed_launches(counts, dets):
    """The launches the card ran while the counters in ``counts`` counted:
    the wrappers' counts, less the launches they recorded into the captured
    graphs of ``dets`` (detectors or artifacts), plus those that the graphs'
    replays ran."""
    out = dict(counts)
    for det in dets:
        for step in getattr(det, "steps", None) or [det._step]:
            for k, v in step.run.recorded.items():
                out[k] -= v
            for k, v in step.run.replayed.items():
                out[k] += v
    return out


def choosing_run(torch, det, inputs, quiet):
    """``run_steps`` with the launches the wrappers counted over the frames
    after the first (the captured detector's warm-up and capture) returned
    too; with ``quiet`` those frames run under the sync debug mode "error",
    so that a replay that read the host would raise."""
    det.reset()
    outs = [det.step(*inputs[0])]
    torch.cuda.synchronize()
    reset_counters()
    if quiet:
        torch.cuda.set_sync_debug_mode("error")
    try:
        outs += [det.step(*frame) for frame in inputs[1:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = read_counters()
    states = det.states if getattr(det, "mesh", None) is None else [
        hc for replica in det.states for hc in replica]
    return ([({k: v.cpu() for k, v in d.items()}, p.cpu()) for d, p in outs],
            [t.cpu() for hc in states for t in hc]), counts


@contextlib.contextmanager
def graph_launches():
    """Count, while active, the calls of the conditional-graph library's
    launch entry (``csrc/cond.cu`` ``sast_cond_launch``, one
    ``cudaGraphLaunch`` each): the counter's ``n``."""
    from sast_tpu_torch import graphs

    real = graphs._cond_library
    counter = types.SimpleNamespace(n=0)

    class Counting:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name)

        def sast_cond_launch(self, *args):
            counter.n += 1
            return self.lib.sast_cond_launch(*args)

    graphs._cond_library = lambda device: Counting(real(device))
    try:
        yield counter
    finally:
        graphs._cond_library = real


def one_launch_check(run, replays, launches, what, choosing=True):
    """Fail unless the ``graphs.Captured`` ``run`` replayed ``replays``
    times in ``launches`` graph launches (``graph_launches``), and, where
    ``choosing``, every choice of its graph took both branches by the
    counters on the card; returns the choices' counts."""
    schedule = run.schedule
    taken = schedule.taken.cpu().tolist() if schedule is not None else []
    choices = sum(item[0] == "choose" for item in schedule.items) if schedule else 0
    one_way = [i for i, (a, b) in enumerate(taken[:choices]) if not (a and b)]
    if schedule is None or run.replays != replays or launches != replays \
            or (choosing and (not choices or one_way)):
        fail(f"{what}: {run.replays} replays in {launches} graph launches, {choices} choices; "
             f"choices that took one branch only: {one_way[:8]} (counts {taken[:8]})")
    return taken[:choices]


def param_cast_counter(torch, params):
    """A ``TorchDispatchMode`` that counts, while active, the dtype casts
    whose input lies in the storage of one of ``params`` (its ``n``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    storages = {t.untyped_storage().data_ptr() for t in params}

    class ParamCasts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._to_copy.default and \
                    args[0].untyped_storage().data_ptr() in storages:
                self.n += 1
            return func(*args, **(kwargs or {}))

    return ParamCasts()


def graph_detectors(torch, cfg, model, name, dtype, graphs=(True,)):
    """A ``StreamingDetector`` per entry of ``graphs`` (its ``graph``) on
    ``GRAPH_PATHS[name]`` in ``dtype``, all on one model of their own with
    ``model``'s weights."""
    from sast_tpu_torch.models.detector import YoloXDetector
    from sast_tpu_torch.serving import StreamingDetector

    backbone, attention, sparse_kernel, _ = GRAPH_PATHS[name]
    cfg_p = export_config(cfg, backbone, attention)
    cfg_p = dataclasses.replace(cfg_p, model=dataclasses.replace(cfg_p.model,
                                                                 compute_dtype=dtype))
    model_p = YoloXDetector(cfg_p.model)
    model_p.load_state_dict(model.state_dict())
    return [StreamingDetector(cfg_p, model_p, max_events=EVENTS_PER_FRAME, num_streams=STREAMS,
                              device=DEVICE, sparse_kernel=sparse_kernel, graph=graph)
            for graph in graphs]


def phase_graph_paths(torch, np, cfg, model, frames, inputs, cond_inputs):
    """11a: per path of ``GRAPH_PATHS``, in fp32 (TF32 off) and bf16, the
    captured step against the eager step over the 8 frames: the same bits
    (slates, telemetry, carried states). The choosing paths
    (``CHOOSING_PATHS``) run over ``cond_inputs``; each of their replays is
    one graph launch under the sync debug mode "error", every choice took
    both branches by the counters on the card, and the launches the replays
    ran equal the eager step's over the same frames. In bf16 also: the
    launches the card ran (the wrappers' counts less those recorded at
    capture, plus the replays'), the parameter casts recorded into the
    graphs, the hand-written kernels that one replay's profiler rows name,
    the step times eager and captured in turns (CUDA events), each one's
    card time and idle share, and ``process_batch`` on the host clock."""
    from torch.profiler import ProfilerActivity, profile

    from sast_tpu_torch import graphs
    from sast_tpu_torch.utils.benchmark import looped_kernel
    from sast_tpu_torch.utils.profiling import kernel_table

    no_reset = torch.zeros(STREAMS, dtype=torch.bool, device=DEVICE)
    pk, nk, _ = inputs[0]
    out = {}
    capture = graphs.Schedule.capture
    for name, (_, _, _, looped) in GRAPH_PATHS.items():
        res = out[name] = {}
        choosing = name in CHOOSING_PATHS
        path_inputs = cond_inputs if choosing else inputs
        for dtype in ("float32", "bfloat16"):
            eager, captured = graph_detectors(torch, cfg, model, name, dtype, (False, True))
            mode = param_cast_counter(torch, list(captured.model.parameters()))

            def counting(self, body, mode=mode):
                with mode:
                    return capture(self, body)

            graphs.Schedule.capture = counting
            try:
                with looped_kernel(looped):
                    if choosing:
                        run_e, counts_e = choosing_run(torch, eager, path_inputs, quiet=False)
                        counts_e = {k: v for k, v in counts_e.items() if v}
                        reset_counters()
                        with graph_launches() as launched:
                            run_c, _ = choosing_run(torch, captured, path_inputs, quiet=True)
                    else:
                        run_e = run_steps(torch, eager, path_inputs)
                        reset_counters()
                        run_c = run_steps(torch, captured, path_inputs)
                    counts = read_counters()
            finally:
                graphs.Schedule.capture = capture
            bad = same_bits(torch, run_e, run_c)
            if bad:
                fail(f"graph {name} {dtype}: the captured step differs from the eager step: "
                     f"{bad[:6]}")
            launches = executed_launches(counts, [captured])
            step = captured.steps[0].run
            res[dtype] = dict(launches={k: v for k, v in launches.items() if v},
                              recorded=dict(step.recorded), replayed=dict(+step.replayed),
                              replays=step.replays,
                              graphs=len(step.schedule.items) if step.schedule else 0,
                              param_casts=mode.n)
            if mode.n:
                fail(f"graph {name} {dtype}: {mode.n} parameter casts recorded into the graphs")
            if choosing:
                taken = one_launch_check(step, len(path_inputs) - 1, launched.n,
                                         f"graph {name} {dtype}")
                if res[dtype]["replayed"] != counts_e:
                    fail(f"graph {name} {dtype}: the replays ran {res[dtype]['replayed']}, the "
                         f"eager step over the same frames {counts_e}")
                res[dtype].update(taken=taken, eager_launches=counts_e)
                log(f"graph {name} {dtype}: {len(path_inputs) - 1} replays, one launch each, "
                    f"no host read (sync debug mode error); {len(taken)} choices, each an IF "
                    f"node with an else body, each took both branches (first / second counts "
                    f"on the card {taken}); the replays ran the eager step's launches "
                    f"{counts_e}")
            if dtype == "float32":
                del eager, captured
                torch.cuda.empty_cache()
                continue
            with looped_kernel(looped):
                # One replay's rows must name every hand-written kernel it
                # ran. The profiler's first step is a warm-up, whose rows are
                # dropped: CUPTI's activity records are live before the
                # replay that is read starts (a replay profiled from the
                # profiler's start once went without its first kernel's
                # record, the stem's).
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                              repeat=1)) as prof:
                    captured.step(pk, nk, no_reset)
                    torch.cuda.synchronize()
                    prof.step()
                    before = dict(step.replayed)
                    captured.step(pk, nk, no_reset)
                    torch.cuda.synchronize()
                    prof.step()
                named = kernel_table(prof, steps=1)
                ran = {k for k, v in step.replayed.items() if v > before.get(k, 0)}
                want = {GRAPH_KERNEL_LABELS[k] for k in ran if k in GRAPH_KERNEL_LABELS}
                missing = want - set(named["hand_written"])
                if missing or not want:
                    fail(f"graph {name}: one replay ran {sorted(ran)}, its profiler rows name "
                         f"{sorted(named['hand_written'])}; missing {sorted(missing)}")
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        eager.step(pk, nk, no_reset)
                    torch.cuda.synchronize()
                eager_card = kernel_table(prof, steps=3)
                rounds = {"eager": [], "captured": []}
                for _ in range(GRAPH_ROUNDS):
                    for kind in ("eager", "captured", "captured", "eager"):
                        det = eager if kind == "eager" else captured
                        rounds[kind].append(cuda_ms(torch, lambda: det.step(pk, nk, no_reset),
                                                    iters=20, warmup=3))
                host = {}
                for kind, det in (("eager", eager), ("captured", captured)):
                    det.reset()
                    det.process_batch(frames[0])
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for f in range(1, len(frames)):
                        det.process_batch(frames[f])
                    host[kind] = (time.perf_counter() - t0) / (len(frames) - 1) * 1e3
            ms = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
            res[dtype].update(
                replay_kernels=named["hand_written"], card_ms=named["kernel_ms"],
                eager_card_ms=eager_card["kernel_ms"], step_ms_rounds=rounds, step_ms=ms,
                idle_share=1 - named["kernel_ms"] / ms["captured"],
                eager_idle_share=1 - eager_card["kernel_ms"] / ms["eager"],
                process_batch_ms=host)
            log(f"graph {name}: captured = eager bit for bit in fp32 and bf16 over "
                f"{len(inputs)} frames ({res[dtype]['graphs']} graphs, "
                f"{mode.n} parameter casts recorded); bf16 step ms eager {ms['eager']:.3f} / "
                f"captured {ms['captured']:.3f} (rounds {rounds}); card ms eager "
                f"{eager_card['kernel_ms']:.3f} / captured {named['kernel_ms']:.3f}, idle share "
                f"{res[dtype]['eager_idle_share']:.3f} / {res[dtype]['idle_share']:.3f}; "
                f"process_batch ms {host}; one replay names "
                f"{ {k: round(v, 4) for k, v in named['hand_written'].items()} }; launches run "
                f"{res[dtype]['launches']}")
            del eager, captured
            torch.cuda.empty_cache()
    return out


def phase_graph_deployment(torch, np, cfg, model, inputs, cond_inputs):
    """11b: the captured mesh of two replicas on the one card against its
    eager mesh; a loaded artifact (default path, and the gather and
    threshold configurations whose layers choose on the card, over
    ``cond_inputs``: each replay one graph launch, every choice both
    branches), captured, against the captured live detector, and no
    parameter cast left in its graph or its branches; new weights loaded
    into a captured detector that has stepped, against a fresh detector on
    those weights."""
    from sast_tpu_torch import export
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.serving import StreamingDetector

    res = {}
    meshes = {}
    for graph in (False, True):
        m = copy.deepcopy(model)
        meshes[graph] = StreamingDetector(cfg, m, max_events=EVENTS_PER_FRAME,
                                          num_streams=STREAMS, mesh=MESH, graph=graph)
    bad = same_bits(torch, run_steps(torch, meshes[False], inputs),
                    run_steps(torch, meshes[True], inputs))
    if bad:
        fail(f"graph mesh: the captured mesh differs from the eager mesh: {bad[:6]}")
    res["mesh_replays"] = [s.run.replays for s in meshes[True].steps]
    log(f"graph mesh {MESH}: captured = eager bit for bit over {len(inputs)} frames")
    del meshes
    for name in ("default", "gather_0.5", "threshold_0.5"):
        choosing = name in CHOOSING_PATHS
        name_inputs = cond_inputs if choosing else inputs
        (live,) = graph_detectors(torch, cfg, model, name, "bfloat16")
        with graph_launches() as live_launched:
            live_run = run_steps(torch, live, name_inputs)
        # The artifact of this configuration that phase 8a or 10a exported
        # from the same weights (exported here where those did not run).
        blob, export_s = _MADE.get(f"artifact_{name}"), None
        if blob is None:
            t0 = time.perf_counter()
            blob = export.export_streaming_detector(live)
            export_s = time.perf_counter() - t0
        art = export.ExportedStreamingDetector(blob)
        casts = export.parameter_casts(art.program)
        with graph_launches() as art_launched:
            art_run = run_steps(torch, art, name_inputs)
        bad = same_bits(torch, live_run, art_run)
        if bad:
            fail(f"graph artifact {name}: the captured artifact differs from the captured live "
                 f"detector: {bad[:6]}")
        if choosing:
            for what, run, launched in (("live", live.steps[0].run, live_launched),
                                        ("artifact", art._step.run, art_launched)):
                one_launch_check(run, len(name_inputs) - 1, launched.n,
                                 f"graph artifact {name} {what}")
        if casts:
            fail(f"graph artifact {name}: {casts} parameter casts left in the graph or its "
                 f"branches")
        pk, nk, _ = inputs[0]
        no_reset = torch.zeros(STREAMS, dtype=torch.bool, device=DEVICE)
        turns = [cuda_ms(torch, lambda d=d: d.step(pk, nk, no_reset), iters=20, warmup=3)
                 for d in (live, art, art, live)]
        res[f"artifact_{name}"] = dict(export_s=export_s, bytes=len(blob), parameter_casts=casts,
                                       cond_nodes=len(art.cond_nodes),
                                       graphs=len(art._step.run.schedule.items)
                                       if art._step.run.schedule else 0,
                                       live_ms_turns=[turns[0], turns[3]],
                                       artifact_ms_turns=turns[1:3])
        log(f"graph artifact {name}: captured artifact = captured live detector bit for bit "
            f"({res[f'artifact_{name}']})")
        del live, art, blob
        torch.cuda.empty_cache()
    (det,) = graph_detectors(torch, cfg, model, "default", "bfloat16")
    run_steps(torch, det, inputs[:3])
    schedule = det.steps[0].run.schedule
    other = stand_in_trained(torch, build_detector(cfg.model, seed=1, device="cpu"))
    det.model.load_state_dict(other.state_dict())
    got = run_steps(torch, det, inputs)
    (fresh,) = graph_detectors(torch, cfg, other, "default", "bfloat16")
    bad = same_bits(torch, got, run_steps(torch, fresh, inputs))
    if bad:
        fail(f"graph weights: a captured detector given new weights differs from a fresh one: "
             f"{bad[:6]}")
    res["new_weights_recaptured"] = det.steps[0].run.schedule is not schedule
    log(f"graph weights: new weights loaded after capture = a fresh detector, bit for bit "
        f"(captured again: {res['new_weights_recaptured']})")
    return res


def phase_eleven(torch, np):
    """Phase 11: the serving step as captured CUDA graphs at gen4-base, 4
    lanes, phase 8's weights and frames."""
    cfg, model, frames, resets = deployment_setup(torch, np)
    inputs = serving_inputs(torch, np, cfg, frames, resets)
    cond_inputs = serving_inputs(torch, np, cfg, cond_frames(np, cfg, frames), resets)
    t0 = time.perf_counter()
    res = dict(paths=phase_graph_paths(torch, np, cfg, model, frames, inputs, cond_inputs))
    log(f"phase 11a: captured paths ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    res["deployment"] = phase_graph_deployment(torch, np, cfg, model, inputs, cond_inputs)
    log(f"phase 11b: captured mesh, artifacts and new weights ok "
        f"({time.perf_counter() - t0:.1f} s)")
    return res


# ---------------------------------------------------------------------------
# Phase 12: train and validate as JAX's jitted and donated steps do.

TRAIN_GRAPH_STEPS = 4  # fit steps of each captured-against-eager run (12a)
GRAPH_TURN_STEPS = 3  # train steps per timing turn (12a), E C
# path -> (sparse_kernel_eval, kernel F, attention switches, backbone switches)
EVAL_GRAPH_PATHS = {"default": (False, False, {}, {}), "sparse": (True, False, {}, {}),
                    "looped": (True, True, {}, {}), "fused": (False, False, {"fused_block": True}, {}),
                    "fusion_off": (False, False, {}, {"fuse_stem_density": False}),
                    "gather_0.5": (False, False, {"gather_budget": 0.5}, {}),
                    "threshold_0.5": (True, False, {"pallas_density_threshold": 0.5}, {})}
EVAL_GRAPH_BATCHES = 3
CACHE_GRAPH_STEPS = 3
REGULARIZED_GRAPH_STEPS = 3


def captured_launches(counts, runs):
    """The launches the card ran while ``counts`` counted: the wrappers'
    counts, less those recorded into the graphs of ``runs``
    (``graphs.Captured``), plus those their replays ran."""
    out = dict(counts)
    for run in runs:
        for k, v in run.recorded.items():
            out[k] -= v
        for k, v in run.replayed.items():
            out[k] += v
    return {k: v for k, v in out.items() if v}


def trainer_runs(trainer):
    """The ``graphs.Captured`` of a trainer's train step and eval steps."""
    runs = [trainer._train.run] if trainer._train.run is not None else []
    return runs + [e.run for e in trainer._evals.values() if e.run is not None]


def written_state(torch, run):
    """Copies on the card of all that the train step ``run`` (a
    ``CapturedTrainStep``) writes: parameters and BatchNorm statistics, the
    EMA copy, the optimizer's count and moments, the carried LSTM states."""
    state = run.state
    out = list(state.model.state_dict().values())
    out += list((state.ema_params or {}).values())
    out += state.optimizer.tensors()
    out += [t for hc in run.states for t in hc]
    return [t.detach().clone() for t in out]


def eager_twin(torch, trainer, mesh=None):
    """The eager train step (what ``Trainer(graph=False)`` runs) on a copy of
    ``trainer``'s model, its optimizer and EMA copy fresh from the same
    weights as a new trainer's are: the same start without a second random
    initialisation. Made before ``trainer`` steps."""
    from sast_tpu_torch.models.detector import YoloXDetector
    from sast_tpu_torch.training.steps import CapturedTrainStep, make_train_step, train_state_for

    cfg = trainer.cfg
    model = YoloXDetector(cfg.model, sparse_kernel=trainer.sparse_kernel_train)
    model = model.to(trainer.device).eval()
    model.load_state_dict(trainer.model.state_dict())
    return CapturedTrainStep({"train": make_train_step(model, cfg, mesh)},
                             train_state_for(model, cfg), cfg, trainer.device, graph=False)


def step_metrics(run, batches):
    """``run`` over ``batches``: each step's metrics as floats."""
    from sast_tpu_torch.data.batch import split_device_batch

    return [{k: float(v) for k, v in run(split_device_batch(b)[0]).items()} for b in batches]


@contextlib.contextmanager
def timed_captures(times):
    """``graphs.Schedule.capture`` with the host seconds of each capture
    (warm-ups excluded) appended to ``times``."""
    from sast_tpu_torch import graphs

    capture = graphs.Schedule.capture

    def timed(self, body):
        t0 = time.perf_counter()
        try:
            return capture(self, body)
        finally:
            times.append(time.perf_counter() - t0)

    graphs.Schedule.capture = timed
    try:
        yield
    finally:
        graphs.Schedule.capture = capture


def step_times(torch, fn, steps):
    """ms per call of ``fn`` over ``steps`` calls after one: between two
    CUDA events, and on the host clock to the card's end."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps, (time.perf_counter() - t0) / steps * 1e3


def graph_train_batches(torch, np, cfg):
    """Phase 5's batches (``training_batches``), the clustered ones, which
    come at the dataset's resolution, padded to the model's as the step's
    padder pads (zeros below and to the right), so that every batch has one
    shape and the step is captured once."""
    C = cfg.model.backbone.input_channels
    H, W = cfg.model.backbone.in_res_hw
    out = []
    for b in training_batches(torch, np, cfg)[:TRAIN_GRAPH_STEPS]:
        T, B, h, wc = b["ev_repr"].shape
        ev = b["ev_repr"].reshape(T, B, h, wc // C, C)
        ev = np.pad(ev, ((0, 0), (0, 0), (0, H - h), (0, W - wc // C), (0, 0)))
        out.append(dict(b, ev_repr=ev.reshape(T, B, H, W * C)))
    return out


# name -> sparse_kernel, attention switches: the paths of 12a; the last two
# choose their branch on the card, forward and backward.
TRAIN_GRAPH_PATHS = (("sparse", True, {}), ("masked", False, {}),
                     ("gather_0.5", False, {"gather_budget": 0.5}),
                     ("threshold_0.5", True, {"pallas_density_threshold": 0.5}))


def choosing_train_batches(np, batches):
    """The batches of a choosing configuration's 12a run: phase 5's first
    two, each after a copy of it without events (few windows kept: every
    choice's first branch), so that the three replays take the second
    branch, the first and the second again at every choice."""
    first, second = batches[0], batches[1]
    return [dict(first, ev_repr=np.zeros_like(first["ev_repr"])), first,
            dict(second, ev_repr=np.zeros_like(second["ev_repr"])), second]


@contextlib.contextmanager
def branch_forwards():
    """The forward calls of the attention layers' branch functions
    (``masked``, ``gathered``, ``kernel`` of ``models/sast.
    MaskedSparseAttention``) made while a ``graphs.Schedule`` captured, by
    the graph they were captured into (the ``id`` of its
    ``torch.cuda.CUDAGraph``)."""
    from sast_tpu_torch import graphs
    from sast_tpu_torch.models.sast import MaskedSparseAttention

    counts = collections.Counter()
    saved = {n: getattr(MaskedSparseAttention, n) for n in ("masked", "gathered", "kernel")}

    def spy(orig):
        def branch(self, *args, **kw):
            schedule = graphs._active.schedule
            if schedule is not None and not schedule.warming:
                counts[id(schedule._graph)] += 1
            return orig(self, *args, **kw)
        return branch

    for n, fn in saved.items():
        setattr(MaskedSparseAttention, n, spy(fn))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(MaskedSparseAttention, n, fn)


def replayed_branch_forwards(schedule, counts):
    """The branch forwards a replay of ``schedule`` ran, on average: each
    graph's captured calls (``branch_forwards``) times the replays that ran
    it (a segment every replay, a branch as often as the card took it)."""
    taken = schedule.taken.tolist()
    total, i = 0, 0
    for item in schedule.items:
        if item[0] == "run":
            total += counts[id(item[1])] * schedule.replays
            continue
        total += sum(counts[id(graph)] * n for (graph, _), n in zip(item[2:4], taken[i]))
        i += 1
    return total / schedule.replays


def phase_graph_train(torch, np, card, work, batches, eager_card=None):
    """12a: ``fit`` over 4 steps at gen4-base (B 12, T 5, L 3, remat full) on
    the sparse-kernel path (A, E, G, H), the masked path and the two
    configurations whose layers choose on the card (``TRAIN_GRAPH_PATHS``;
    their batches from ``choosing_train_batches``, each replay one graph
    launch, every choice both branches by the counters on the card, and at
    most two branch forwards a replay per layer and timestep, the forward's
    and the recomputation's: ``branch_forwards``), in
    fp32 and bf16, captured (``graph=True``) against eager, from one seed
    and the same batches, cuDNN and torch in their deterministic modes:
    every logged metric and all that the step writes (parameters, BatchNorm
    statistics, EMA copy, optimizer count and moments, LSTM states) bit for
    bit. Then, bf16, in the default modes: a fresh eager and a fresh
    captured trainer's first step (capture seconds, peak memory), ms/step in
    turns E C (CUDA events and host clock), the card's kernel time of one
    step each (``torch.profiler``; the eager step's from phase 5's profile
    of the same step where ``eager_card`` holds it, by path), the idle
    share, the FLOPs of one eager step (``flop_count``); each choosing
    configuration's eager
    peak within 0.3 GiB of the path it chooses against (masked for gather,
    sparse for threshold), and the gather step's FLOPs at most 1.01 times
    the masked one's; after more captured steps, the trainer's captured eval
    step against a fresh model holding the trained weights (a replay writes
    the weights without moving their versions)."""
    from torch.profiler import ProfilerActivity, profile

    from sast_tpu_torch import graphs
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import split_device_batch, to_device
    from sast_tpu_torch.models.detector import YoloXDetector
    from sast_tpu_torch.models.sast import MaskedSparseAttention
    from sast_tpu_torch.training.loop import Trainer
    from sast_tpu_torch.training.steps import CapturedEvalStep, make_eval_step
    from sast_tpu_torch.utils.profiling import kernel_table

    res, launches = {}, {}
    for name, sparse, attention in TRAIN_GRAPH_PATHS:
        base = export_config(get_config("gen4", "base"), {}, attention)
        choosing = bool(attention)
        path_batches = choosing_train_batches(np, batches) if choosing else batches
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, model=dataclasses.replace(base.model,
                                                                      compute_dtype=dtype))
            trainer = Trainer(cfg, str(work / f"train_{name}_{dtype}"), sparse_kernel_train=sparse,
                              device=DEVICE)
            twin = eager_twin(torch, trainer)
            with deterministic(torch):
                rows_e = step_metrics(twin, path_batches)
                state_e = written_state(torch, twin)
                del twin
                torch.cuda.empty_cache()
                reset_counters()
                with graph_launches() as launched, branch_forwards() as captured_forwards:
                    rows_c = step_metrics(trainer._train, path_batches)
            torch.cuda.synchronize()
            counts = read_counters()
            state_c = written_state(torch, trainer._train)
            run = trainer._train.run
            if run.replays != TRAIN_GRAPH_STEPS - 1:
                fail(f"graph train {name} {dtype}: {run.replays} replays")
            taken = one_launch_check(run, TRAIN_GRAPH_STEPS - 1, launched.n,
                                     f"graph train {name} {dtype}", choosing)
            if choosing:
                # The branches' forwards per layer and timestep of a replay:
                # the forward's and the recomputation's, none in a backward.
                layers = sum(isinstance(m, MaskedSparseAttention) for m in trainer.model.modules())
                T = path_batches[0]["ev_repr"].shape[0]
                forwards = (replayed_branch_forwards(run.schedule, captured_forwards)
                            if run.schedule is not None else 0.0)
                forwards_per = forwards / (layers * T)
                if forwards_per > 2:
                    fail(f"graph train {name} {dtype}: a replay runs {forwards_per} branch forwards "
                         f"per layer and timestep (more than the forward's and the "
                         f"recomputation's)")
            for k, v in captured_launches(counts, [run]).items():
                launches[k] = launches.get(k, 0) + v
            replayed = dict(+run.replayed)
            del trainer, run
            torch.cuda.empty_cache()
            bad = [i for i, (a, b) in enumerate(zip(state_e, state_c)) if not torch.equal(a, b)]
            if rows_e != rows_c or bad or len(state_e) != len(state_c):
                apart = sorted({k for a, b in zip(rows_e, rows_c) for k in a if a[k] != b.get(k)})
                fail(f"graph train {name} {dtype}: captured differs from eager: metrics "
                     f"{apart}, tensors {bad[:8]} of {len(state_e)}")
            if sparse and not all(replayed.get(k) for k in
                                  ("stem_conv7x4", "sparse_window_block", "sparse_block_mlp_bwd",
                                   "sparse_block_attn_bwd")):
                fail(f"graph train {name} {dtype}: the replays ran {replayed}")
            res[f"{name}_{dtype}"] = dict(losses=[r["loss"] for r in rows_c],
                                          replayed=replayed, tensors=len(state_c),
                                          graph_launches=launched.n)
            if choosing:
                res[f"{name}_{dtype}"].update(choices=len(taken),
                                              first_taken=sum(t[0] for t in taken),
                                              second_taken=sum(t[1] for t in taken),
                                              branch_forwards_per_replay=forwards,
                                              branch_forwards_per_layer_timestep=forwards_per)
            log(f"graph train {name} {dtype}: captured = eager bit for bit over "
                f"{TRAIN_GRAPH_STEPS} steps ({len(state_c)} tensors, every metric; losses "
                f"{[round(r['loss'], 5) for r in rows_c]}); the replays ran {replayed}"
                + (f"; one launch a replay, {len(taken)} choices (forward, recomputation and "
                   f"backward), each both branches on the card; {forwards} branch forwards a "
                   f"replay, {forwards_per} per layer and timestep" if choosing else ""))
            del state_e, state_c
            torch.cuda.empty_cache()

        # Timing, bf16, the default modes: a fresh trainer and its eager twin.
        dev_batch = to_device(split_device_batch(batches[-1])[0], DEVICE)
        trainer = Trainer(base, str(work / f"time_{name}"), sparse_kernel_train=sparse,
                          device=DEVICE)
        steps = {False: eager_twin(torch, trainer), True: trainer._train}
        peak, capture_s = {}, []
        for graph in (False, True):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # Above what was allocated before the first step (the models,
            # the batch): gradients, optimizer, buffers, activations, pool.
            before = torch.cuda.memory_allocated()
            with timed_captures(capture_s) if graph else contextlib.nullcontext():
                t0 = time.perf_counter()
                steps[graph](dev_batch)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            steps[graph](dev_batch)
            torch.cuda.synchronize()
            peak[graph] = dict(allocated=torch.cuda.max_memory_allocated() - before,
                               reserved=torch.cuda.max_memory_reserved(), first_step_s=first_s)
        # One turn each (E C): the eager step's time follows the host's pace.
        turns = {False: [], True: []}
        for graph in (False, True):
            turns[graph].append(step_times(torch, lambda r=steps[graph]: r(dev_batch),
                                           GRAPH_TURN_STEPS))
        # The card time of one step of each (the eager one from phase 5's
        # profile where it has it; the card's activity only, as there), and
        # the FLOPs of one more eager step, unprofiled (the kernels'
        # operators count as their plain versions at full window density).
        busy = {}
        for graph in (False, True):
            if not graph and eager_card and name in eager_card:
                busy[graph] = dict(kernel_ms=eager_card[name]["card_ms"],
                                   hand_written=eager_card[name]["hand_written_kernels_ms"])
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                steps[graph](dev_batch)
                torch.cuda.synchronize()
            busy[graph] = kernel_table(prof)
        with flop_count(torch) as flops:
            steps[False](dev_batch)
        timing = {}
        for graph, kind in ((False, "eager"), (True, "captured")):
            ev = sorted(t[0] for t in turns[graph])
            host = sorted(t[1] for t in turns[graph])
            timing[kind] = dict(
                event_ms=[t[0] for t in turns[graph]], host_ms=[t[1] for t in turns[graph]],
                event_ms_mean=sum(ev) / len(ev), host_ms_mean=sum(host) / len(host),
                card_ms=busy[graph]["kernel_ms"], hand_written_ms=busy[graph]["hand_written"],
                idle_share=1 - busy[graph]["kernel_ms"] / (sum(ev) / len(ev)),
                peak_allocated_gib=peak[graph]["allocated"] / 2 ** 30,
                peak_reserved_gib=peak[graph]["reserved"] / 2 ** 30,
                first_step_s=peak[graph]["first_step_s"])
        timing["capture_s"] = capture_s
        timing["eager_tflop"] = flops.total / 1e12
        res[f"{name}_timing"] = timing
        log(f"graph train {name} bf16 on {card}: ms/step eager "
            f"{[round(t[0], 3) for t in turns[False]]} (host {[round(t[1], 3) for t in turns[False]]})"
            f", captured {[round(t[0], 3) for t in turns[True]]} (host "
            f"{[round(t[1], 3) for t in turns[True]]}); card ms eager "
            f"{busy[False]['kernel_ms']:.3f}{' (phase 5)' if eager_card and name in eager_card else ''} / captured "
            f"{busy[True]['kernel_ms']:.3f}, idle share "
            f"{timing['eager']['idle_share']:.3f} / {timing['captured']['idle_share']:.3f}; peak "
            f"allocated above the first step's start, GiB {timing['eager']['peak_allocated_gib']:.3f} / "
            f"{timing['captured']['peak_allocated_gib']:.3f} (reserved "
            f"{timing['eager']['peak_reserved_gib']:.3f} / "
            f"{timing['captured']['peak_reserved_gib']:.3f}); capture {capture_s} s, first step "
            f"eager {peak[False]['first_step_s']:.3f} s / captured {peak[True]['first_step_s']:.3f} s"
            f"; {timing['eager_tflop']:.4f} TFLOP an eager step")
        if name == "sparse":
            # Item 4's trap: the eval step captured, then captured train
            # steps, then the eval step replayed: a fresh model's bits.
            eval_batch = split_device_batch(batches[0])[0]
            run = trainer._eval_run()
            run(eval_batch)
            run(eval_batch)
            before = trainer._train.run.replays
            for b in batches[1:3]:
                trainer._train(split_device_batch(b)[0])
            run.zero_states()
            got = {k: v.clone() for k, v in run(eval_batch).items()}
            fresh = YoloXDetector(base.model, sparse_kernel=True).to(DEVICE)
            fresh.load_state_dict(trainer.model.state_dict())
            ref_run = CapturedEvalStep({"eval": make_eval_step(fresh, base)}, fresh, base,
                                       DEVICE, graph=False)
            want = ref_run(eval_batch)
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            bad += [f"state {i}" for i, (a, b) in enumerate(zip(
                [t for hc in run.states for t in hc], [t for hc in ref_run.states for t in hc]))
                if not torch.equal(a, b)]
            if bad or trainer._train.run.replays != before + 2 or run.run.replays != 2:
                fail(f"graph eval after captured train steps differs from a fresh model: {bad}")
            res["eval_after_train"] = dict(train_replays=trainer._train.run.replays,
                                           eval_replays=run.run.replays)
            log(f"graph eval after 2 captured train steps = a fresh model on the trained "
                f"weights, bit for bit (bf16; the eval step captured before them)")
            del fresh, ref_run, run
        del steps, trainer
        torch.cuda.empty_cache()
    # Each choosing configuration beside the path it chooses against: what
    # its forward keeps for the backward is the taken branch's residuals of
    # one timestep, as on that path, so its eager peak stays within 0.3 GiB
    # of that path's; a gather step computes no more than the masked one.
    for chooser, plain in (("gather_0.5", "masked"), ("threshold_0.5", "sparse")):
        a, b = res[f"{chooser}_timing"], res[f"{plain}_timing"]
        beside = {f"{kind}_peak_gib": [a[kind]["peak_allocated_gib"], b[kind]["peak_allocated_gib"]]
                  for kind in ("eager", "captured")}
        beside["eager_tflop"] = [a["eager_tflop"], b["eager_tflop"]]
        beside["card_ms"] = {kind: [a[kind]["card_ms"], b[kind]["card_ms"]]
                             for kind in ("eager", "captured")}
        res[f"{chooser}_beside_{plain}"] = beside
        log(f"graph train {chooser} beside {plain} (bf16 on {card}): {beside}")
        if beside["eager_peak_gib"][0] > beside["eager_peak_gib"][1] + 0.3:
            fail(f"graph train {chooser}: the eager step's peak, {beside['eager_peak_gib'][0]:.3f} "
                 f"GiB above its start, exceeds the {plain} path's "
                 f"{beside['eager_peak_gib'][1]:.3f} by more than 0.3 GiB")
        if chooser == "gather_0.5" and beside["eager_tflop"][0] > 1.01 * beside["eager_tflop"][1]:
            fail(f"graph train {chooser}: {beside['eager_tflop'][0]:.4f} TFLOP an eager step "
                 f"against the masked path's {beside['eager_tflop'][1]:.4f}")
    res["launches"] = launches
    return res


def phase_graph_eval(torch, np, card, batches):
    """12b: the eval step at gen4-base (B 12, T 5, L 3, bf16) on the default,
    sparse, looped and fused paths, with the stem's density fusion off
    (kernel B) and on the two configurations whose layers choose on the
    card, captured against eager over 3 batches with the LSTM states
    carried: detections and states bit for bit, each replay one graph
    launch; ms per batch in turns E C C E (CUDA events)."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import split_device_batch
    from sast_tpu_torch.models.detector import YoloXDetector, build_detector
    from sast_tpu_torch.training.steps import CapturedEvalStep, make_eval_step
    from sast_tpu_torch.utils.benchmark import looped_kernel

    base = get_config("gen4", "base")
    batches = [split_device_batch(b)[0] for b in batches[-EVAL_GRAPH_BATCHES:]]
    weights = build_detector(base.model, seed=0, device=DEVICE).state_dict()
    res, launches = {}, {}
    for name, (sparse, looped, attention, backbone) in EVAL_GRAPH_PATHS.items():
        cfg = export_config(base, backbone, attention)
        model = YoloXDetector(cfg.model, sparse_kernel=sparse).to(DEVICE).eval()
        model.load_state_dict(weights)
        fns = {"eval": make_eval_step(model, cfg)}
        runs = {g: CapturedEvalStep(fns, model, cfg, DEVICE, graph=g) for g in (False, True)}
        with looped_kernel(looped):
            outs = {}
            for graph, run in runs.items():
                reset_counters()
                with graph_launches() as launched:
                    outs[graph] = [{k: v.clone() for k, v in run(b).items()} for b in batches]
                counts = read_counters()
                outs[graph].append([t.clone() for hc in run.states for t in hc])
            bad = [i for i, (a, b) in enumerate(zip(outs[False], outs[True]))
                   if not all(torch.equal(x, y) for x, y in
                              (zip(a, b) if isinstance(a, list) else ((a[k], b[k]) for k in a)))]
            if bad:
                fail(f"graph eval {name}: captured differs from eager at {bad}")
            one_launch_check(runs[True].run, len(batches) - 1, launched.n, f"graph eval {name}",
                             choosing=False)
            for k, v in captured_launches(counts, [runs[True].run]).items():
                launches[k] = launches.get(k, 0) + v
            turns = {False: [], True: []}
            for graph in (False, True, True, False):
                turns[graph].append(cuda_ms(torch, lambda r=runs[graph]: r(batches[0]), iters=5,
                                            warmup=1))
        res[name] = dict(eager_ms=turns[False], captured_ms=turns[True],
                         replayed=dict(runs[True].run.replayed),
                         graphs=len(runs[True].run.schedule.items) if runs[True].run.schedule
                         else 0)
        log(f"graph eval {name}: captured = eager bit for bit over {len(batches)} batches "
            f"(detections, carried states); ms per batch (B 12) eager "
            f"{[round(v, 3) for v in turns[False]]}, captured "
            f"{[round(v, 3) for v in turns[True]]}; the replays ran {res[name]['replayed']}")
        del runs, model, fns, outs
        torch.cuda.empty_cache()
    del weights
    res["launches"] = launches
    return res


def phase_graph_fit(torch, np, card, work):
    """12c: phase 6's configuration (gen4-base B 4, T 5, L 3, bf16, EMA
    0.999, in-memory clips through ``assemble_batch`` and ``Prefetcher``)
    with ``fit`` captured: validation every 2 steps over 4 (the eval step
    captured), a trace of steps 3-4 holding their ``train_step`` ranges and
    kernel E's launches from the replays; then a fresh trainer restored from
    the step-2 checkpoint and fit over steps 3-4 (the third batch starts
    every lane), bit-equal to the uninterrupted run (both in the
    deterministic modes)."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.batch import Prefetcher, assemble_batch
    from sast_tpu_torch.training.loop import Trainer

    cfg = get_config("gen4", "base", **{"training.ema_decay": 0.999})
    L, G = cfg.training.max_labeled_frames_per_lane, cfg.model.head.max_gt
    train_clips, eval_clips = fit_clips(np, cfg)
    train_clips = [[dict(c, is_first=s in (0, 2)) for c in clips]
                   for s, clips in enumerate(train_clips[:FIT_STEPS])]

    def batches(clips):
        return Prefetcher(assemble_batch(c, L, G) for c in clips)

    whole = Trainer(cfg, str(work / "fit"), log_every=1, val_every=FIT_VAL_EVERY,
                    sparse_kernel_train=True, sparse_kernel_eval=True, device=DEVICE)
    reset_counters()
    t0 = time.perf_counter()
    with deterministic(torch):
        metrics = whole.fit(batches(train_clips), eval_loader_fn=lambda: batches(eval_clips),
                            max_steps=FIT_STEPS, eval_max_batches=FIT_EVAL_BATCHES,
                            profile_steps=(3, 4))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counters()
    launches = captured_launches(counts, trainer_runs(whole))
    rows = [json.loads(line) for line in (work / "fit" / "metrics.jsonl").read_text().splitlines()]
    val_steps = [r["step"] for r in rows if "val/AP" in r]
    val = {k for k in metrics if k.startswith("val/")}
    evals = list(whole._evals.values())
    if (val_steps != [2, 4] or val != VAL_KEYS or whole._train.run.replays != FIT_STEPS - 1
            or len(evals) != 1 or evals[0].run.replays != 2 * FIT_EVAL_BATCHES - 1):
        fail(f"graph fit: validations at {val_steps}, keys {sorted(val)}, train replays "
             f"{whole._train.run.replays}, eval steps {len(evals)}")
    files = sorted((work / "fit" / "trace").glob("*.pt.trace.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
    steps = sorted({int(e["name"].split()[1]) for e in events
                    if str(e.get("name", "")).startswith("train_step ")})
    e_launches = sum(1 for e in events if e.get("cat") == "kernel" and "sf::" in e.get("name", ""))
    shutil.rmtree(work / "fit" / "trace", ignore_errors=True)
    if steps != [3, 4] or not e_launches:
        fail(f"graph fit: the trace holds steps {steps} and {e_launches} launches of kernel E")
    resumed = Trainer(cfg, str(work / "resumed"), log_every=1, sparse_kernel_train=True,
                      sparse_kernel_eval=True, device=DEVICE)
    whole.ckpt.restore(resumed.state, step=2)
    with deterministic(torch):
        resumed.fit(batches(train_clips[2:]), max_steps=FIT_STEPS)
    bad = _states_differ(torch, whole.state, resumed.state)
    if bad or resumed._train.run.replays != 1:
        fail(f"graph fit: the resumed run differs from the uninterrupted one in {bad[:6]}")
    res = dict(fit_s=fit_s, metrics={k: v for k, v in metrics.items() if k.startswith("val/")},
               step_time_s=[r["train/step_time_s"] for r in rows if "train/step_time_s" in r],
               trace_steps=steps, kernel_e_in_trace=e_launches, launches=launches)
    log(f"graph fit: {FIT_STEPS} captured steps with validations at {val_steps} (captured eval "
        f"step, {evals[0].run.replays} replays) in {fit_s:.1f} s, step times "
        f"{[round(v * 1e3, 1) for v in res['step_time_s']]} ms (host clock between log points, "
        f"batches assembled inside); trace of steps {steps} with {e_launches} launches of kernel "
        f"E; a resume from step 2 = the uninterrupted run, bit for bit; launches {launches}")
    del whole, resumed
    torch.cuda.empty_cache()
    return res


def phase_graph_cache(torch, np, card, work):
    """12d: phase 7c's in-memory sequences behind the card-resident cache,
    each clip gathered straight into the captured step's ``ev_repr`` buffer
    from the second batch on, against the host ``DataModule``'s batches
    uploaded through the step's page-locked staging: 3 captured steps each
    in the deterministic modes, bit for bit; host ms per step of each."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.device_cache import DeviceCachedTrainStream
    from sast_tpu_torch.data.module import DataModule
    from sast_tpu_torch.training.loop import Trainer

    cfg = get_config("gen4", "base", **{
        "training.batch_size_train": 4, "dataset.data_augmentation_stream.zoom.prob": 0.0,
        "dataset.train_sampling": "stream"})
    readers = cache_readers(np, cfg)
    stream = DeviceCachedTrainStream(cfg, seed=5, device=DEVICE, readers=readers)
    seen, step_s = [], {}

    class Fed:
        """The stream, its batches' storage recorded."""

        def __iter__(self):
            for batch in stream:
                seen.append(batch["ev_repr"].data_ptr())
                yield batch

        def gather_into(self, buffer):
            stream.gather_into(buffer)

    trainers = {}
    for name, source in (("cache", Fed()),
                         ("host", DataModule(cfg, readers={"train": readers}).train_batches(
                             seed=5, prefetch=False))):
        trainer = Trainer(cfg, str(work / f"cache_{name}"), log_every=1, sparse_kernel_train=True,
                          device=DEVICE)
        with deterministic(torch):
            trainer.fit(source, max_steps=CACHE_GRAPH_STEPS)
        rows = [json.loads(line) for line in
                (work / f"cache_{name}" / "metrics.jsonl").read_text().splitlines()]
        step_s[name] = [r["train/step_time_s"] * 1e3 for r in rows]
        trainers[name] = trainer
    buffer = trainers["cache"]._train.buffers.tensors["ev_repr"].data_ptr()
    bad = _states_differ(torch, trainers["cache"].state, trainers["host"].state)
    if bad or seen[0] == buffer or seen[1:CACHE_GRAPH_STEPS] != [buffer] * (CACHE_GRAPH_STEPS - 1):
        fail(f"graph cache: differs from the host's batches in {bad[:6]}; gathered into the "
             f"buffer: {[p == buffer for p in seen]}")
    log(f"graph cache: {CACHE_GRAPH_STEPS} captured steps fed by the cache, each clip after the "
        f"first gathered into the step's ev_repr buffer, = the host's batches bit for bit; host "
        f"ms per step (between log points) cache {[round(v, 1) for v in step_s['cache']]}, host "
        f"{[round(v, 1) for v in step_s['host']]}")
    del trainers, stream
    torch.cuda.empty_cache()
    return dict(step_ms=step_s, bytes_resident=None)


def phase_graph_world(torch, np, card, work):
    """12e: every regularizer rate at 0.1 (gen4-base, B 12, bf16; the masked
    path, masks hashed on the card from the count there), captured against
    eager over 3 steps; a world of one over NCCL (phase 7a's configuration),
    captured (the gradient buckets' and the metrics' all-reduces inside the
    graph) against eager: bit for bit, cuDNN and torch in their
    deterministic modes."""
    import torch.distributed as dist

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.parallel.mesh import make_mesh
    from sast_tpu_torch.training.loop import Trainer

    res = {}
    cfg = with_rates(get_config("gen4", "base"), 0.1)
    rng = np.random.RandomState(22)
    batches = [synthetic_train_batch(cfg, rng, sparsity=0.9)
               for _ in range(REGULARIZED_GRAPH_STEPS)]

    def captured_against_eager(trainer, batches, mesh=None):
        """The trainer's captured steps against its eager twin's over
        ``batches`` in the deterministic modes: (metrics, state) bit for
        bit, and the replays."""
        twin = eager_twin(torch, trainer, mesh)
        with deterministic(torch):
            rows_e = step_metrics(twin, batches)
            state_e = written_state(torch, twin)
            del twin
            rows_c = step_metrics(trainer._train, batches)
        state_c = written_state(torch, trainer._train)
        bad = [i for i, (a, b) in enumerate(zip(state_e, state_c)) if not torch.equal(a, b)]
        return rows_e == rows_c and not bad, bad, rows_c, trainer._train.run.replays

    trainer = Trainer(cfg, str(work / "rates"), sparse_kernel_train=True, device=DEVICE)
    same, bad, rows, replays = captured_against_eager(trainer, batches)
    del trainer
    torch.cuda.empty_cache()
    if not same or replays != REGULARIZED_GRAPH_STEPS - 1:
        fail(f"graph regularizers: captured differs from eager in tensors {bad[:6]}, metrics "
             f"or replays {replays}")
    res["regularized_losses"] = [r["loss"] for r in rows]
    log(f"graph regularizers: every rate 0.1, captured = eager bit for bit over "
        f"{REGULARIZED_GRAPH_STEPS} steps (losses {[round(v, 5) for v in res['regularized_losses']]})")

    cfg = dp_config()
    card0 = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)
    backend = "nccl" if card0.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, **({"device_id": card0} if backend == "nccl" else {}))
    try:
        mesh = make_mesh(card0)
        trainer = Trainer(cfg, str(work / "nccl"), sparse_kernel_train=True, device=DEVICE,
                          mesh=mesh)
        same, bad, rows, replays = captured_against_eager(trainer, dp_batches(np, cfg), mesh)
        del trainer
        torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if not same or replays != DP_STEPS - 1:
        fail(f"graph nccl: the captured world of one differs from eager in tensors {bad[:6]}, "
             f"metrics or replays {replays}")
    log(f"graph nccl: a world of one over {backend}, captured (all-reduces inside the graph) = "
        f"eager bit for bit over {DP_STEPS} steps")
    res["nccl_world_of_one"] = dict(steps=DP_STEPS, replays=replays)
    return res


def phase_twelve(torch, np, card, eager_card=None):
    """Phase 12: train and validate as JAX's jitted and donated steps do;
    its scratch directory under ``OUT_DIR`` removed at the end.
    ``eager_card``: phase 5's card time of the eager B 12 step by path
    (``card_ms``, ``hand_written_kernels_ms``), which 12a then does not
    profile again. Phase 10b runs in its own process beside 12c-12e; its
    result is ``out["clis"]``."""
    import tempfile

    from sast_tpu_torch.config import get_config

    work = Path(tempfile.mkdtemp(prefix="phase12_", dir=OUT_DIR))
    out, clis = {}, None
    t0 = time.perf_counter()
    batches = graph_train_batches(torch, np, get_config("gen4", "base"))
    log(f"phase 12: {len(batches)} train batches made in {time.perf_counter() - t0:.1f} s")
    try:
        for name, fn, args in (("train", phase_graph_train, (work, batches, eager_card)),
                               ("eval", phase_graph_eval, (batches,)),
                               ("fit", phase_graph_fit, (work,)),
                               ("cache", phase_graph_cache, (work,)),
                               ("world", phase_graph_world, (work,))):
            if name == "fit":
                clis = start_clis(work)
                start_fresh()
            t0 = time.perf_counter()
            out[name] = fn(torch, np, card, *args)
            out[name]["seconds"] = time.perf_counter() - t0
            log(f"phase 12 {name}: ok ({out[name]['seconds']:.1f} s)")
        out["clis"], clis = finish_clis(clis), None
        finish_fresh()
    finally:
        stop_fresh()
        if clis is not None and clis[0].poll() is None:
            clis[0].kill()
            clis[0].wait()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def rvt_update_gap(got, want, x):
    """||(got - x) - (want - x)|| / ||want - x||: an RVT layer's update,
    which a LayerScale keeps small beside x, compared relative to its size."""
    d = want.float() - x.float()
    return float(((got.float() - x.float()) - d).norm() / d.norm())


def rvt_block_bound(M, C, inner):
    """Least time of kernel D's RVT variant on ``M`` windows in bf16: tokens
    read and written once, the four matrices in bf16 and the 11 C + inner
    fp32 vectors read once; 2 operations a multiply-add of QKV, q k^T, P v,
    proj, Lin1 and Lin2 (``perfbench/yardstick_rvt.py``'s counts)."""
    hw = BLOCK_HW
    n_bytes = 2 * M * hw * C * 2 + (4 * C * C + 2 * C * inner) * 2 + (11 * C + inner) * 4
    flops = 2.0 * M * hw * (4 * C * C + 2 * hw * C + 2 * C * inner)
    return bound_ms(n_bytes, flops, "bf16")


def rvt_library_layer(torch, p, t, heads, dh, eps):
    """RVT's layer on (M, hw, C) bf16 tokens in PyTorch's library calls
    (``F.layer_norm``, cuBLAS ``F.linear``, the fused
    ``F.scaled_dot_product_attention``, ``F.gelu``), weights from
    ``fused_block.rvt_params``: the library version of the variant."""
    F = torch.nn.functional
    M, hw, C = t.shape

    def v(key):
        return p[key].to(t.dtype)

    y = F.layer_norm(t, (C,), v("ln1_scale"), v("ln1_bias"), eps)
    q, k, vv = F.linear(y, p["wqkv"], v("bqkv")).view(M, hw, 3, heads, dh).permute(2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, vv).transpose(1, 2).reshape(M, hw, C)
    h1 = t + v("ls1") * F.linear(a, p["wproj"], v("bproj"))
    m = F.gelu(F.linear(F.layer_norm(h1, (C,), v("ln2_scale"), v("ln2_bias"), eps), p["w1"],
                        v("b1")))
    return h1 + v("ls2") * F.linear(m, p["w2"], v("b2"))


def phase_rvt(torch, np):
    """Phase 13: RVT-B (``MaxViTRNN``) on kernel D's RVT variant. (a) The
    variant at the four stage shapes of the gen4 serving step at
    ``RVT_LANES`` lanes (bf16, TF32 off, LayerScale 1 so that the update is
    the layer's whole work) against its plain version on the same inputs
    (``RVT_GAP`` on the update, ``rvt_update_gap``; the plain version with
    float8 e4m3 matrices must read above it, so that the tolerance fails a
    coarser kernel), bit-equal to its own second launch; timed beside the
    plain version, the port's torch-op layer and the library version, with
    its bound. (b) The captured serving step of gen4 RVT-B at
    ``RVT_LANES`` lanes through ``process_batch``: 8 launches of the
    variant a frame, counted from 0; replays under the sync debug mode
    "error"; every token slot reported as attended; ms/step. Returns the
    variant's row of the kernel table."""
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.models.layers import Dense
    from sast_tpu_torch.models.maxvit import PartitionAttention
    from sast_tpu_torch.ops import fused_block
    from sast_tpu_torch.packing import pack_event_batch
    from sast_tpu_torch.serving import StreamingDetector

    cfg = get_config("gen4", "base", **{"model.backbone.name": "MaxViTRNN"})
    attn_cfg_rvt = cfg.model.backbone.attention
    eps = attn_cfg_rvt.norm_eps
    tot = dict(ms=0.0, call=0.0, plain=0.0, torch_ops=0.0, library=0.0, bound=0.0, by={})
    worst, rows = 0.0, []
    for si, (M, C) in enumerate(RVT_SHAPES):
        heads, dh = C // attn_cfg_rvt.dim_head, attn_cfg_rvt.dim_head
        torch.manual_seed(300 + si)
        layer = PartitionAttention(C, attn_cfg_rvt, torch.bfloat16).to(DEVICE).eval()
        with torch.no_grad():
            for m in layer.modules():
                if isinstance(m, Dense):
                    m.kernel.normal_(0.0, m.kernel.shape[1] ** -0.5)
                    m.bias.normal_(0.0, 0.1)
            layer.ls1.gamma.fill_(1.0)
            layer.ls2.gamma.fill_(1.0)
            x = torch.randn(M, BLOCK_HW, C, device=DEVICE).to(torch.bfloat16)
            p = fused_block.rvt_params(layer)
            got = fused_block.rvt_window_block(x, p, heads, dh, eps)
            again = fused_block.rvt_window_block(x, p, heads, dh, eps)
            plain = fused_block.rvt_block_plain(x, p, heads, dh, eps)
            coarse = fused_block.rvt_block_plain(
                x, {k: v.to(torch.float8_e4m3fn) if k in fused_block.RVT_MATRICES else v
                    for k, v in p.items()}, heads, dh, eps)
            lib = rvt_library_layer(torch, p, x, heads, dh, eps)
        torch.cuda.synchronize()
        where = f"rvt_window_block stage {si + 1} ({M} windows, C {C})"
        gap, gap_coarse, gap_lib = (rvt_update_gap(got, plain, x), rvt_update_gap(coarse, plain, x),
                                    rvt_update_gap(lib, plain, x))
        if got.dtype != torch.bfloat16 or not bool(torch.isfinite(got.float()).all()):
            fail(f"{where}: not finite bf16 ({got.dtype})")
        if not torch.equal(got, again):
            fail(f"{where}: not bit-equal to its own second launch")
        if gap > RVT_GAP:
            fail(f"{where}: update gap to the plain version {gap:.3e} > {RVT_GAP}")
        if not gap_coarse > RVT_GAP:
            fail(f"{where}: the float8 plain version reads {gap_coarse:.3e} <= {RVT_GAP}: "
                 "the tolerance would not fail a coarser kernel")
        if gap_lib > 0.03:
            fail(f"{where}: the library version's update gap {gap_lib:.3e} > 0.03")
        worst = max(worst, gap)
        inner = p["w1"].shape[0]
        with torch.no_grad():
            t = dict(
                ms=cuda_ms(torch, lambda: fused_block.rvt_window_block(x, p, heads, dh, eps),
                           iters=10, ahead=True),
                call=cuda_ms(torch, lambda: fused_block.rvt_window_block(x, p, heads, dh, eps)),
                plain=cuda_ms(torch, lambda: fused_block.rvt_block_plain(x, p, heads, dh, eps),
                              iters=5, warmup=1),
                torch_ops=cuda_ms(torch, lambda: layer.block_math(x[None]), iters=10, ahead=True),
                library=cuda_ms(torch, lambda: rvt_library_layer(torch, p, x, heads, dh, eps),
                                iters=10, ahead=True))
            per_launch = launch_us(torch, lambda: fused_block.rvt_window_block(
                x, p, heads, dh, eps), "rvt_block")
        b, by = rvt_block_bound(M, C, inner)
        for k in ("ms", "call", "plain", "torch_ops", "library"):
            tot[k] += 2 * t[k]  # a window layer and a grid layer a stage
        tot["bound"] += 2 * b
        tot["by"][by] = tot["by"].get(by, 0.0) + 2 * b
        rows.append(dict(stage=si + 1, M=M, C=C, gap=gap, gap_fp8_plain=gap_coarse,
                         gap_library=gap_lib, bound_ms=b, bound_by=by, **t))
        log(f"{where}: update gap {gap:.3e} (fp8 plain {gap_coarse:.3e}, library "
            f"{gap_lib:.3e}); card ms {t['ms']:.4f} (call {t['call']:.4f}), plain "
            f"{t['plain']:.4f}, torch ops {t['torch_ops']:.4f}, library {t['library']:.4f}, "
            f"bound {b:.5f} ({by}, share {b / t['ms']:.4f}); us by launch: {per_launch}")
        del layer, x, got, again, plain, coarse, lib
    torch.cuda.empty_cache()

    # (b) The captured serving step at the cell's lanes.
    h, w = cfg.dataset.resolution_hw
    model = build_detector(cfg.model, seed=0, device=DEVICE)
    det = StreamingDetector(cfg, model, max_events=EVENTS_PER_FRAME, num_streams=RVT_LANES,
                            device=DEVICE)
    rng = np.random.RandomState(13)
    frames = [[clustered_events(
        np, rng, EVENTS_PER_FRAME - EVENTS_PER_FRAME // (2 * RVT_LANES) * s, h, w, f, s)
               for s in range(RVT_LANES)] for f in range(FRAMES)]
    resets = [np.array([f == FRAMES // 2 and s == 2 for s in range(RVT_LANES)])
              for f in range(FRAMES)]
    reset_counters()
    outs = [det.process_batch(frames[f], reset=resets[f]) for f in range(FRAMES)]
    torch.cuda.synchronize()
    wrappers = read_counters()
    counts = executed_launches(wrappers, [det])
    log(f"rvt captured serving, {RVT_LANES} lanes, launches run over {FRAMES} frames: {counts} "
        f"(the wrappers' counts {wrappers}, {det.steps[0].run.replays} replays)")
    if counts["rvt_window_block"] != 8 * FRAMES:
        fail(f"rvt serving: {counts['rvt_window_block']} launches of the variant over {FRAMES} "
             f"frames, not 8 a frame")
    if counts["stem_conv7x4"] < FRAMES or counts["greedy_keep"] < FRAMES:
        fail(f"rvt serving did not launch the stem and NMS kernels on every frame: {counts}")
    if det.steps[0].run.replays != FRAMES - 1:
        fail(f"rvt serving: {det.steps[0].run.replays} replays over {FRAMES} frames")
    slots = [2.0 * (h_ * w_) for h_, w_ in (
        (cfg.model.backbone.in_res_hw[0] // s, cfg.model.backbone.in_res_hw[1] // s)
        for s in cfg.model.backbone.stage_strides)]
    for f, out in enumerate(outs):
        if not np.isfinite(out["boxes"]).all() or not np.isfinite(out["scores"]).all():
            fail(f"rvt serving frame {f}: non-finite outputs")
        if not (np.asarray(out["selected_tokens"]) == np.asarray(slots)).all():
            fail(f"rvt serving frame {f}: selected tokens {out['selected_tokens'][0]} != {slots}")
    packed, n = pack_event_batch(frames[0], RVT_LANES, EVENTS_PER_FRAME)
    pk, nk = torch.from_numpy(packed).to(DEVICE), torch.from_numpy(n).to(DEVICE)
    no_reset = torch.zeros(RVT_LANES, dtype=torch.bool, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            det.step(pk, nk, no_reset)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    step_ms = cuda_ms(torch, lambda: det.step(pk, nk, no_reset), iters=30, warmup=5)
    log(f"rvt captured serving step gen4 RVT-B b{RVT_LANES}: {step_ms:.3f} ms/step "
        f"({RVT_LANES * 1e3 / step_ms:.1f} frames/s); the variant's 8 layers "
        f"{tot['ms']:.4f} ms on the card alone ({tot['ms'] / step_ms:.3f} of the step)")
    log(f"kernel rvt_window_block: sum over the 8 layers at {RVT_LANES} lanes, bf16: "
        f"{tot['ms']:.4f} ms on the card ({tot['call']:.4f} ms per eager call), plain "
        f"{tot['plain']:.4f} ms, torch ops {tot['torch_ops']:.4f} ms, library "
        f"{tot['library']:.4f} ms, bound {tot['bound']:.5f} ms (share "
        f"{tot['bound'] / tot['ms']:.4f}); worst update gap {worst:.3e}")
    (OUT_DIR / "rvt_block.json").write_text(json.dumps(dict(
        layers=rows, step_ms=step_ms, counts=counts), indent=1))
    return dict(name="rvt_window_block", route="cuda", source="sast_tpu_torch/csrc/sparse_fwd.cu",
                replaces=None, launches=counts["rvt_window_block"], max_abs_err=None,
                max_update_gap=worst, ms=tot["ms"], plain_ms=tot["plain"],
                bound_ms=tot["bound"], bound_by=max(tot["by"], key=tot["by"].get),
                library_ms=tot["library"], call_ms=tot["call"], torch_ops_ms=tot["torch_ops"],
                bound_share=tot["bound"] / tot["ms"], step_ms=step_ms)


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
        "== registers and spills of kernels A, B, C, E, F, G and H\n" + "\n".join(ptxas) + "\n"
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

    t0 = time.perf_counter()
    fit_validate = phase_fit_validate(torch, np, smi)
    # Launches on this slice's path (fit with validation, counted from 0
    # over that run): kernels A, C, E, G and H.
    for k in kernels:
        if k["name"] in fit_validate["launches"] and fit_validate["launches"][k["name"]]:
            k["launches_fit_validate"] = fit_validate["launches"][k["name"]]
    log(f"phase 6: train, validate, checkpoint and resume ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    seven = phase_seven(torch, np, smi, training["sparse"]["first_step"])
    # Launches on this slice's path: the two-rank world's fit (A, E, G, H)
    # and validation (C), counted from 0 on rank 0 over each.
    for k in kernels:
        if seven["data_parallel"]["launches"].get(k["name"]):
            k["launches_data_parallel"] = seven["data_parallel"]["launches"][k["name"]]
    log(f"phase 7: data parallel, regularizers, device cache and profiler ok "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    eight = phase_eight(torch, np)
    eight["seconds"] = time.perf_counter() - t0
    log(f"phase 8: export and serving lanes ok ({eight['seconds']:.1f} s)")

    t0 = time.perf_counter()
    nine = phase_nine(torch, np)
    # Launches on this slice's path: the timed chunks of compute_fps on the
    # four kernel paths, each counted from 0 over its own run, summed.
    for k in kernels:
        n = sum(p["launches"].get(k["name"], 0) for p in nine["benchmark"]["paths"].values())
        if n:
            k["launches_benchmark"] = n
    for name in ("stem_conv7x4", "greedy_keep", "fused_window_block", "sparse_window_block",
                 "sparse_window_block_looped"):
        if not any(k["name"] == name and k.get("launches_benchmark") for k in kernels):
            fail(f"kernel {name} was not launched by the benchmark's timed chunks")
    nine["seconds"] = time.perf_counter() - t0
    log(f"phase 9: benchmark library, timers and representations ok ({nine['seconds']:.1f} s)")

    t0 = time.perf_counter()
    ten = phase_ten(torch, np)
    ten["seconds"] = time.perf_counter() - t0
    log(f"phase 10: cond artifacts ok ({ten['seconds']:.1f} s; the CLIs run beside phase 12)")

    t0 = time.perf_counter()
    eleven = phase_eleven(torch, np)
    # Launches on this slice's path: the captured steps of phase 11a (fp32
    # and bf16, each path counted from 0 over its 8 frames), the warm-ups'
    # and the replays', summed; every serving kernel must have run inside
    # a replay.
    for k in kernels:
        n = sum(r["launches"].get(k["name"], 0) for p in eleven["paths"].values()
                for r in p.values())
        if n:
            k["launches_captured"] = n
    for name in ("stem_conv7x4", "density_ratio", "greedy_keep", "fused_window_block",
                 "sparse_window_block", "sparse_window_block_looped"):
        if not any(r["replayed"].get(name) for p in eleven["paths"].values()
                   for r in p.values()):
            fail(f"kernel {name} was not launched by a replay of a captured step")
    eleven["seconds"] = time.perf_counter() - t0
    log(f"phase 11: captured serving steps ok ({eleven['seconds']:.1f} s)")

    t0 = time.perf_counter()
    twelve = phase_twelve(torch, np, smi, eager_card=training)
    # Launches on this slice's path: the captured train steps of 12a, the
    # captured eval steps of 12b and the captured fit of 12c, the warm-ups'
    # and the replays', each counted from 0 over its own run, summed.
    for k in kernels:
        n = sum(twelve[p]["launches"].get(k["name"], 0) for p in ("train", "eval", "fit"))
        if not n:
            fail(f"kernel {k['name']} was not launched by a captured train or eval step")
        k["launches_captured_train"] = n
    twelve["seconds"] = time.perf_counter() - t0
    ten["clis"] = twelve.pop("clis")
    # Launches inside the loaded artifacts of phases 8a (the four, each
    # counted from 0 over its frames) and 10a (the two whose layers choose
    # on the card), which fresh processes ran beside phase 12, and in the
    # CLIs' runs (each counted from 0), summed.
    for k in kernels:
        for key, runs in (("launches_artifact", eight["exports"].values()),
                          ("launches_cond_artifact", ten["cond"].values())):
            n = sum(e["launches_artifact"].get(k["name"], 0) for e in runs)
            if n:
                k[key] = n
        n = sum(c["launches"].get(k["name"], 0) for c in ten["clis"].values())
        if n:
            k["launches_cli"] = n
    for name in ("stem_conv7x4", "density_ratio", "greedy_keep", "fused_window_block",
                 "sparse_window_block", "sparse_window_block_looped"):
        if not any(k["name"] == name and k.get("launches_artifact") for k in kernels):
            fail(f"kernel {name} was not launched from inside an artifact")
    log(f"phase 12: captured train and eval steps ok, and phase 10b beside it "
        f"({twelve['seconds']:.1f} s)")

    t0 = time.perf_counter()
    kernels.append(phase_rvt(torch, np))
    log(f"phase 13: RVT-B on kernel D's RVT variant ok ({time.perf_counter() - t0:.1f} s)")

    record = dict(card=smi, kernels=kernels, serving=serving, cpu_parity=parity,
                  training=training, fit_validate=fit_validate, phase7=seven, phase8=eight,
                  phase9=nine, phase10=ten, phase11=eleven, phase12=twelve,
                  seconds=time.perf_counter() - t_start)
    log(f"chip_smoke: all phases ok in {record['seconds']:.1f} s")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print_result(kernels, smi, torch.cuda.get_device_name(0), torch.cuda.device_count())


def print_result(kernels, smi: str, kind: str, count: int) -> None:
    """The kernels line, the card line and, last, the ok line."""
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # Kernels redesigned since their first port; launches on phases 6-10.
    extra = ("redesigned", "launches_fit_validate", "launches_data_parallel",
             "launches_artifact", "launches_benchmark", "launches_cond_artifact", "launches_cli",
             "launches_captured", "launches_captured_train")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys + extra if k in kern}
                                  for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--clis"]:
        clis_main(*sys.argv[2:4])
    else:
        main()
