"""Frame-rate and FLOP measurement library (port of
sast_tpu/utils/benchmark.py).

- ``compute_fps``: the streaming step on seeded synthetic input at a chosen
  sparsity, with the recurrent state carried, timed on the card as the slope
  of two chunk lengths (``slope_time`` over ``streaming_chunk``).
- ``compute_flops``: the operations of one forward, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of XLA's cost
  analysis), and the bytes its operators read and write.
- ``transformer_macs_from_telemetry``: the reference's per-sample
  transformer GFLOPs at the gathered (M kept windows x Kmax tokens) shapes,
  from the blocks' selection telemetry (``models/sast.SASTBlock``).

``sync_dispatch`` (JAX ``utils/benchmark.py:29``) is not ported: it flips the
dispatch mode of a network-attached TPU runtime, which a local card does
not have; ``torch.cuda.synchronize`` waits for the card directly.

Each entry point that runs the model takes an attention ``path`` of
``PATHS``, which picks the configuration's existing switches:

- ``default``: the configuration as it is (stem kernel A with the density
  ratio fused; the masked torch-op attention);
- ``sparse``: the window-skipping block kernel E (``sparse_kernel``);
- ``looped``: the same on kernel F (``sparse_block.MODEL_USES_LOOPED``);
- ``fused``: the dense block kernel D (``attention.fused_block``);
- ``masked``: every kernel switch of the backbone off: the plain torch ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from sast_tpu_torch.config import ExperimentConfig

PATHS = ("default", "sparse", "looped", "fused", "masked")


def path_config(cfg: ExperimentConfig, path: str) -> Tuple[ExperimentConfig, bool, bool]:
    """(configuration, ``sparse_kernel``, looped) of attention ``path``."""
    if path not in PATHS:
        raise ValueError(f"path {path!r} is not one of {PATHS}")
    bb = cfg.model.backbone
    if path == "fused":
        bb = dataclasses.replace(bb, attention=dataclasses.replace(bb.attention,
                                                                   fused_block=True))
    elif path == "masked":
        bb = dataclasses.replace(bb, stem_pallas=False, ratio_pallas=False,
                                 fuse_stem_density=False)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))
    return cfg, path in ("sparse", "looped"), path == "looped"


@contextlib.contextmanager
def looped_kernel(on: bool):
    """The model's sparse path on kernel F (``on``) or E for the body."""
    from sast_tpu_torch.ops import sparse_block

    before = sparse_block.MODEL_USES_LOOPED
    sparse_block.MODEL_USES_LOOPED = on
    try:
        yield
    finally:
        sparse_block.MODEL_USES_LOOPED = before


def make_sparse_input(
    rng: np.random.RandomState, shape: Tuple[int, ...], sparsity: float
) -> np.ndarray:
    from sast_tpu_torch.data.synthetic import sparse_event_input

    return sparse_event_input(rng, shape, sparsity)


def streaming_chunk(model, length: int, detect: bool = False):
    """``run(x, states) -> (states, acc)``: ``length`` frames of the full
    detector with the recurrent state carried, under
    ``torch.inference_mode``.

    Each frame's input is ``x + (acc * 0).to(x.dtype)``, where ``acc`` is an
    fp32 scalar on ``x``'s device that accumulates ``preds.sum()``. JAX
    needs this feedback to keep XLA from hoisting per-frame input work out of
    its ``lax.scan``; eager PyTorch hoists nothing across frames, so here it
    keeps the same work per frame as JAX's chunk, and keeps the body ready
    for a one-program step. Weights, input and states stay arguments (the
    model's parameters and ``run``'s); nothing inside reads the host. With
    ``detect`` each frame also runs the serving step's decode and
    fixed-budget NMS (``ops/nms.postprocess`` with the model configuration's
    thresholds), and ``acc`` also takes the slate's scores.
    """
    from sast_tpu_torch.models.head import inference_outputs
    from sast_tpu_torch.ops.nms import postprocess

    cfg = model.config
    pp = cfg.postprocess

    @torch.inference_mode()
    def run(x: torch.Tensor, states):
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(length):
            outputs, states, _ = model(x + (acc * 0).to(x.dtype), states)
            acc = acc + outputs["preds"].sum(dtype=torch.float32)
            if detect:
                dets = postprocess(
                    inference_outputs(outputs["preds"]), num_classes=cfg.head.num_classes,
                    conf_threshold=pp.confidence_threshold, nms_threshold=pp.nms_threshold,
                    pre_nms_topk=pp.pre_nms_topk, max_detections=pp.max_detections)
                acc = acc + dets["scores"].sum(dtype=torch.float32)
        return states, acc

    return run


def _sync() -> None:
    """Wait for the card, where CUDA was used in this process; without it
    no work is queued anywhere."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def chunk_times(make_fn, L1: int, L2: int, blocks: int = 3) -> Tuple[List[float], List[float]]:
    """Seconds of each of ``blocks`` runs of the L1 and the L2 chunk, in
    turns, each bracketed by a synchronise, after one untimed run of each.
    ``make_fn(L)`` returns a zero-argument callable that runs L chained
    frames (``streaming_chunk``)."""
    if not 0 < L1 < L2:
        raise ValueError(f"need 0 < L1 < L2 for a valid slope, got {(L1, L2)}")
    f1, f2 = make_fn(L1), make_fn(L2)
    for f in (f1, f2):
        f()
        _sync()
    t1, t2 = [], []
    for _ in range(blocks):
        for f, times in ((f1, t1), (f2, t2)):
            t0 = time.perf_counter()
            f()
            _sync()
            times.append(time.perf_counter() - t0)
    return t1, t2


def slope_time(make_fn, L1: int = 20, L2: int = 100, blocks: int = 3) -> float:
    """Per-frame time in seconds: ``(best L2 - best L1) / (L2 - L1)`` over
    ``chunk_times``. The slope cancels what every chunk pays once (the
    synchronise, the first launch). On the port's eager step it is the
    per-frame time that the host's dispatch allows: the port's real cost
    per frame today."""
    t1, t2 = chunk_times(make_fn, L1, L2, blocks)
    return (min(t2) - min(t1)) / (L2 - L1)


def _build_model_and_inputs(cfg: ExperimentConfig, batch_size: int, sparsity: float, seed: int,
                            device, sparse_kernel: bool = False):
    """The detector with weights from ``torch.Generator().manual_seed(seed)``
    on ``device``, the seeded sparse uint8 input there, and zero states in
    the compute dtype."""
    from sast_tpu_torch.models.backbone import zero_states
    from sast_tpu_torch.models.detector import DTYPES, build_detector

    model = build_detector(cfg.model, seed=seed, device=device, sparse_kernel=sparse_kernel)
    bb = cfg.model.backbone
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(
        make_sparse_input(rng, (batch_size, *bb.in_res_hw, bb.input_channels), sparsity)
    ).to(device)
    states = zero_states(bb, batch_size, dtype=DTYPES[cfg.model.compute_dtype], device=device)
    return model, x, states


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"timing needs an NVIDIA card, got device {device} (CUDA available: "
                           f"{torch.cuda.is_available()})")
    return device


def compute_fps(
    cfg: ExperimentConfig,
    batch_size: int = 4,
    sparsity: float = 0.9,
    iters: int = 300,
    seed: int = 0,
    path: str = "default",
    blocks: int = 3,
    device="cuda",
) -> Dict[str, float]:
    """Streaming per-frame frames/s on the card, the state carried: the
    slope over ``streaming_chunk``s of ``max(10, iters // 6)`` and
    ``max(iters, 2 * L1)`` frames, each chunk from the same zero states.
    The timed frame is the serving frame (``detect``: decode and NMS, kernel
    C, included; JAX's chunk ends at the predictions). Refuses to run
    without a card. ``frames`` counts every
    frame run (the untimed first chunks included), for checks of the launch
    counters."""
    device = _card(device)
    cfg, sparse_kernel, looped = path_config(cfg, path)
    model, x, states = _build_model_and_inputs(cfg, batch_size, sparsity, seed, device,
                                               sparse_kernel)
    L1 = max(10, iters // 6)
    L2 = max(iters, 2 * L1)

    def make_fn(length):
        run = streaming_chunk(model, length, detect=True)
        return lambda: run(x, states)

    with looped_kernel(looped):
        t1, t2 = chunk_times(make_fn, L1, L2, blocks)
    dt = (min(t2) - min(t1)) / (L2 - L1)
    return {
        "fps": batch_size / dt,
        "step_ms": dt * 1000.0,
        "latency_per_frame_ms": dt * 1000.0,  # one step = one frame per lane
        "per_dispatch_overhead_ms": 1000.0 * (min(t1) - L1 * dt),
        "batch_size": batch_size,
        "sparsity": sparsity,
        "path": path,
        "chunk_lengths": (L1, L2),
        "frames": (blocks + 1) * (L1 + L2),
        "device_kind": torch.cuda.get_device_name(device),
    }


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every tensor an operator reads or writes (views
    excluded: they move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in pytree.tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def compute_flops(
    cfg: ExperimentConfig,
    batch_size: int = 1,
    sparsity: float = 0.9,
    seed: int = 0,
    path: str = "default",
    device="cuda",
) -> Dict[str, float]:
    """GFLOPs of one forward per batch element, counted by
    ``FlopCounterMode`` at 2 FLOPs per multiply-add, as XLA counts. The
    kernels' operators count through their registered formulas, each the
    count of its plain version at full window density, so that one
    configuration reads the same total on every attention path; the
    sparsity-scaled attention work is ``transformer_macs_from_telemetry``'s.
    ``bytes_accessed_mb`` sums the bytes of every operator's tensor inputs
    and outputs: an upper bound of the traffic, as if nothing were fused.
    A count, not a time: ``device`` may be the CPU."""
    cfg, sparse_kernel, looped = path_config(cfg, path)
    model, x, states = _build_model_and_inputs(cfg, batch_size, sparsity, seed, device,
                                               sparse_kernel)
    with looped_kernel(looped):
        flops, n_bytes = count_flops_and_bytes(model, x, states)
    return {
        "gflops_total": flops / 1e9 / batch_size,
        "bytes_accessed_mb": n_bytes / 1e6 / batch_size,
    }


def count_flops_and_bytes(fn, *args) -> Tuple[int, int]:
    """(FLOPs, bytes) of ``fn(*args)`` under ``torch.inference_mode``: the
    ``FlopCounterMode`` total and the bytes of every operator's tensor
    inputs and outputs."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter, _BytesMode() as traffic:
        fn(*args)
    return counter.get_total_flops(), traffic.bytes


def sweep_sparsity_fps(cfg, sparsities=(0.5, 0.75, 0.9, 0.95, 0.99), **kw):
    return {s: compute_fps(cfg, sparsity=s, **kw) for s in sparsities}


def transformer_macs_from_telemetry(cfg, telemetry) -> Dict[str, float]:
    """Reference-style per-sample transformer GFLOPs from selection
    telemetry, as JAX's function computes them: per attention with M kept
    windows padded to Kmax tokens (T = M * Kmax), C channels and gated-MLP
    inner width I,

        qkv    T * C * 3C
        logits M * Kmax^2 * C ; att*v  M * Kmax^2 * C
        proj   T * C * C
        glu    T * C * 2I ; out  T * I * C

    plus the first block's full-layout scoring product N * hw * C^2, one
    multiply-add counted as one FLOP. Batch 1.

    ``telemetry``: the dict that ``forward_backbone(..., telemetry=...)``
    filled (JAX: the mutable ``telemetry`` collection). Returns
    ``gflops_transformer``, ``gflops_stage{i}`` and ``t_eff_total``.
    """
    bb = cfg.model.backbone
    hw = bb.attention.partition_size[0] * bb.attention.partition_size[1]
    out: Dict[str, float] = {}
    total = 0.0
    t_eff_total = 0
    bb_tel = telemetry.get("backbone", telemetry)
    for i, C in enumerate(bb.stage_dims):
        inner = max(32, (C * bb.attention.mlp_ratio * 2 // 3) // 32 * 32)
        stage_tel = bb_tel.get(f"stage{i}", {})
        stage_macs = 0.0
        for j in range(bb.num_blocks[i]):
            blk = stage_tel.get(f"block{j}", {})
            for sel_name in ("sel_win", "sel_grid"):
                if sel_name not in blk:
                    continue
                stats = blk[sel_name][-1]  # (B, 3) int32; B == 1
                stats = stats.cpu().numpy() if isinstance(stats, torch.Tensor) else np.asarray(stats)
                m, kmax, t_eff = (int(v) for v in stats[0])
                t_pad = m * kmax
                stage_macs += (
                    t_pad * C * 3 * C          # qkv
                    + 2 * m * kmax * kmax * C  # logits + att*v
                    + t_pad * C * C            # proj
                    + t_pad * C * 2 * inner    # glu
                    + t_pad * inner * C        # out proj
                )
                t_eff_total += t_eff
            if j == 0 and blk:
                # The scoring module on the full window layout.
                h = bb.in_res_hw[0] // bb.stage_strides[i]
                w = bb.in_res_hw[1] // bb.stage_strides[i]
                stage_macs += (h * w) // hw * hw * C * C
        out[f"gflops_stage{i + 1}"] = stage_macs / 1e9
        total += stage_macs
    out["gflops_transformer"] = total / 1e9
    out["t_eff_total"] = float(t_eff_total)
    return out
