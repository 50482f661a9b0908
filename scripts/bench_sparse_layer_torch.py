#!/usr/bin/env python3
"""One attention layer's paths at set window densities, forward and
forward+backward (port of scripts/bench_sparse_layer.py).

One ``models/sast.MaskedSparseAttention`` layer (seeded weights, LayerScale
0.5) on a (B, N, hw, C) input with the window and token masks set directly,
so the density is the one asked for, whatever a scoring module would keep:

- ``masked``: the masked torch-op block on every window;
- ``gather``: the torch-op block on the first ``ceil(budget * M)`` windows
  of the kept-first list (``attention.gather_budget``; exact while the kept
  windows fit, else the masked block);
- ``sparse``: kernel E on the kept windows (``sparse_kernel``, threshold 1);
  with ``--grad`` its backward is kernels G and H;
- ``looped``: kernel F, the same function in one cooperative launch
  (forward only: with ``--grad`` it is not timed, as F has no backward).

Before timing, each path's output (and with ``--grad`` the input's
gradient) is held against the masked path's in fp32, within rtol 2e-4 +
atol 2e-5 max|y| (chip_smoke.py's tolerance for the block kernels); a path
outside it stops the run. Then each path runs in ``--dtype`` as a chain of
L layers (each layer's output the next one's input, as JAX's ``lax.scan``),
timed as the slope of L ``iters // 5`` and ``iters``
(``utils/benchmark.chunk_times``, ``--blocks`` runs in turns). With
``--grad`` a chain's time holds its forward and the backward of
``sum(y * w)`` into the input and the weights.

The last row is the density threshold's own crossover: the densest swept
density at which kernel E still beats the masked path, and the first at
which it no longer does. The model's default threshold
(``attention.pallas_density_threshold``) is not changed by this script.

    python scripts/bench_sparse_layer_torch.py [--grad] [--iters 50]
        [--B 4 --N 256 --hw 60 --C 128 --dim-head 32 --budget 0.5]
        [--densities 0.05,0.1,0.2,0.4,0.6,0.8,1.0] [--device cuda|cpu]

The JAX script's flags and defaults are kept. It has no counterpart of
``sync_dispatch`` or the compilation cache (see bench_serving_torch.py).
Prints the card's name and power limit, a table, then one JSON line per
density and the crossover's line. Runs on the card; ``--device cpu`` runs
the plain versions on the CPU. Without a card it refuses by name.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sast_tpu_torch.utils import profiling  # noqa: E402

PATHS = ("masked", "gather", "sparse", "looped")
RTOL, ATOL_REL = 2e-4, 2e-5
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_layer(path: str, C: int, dim_head: int, budget: float, dtype: torch.dtype, state):
    from sast_tpu_torch.config import AttentionConfig
    from sast_tpu_torch.models.sast import MaskedSparseAttention

    att = AttentionConfig(dim_head=dim_head, ls_init_value=0.5,
                          gather_budget=budget if path == "gather" else 0.0)
    layer = MaskedSparseAttention(C, att, dtype, sparse_kernel=path in ("sparse", "looped"))
    layer.load_state_dict(state)
    return layer


def seeded_state(C: int, dim_head: int, seed: int):
    """Weights from a seeded ``torch.Generator``: entries N(0, 0.2^2),
    LayerNorm scales around 1, LayerScale 0.5."""
    from sast_tpu_torch.config import AttentionConfig
    from sast_tpu_torch.models.sast import MaskedSparseAttention

    layer = MaskedSparseAttention(C, AttentionConfig(dim_head=dim_head))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
            if name.endswith("gamma"):
                p.fill_(0.5)
            elif name.endswith("scale"):
                p.add_(1.0)
    return layer.state_dict()


def chain(layer, path, x, tok, win, w, grad: bool, length: int = 1):
    """``length`` calls of the layer, each on the last one's output (JAX's
    ``lax.scan``): the output, and with ``grad`` the input's gradient of
    ``sum(y * w)`` (the weights' gradients accumulate beside it)."""
    from sast_tpu_torch.utils.benchmark import looped_kernel

    with looped_kernel(path == "looped"):
        if not grad:
            with torch.inference_mode():
                y = x
                for _ in range(length):
                    y = layer(y, tok, win)
            return y, None
        xin = x.detach().requires_grad_(True)
        y = xin
        for _ in range(length):
            y = layer(y, tok, win)
        (y.float() * w).sum().backward()
        return y.detach(), xin.grad


def check(paths, state, args, x, tok, win, w, device) -> dict:
    """Each path against the masked path in fp32: the worst error over the
    tolerance's allowance, per output (1 is the edge)."""
    ref = None
    worst = {}
    for path in paths:
        layer = make_layer(path, args.C, args.dim_head, args.budget, torch.float32,
                           state).to(device)
        grad = args.grad and path != "looped"
        y, dx = chain(layer, path, x.float(), tok, win, w, grad)
        if path == "masked":
            ref = (y, dx)
            continue
        for name, got, want in (("y", y, ref[0]), ("dx", dx, ref[1])):
            if got is None or want is None:
                continue
            allow = RTOL * want.abs() + ATOL_REL * want.abs().max()
            ratio = float(((got - want).abs() / allow).max())
            worst[f"{path}_{name}"] = ratio
            if not ratio <= 1.0:
                raise SystemExit(f"bench_sparse_layer_torch.py: the {path} path's {name} is "
                                 f"{ratio:.3f} times the tolerance off the masked path's")
    return worst


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--N", type=int, default=256, help="windows per sample")
    ap.add_argument("--hw", type=int, default=60, help="tokens per window")
    ap.add_argument("--C", type=int, default=128)
    ap.add_argument("--dim-head", type=int, default=32)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--grad", action="store_true", help="time fwd+bwd")
    ap.add_argument("--budget", type=float, default=0.5)
    ap.add_argument("--densities", default="0.05,0.1,0.2,0.4,0.6,0.8,1.0")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        device = profiling.card(args.device)
    except profiling.CardError as e:
        raise SystemExit(f"bench_sparse_layer_torch.py: {e}") from None

    from sast_tpu_torch.utils.benchmark import chunk_times

    paths = [p for p in PATHS if p in args.paths.split(",")]
    if "masked" not in paths:
        raise SystemExit("bench_sparse_layer_torch.py: --paths must hold masked, the reference")
    timed = [p for p in paths if not (args.grad and p == "looped")]
    B, N, HW, C = args.B, args.N, args.hw, args.C
    dtype = DTYPES[args.dtype]
    rng = np.random.RandomState(args.seed)
    x = torch.from_numpy(rng.randn(B, N, HW, C) * 0.1).to(device, dtype)
    w = torch.from_numpy(rng.randn(B, N, HW, C)).to(device, torch.float32)
    state = seeded_state(C, args.dim_head, args.seed)
    layers = {p: make_layer(p, C, args.dim_head, args.budget, dtype, state).to(device)
              for p in timed}
    L1, L2 = max(2, args.iters // 5), args.iters
    mode = "fwd+bwd" if args.grad else "fwd"
    info = profiling.card_info(device)
    print(f"# card: {info['smi'] or info['kind']}")

    rows = []
    for density in (float(d) for d in args.densities.split(",")):
        n_keep = max(1, int(round(density * B * N)))
        wk = np.zeros(B * N, bool)
        wk[rng.choice(B * N, n_keep, replace=False)] = True
        win = torch.from_numpy(wk.reshape(B, N)).to(device)
        tok = torch.from_numpy(rng.rand(B, N, HW) > 0.25).to(device) & win[..., None]
        worst = check(paths, state, args, x, tok, win, w, device)
        row = dict(metric="sparse_layer", mode=mode, density=density, kept_windows=n_keep,
                   B=B, N=N, hw=HW, C=C, dtype=args.dtype, budget=args.budget,
                   L1=L1, L2=L2, worst_error_over_tolerance=worst,
                   device_kind=info["kind"], card=info["smi"])
        for path in timed:
            def make_fn(length, layer=layers[path], path=path):
                return lambda: chain(layer, path, x, tok, win, w, args.grad, length)

            t1, t2 = chunk_times(make_fn, L1, L2, args.blocks)
            row[f"{path}_ms"] = (min(t2) - min(t1)) / (L2 - L1) * 1e3
        rows.append(row)

    crossover = dict(metric="sparse_layer_crossover", mode=mode, dtype=args.dtype,
                     sparse_beats_masked_up_to=None, sparse_loses_from=None,
                     device_kind=info["kind"], card=info["smi"])
    if "sparse" in timed:
        for row in sorted(rows, key=lambda r: r["density"]):
            if row["sparse_ms"] < row["masked_ms"] and crossover["sparse_loses_from"] is None:
                crossover["sparse_beats_masked_up_to"] = row["density"]
            elif crossover["sparse_loses_from"] is None:
                crossover["sparse_loses_from"] = row["density"]
    profiling.emit(f"# sparse layer {mode}: B={B} N={N} hw={HW} C={C} {args.dtype} "
                   f"budget={args.budget}, ms per layer, slope of L {L1}/{L2} over "
                   f"{args.blocks} blocks", rows,
                   ("density", "kept_windows", *(f"{p}_ms" for p in timed)))
    print(f"# kernel E beats the masked path up to density "
          f"{crossover['sparse_beats_masked_up_to']}, loses from "
          f"{crossover['sparse_loses_from']}")
    print(json.dumps(crossover))


if __name__ == "__main__":
    main()
