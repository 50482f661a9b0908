"""Benchmark CLI of the PyTorch port: frames/s, GFLOPs, sparsity sweep and
per-sample transformer GFLOPs (port of scripts/benchmark.py; the same
options, plus ``--path``).

Synthetic sparsity-controlled input, frames/s = lanes / per-frame time
(``utils/benchmark.compute_fps``: the slope of two chunk lengths on the
card), FLOPs by ``FlopCounterMode`` (``compute_flops``). Refuses to run
without a card.

    python scripts/benchmark_torch.py --dataset gen4 --size base --sweep
    python scripts/benchmark_torch.py --per-sample [--data ROOT --split test]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def per_sample_rows(cfg, samples, device):
    """One row per ``(name, x)`` of ``samples`` (x: (1, H, W, C) uint8 at
    the model resolution): the density ``r``, the selected tokens per stage
    and the reference-style transformer GFLOPs from the blocks' selection
    telemetry (``transformer_macs_from_telemetry``), batch 1, the seed-0
    detector on ``device``."""
    from sast_tpu_torch.models.backbone import zero_states
    from sast_tpu_torch.models.detector import DTYPES, build_detector
    from sast_tpu_torch.utils.benchmark import transformer_macs_from_telemetry

    bb = cfg.model.backbone
    model = build_detector(cfg.model, seed=0, device=device)
    states = zero_states(bb, 1, dtype=DTYPES[cfg.model.compute_dtype], device=device)
    rows = []
    for name, x in samples:
        tel: dict = {}
        with torch.inference_mode():
            _, _, p = model.forward_backbone(torch.from_numpy(x).to(device), states,
                                             telemetry=tel)
        macs = transformer_macs_from_telemetry(cfg, tel)
        row = {"sample": name, "r": round(float((x != 0).mean()), 5),
               "p_tokens": [int(v) for v in p.cpu()]}
        row.update({k: round(v, 4) for k, v in macs.items()})
        rows.append(row)
        print(f"{name:>28}  r={row['r']:.4f}  "
              f"GFLOPs(transformer)={macs['gflops_transformer']:.3f}", file=sys.stderr)
    return rows


def samples_of(cfg, args):
    """Samples from a preprocessed dataset (``--data``: the first 8 frames of
    each sequence of ``--split``, padded to the model resolution) or a
    synthetic density ladder from 0.5 to 0.999."""
    from sast_tpu_torch.data.synthetic import sparse_event_input

    bb = cfg.model.backbone
    if args.data is None:
        rng = np.random.RandomState(0)
        for s in np.linspace(0.5, 0.999, args.num_samples):
            yield f"synthetic[s={s:.3f}]", sparse_event_input(
                rng, (1, *bb.in_res_hw, bb.input_channels), float(s))
        return
    from sast_tpu_torch.data.sequence import SequenceReader
    from sast_tpu_torch.utils.padding import InputPadder

    padder = InputPadder(bb.in_res_hw)
    n = 0
    for seq_dir in sorted(p for p in (args.data / args.split).iterdir() if p.is_dir()):
        reader = SequenceReader(seq_dir, cfg.dataset.ev_repr_name, cfg.dataset.name,
                                cfg.dataset.downsample_by_factor_2)
        for t in range(min(reader.num_ev_repr, 8)):
            if n >= args.num_samples:
                return
            ev = torch.from_numpy(reader.get_ev_repr(t, t + 1))  # (1, H, W, C)
            yield f"{seq_dir.name}[{t}]", padder.pad_tensor_ev_repr(ev).numpy()
            n += 1


def per_sample_sweep(cfg, args) -> None:
    rows = per_sample_rows(cfg, samples_of(cfg, args), "cuda")
    if args.jsonl:
        with open(args.jsonl, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        print(f"wrote {len(rows)} rows to {args.jsonl}", file=sys.stderr)
    g = np.asarray([row["gflops_transformer"] for row in rows])
    print(json.dumps({
        "dataset": args.dataset, "size": args.size, "n": len(rows),
        "gflops_transformer_mean": round(float(g.mean()), 3),
        "gflops_transformer_p10": round(float(np.percentile(g, 10)), 3),
        "gflops_transformer_p50": round(float(np.percentile(g, 50)), 3),
        "gflops_transformer_p90": round(float(np.percentile(g, 90)), 3),
        "gflops_transformer_max": round(float(g.max()), 3),
        "source": str(args.data) if args.data else "synthetic",
        "device_kind": torch.cuda.get_device_name(0),
    }))


def main(argv=None) -> None:
    from sast_tpu_torch.utils.benchmark import PATHS

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", choices=("gen1", "gen4"), default="gen4")
    ap.add_argument("--size", choices=("tiny", "small", "base", "large"), default="base")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--path", choices=PATHS, default="default",
                    help="attention path (utils/benchmark.PATHS)")
    ap.add_argument("--sweep", action="store_true", help="sweep input sparsity levels")
    ap.add_argument("--flops", action="store_true", help="also report GFLOPs")
    ap.add_argument("--per-sample", action="store_true",
                    help="per-sample transformer-GFLOPs sweep: one row per sample with its "
                         "density r and the reference-style gathered-shape GFLOPs")
    ap.add_argument("--data", type=Path, default=None,
                    help="preprocessed dataset root for --per-sample (default: a synthetic "
                         "density ladder)")
    ap.add_argument("--split", default="test")
    ap.add_argument("--num-samples", type=int, default=64)
    ap.add_argument("--jsonl", type=Path, default=None,
                    help="write per-sample rows to this JSONL file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scripts/benchmark_torch.py measures the card: torch.cuda.is_available() is "
              "false", file=sys.stderr)
        sys.exit(1)

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.utils.benchmark import compute_flops, compute_fps, sweep_sparsity_fps

    cfg = get_config(args.dataset, args.size)
    if args.per_sample:
        per_sample_sweep(cfg, args)
        return

    out = {"dataset": args.dataset, "size": args.size}
    if args.sweep:
        sweep = sweep_sparsity_fps(cfg, batch_size=args.batch_size, iters=args.iters,
                                   path=args.path)
        out["sweep"] = {str(k): v for k, v in sweep.items()}
        for s, m in sweep.items():
            print(f"sparsity {s:.2f}: {m['fps']:.0f} fps  {m['step_ms']:.3f} ms/step",
                  file=sys.stderr)
    else:
        m = compute_fps(cfg, batch_size=args.batch_size, sparsity=args.sparsity,
                        iters=args.iters, path=args.path)
        out.update(m)
        print(f"{m['fps']:.0f} fps  {m['step_ms']:.3f} ms/step", file=sys.stderr)
    if args.flops:
        out.update(compute_flops(cfg, sparsity=args.sparsity, path=args.path))
        print(f"GFLOPs/frame: {out['gflops_total']:.2f}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
