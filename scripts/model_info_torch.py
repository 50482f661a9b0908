#!/usr/bin/env python3
"""Parameters per preset, and optionally GFLOP per frame (port of
scripts/model_info.py).

Parameter counts come from the port's ``YoloXDetector`` built on the
``meta`` device (shapes only: no memory, no device), grouped by its
top-level modules ``backbone``, ``fpn`` and ``head`` as the JAX script
groups its parameter tree; BatchNorm statistics are buffers, not
parameters, as they are outside JAX's ``params``. ``--flops`` adds
``utils/benchmark.compute_flops``' GFLOP per frame at ``--sparsity`` (batch
1, ``FlopCounterMode``, the configuration's own path), which runs the model
once on ``--device``.

    python scripts/model_info_torch.py [--datasets gen1 gen4]
        [--sizes tiny small base large] [--flops] [--device cuda|cpu]

The JAX script's flags and defaults are kept; its ``JAX_PLATFORMS``
handling has no counterpart. Prints a table, then one JSON line per preset.
The parameter counts need no card; ``--flops`` runs on the card unless
``--device cpu`` is given, and refuses by name without one.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sast_tpu_torch.utils import profiling  # noqa: E402

GROUPS = ("backbone", "fpn", "head")


def count_params(cfg) -> dict:
    """Parameters of the preset's detector by top-level module, and in
    total, from shapes on the ``meta`` device."""
    from sast_tpu_torch.models.detector import YoloXDetector

    with torch.device("meta"):
        model = YoloXDetector(cfg.model)
    out = {g: 0 for g in GROUPS}
    for name, p in model.named_parameters():
        out[name.split(".")[0]] += p.numel()
    out["total"] = sum(p.numel() for p in model.parameters())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--datasets", nargs="+", default=["gen1", "gen4"])
    ap.add_argument("--sizes", nargs="+", default=["tiny", "small", "base", "large"])
    ap.add_argument("--flops", action="store_true", help="also count GFLOP per frame")
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--device", default="cuda", help="where --flops runs the model")
    args = ap.parse_args(argv)
    try:
        device = profiling.card(args.device) if args.flops else None
    except profiling.CardError as e:
        raise SystemExit(f"model_info_torch.py: {e}") from None

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.utils.benchmark import compute_flops

    rows = []
    for dataset in args.datasets:
        for size in args.sizes:
            cfg = get_config(dataset, size)
            h, w = cfg.model.backbone.in_res_hw
            row = dict(metric="model_info", preset=f"{dataset}-{size}", res_hw=[h, w],
                       **count_params(cfg))
            if args.flops:
                row["gflop_per_frame"] = compute_flops(cfg, batch_size=1, sparsity=args.sparsity,
                                                       device=device)["gflops_total"]
                row["sparsity"] = args.sparsity
            rows.append(row)
    profiling.emit("# parameters per preset" + (f"; GFLOP/frame at sparsity {args.sparsity}"
                                                 if args.flops else ""), rows,
                   ("preset", *GROUPS, "total") + (("gflop_per_frame",) if args.flops else ()))


if __name__ == "__main__":
    main()
