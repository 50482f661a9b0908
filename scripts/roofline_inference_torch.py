#!/usr/bin/env python3
"""The streaming inference step against its FLOP and byte floors on the
card (port of scripts/roofline_inference.py).

The step is one frame of the gen4-base model at ``--batch`` lanes
(backbone with carried state, PAFPN, head; the JAX script's ``model.apply``)
on a uint8 input at ``--sparsity`` (``data/synthetic.sparse_event_input``,
seed 0), seeded weights, the attention path of ``--path``. Its FLOPs and
bytes come from ``utils/benchmark.count_flops_and_bytes``:
``FlopCounterMode``'s count (the kernels' operators as their plain versions
at full window density) and the bytes of every operator's tensor inputs and
outputs, an upper bound of the traffic as if nothing were fused. Then

  compute floor = FLOPs / the card's dense bf16 peak
  memory floor  = bytes / the card's memory rate

against the measured step: ``--measured-ms``, or the slope of chained
chunks of ``--L1`` and ``--L2`` frames (``utils/benchmark.streaming_chunk``
and ``chunk_times``). The shares are each floor over the measured time.

The card's numbers come from ``utils/profiling.CARDS`` by
``torch.cuda.get_device_name()`` (H100 80GB HBM3: 989.4 TFLOP/s, 3.35
TB/s); another card is refused by name. The JAX script's table of TPUs is
not carried over. ``--device cpu`` counts the FLOPs and bytes and times
the step, and reports the floors, the shares and the bound as null: the
table holds no CPU.

    python scripts/roofline_inference_torch.py [--batch 4] [--sparsity 0.9]
        [--measured-ms X] [--path default|...] [--device cuda|cpu]

Prints the card's name and power limit, the table, then one JSON line.
Runs on the card; ``--device cpu`` runs the plain versions on the CPU.
Without a card it refuses by name.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sast_tpu_torch.utils import profiling  # noqa: E402
from sast_tpu_torch.utils.benchmark import PATHS  # noqa: E402


def floors(flops: float, n_bytes: float, measured_ms: float, known) -> dict:
    """The step's floors on the card of ``known`` (its row of
    ``utils/profiling.CARDS``) and their shares of ``measured_ms``; every
    entry None without a row."""
    if known is None:
        return dict.fromkeys(("peak_tflops", "mem_tb_per_s", "compute_floor_ms",
                              "memory_floor_ms", "compute_share", "memory_share",
                              "ridge_flop_per_byte", "bound"))
    peak, rate = known["bf16_tflops"], known["hbm_tb_per_s"]
    compute_ms, memory_ms = flops / (peak * 1e12) * 1e3, n_bytes / (rate * 1e12) * 1e3
    ridge = peak / rate
    return dict(peak_tflops=peak, mem_tb_per_s=rate, compute_floor_ms=compute_ms,
                memory_floor_ms=memory_ms, compute_share=compute_ms / measured_ms,
                memory_share=memory_ms / measured_ms, ridge_flop_per_byte=ridge,
                bound="memory" if flops / max(n_bytes, 1) < ridge else "compute")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--measured-ms", type=float, default=None,
                    help="a known step time in ms (skips the timing)")
    ap.add_argument("--L1", type=int, default=100)
    ap.add_argument("--L2", type=int, default=600)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--dataset", default="gen4")
    ap.add_argument("--size", default="base")
    ap.add_argument("--path", choices=PATHS, default="default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", dest="overrides", action="append", metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    try:
        device = profiling.card(args.device)
        info = profiling.card_info(device)
        known = profiling.card_numbers(info["kind"]) if device.type == "cuda" else None
    except profiling.CardError as e:
        raise SystemExit(f"roofline_inference_torch.py: {e}") from None

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.utils.benchmark import (
        _build_model_and_inputs,
        chunk_times,
        count_flops_and_bytes,
        looped_kernel,
        path_config,
        streaming_chunk,
    )
    from train_torch import parse_overrides

    cfg = get_config(args.dataset, args.size, **parse_overrides(args.overrides))
    cfg, sparse_kernel, looped = path_config(cfg, args.path)
    model, x, states = _build_model_and_inputs(cfg, args.batch, args.sparsity, args.seed,
                                               device, sparse_kernel)
    with looped_kernel(looped):
        flops, n_bytes = count_flops_and_bytes(model, x, states)
        measured = args.measured_ms
        t1 = t2 = None
        if measured is None:
            def make_fn(length):
                run = streaming_chunk(model, length)
                return lambda: run(x, states)

            t1, t2 = chunk_times(make_fn, args.L1, args.L2, args.blocks)
            measured = (min(t2) - min(t1)) / (args.L2 - args.L1) * 1e3
    row_floors = floors(flops, n_bytes, measured, known)
    print(f"# card: {info['smi']}; peak {known['bf16_tflops']} TFLOP/s bf16, memory "
          f"{known['hbm_tb_per_s']} TB/s" if known else
          "# device: cpu; no peak or memory rate (utils/profiling.CARDS holds cards only)")
    row = dict(metric="roofline_inference", dataset=args.dataset, size=args.size,
               path=args.path, batch=args.batch, sparsity=args.sparsity,
               gflop_per_step=flops / 1e9, mb_per_step=n_bytes / 1e6, measured_ms=measured,
               measured_given=args.measured_ms is not None, t_L1_s=t1, t_L2_s=t2,
               flop_per_byte=flops / max(n_bytes, 1), **row_floors, device_kind=info["kind"], card=info["smi"])
    profiling.emit(f"# roofline of the {args.dataset}-{args.size} step, batch {args.batch}, "
                   f"sparsity {args.sparsity}, path {args.path}", [row],
                   ("gflop_per_step", "mb_per_step", "compute_floor_ms", "memory_floor_ms",
                    "measured_ms", "compute_share", "memory_share"))


if __name__ == "__main__":
    main()
