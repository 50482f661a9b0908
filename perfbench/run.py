"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration, its traffic
mix and its metrics; the files of each are found by name
(``perfbench/common.Cell``). The mix names the loop that runs it
(``perfbench/loops/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with the reference beside its limit, which
also end standard error. No card, fewer cards than the cell asks for, a
module of JAX or of the JAX package loaded, or a file of the cell missing:
exit code 2 and no result.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.common import (  # noqa: E402
    Cell, Clock, Refused, card_or_refuse, device_info, jax_loaded, log, use_checkout_caches,
)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.seed %= 2 ** 63  # any whole number; the generators take 63 bits
    return args


def per_layer(cell, readings: dict) -> dict:
    out = {}
    for m in cell.per_layer():
        value = cell.reader(m["name"]).read(readings, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(limits: dict, checks: dict):
    """(correct, [name, reading, limit] in order)."""
    rows = [[name, checks[name], lim["limit"]] for name, lim in limits["compared"].items()]
    return all(r[1] <= r[2] for r in rows), rows


def main(argv=None) -> int:
    clock = Clock()
    args = parse(argv)
    try:
        use_checkout_caches()
        cell = Cell(args.workload)
        device = card_or_refuse(cell.chips)
        result = cell.loop().run(cell, args, clock, device)
    except Refused as e:
        log(f"refused: {e}")
        return 2
    found = jax_loaded()
    if found:
        log(f"refused: JAX or the JAX package is loaded: {found}")
        return 2
    correct, rows = verdict(cell.limits, result["checks"])
    readings = result["readings"]
    if args.trace:
        metrics = per_layer(cell, readings)
    else:
        metrics = {m["name"]: {"value": (result["setup_s"] if m["name"] == "setup_s"
                                         else result["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end()}
    device = device_info(cell.chips, result["memory"])
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device}
    if args.trace and "trace" in readings:
        from perfbench.trace import breakdown

        red = readings["trace"]
        device["busy_s"], device["window_s"] = red["busy_s"], red["window_s"]
        line["breakdown"] = breakdown(red)
    for name, value in result["checks"].items():
        if name not in cell.limits["compared"]:
            log(f"reading {name} = {value!r} (not compared)")
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
