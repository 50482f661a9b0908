#!/usr/bin/env python3
"""Host cost of the serving kernels' operators on the card.

    python3 scripts/torch_op_overhead.py [--calls 200] [--out chiprun_out/op_overhead.json]

Each serving kernel is called on the card at a gen4-base b4 shape two ways
in one process, in turns (operator, direct, direct, operator): through its
``torch.library`` operator ``torch.ops.sast_tpu_torch.*`` (the dispatcher,
then the CUDA implementation), and through the function that defines the
CUDA implementation, called directly (``custom_op``'s ``_init_fn``): the
same launch without the dispatcher. Per call, the host CPU time of this
process (``time.process_time``) and the wall time with the card's work
queued behind long matrix products (so that the host, not the card, paces
the calls), over ``--calls`` calls. Kernels A (with the density) and B at
(4, 384, 640, 20), C at 4 x 1000 candidates, D, E and F at stage 1 (1024
windows of 60 tokens, 64 channels, bf16, window density 0.4). Prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "op_overhead.json"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_op_overhead: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("kernel_turns",
                                                  HERE / "scripts" / "torch_kernel_turns.py")
    turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turns)
    from sast_tpu_torch import build
    from sast_tpu_torch.ops import block, density, fused_block, nms_keep, sparse_block, stem_conv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    build.build()
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.poisson(0.1, (4, 384, 640, 20))).astype(np.uint8)).cuda()
    w = torch.from_numpy(rng.randn(64, 20, 7, 7).astype(np.float32)).cuda().to(torch.bfloat16)
    boxes, scores = turns.nms_inputs(torch, np, 4)
    y, tok, win, params = turns.block_inputs(torch, np, 1024, 64, 2, torch.bfloat16, 0)
    heads, dh, eps = 2, 32, 1e-5
    plist = [params[k] for k in block.PARAM_KEYS]
    ops = torch.ops.sast_tpu_torch
    # name -> (the operator, its CUDA implementation as defined, the arguments)
    calls = {
        "A stem_conv_density7x4": (ops.stem_conv_density7x4, stem_conv._stem_density_op, (x, w)),
        "B density_ratio": (ops.density_ratio, density._density_op, (x,)),
        "C greedy_keep": (ops.greedy_keep, nms_keep._greedy_keep_op, (boxes, scores, 0.5)),
        "D fused_block_fwd": (ops.fused_block_fwd, fused_block._fused_op,
                              (y, tok, plist, heads, dh, eps)),
        "E sparse_block_fwd": (ops.sparse_block_fwd, sparse_block._sparse_fwd_op,
                               (y, tok, win, plist, heads, dh, eps, False)),
        "F sparse_block_looped": (ops.sparse_block_looped, sparse_block._looped_op,
                                  (y, tok, win, plist, heads, dh, eps)),
    }
    ahead = torch.randn(8192, 8192, device="cuda")

    def host_us(fn):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        for _ in range(3):
            ahead @ ahead  # the card's queue: the calls below are paced by the host
        cpu0, wall0 = time.process_time(), time.perf_counter()
        for _ in range(args.calls):
            fn()
        cpu, wall = time.process_time() - cpu0, time.perf_counter() - wall0
        torch.cuda.synchronize()
        return cpu / args.calls * 1e6, wall / args.calls * 1e6

    record = dict(card=card, torch=torch.__version__, calls=args.calls)
    with torch.no_grad():
        for name, (op, definition, a) in calls.items():
            through = lambda: op(*a)  # noqa: E731
            direct = lambda: definition._init_fn(*a)  # noqa: E731
            got = [host_us(f) for f in (through, direct, direct, through)]
            record[name] = dict(operator_cpu_us=(got[0][0] + got[3][0]) / 2,
                                direct_cpu_us=(got[1][0] + got[2][0]) / 2,
                                operator_wall_us=(got[0][1] + got[3][1]) / 2,
                                direct_wall_us=(got[1][1] + got[2][1]) / 2)
    line = json.dumps(record)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
