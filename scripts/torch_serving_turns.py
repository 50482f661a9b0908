#!/usr/bin/env python3
"""Time the live serving step of one checkout of the PyTorch/CUDA port on the card.

For comparing two checkouts (a parent commit and its change) in turns in one
call on one card, one process each, e.g. parent, change, change, parent:

    python3 scripts/torch_serving_turns.py --root PATH --tag parent \\
        --out chiprun_out/serving_turns.jsonl

imports ``sast_tpu_torch`` from PATH (default: this checkout), builds its
libraries, and prints one JSON line (appended to ``--out`` too): the card's
name and power limit, then per attention path (masked, sparse kernel E,
looped kernel F, fused kernel D) the ms per ``StreamingDetector.step`` at
gen4-base, 4 streams, bf16, seeded random weights and chip_smoke.py's
clustered frames (CUDA events over 20 steps after 3, as chip_smoke.py phase
3 times it: the step is paced by the host, so this is where a change of
host work per kernel call shows), the host CPU time of this process per
step over the same calls (``time.process_time``, which a busy neighbour on
the host moves less than the wall clock), and a digest of the step's
detections and telemetry (the same digest on two trees means the same
bits; of the second step, a captured step's first replay). Only the public
API that both sides of a comparison share is used.

``--paths`` picks the paths, by name: the four above (the default), or
``captured_default``, ``captured_gather_0.5`` and ``captured_threshold_0.5``,
the captured step (the detector's default on a card) on the default path
and on the two configurations whose attention layers choose their branch
on the card (``attention.gather_budget`` 0.5; the sparse kernel below
``attention.pallas_density_threshold`` 0.5), timed the same way after the
capture.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PATHS = ("masked", "sparse", "looped", "fused")
# name -> (attention switches, sparse_kernel): the captured step's paths
CAPTURED = {"captured_default": ({}, False),
            "captured_gather_0.5": ({"gather_budget": 0.5}, False),
            "captured_threshold_0.5": ({"pallas_density_threshold": 0.5}, True)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose sast_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="name of the checkout in the output")
    ap.add_argument("--out", default=None, help="file the JSON line is appended to")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help=f"comma-separated, of {', '.join(PATHS + tuple(CAPTURED))}")
    args = ap.parse_args()
    paths = [n for n in args.paths.split(",") if n]
    unknown = [n for n in paths if n not in PATHS and n not in CAPTURED]
    if unknown:
        sys.exit(f"torch_serving_turns: unknown paths {unknown}")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_serving_turns: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sast_tpu_torch import build
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.models.detector import YoloXDetector, build_detector
    from sast_tpu_torch.ops import sparse_block
    from sast_tpu_torch.packing import pack_event_batch
    from sast_tpu_torch.serving import StreamingDetector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    build.build()
    cfg = get_config("gen4", "base")
    h, w = cfg.dataset.resolution_hw
    S, E = smoke.STREAMS, smoke.EVENTS_PER_FRAME
    rng = np.random.RandomState(7)
    frame = [smoke.clustered_events(np, rng, E - 1000 * s, h, w, 0, s) for s in range(S)]
    packed, n = pack_event_batch(frame, S, E)
    pk, nk = torch.from_numpy(packed).cuda(), torch.from_numpy(n).cuda()
    no_reset = torch.zeros(S, dtype=torch.bool, device="cuda")
    model = build_detector(cfg.model, seed=0, device="cuda")
    record = dict(tag=args.tag, root=str(Path(args.root).resolve()), card=card,
                  torch=torch.__version__)
    for name in paths:
        if name in CAPTURED:
            switches, sparse_kernel = CAPTURED[name]
            cfg_p = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, backbone=dataclasses.replace(
                    cfg.model.backbone, attention=dataclasses.replace(
                        cfg.model.backbone.attention, **switches))))
            model_p = YoloXDetector(cfg_p.model)
            model_p.load_state_dict(model.state_dict())
            det = StreamingDetector(cfg_p, model_p, max_events=E, num_streams=S,
                                    sparse_kernel=sparse_kernel)
        elif name == "masked":
            det = StreamingDetector(cfg, model, max_events=E, num_streams=S)
        else:
            det = smoke.path_detector(cfg, model, name, E, S)
        sparse_block.MODEL_USES_LOOPED = name == "looped"
        try:
            det.step(pk, nk, no_reset)  # a captured step's warm-up and capture
            dets, tel = det.step(pk, nk, no_reset)  # and its first replay
            h_ = hashlib.sha256()
            for t in [dets[k] for k in sorted(dets)] + [tel]:
                h_.update(t.contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
            det.reset()
            cpu0 = time.process_time()
            ms = smoke.cuda_ms(torch, lambda: det.step(pk, nk, no_reset), iters=20, warmup=3)
            cpu_ms = (time.process_time() - cpu0) / 23 * 1e3
        finally:
            sparse_block.MODEL_USES_LOOPED = False
        record[name] = dict(step_ms=ms, host_cpu_ms=cpu_ms, digest=h_.hexdigest()[:16])
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
