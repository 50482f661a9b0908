#!/usr/bin/env python3
"""Phase 7a of ``chip_smoke.py`` (two gloo ranks against one process, beside
the floor) at several settings, on one card: how far a world of two and
the floor runs (the one process with its lanes in three other orders, and
without cuDNN) each move the state of one process.

Settings: the phase's own (a constant rate of 1e-5, data seed 71); the same
with data seed 72; the rate reached by the one-cycle warm-up (a twentieth
of 1e-5 at the first steps, data seed 71), the setting of the phase before
it took a constant rate. Prints the card's name and power limit, then one
JSON line per setting. Fails where the world is beyond 4 times the floor.

    python3 scripts/torch_dp_spread.py
"""
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SETTINGS = (dict(warmup=False, seed=71), dict(warmup=False, seed=72), dict(warmup=True, seed=71))


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from sast_tpu_torch import build

    if not torch.cuda.is_available():
        sys.exit("this script needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    build.build()
    for setting in SETTINGS:
        work = Path(tempfile.mkdtemp(dir=cs.OUT_DIR))
        try:
            out = cs.phase_data_parallel(torch, np, card, work, checks=False, **setting)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(dict(card=card, **setting, **out)), flush=True)


if __name__ == "__main__":
    main()
