"""Train cells: ``Trainer.fit`` as it runs by default (the step captured as a
CUDA graph at its first batch, bfloat16, full rematerialisation), fed from
a pool of host batches made in set-up and cycled.

One ``fit`` call does everything, fed by ``feed``: its first three steps
are set-up and the check's (after step 1 the optimizer's first moments are
copied, after steps 1-3 each step's loss, objectness loss and foreground
count are read, copied on the card by a wrapper of the train step, after
step 3 the parameters are copied); then the window yields batches for ``--seconds``
and waits for the card: ``train_seqs_per_s`` is lanes x steps over the
window's seconds. With ``--trace 1`` ``trace_steps`` more steps run under
the profiler. ``fit`` ends there, saves its checkpoint into a working
directory under ``TMPDIR`` (removed afterwards), and the reference follows
the first three steps (``perfbench/check_train.py``).
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict

import torch

from perfbench import check_train, trace
from perfbench.common import free, log, peak_memory, sync
from perfbench.program import program_config
from perfbench.reference.detector import Sizes, param_shapes
from perfbench.weights import make_weights

CHECK_STEPS = 3


def run(cell, args, clock, device) -> Dict:
    from sast_tpu_torch.training.loop import Trainer

    mix = cell.mix
    sizes = Sizes(cell.config)
    cfg = program_config(cell)
    pool = cell.generator().train_pool(mix, sizes, args.seed, device)
    log(f"set-up: batch pool made at {clock():.3f} s")
    workdir = tempfile.mkdtemp(prefix="perfbench-fit-")
    try:
        trainer = Trainer(cfg, workdir, device=device)
        with torch.no_grad():
            trainer.model.load_state_dict(
                make_weights(param_shapes(sizes), args.seed, device, head_gain={}))
        log(f"set-up: trainer built at {clock():.3f} s")
        names = [n for n, _ in trainer.model.named_parameters()]
        fit_step = trainer.train_step
        seen = torch.zeros(3, device=device)  # the step's loss, conf_loss and num_fg

        def step_with_loss(state, batch, states):
            out = fit_step(state, batch, states)
            seen.copy_(torch.stack([out[2][k] for k in ("loss", "conf_loss", "num_fg")]))
            return out

        trainer.train_step = step_with_loss
        got = dict(losses=[], obj_sums=[])
        timing = {}

        def feed():
            for j in range(CHECK_STEPS):
                yield pool[j % len(pool)]
                sync(device)
                log(f"set-up: step {j + 1} (the first captures the step) done at {clock():.3f} s")
                value, conf, num_fg = seen.tolist()
                b = pool[j % len(pool)]
                gts = max(int((b["gt_valid"] & b["frame_valid"][..., None]).sum()), 1)
                got["losses"].append(value)
                got["obj_sums"].append(conf * max(round(num_fg * gts), 1))
                if j == 0:
                    moments = trainer.state.optimizer.adamw.state_dict()["state"]
                    got["m1"] = {names[i]: s["exp_avg"].clone() for i, s in moments.items()}
            got["params"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
            timing["setup_s"] = clock()
            log(f"set-up {timing['setup_s']:.3f} s")
            steps, j = 0, CHECK_STEPS
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < args.seconds:
                yield pool[j % len(pool)]
                j, steps = j + 1, steps + 1
            sync(device)
            timing["window_s"], timing["steps"] = time.perf_counter() - t0, steps
            if args.trace:
                tracer = trace.Tracer(device)
                for _ in range(mix["trace_steps"]):
                    with tracer.call():
                        yield pool[j % len(pool)]
                    j += 1
                timing["trace"] = tracer.finish()

        trainer.fit(feed(), max_steps=10 ** 9)
        memory = peak_memory(device)
        del trainer, fit_step, step_with_loss
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    free(device)
    lanes = mix["lanes"]
    rate = lanes * timing["steps"] / timing["window_s"]
    log(f"window {timing['window_s']:.3f} s, {timing['steps']} steps")
    readings = dict(seqs_per_s=rate, steps=timing["steps"], lanes=lanes)
    if "trace" in timing:
        readings["trace"] = timing["trace"]
    checks = check_train.compare(cell, sizes, args.seed, device,
                                 [pool[j % len(pool)] for j in range(CHECK_STEPS)], got)
    return dict(setup_s=timing["setup_s"], end_to_end=dict(train_seqs_per_s=rate),
                attempted=timing["steps"] * lanes, failed=0, readings=readings, memory=memory,
                checks=checks)
