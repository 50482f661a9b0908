"""Whether a train cell's ``fit`` trained right: its first three steps
against the reference's three steps from the same weights and batches.

Readings, against the limits in ``limits/<cell>.json`` where they are
compared (the others are printed beside them):

- ``loss_gap``: the worst over the three steps of |program - reference| /
  |reference| of the step's loss;
- ``obj_gap``: the same of the loss's objectness term summed over every
  anchor of every labeled frame before its division by the foreground count
  (the program's ``conf_loss`` times its foreground count): the forward's
  precision without the few anchors whose assignment moved;
- ``grad_gap``: the first step's gradient as the optimizer got it, the
  program's worked out from its first moments after one step (m1 / (1 -
  b1)), by the worst leaf: | ||g_p|| - ||g_r|| | over the larger of the
  reference's ||g_r|| and the median leaf's (some gradients are all but
  zero);
- ``change_gap``: the parameters' change over the three steps by the worst
  leaf, as ``grad_gap``, over the elements whose reference gradient reaches
  a thousandth of the median leaf's root mean square (``moved``: an element
  with no gradient to rounding, such as the key bias under softmax, moves
  under Adam by round-off alone, by the rate on one side and not at all on
  the other).

At a random initialisation SimOTA's costs lie close together, and the
program's bfloat16 moves a few of its assignments (and so the foreground
count that divides the loss) where float32 does not, so the loss follows
those few anchors; and the gradients of a randomly initialised network are
small differences of large terms (BatchNorm and LayerNorm backward), so a
leaf's gradient in bfloat16 lies 10-15% from float32's at the median leaf
and more at the worst (PERF.md).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.common import log
from perfbench.reference import detector as R
from perfbench.reference import training as RT
from perfbench.reference.precision import PRECISIONS
from perfbench.weights import make_weights


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf: | ||prog|| - ||ref|| | over the larger of ||ref|| and the
    median leaf's ||ref||."""
    pn = {k: float(v.norm()) for k, v in prog.items()}
    rn = {k: float(ref[k].norm()) for k in prog}
    median = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], median) for k in prog}


def moved(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per leaf, the elements whose reference gradient reaches a thousandth
    of the median leaf's root mean square: the rest (a key's bias under
    softmax, for one) have no gradient to rounding and move under Adam by
    round-off alone. Leaves with no such element are left out."""
    rms = {k: float(g.pow(2).mean().sqrt()) for k, g in grads.items()}
    floor = 1e-3 * float(np.median(list(rms.values())))
    masks = {k: g.abs() >= floor for k, g in grads.items()}
    return {k: m for k, m in masks.items() if m.any()}


def reference_run(cell, sizes: R.Sizes, seed: int, device, batches: List[dict],
                  precision: str = "fp32"):
    """The reference's three steps: (losses, objectness sums, first clipped
    gradients, starting weights, weights after)."""
    R.fp32_only()
    c = cell.config
    P = make_weights(R.param_shapes(sizes), seed, device, head_gain={})
    start = {k: v.clone() for k, v in P.items()}
    trainable = [k for k in P if not k.endswith((".mean", ".var"))]

    def schedule(count):
        return RT.one_cycle(count, c["learning_rate"], c["lr_total_steps"], c["lr_pct_start"],
                            c["lr_div_factor"], c["lr_final_div_factor"])

    opt = RT.AdamW({k: P[k] for k in trainable}, schedule, c["gradient_clip_val"],
                   c["weight_decay"])
    dev = [{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()} for b in batches]
    losses, obj_sums, first = RT.train_steps(P, sizes, dev, trainable, opt,
                                             PRECISIONS[precision])
    return losses, obj_sums, first, start, P


def compare(cell, sizes: R.Sizes, seed: int, device, batches: List[dict], got: dict,
            precision: str = "fp32") -> Dict[str, float]:
    losses, obj_sums, g_ref, start, after = reference_run(cell, sizes, seed, device, batches,
                                                          precision)
    log(f"losses: program {got['losses']}, reference {losses}")
    log(f"objectness sums: program {got['obj_sums']}, reference {obj_sums}")
    g_prog = {k: m / (1.0 - RT.B1) for k, m in got["m1"].items()}
    grads = leaf_gaps(g_prog, g_ref)
    masks = moved(g_ref)
    changes = leaf_gaps({k: (got["params"][k] - start[k])[m] for k, m in masks.items()},
                        {k: (after[k] - start[k])[m] for k, m in masks.items()})
    log(f"worst leaves: gradient {max(grads, key=grads.get)}, change "
        f"{max(changes, key=changes.get)} ({sum(int((~m).sum()) for m in masks.values())} "
        "elements left out of the change)")
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], losses)),
            "obj_gap": max(abs(a - b) / abs(b) for a, b in zip(got["obj_sums"], obj_sums)),
            "grad_gap": max(grads.values()),
            "change_gap": max(changes.values())}
