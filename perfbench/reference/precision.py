"""The precisions in which the reference's matrix products take their
operands: float32 (the reference), and the control's lower ones.

The configurations state bfloat16, so the control is the reference with
every operand of every matrix product and convolution rounded to float8
e4m3 with one scale per tensor (amax to 448), the step that an fp8 path of
the program would take. The rounding passes gradients straight through, so
the same control serves training."""

from __future__ import annotations

import torch

from perfbench.reference.detector import identity

FP8_MAX = 448.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32; the gradient passes unchanged."""
    with torch.no_grad():
        amax = t.detach().abs().amax().clamp_min(1e-12)
        scale = FP8_MAX / amax
        r = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t + (r - t).detach() if t.requires_grad else r


PRECISIONS = {"fp32": identity, "fp8": fp8_e4m3}
