"""Where a profiled run spends the card's time, and what the measuring CLIs
print.

- ``kernel_table``: the CUDA kernel rows of a ``torch.profiler`` run (self
  time on the card), each in one group: the port's hand-written kernels A-H
  by the names and namespaces of their sources, GEMMs and convolutions,
  copies and casts, scatter and index ops, elementwise ops, and the rest
  (reductions, softmax, normalisation); the kernel time per step and the
  hand-written kernels' share of it. ``chip_smoke.py`` (phases 3 and 5) and
  ``scripts/profile_{inference,train}_torch.py`` read it.
- ``card``: the device a CLI was asked for, refused with ``CardError`` when
  it is a card and there is none (nothing falls back to the CPU), which
  each CLI's ``main`` turns into its exit; ``card_numbers``: a card's row
  of ``CARDS``, the same error for a card it does not hold; ``card_info``:
  its name and power limit as ``nvidia-smi`` gives them.
- ``emit``: a CLI's table, then one JSON line per row.
"""

from __future__ import annotations

import json
import re
import subprocess
from typing import Dict, List, Optional, Sequence

import torch

# Dense bf16 peak and memory rate of the cards the CLIs know, by
# ``torch.cuda.get_device_name`` (NVIDIA's data sheet, SXM at 700 W).
CARDS = {"NVIDIA H100 80GB HBM3": dict(bf16_tflops=989.4, hbm_tb_per_s=3.35)}
# The hand-written kernels by the name or namespace of their sources.
HAND_WRITTEN = {
    "A stem_conv": r"stem_\w*kernel|arrange_kernel",
    "B density": r"density_kernel",
    "C nms_keep": r"\bnk::",
    "D/E sparse_fwd": r"^(?!.*looped_kernel).*\bsf::",
    "F looped": r"looped_kernel",
    "G mlp_bwd": r"\bmb::",
    "H attn_bwd": r"\bab::",
}
# The library's kernels by what they do, first match wins.
GROUPS = (
    ("copies and casts", r"copy|memcpy|memset|\bcast"),
    ("scatter and index", r"scatter|index|gather|sort|radix|\btake|\bput"),
    ("GEMMs and convolutions", r"gemm|xmma|cutlass|cudnn|conv|cublas|nvjet|wgrad|dgrad|fprop|"
                               r"aten::(add|b)?mm\b|matmul|linear"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)
OTHER = "reductions and other"


def group_of(name: str) -> str:
    """The group of a CUDA kernel's name: a hand-written kernel's label
    (``HAND_WRITTEN``), a group of ``GROUPS``, or ``OTHER``."""
    for label, pattern in HAND_WRITTEN.items():
        if re.search(pattern, name):
            return label
    low = name.lower()
    for label, pattern in GROUPS:
        if re.search(pattern, low):
            return label
    return OTHER


def kernel_table(prof, steps: int = 1, device_type: str = "cuda") -> Dict:
    """The CUDA kernel rows of ``prof`` (a finished ``torch.profiler.profile``)
    per step of the ``steps`` it recorded: ``kernel_ms`` (their self time on
    the card), ``rows`` (name, group, ms and calls per step, share of
    ``kernel_ms``; by time, longest first), ``groups`` and ``hand_written``
    (ms per step by group, and of the hand-written kernels alone). An
    operator's own row repeats its kernels' time, so only kernel rows
    count; so does an annotation's (a ``record_function`` range, or the
    profiler's own step under a ``schedule``, which the profiler also lays
    on the card's timeline), so none counts. With ``device_type`` "cpu" the
    rows are the operators' self time on the host instead (a run on the CPU
    has no kernel rows)."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if device_type == "cuda" else DeviceType.CPU
    rows, total = [], 0.0
    for e in prof.key_averages():
        if e.device_type != want or getattr(e, "is_user_annotation", False):
            continue
        if want == DeviceType.CPU:
            us = e.self_cpu_time_total
        else:
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        total += us
        rows.append(dict(name=e.key, group=group_of(e.key), ms=us / steps / 1e3,
                         calls=e.count / steps))
    rows.sort(key=lambda r: -r["ms"])
    groups: Dict[str, float] = {}
    for r in rows:
        r["share"] = r["ms"] / (total / steps / 1e3) if total else 0.0
        groups[r["group"]] = groups.get(r["group"], 0.0) + r["ms"]
    return dict(kernel_ms=total / steps / 1e3, rows=rows, groups=groups,
                hand_written={k: v for k, v in groups.items() if k in HAND_WRITTEN})


def format_table(table: Dict, top_k: int = 40, wall_ms: Optional[float] = None) -> List[str]:
    """``kernel_table``'s top ``top_k`` rows and its groups as text lines;
    with ``wall_ms`` (the same steps unprofiled, per step) also the idle
    share ``1 - kernel_ms / wall_ms``."""
    lines = [f"kernel time on the card {table['kernel_ms']:.3f} ms/step"
             + (f", wall {wall_ms:.3f} ms/step, idle share "
                f"{1 - table['kernel_ms'] / wall_ms:.3f}" if wall_ms else ""),
             f"{'ms/step':>10} {'%':>6} {'calls':>7}  {'group':<24} kernel"]
    for r in table["rows"][:top_k]:
        lines.append(f"{r['ms']:10.4f} {100 * r['share']:6.2f} {r['calls']:7.1f}  "
                     f"{r['group']:<24} {r['name'][:90]}")
    lines.append("by group:")
    for group, ms in sorted(table["groups"].items(), key=lambda kv: -kv[1]):
        share = ms / table["kernel_ms"] if table["kernel_ms"] else 0.0
        lines.append(f"{ms:10.4f} {100 * share:6.2f}  {group}")
    return lines


class CardError(RuntimeError):
    """The device a CLI was asked for is a card that this host does not
    have, or one whose numbers ``CARDS`` does not hold."""


def card(device: str) -> torch.device:
    """``device`` as a ``torch.device``; ``CardError`` for a card when
    ``torch.cuda.is_available()`` is false (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CardError(f"--device {device} needs an NVIDIA card and "
                        "torch.cuda.is_available() is false (--device cpu runs the plain "
                        "versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise CardError(f"unsupported device {device}")
    return dev


def card_numbers(kind: str) -> Dict[str, float]:
    """``CARDS``' row of the card named ``kind``; ``CardError`` for a card
    it does not hold."""
    if kind not in CARDS:
        raise CardError(f"no peak or memory rate known for {kind!r} (utils/profiling.CARDS "
                        f"holds {sorted(CARDS)})")
    return CARDS[kind]


def card_info(device: torch.device) -> Dict:
    """``kind`` (``torch.cuda.get_device_name``) and ``smi``, the card's line
    of ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
    ``cpu`` and None on the CPU."""
    if device.type != "cuda":
        return dict(kind="cpu", smi=None)
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={index}"], capture_output=True, text=True, check=True)
    return dict(kind=torch.cuda.get_device_name(device), smi=smi.stdout.strip())


def sync(device) -> None:
    """Wait for ``device``'s queued work when it is a card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def emit(title: str, rows: Sequence[Dict], columns: Sequence[str]) -> None:
    """Print ``title``, a table of ``columns`` over ``rows``, then each row
    whole as one JSON line."""
    print(title)
    print(" ".join(f"{c:>14}" for c in columns))
    for r in rows:
        cells = []
        for c in columns:
            v = r.get(c)
            cells.append(f"{v:>14.4f}" if isinstance(v, float) else f"{str(v):>14}")
        print(" ".join(cells))
    for r in rows:
        print(json.dumps(r))
