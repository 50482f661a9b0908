"""Kernel D's RVT variant's share of its roofline in the traced serve calls,
in %: its least time per call at the cell's shapes
(``perfbench/yardstick_rvt.block_least_seconds``: per attention layer the
larger of its bytes over 3.35 TB/s and its operations over 989.4 TFLOP/s,
summed over the step's eight layers) over its card time per call, its
kernels found by the name they carry (``rvt_block``). None where the traced
calls launched none of them."""

import re

from perfbench import yardstick_rvt


def read(readings, cell):
    red = readings.get("trace") or {}
    pattern = re.compile(yardstick_rvt.KERNEL)
    seconds = sum(s for name, (s, _) in red.get("kernels", {}).items() if pattern.search(name))
    if not seconds:
        return None
    least = yardstick_rvt.block_least_seconds(readings["lanes"], cell.config)
    return 100.0 * least / (seconds / red["calls"])
