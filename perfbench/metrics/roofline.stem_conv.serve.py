"""Kernel A's (the stem convolution with the density pyramid) share of its
roofline in the traced serve calls, in %: its least time at the cell's
shapes (``perfbench/yardstick.stem_bytes_and_flops``: each input byte read
once, each output byte written once, 2 operations per multiply-add; the
larger of bytes over 3.35 TB/s and operations over 989.4 TFLOP/s) over its
card time per call, its kernels found by the names of their sources. None
where the traced calls launched none of them."""

import re

from perfbench import yardstick


def read(readings, cell):
    red = readings.get("trace") or {}
    pattern = re.compile(yardstick.KERNEL_A)
    seconds = sum(s for name, (s, _) in red.get("kernels", {}).items() if pattern.search(name))
    if not seconds:
        return None
    n_bytes, flops = yardstick.stem_bytes_and_flops(readings["lanes"], cell.config)
    return 100.0 * yardstick.least_seconds(n_bytes, flops) / (seconds / red["calls"])
