"""The card's idle share of the traced stretch of serve calls, in %: one
minus the union of its kernels, copies and sets over the stretch's length
(``perfbench/trace.py``)."""


def read(readings, cell):
    red = readings.get("trace") or {}
    if not red.get("window_s"):
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
