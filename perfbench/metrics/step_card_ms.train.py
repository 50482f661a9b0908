"""The card's busy time per optimizer step of ``fit`` in the traced stretch,
in ms: the union of its kernels, copies and sets over the steps."""


def read(readings, cell):
    red = readings.get("trace") or {}
    if not red.get("calls") or not red.get("busy_s"):
        return None
    return 1e3 * red["busy_s"] / red["calls"]
