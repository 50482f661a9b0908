"""The host's time copying a batch into the page-locked staging, in ms per
optimizer step of ``fit`` in the traced stretch: the program's ``fit.stage``
span over its count of ``fit.launch`` (one a step; ``perfbench/spans.py``)."""

from perfbench import spans


def read(readings, cell):
    return spans.per_call_ms("fit.stage", "fit.launch")
