"""The host's time blocked on the card, in ms per optimizer step of ``fit``
in the traced stretch: the program's ``fit.wait`` span (the wait for the
previous batch's copies before the staging is rewritten, and a log point's
read of the metrics) over its count of ``fit.launch``
(``perfbench/spans.py``)."""

from perfbench import spans


def read(readings, cell):
    return spans.per_call_ms("fit.wait", "fit.launch")
