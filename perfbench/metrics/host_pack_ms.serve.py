"""The host's time packing a call's frames into the page-locked upload (and
its reset mask), in ms per ``process_batch`` call of the traced stretch:
the program's ``serve.pack`` span over its count of ``serve.batch``
(``perfbench/spans.py``)."""

from perfbench import spans


def read(readings, cell):
    return spans.per_call_ms("serve.pack", "serve.batch")
