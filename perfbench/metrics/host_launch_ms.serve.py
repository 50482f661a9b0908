"""The host's time enqueuing a call's work, in ms per ``process_batch`` call
of the traced stretch: the program's ``serve.launch`` span (the uploads,
every replica's replay, the slate's downloads and their event) over its
count of ``serve.batch`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(readings, cell):
    return spans.per_call_ms("serve.launch", "serve.batch")
