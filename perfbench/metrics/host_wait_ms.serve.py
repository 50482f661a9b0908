"""The host's time blocked on the card, in ms per ``process_batch`` call of
the traced stretch: the program's ``serve.wait`` span (the wait for the
slate's download) over its count of ``serve.batch``
(``perfbench/spans.py``)."""

from perfbench import spans


def read(readings, cell):
    return spans.per_call_ms("serve.wait", "serve.batch")
