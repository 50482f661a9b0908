"""The share of the bytes uploaded that are events, in %, over the traced
stretch: 16 bytes an event (four int32) times the program's counter
``serve.events`` over its counter ``serve.upload_bytes`` (every lane's
whole budget of events, the counts and the resets; ``perfbench/spans.py``)."""

from perfbench import spans

EVENT_BYTES = 16


def read(readings, cell):
    share = spans.ratio("serve.events", "serve.upload_bytes")
    return None if share is None else 100.0 * EVENT_BYTES * share
