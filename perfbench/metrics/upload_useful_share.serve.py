"""The share of the bytes uploaded that are events, in %, over the traced
stretch: 16 bytes an event (four int32) times the program's counter
``serve.events`` over its counter ``serve.upload_bytes``, the bytes that
``process_batch``'s uploads enqueued (``perfbench/spans.py``): 16 a filled
event and 9 a lane (its first column, count and reset), so the share is
16 E / (16 E + 9 S) over E events in S lanes, under 100%."""

from perfbench import spans

EVENT_BYTES = 16


def read(readings, cell):
    share = spans.ratio("serve.events", "serve.upload_bytes")
    return None if share is None else 100.0 * EVENT_BYTES * share
