"""The program's own spans and counters over the traced stretch
(``sast_tpu_torch/utils/timers.py``): the host's clock and counts, taken
inside ``process_batch`` and ``fit``.

They record only while a profiler records, so in a run's process the
registry holds the traced stretch (``perfbench/trace.py``) and nothing
else. A program without the span or counter asked for gives None.
"""

from __future__ import annotations

from typing import Optional

from sast_tpu_torch.utils import timers


def per_call_ms(span: str, calls: str) -> Optional[float]:
    """``span``'s total host time over the count of the span ``calls``, in ms."""
    stats = timers.timer_stats()
    if span not in stats or calls not in stats:
        return None
    return 1e3 * stats[span]["total_s"] / stats[calls]["count"]


def ratio(numerator: str, denominator: str) -> Optional[float]:
    """The total of counter ``numerator`` over that of ``denominator``."""
    stats = timers.timer_stats()
    top, bottom = stats.get(numerator, {}).get("total"), stats.get(denominator, {}).get("total")
    if top is None or not bottom:
        return None
    return top / bottom
