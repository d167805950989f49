"""What the program records of itself while a profiler records
(geobignn_tpu_torch/tracing.py): its counters, read here, and its spans,
which arrive among a Trace's host events with the profiler's own.  A
program without them (one from before its tracing) reads as nothing: its
counters as {}, its spans as [], and a metric of them as None."""

from __future__ import annotations


def counters() -> dict:
    """The program's counters (only a traced window counts)."""
    try:
        from geobignn_tpu_torch import tracing
    except ImportError:  # a program without spans and counters
        return {}
    return tracing.counters()


def ratio(name: str, per: str):
    """counters()[name] / counters()[per], or None without a reading."""
    c = counters()
    if not c.get(per) or name not in c:
        return None
    return c[name] / c[per]


def spans(trace, *names) -> list:
    """(start_us, end_us) of the trace's host spans named `names`, clipped
    to its window; [] without a trace."""
    if trace is None:
        return []
    lo, hi = trace.window
    return [(max(s, lo), min(e, hi)) for n, s, e in trace.host
            if n in names and e > lo and s < hi]
