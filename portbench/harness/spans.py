"""The program's own span records in a traced run: each command's
``StageTimer`` stages (``PlanetResult.timing.stages``), where the program
records them as spans with ``depth``, ``start``, ``end`` (host seconds on
``time.perf_counter()``, the clock :mod:`.trace` maps the device events
onto) and ``reads``. A program whose stages are bare ``(name, ms)`` pairs
has none of these: the readers then read nothing."""

from __future__ import annotations

import bisect

from . import yardstick


def stage_spans(call):
    """The depth-0 spans of a traced call, or None where its stages carry
    no span record."""
    stages = call["stages"]
    if any(getattr(s, "start", None) is None for s in stages):
        return None
    return [s for s in stages if s.depth == 0]


def _device_index(events):
    """(events sorted by start, their starts, the longest event's length)."""
    ev = sorted(events, key=lambda e: e[1])
    return ev, [a for _, a, _ in ev], max((b - a for _, a, b in ev),
                                          default=0.0)


def span_idle_s(index, start: float, end: float) -> float:
    """The seconds of [start, end] in which no device event of ``index``
    (:func:`_device_index`) ran: the span's length less the union of the
    events clipped to it."""
    ev, starts, longest = index
    lo = bisect.bisect_left(starts, start - longest)
    hi = bisect.bisect_left(starts, end)
    inside = [(max(a, start) * 1e6, min(b, end) * 1e6)
              for _, a, b in ev[lo:hi] if b > start and a < end]
    return (end - start) - yardstick.busy_us(inside) / 1e6


def idle_ms(trace, selects):
    """The mean over the traced calls of the span idle (ms) summed over
    each call's depth-0 spans whose name ``selects`` accepts (a repeated
    name counts each time); None where the stages carry no span record or
    no call has such a span."""
    calls = [stage_spans(c) for c in trace["calls"]]
    if not calls or any(c is None for c in calls):
        return None
    if not any(selects(s[0]) for c in calls for s in c):
        return None
    index = _device_index(trace["events"])
    per_call = [sum(span_idle_s(index, s.start, s.end)
                    for s in c if selects(s[0])) * 1e3 for c in calls]
    return sum(per_call) / len(per_call)


def reads(trace):
    """The mean over the traced calls of the convergence reads their
    depth-0 spans counted; None where the stages carry no span record."""
    calls = [stage_spans(c) for c in trace["calls"]]
    if not calls or any(c is None for c in calls):
        return None
    per_call = [sum(s.reads for s in c) for c in calls]
    return sum(per_call) / len(per_call)
