"""Capped relax launches per call: the launches of the staged relax
kernels whose chunk T the shared-memory window cap cut below its free
size, which the program counts at its stage spans' boundaries (a span's
``capped``), summed over a call's depth-0 spans (harness/spans.py). None
where the spans carry no such count (a program that does not count
them), where the stages carry no span record, or where no call came."""

from portbench.harness import spans

UNIT = "launches"


def read(trace):
    calls = [spans.stage_spans(c) for c in trace["calls"]]
    if not calls or any(c is None for c in calls):
        return None
    if any(not hasattr(s, "capped") for c in calls for s in c):
        return None
    per_call = [sum(s.capped for s in c) for c in calls]
    return sum(per_call) / len(per_call)
