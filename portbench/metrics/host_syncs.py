"""Host syncs per call: the synchronizing torch calls of a call, counted
by CUDA sync debug mode in a pass after the profiled one (the host code of
the sweep loops, ops/banded.py relax(), erosion/flood.py, climate/*)."""

UNIT = "syncs"


def read(trace):
    if not trace["host_syncs"]:
        return None
    return sum(trace["host_syncs"]) / len(trace["host_syncs"])
