"""The share of the traced calls' wall in which no operation ran on the
device: 1 - (union of the device event intervals) / (the calls' wall),
from the profiler's trace."""

UNIT = "%"


def read(trace):
    if trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
