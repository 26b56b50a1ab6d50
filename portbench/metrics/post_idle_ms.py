"""Device idle in terrain post-processing, per call: the host time of the
program's "Terrain post-processing" span (its own start and end) in which
no device event ran, from the profiler's trace (harness/spans.py)."""

from portbench.harness import spans

UNIT = "ms"


def read(trace):
    return spans.idle_ms(trace,
                         lambda name: name == "Terrain post-processing")
