"""Device idle in the climate stages, per call: the host time of the
program's "Climate: ..." spans (their own starts and ends) in which no
device event ran, summed, from the profiler's trace (harness/spans.py)."""

from portbench.harness import spans

UNIT = "ms"


def read(trace):
    return spans.idle_ms(trace, lambda name: name.startswith("Climate: "))
