"""Convergence reads per call: the host reads of a loop's stop test (a
sweep loop's change flag, a pointer-doubling loop's "any pointer left"),
which the program makes through ``spmd.flag_any`` and counts at its stage
spans' boundaries, summed over a call's stages (harness/spans.py)."""

from portbench.harness import spans

UNIT = "reads"


def read(trace):
    return spans.reads(trace)
