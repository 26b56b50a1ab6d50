"""The relax kernels' share of their bytes bound over the traced calls:
the least time the card needs to read each tensor argument of each loop
call once and write its output once, at the H100's 3.35 TB/s, over the
device time of those kernels in the trace. The loop calls are recorded
by wrapping the functions of kernels/sweeps.json."""

from portbench.harness import yardstick

UNIT = "%"
KERNELS = "sweeps"


def read(trace):
    names = trace["kernel_names"][KERNELS]
    device_s = sum(b - a for name, a, b in trace["events"]
                   if any(k in name for k in names))
    nbytes = sum(sum(v) for v in trace["kernel_bytes"][KERNELS].values())
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * yardstick.bytes_bound_s(nbytes) / device_s
