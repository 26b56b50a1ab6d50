"""The benchmark's frozen metric arithmetic: the device-busy union, the
host-sync count and the bytes bound of a kernel call, with the published
peaks of one NVIDIA H100 (SXM, NVIDIA's data sheet, at its 700 W power
limit). Copied from the port's chip_smoke.py (``profile_generate``,
``count_host_syncs``, ``bound_ms``) so that later changes there leave the
yardstick as it is."""

from __future__ import annotations

import math
import subprocess
import warnings

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, 80 GB HBM3
F32_OPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores


def busy_us(spans) -> float:
    """The length of the union of the ``(start, end)`` intervals (µs)."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def idle_gaps(spans, lo: float, hi: float):
    """The gaps ``(start, end)`` inside [lo, hi] that no interval of
    ``spans`` covers."""
    gaps, cur = [], lo
    for a, b in sorted(spans):
        if b <= cur:
            continue
        a = max(a, lo)
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def tensor_bytes(x) -> int:
    """The bytes of every tensor in ``x`` (a tensor, or tuples, lists and
    dicts of them); other values count 0."""
    import torch

    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(tensor_bytes(v) for v in x.values())
    return 0


def call_bytes(args, kwargs, out) -> int:
    """A loop call's least traffic: each tensor argument read once and
    each output written once (the state of a ``(state, count)`` result)."""
    if isinstance(out, tuple):
        out = out[0]
    return tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)


def bytes_bound_s(nbytes: float) -> float:
    """The least seconds the card needs to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S


def count_host_syncs(fn):
    """(fn(), host syncs): the synchronizing torch calls inside ``fn()``,
    counted as the warnings of CUDA sync debug mode."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"
