"""The traced pass of a ``--trace 1`` run: the calls under
``torch.profiler`` (device events only), the loop calls of the kernel
lists recorded with their bytes, the program's stage spans (its
``StageTimer``) on the host clock, and a separate pass that counts host
syncs. What the metric readers get is the dict :func:`traced` returns."""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

from . import yardstick


@contextlib.contextmanager
def _recording(kernel_lists):
    """Wrap the loop functions of each kernel list (name → list) so that
    each call adds its bytes (:func:`yardstick.call_bytes`) to the record
    of its list and function."""
    records, undo = {}, []
    for list_name, spec in kernel_lists.items():
        mod = importlib.import_module(spec["module"])
        for fn in spec["functions"]:
            orig = getattr(mod, fn)
            rec = records.setdefault(list_name, {}).setdefault(fn, [])

            @functools.wraps(orig)
            def wrapped(*a, _orig=orig, _rec=rec, **kw):
                out = _orig(*a, **kw)
                _rec.append(yardstick.call_bytes(a, kw, out))
                return out

            setattr(mod, fn, wrapped)
            undo.append((mod, fn, orig))
    try:
        yield records
    finally:
        for mod, fn, orig in undo:
            setattr(mod, fn, orig)


@contextlib.contextmanager
def _stage_spans():
    """Record the program's stage spans ``(name, start, end)`` (host
    clock, seconds) while the pass runs."""
    from planet_heightmap_generation_torch.pipeline.timing import StageTimer

    spans, orig = [], StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name, sync=None):
        t0 = time.perf_counter()
        with orig(self, name, sync):
            yield
        spans.append((name, t0, time.perf_counter()))

    StageTimer.stage = stage
    try:
        yield spans
    finally:
        StageTimer.stage = orig


def _label(spans, t: float) -> str:
    """The innermost stage span holding the host time ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else "between stages"


def traced(call, cmds, n_calls: int, n_sync: int, kernel_lists, device):
    """Run ``n_calls`` commands of ``cmds`` under the profiler, then
    ``n_sync`` more counting host syncs. ``call(cmd)`` runs one command
    and returns (key, result or None if it failed) after a device sync.
    Returns (trace, results) with ``results`` the (key, result) pairs of
    both passes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    results, calls = [], []
    torch.cuda.synchronize(device)
    with _recording(kernel_lists) as records, _stage_spans() as spans, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_mark = time.perf_counter()
        torch.ones(1, device=device)        # the first device event
        torch.cuda.synchronize(device)
        for _ in range(n_calls):
            cmd = next(cmds)
            a = time.perf_counter()
            key, res = call(cmd)
            b = time.perf_counter()
            calls.append(dict(start=a, end=b, result=res))
            results.append((key, res))
    dev_events = sorted(
        ((e.name, e.time_range.start, e.time_range.end)
         for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e[1])
    if len(dev_events) < 2:
        raise RuntimeError("the profiler's trace holds no device events")
    # the host clock of a device time: the marker started at t_mark
    mark_us = dev_events[0][1]
    events = [(name, t_mark + (a - mark_us) / 1e6, t_mark + (b - mark_us) / 1e6)
              for name, a, b in dev_events[1:]]
    busy = window = 0.0
    gaps: dict = {}
    for c in calls:
        inside = [(max(a, c["start"]), min(b, c["end"]))
                  for _, a, b in events if b > c["start"] and a < c["end"]]
        busy += yardstick.busy_us([(a * 1e6, b * 1e6) for a, b in inside]) \
            / 1e6
        window += c["end"] - c["start"]
        for a, b in yardstick.idle_gaps(inside, c["start"], c["end"]):
            key = _label(spans, (a + b) / 2)
            gaps[key] = gaps.get(key, 0.0) + (b - a)
    by_name: dict = {}
    for name, a, b in events:
        by_name[name] = by_name.get(name, 0.0) + (b - a)

    syncs = []
    for _ in range(n_sync):
        cmd = next(cmds)
        key_res, n = yardstick.count_host_syncs(lambda: call(cmd))
        syncs.append(n)
        results.append(key_res)

    trace = dict(
        calls=[dict(wall_s=c["end"] - c["start"],
                    stages=list(c["result"].timing.stages))
               for c in calls if c["result"] is not None],
        events=events, busy_s=busy, window_s=window, kernel_bytes=records,
        kernel_names={n: sorted(set(spec["functions"].values()))
                      for n, spec in kernel_lists.items()},
        host_syncs=syncs,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10])
    return trace, results
