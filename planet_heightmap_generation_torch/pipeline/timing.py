"""Per-stage timing instrumentation — the equivalent of the reference's
console.table timing (SURVEY.md §5: 118 performance.now() calls in the
worker). Stages are timed host-side around a device synchronize so
asynchronous CUDA launches don't hide device time.

Each command records one span tree: its stages at depth 0 and the
sub-stage spans the stage code opens inside them (:func:`span`), each
with its host start and end on ``time.perf_counter()`` and the
convergence reads made inside it (:func:`count_read`, called by
``parallel/spmd.py`` ``flag_any``) and the staged relax launches whose
chunk the shared-memory window cap cut (:func:`count_capped`, called by
``ops/sweep_cuda.py``'s launch path). The stage code finds the command's
timer through the calling thread's current timer (:func:`current`),
which the engine sets for the length of each command."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List

import torch

_CURRENT = threading.local()


class Span(tuple):
    """One recorded span: unpacks as ``(name, ms)``. ``depth`` (0 for a
    command's stages), ``start`` and ``end`` (host seconds on
    ``time.perf_counter()``), ``reads`` (the convergence reads made
    inside it) and ``capped`` (the capped relax launches made inside it),
    each counting its children's, are attributes."""

    def __new__(cls, name: str, ms: float, depth: int, start: float,
                end: float, reads: int, capped: int = 0):
        self = super().__new__(cls, (name, ms))
        self.depth, self.start, self.end, self.reads = depth, start, end, \
            reads
        self.capped = capped
        return self

    def __reduce__(self):
        return (Span, (self[0], self[1], self.depth, self.start, self.end,
                       self.reads, self.capped))


class StageTimer:
    """``sync_enabled=False`` (the production default) turns per-stage
    device synchronizes into no-ops: stages record enqueue time only and
    the device pipeline runs gap-free with a single final sync. Enable it
    (engine ``timing=True`` / ``PLANET_TIMING=1``) to get true per-stage
    device timings at the cost of a host round trip between stages.
    ``syncs`` counts the per-stage synchronizes made, ``reads`` the
    convergence reads of the command and ``capped`` its capped relax
    launches; ``stop()`` (at the end of a
    command) freezes ``total_ms``. ``stages`` holds the :class:`Span` of
    every stage and sub-stage, in the order they ended."""

    def __init__(self, sync_enabled: bool = True):
        self.stages: List[Span] = []
        self.sync_enabled = sync_enabled
        self.syncs = 0
        self.reads = 0
        self.capped = 0
        self._depth = 0
        self._t0 = time.perf_counter()
        self._t1 = None

    @contextmanager
    def stage(self, name: str, sync=None):
        depth, reads, capped = self._depth, self.reads, self.capped
        self._depth = depth + 1
        t0 = time.perf_counter()
        try:
            yield
            if sync is not None and self.sync_enabled:
                self.syncs += 1
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self._depth = depth
            t1 = time.perf_counter()
            self.stages.append(Span(name, (t1 - t0) * 1000.0, depth, t0, t1,
                                    self.reads - reads,
                                    self.capped - capped))

    def stop(self) -> None:
        if self._t1 is None:
            self._t1 = time.perf_counter()

    @property
    def total_ms(self) -> float:
        end = time.perf_counter() if self._t1 is None else self._t1
        return (end - self._t0) * 1000.0

    def opened(self) -> List[Span]:
        """``stages`` in the order they opened (a parent before its
        children)."""
        return sorted(self.stages, key=lambda s: (s.start, s.depth))

    def totals(self) -> Dict[str, float]:
        """Milliseconds by span name, a repeated name summed, in the order
        the names first opened."""
        out: Dict[str, float] = {}
        for name, ms in self.opened():
            out[name] = out.get(name, 0.0) + ms
        return out

    def table(self) -> str:
        """One line a span, indented by its depth; a name repeated inside
        one stage is one line, its times summed and its count shown."""
        rows: Dict[tuple, list] = {}
        stage = 0
        for s in self.opened():
            stage += s.depth == 0
            row = rows.setdefault((stage, s.depth, s[0]), [0.0, 0])
            row[0] += s[1]
            row[1] += 1
        labels = [("  " * depth + name + (f" ×{n}" if n > 1 else ""), ms)
                  for (_, depth, name), (ms, n) in rows.items()]
        width = max((len(s) for s, _ in labels), default=10)
        lines = [f"{s:<{width}}  {ms:9.1f} ms" for s, ms in labels]
        lines.append(f"{'TOTAL':<{width}}  {self.total_ms:9.1f} ms")
        return "\n".join(lines)


@contextmanager
def current(timer):
    """Make ``timer`` (a :class:`StageTimer` or None) the calling thread's
    current timer for the body, then restore the one before."""
    held = getattr(_CURRENT, "timer", None)
    _CURRENT.timer = timer
    try:
        yield timer
    finally:
        _CURRENT.timer = held


def span(name: str):
    """A sub-stage span of the calling thread's current timer:
    ``current.stage(name)``, with no sync; with no current timer, a
    context that does nothing."""
    timer = getattr(_CURRENT, "timer", None)
    return nullcontext() if timer is None else timer.stage(name)


def count_read() -> None:
    """Count one convergence read (a host read of a loop's change flag) on
    the calling thread's current timer, if there is one."""
    timer = getattr(_CURRENT, "timer", None)
    if timer is not None:
        timer.reads += 1


def count_capped() -> None:
    """Count one capped relax launch (a staged kernel whose chunk T the
    shared-memory window cap cut below its free size) on the calling
    thread's current timer, if there is one."""
    timer = getattr(_CURRENT, "timer", None)
    if timer is not None:
        timer.capped += 1
