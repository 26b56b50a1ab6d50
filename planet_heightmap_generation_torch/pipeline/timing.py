"""Per-stage timing instrumentation — the equivalent of the reference's
console.table timing (SURVEY.md §5: 118 performance.now() calls in the
worker). Stages are timed host-side around a device synchronize so
asynchronous CUDA launches don't hide device time."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Tuple

import torch


class StageTimer:
    """``sync_enabled=False`` (the production default) turns per-stage
    device synchronizes into no-ops: stages record enqueue time only and
    the device pipeline runs gap-free with a single final sync. Enable it
    (engine ``timing=True`` / ``PLANET_TIMING=1``) to get true per-stage
    device timings at the cost of a host round trip between stages.
    ``syncs`` counts the per-stage synchronizes made; ``stop()`` (at the
    end of a command) freezes ``total_ms``."""

    def __init__(self, sync_enabled: bool = True):
        self.stages: List[Tuple[str, float]] = []
        self.sync_enabled = sync_enabled
        self.syncs = 0
        self._t0 = time.perf_counter()
        self._t1 = None

    @contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None and self.sync_enabled:
            self.syncs += 1
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.stages.append((name, (time.perf_counter() - t0) * 1000.0))

    def stop(self) -> None:
        if self._t1 is None:
            self._t1 = time.perf_counter()

    def push(self, name: str, ms: float):
        self.stages.append((name, ms))

    @property
    def total_ms(self) -> float:
        end = time.perf_counter() if self._t1 is None else self._t1
        return (end - self._t0) * 1000.0

    def table(self) -> str:
        width = max((len(s) for s, _ in self.stages), default=10)
        lines = [f"{s:<{width}}  {ms:9.1f} ms" for s, ms in self.stages]
        lines.append(f"{'TOTAL':<{width}}  {self.total_ms:9.1f} ms")
        return "\n".join(lines)
