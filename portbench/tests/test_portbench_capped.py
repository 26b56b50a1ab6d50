"""The reader of ``capped_launches.generate`` (metrics/capped_launches.py)
on synthetic traces, and a traced run on the CPU with a program whose
spans carry no ``capped`` count, as before the program counted them: the
result line still comes, without the metric."""

import time

import pytest
import torch

from planet_heightmap_generation_torch.pipeline import timing
from planet_heightmap_generation_torch.pipeline.timing import Span
from portbench.harness import check, main, spec

NAME = "capped_launches.generate"
CELL = "detail-2.56m.new-planet"
SEED = 2 ** 31 + 1818


class OldSpan(tuple):
    """A span as a program that counts no capped launches records it:
    ``(name, ms)`` with ``depth``, ``start``, ``end`` and ``reads``."""

    def __new__(cls, name, ms, depth, start, end, reads, *_):
        self = super().__new__(cls, (name, ms))
        self.depth, self.start, self.end, self.reads = depth, start, end, \
            reads
        return self


def _span(name, start, end, depth=0, capped=0, kind=Span):
    args = (name, (end - start) * 1e3, depth, start, end, 0)
    return kind(*args, capped) if kind is Span else kind(*args)


def _trace(calls):
    return dict(calls=[dict(wall_s=1.0, stages=c) for c in calls],
                events=[])


def test_reads_the_mean_of_the_depth_zero_sums():
    call_a = [_span("Elevation", 0.0, 1.0, capped=9),
              _span("Elevation: distance BFS", 0.1, 0.4, depth=1, capped=6),
              _span("Elevation: stress propagation", 0.4, 0.5, depth=1,
                    capped=3),
              _span("Terrain post-processing", 1.0, 2.0, capped=1),
              _span("Post: warp", 1.0, 1.1, depth=1, capped=1)]
    call_b = [_span("Elevation", 0.0, 1.0, capped=4),
              _span("Terrain post-processing", 1.0, 2.0)]
    reader = spec.metric_reader(NAME)
    assert reader.read(_trace([call_a, call_b])) == pytest.approx(7.0)
    assert reader.read(_trace([call_b])) == pytest.approx(4.0)
    zero = [_span("Elevation", 0.0, 1.0)]
    assert reader.read(_trace([zero])) == 0.0


@pytest.mark.parametrize("stages", [
    [_span("Elevation", 0.0, 1.0, kind=OldSpan),
     _span("Terrain post-processing", 1.0, 2.0, kind=OldSpan)],
    [("Elevation", 700.0), ("Terrain post-processing", 200.0)],
], ids=["spans without capped", "bare stages"])
def test_reads_nothing_without_the_count(stages):
    reader = spec.metric_reader(NAME)
    assert reader.read(_trace([stages, stages])) is None
    # one call counting and one not: still nothing
    counted = [_span("Elevation", 0.0, 1.0, capped=2)]
    assert reader.read(_trace([counted, stages])) is None


def test_reads_nothing_without_calls():
    assert spec.metric_reader(NAME).read(_trace([])) is None


def test_only_the_new_cell_lists_the_metric():
    bench = spec.load_benchmark()
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == [CELL]
    for wl in bench["workloads"]:
        names = {x["name"] for x in spec.per_layer_metrics(bench,
                                                           wl["name"])}
        assert (NAME in names) == (wl["name"] == CELL)


class _Event:
    def __init__(self, name, start_us, end_us):
        self.name = name
        self.device_type = torch.autograd.DeviceType.CUDA
        self.time_range = type("R", (), dict(start=start_us, end=end_us))


class _Profile:
    """``torch.profiler.profile`` on a host without a card: two device
    events, the marker and one kernel, on the device's clock."""

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return [_Event("marker", 0.0, 1.0), _Event("kernel", 10.0, 2010.0)]


@pytest.mark.parametrize("span_kind", ["program", "old"])
def test_a_traced_cpu_run_gives_a_line(span_kind, tiny_cfg, monkeypatch):
    """The cell's traced run at 2,000 cells on the CPU (the profiler and
    the card's syncs stood in for): with the program's spans the metric
    reads 0 (CPU launches count nothing); with spans that carry no
    ``capped`` the line still comes, without the metric."""
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda *a, **kw: None)
    if span_kind == "old":
        monkeypatch.setattr(timing, "Span", OldSpan)
    cfg = dict(tiny_cfg(CELL), reference="torch-cpu")
    res = main.run_cell(CELL, SEED, 1.0, True, "cpu", time.perf_counter(),
                        cfg=cfg)
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["correct"] is True
    assert set(res["compared"]) == set(check.NUMBERS)
    metrics = res["metrics"]
    assert {"host_prologue_ms.generate", "flag_reads.generate",
            "device_idle_pct.generate"} <= set(metrics)
    if span_kind == "old":
        assert NAME not in metrics
    else:
        assert metrics[NAME] == dict(value=0.0, unit="launches")
