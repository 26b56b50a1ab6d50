"""The readers of the program's span records (harness/spans.py and the
``*_idle_ms`` and ``flag_reads`` metrics) on synthetic traces."""

import pytest

from planet_heightmap_generation_torch.pipeline.timing import Span
from portbench.harness import spans, spec

IDLE = ("elevation_idle_ms.generate", "post_idle_ms.generate",
        "post_idle_ms.command", "climate_idle_ms.generate",
        "climate_idle_ms.command")


def _span(name, start, end, depth=0, reads=0):
    return Span(name, (end - start) * 1e3, depth, start, end, reads)


def _trace(calls, events):
    return dict(calls=[dict(wall_s=1.0, stages=c) for c in calls],
                events=events)


def test_span_idle_clips_events_that_straddle_its_edges():
    # the span [10, 20] s; events [8, 11] and [19, 25] straddle its edges,
    # [12, 13] and [12.5, 14] overlap inside it, [30, 31] lies outside
    events = [("k", 12.0, 13.0), ("k", 8.0, 11.0), ("k", 19.0, 25.0),
              ("k", 12.5, 14.0), ("k", 30.0, 31.0)]
    index = spans._device_index(events)
    # busy inside: [10, 11] + [12, 14] + [19, 20] = 4 s of 10
    assert spans.span_idle_s(index, 10.0, 20.0) == pytest.approx(6.0)
    assert spans.span_idle_s(index, 26.0, 29.0) == pytest.approx(3.0)
    assert spans.span_idle_s(index, 8.5, 10.5) == pytest.approx(0.0)
    tr = _trace([[_span("Elevation", 10.0, 20.0),
                  _span("Elevation: collisions", 10.0, 12.0, depth=1)]],
                events)
    reader = spec.metric_reader("elevation_idle_ms.generate")
    assert reader.read(tr) == pytest.approx(6000.0)


def test_repeated_names_are_summed_and_calls_averaged():
    events = [("k", 1.0, 1.5), ("k", 3.0, 3.25)]
    call_a = [_span("Terrain post-processing", 0.0, 2.0),      # idle 1.5
              _span("Climate: wind", 2.0, 2.5),                # idle 0.5
              _span("Climate: wind", 3.0, 4.0),                # idle 0.75
              _span("Climate: precipitation", 4.0, 4.5),       # idle 0.5
              _span("Post: stream power", 0.5, 1.0, depth=1),
              _span("Climate: nested", 2.1, 2.2, depth=1)]
    call_b = [_span("Terrain post-processing", 5.0, 5.5)]      # idle 0.5
    tr = _trace([call_a, call_b], events)
    post = spec.metric_reader("post_idle_ms.command").read(tr)
    climate = spec.metric_reader("climate_idle_ms.command").read(tr)
    assert post == pytest.approx((1500.0 + 500.0) / 2)
    assert climate == pytest.approx((500.0 + 750.0 + 500.0 + 0.0) / 2)
    assert spec.metric_reader("post_idle_ms.generate").read(tr) == post
    assert spec.metric_reader("climate_idle_ms.generate").read(tr) == \
        climate


def test_flag_reads_sum_the_depth_zero_spans():
    call_a = [_span("Smooth + reconnect plates", 0.0, 1.0, reads=2),
              _span("Elevation", 1.0, 2.0, reads=8),
              _span("Elevation: coast carry BFS", 1.2, 1.5, depth=1,
                    reads=5),
              _span("Elevation: structural carry BFS", 1.5, 1.8, depth=1,
                    reads=3)]
    call_b = [_span("Terrain post-processing", 0.0, 1.0)]
    tr = _trace([call_a, call_b], [])
    for name in ("flag_reads.generate", "flag_reads.command"):
        assert spec.metric_reader(name).read(tr) == pytest.approx(5.0)


@pytest.mark.parametrize("name", IDLE + ("flag_reads.generate",
                                         "flag_reads.command"))
def test_readers_read_nothing_without_span_records(name):
    """A program whose stages are bare (name, ms) pairs, as before spans
    were recorded: every reader returns None."""
    bare = [("Elevation", 700.0), ("Terrain post-processing", 200.0),
            ("Climate: wind", 30.0)]
    tr = _trace([bare, bare], [("k", 0.0, 1.0)])
    assert spec.metric_reader(name).read(tr) is None
    assert spec.metric_reader(name).read(_trace([], [])) is None


def test_idle_readers_read_nothing_without_their_stage():
    tr = _trace([[_span("Terrain post-processing", 0.0, 1.0)]], [])
    assert spec.metric_reader("elevation_idle_ms.generate").read(tr) is None
    assert spec.metric_reader("climate_idle_ms.command").read(tr) is None
    assert spec.metric_reader("post_idle_ms.command").read(tr) == \
        pytest.approx(1000.0)
