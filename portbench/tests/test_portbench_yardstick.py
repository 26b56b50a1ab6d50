"""The frozen arithmetic and the metric readers on synthetic traces."""

import math

import pytest
import torch

from portbench.harness import spec, yardstick


def test_busy_union():
    assert yardstick.busy_us([]) == 0.0
    assert yardstick.busy_us([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert yardstick.busy_us([(20, 30), (0, 10), (2, 3)]) == 20.0


def test_idle_gaps():
    spans = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    assert yardstick.idle_gaps(spans, 0.0, 7.0) == [(0.0, 1.0), (3.0, 5.0),
                                                   (6.0, 7.0)]
    assert yardstick.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    assert yardstick.idle_gaps([(0.0, 9.0)], 1.0, 2.0) == []


def test_bytes_bound_and_call_bytes():
    a = torch.zeros(1000, dtype=torch.float32)
    b = torch.zeros((2, 10), dtype=torch.int32)
    out = (torch.zeros(1000), torch.zeros(1, dtype=torch.int32))
    assert yardstick.call_bytes((a, b, 3, (0, 1)), {"gate": None}, out) == \
        4000 + 80 + 4000
    assert yardstick.bytes_bound_s(3.35e12) == pytest.approx(1.0)


def _trace(entry):
    # two calls of 1 s; device busy 0.25 s; a bfs launch of 1 ms that
    # moved 1.675 GB (bound 0.5 ms)
    return dict(
        entry=entry, busy_s=0.5, window_s=2.0, host_syncs=[540, 544],
        calls=[dict(wall_s=1.0, stages=[("Sphere mesh + upload", 300.0),
                                        ("Coarse plates", 200.0),
                                        ("Elevation", 700.0)]),
               dict(wall_s=1.0, stages=[("Sphere mesh + upload", 100.0),
                                        ("Coarse plates", 0.0)])],
        events=[("void bfs_relax_kernel<4>(...)", 0.0, 1e-3),
                ("elementwise_kernel", 1e-3, 0.25)],
        kernel_bytes={"sweeps": {"bfs_relax": [1.675e9]}},
        kernel_names={"sweeps": ["bfs_relax_kernel"]})


@pytest.mark.parametrize("entry,kind", [("generate", "generate"),
                                        ("reapply", "command")])
def test_readers_on_a_synthetic_trace(entry, kind):
    tr = _trace(entry)
    assert spec.metric_reader(f"device_idle_pct.{kind}").read(tr) == \
        pytest.approx(75.0)
    assert spec.metric_reader(f"host_syncs.{kind}").read(tr) == 542.0
    assert spec.metric_reader(f"sweeps_roofline.{kind}").read(tr) == \
        pytest.approx(50.0)
    other = "command" if kind == "generate" else "generate"
    for name in ("device_idle_pct", "host_syncs", "sweeps_roofline"):
        # the names split by the end-to-end metric they move share a reader
        assert spec.metric_reader(f"{name}.{other}").read(tr) == \
            spec.metric_reader(f"{name}.{kind}").read(tr)


def test_host_prologue_reader():
    r = spec.metric_reader("host_prologue_ms.generate")
    tr = _trace("generate")
    assert r.read(tr) == pytest.approx(300.0)
    tr["calls"] = []
    assert r.read(tr) is None


def test_roofline_reads_nothing_without_its_kernels():
    tr = _trace("generate")
    tr["events"] = [("elementwise_kernel", 0.0, 1.0)]
    assert spec.metric_reader("sweeps_roofline.generate").read(tr) is None
    tr = _trace("generate")
    tr["kernel_bytes"] = {"sweeps": {}}
    assert spec.metric_reader("sweeps_roofline.generate").read(tr) is None


def test_p90_counts_failures_as_missing():
    from portbench.harness.main import p90

    assert p90([float(i) for i in range(1, 101)]) == 90.0
    assert p90([1.0] * 95 + [math.inf] * 5) == 1.0
    assert p90([1.0] * 85 + [math.inf] * 15) == math.inf
