"""The capped-launch counter of the port's span tree: a staged relax
launch whose chunk T the shared-memory window cap cut below its free size
(a capped plan, csrc ``get_plan``) counts one on the calling thread's
current timer (pipeline/timing.py ``count_capped``). The library counts
such launches per host thread; ops/sweep_cuda.py ``_launch`` takes that
count after each launch. On the CPU.

Contracts:

- ``count_capped`` is charged to the innermost open span and to each of
  its ancestors; a nested span gets its own count; with no current timer
  it does nothing; a ``Span`` keeps ``capped`` through pickling, and one
  built without it reads 0.
- ``_launch`` counts one capped launch for each the library reports after
  it, none where it reports none; a refused launch counts nothing; the
  count is asked of the library itself (its entry point is declared), and
  the library source counts in its one cooperative launch path.
- launches on CPU tensors (the plain versions) never count.
"""

import contextlib
import pickle
import types

import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.ops import sweep_cuda
from planet_heightmap_generation_torch.pipeline import timing
from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine
from planet_heightmap_generation_torch.pipeline.timing import (
    Span, StageTimer)


# ── the record ───────────────────────────────────────────────────────────

def test_capped_is_charged_to_the_open_spans_and_their_ancestors():
    t = StageTimer(sync_enabled=False)
    with timing.current(t):
        with t.stage("Elevation"):
            timing.count_capped()
            with t.stage("Elevation: distance BFS"):
                timing.count_capped()
                timing.count_capped()
            with t.stage("Elevation: assembly"):
                pass
        with t.stage("Terrain post-processing"):
            with t.stage("Post: warp"):
                timing.count_capped()
    s = {x[0]: x.capped for x in t.stages}
    assert s == {"Elevation": 3, "Elevation: distance BFS": 2,
                 "Elevation: assembly": 0, "Terrain post-processing": 1,
                 "Post: warp": 1}
    assert t.capped == 4
    assert all(x.reads == 0 for x in t.stages)


def test_count_capped_without_a_current_timer_does_nothing():
    t = StageTimer(sync_enabled=False)
    with t.stage("Elevation"):
        timing.count_capped()
    assert t.capped == 0 and t.stages[0].capped == 0


def test_span_keeps_capped_through_pickling():
    span = Span("Elevation", 12.5, 0, 1.0, 1.0125, 3, 7)
    back = pickle.loads(pickle.dumps(span))
    assert tuple(back) == ("Elevation", 12.5)
    assert (back.depth, back.start, back.end, back.reads, back.capped) == \
        (0, 1.0, 1.0125, 3, 7)
    assert Span("Elevation", 1.0, 0, 0.0, 0.001, 2).capped == 0


# ── the launch path ──────────────────────────────────────────────────────

@pytest.fixture
def card(monkeypatch):
    """``_launch`` on a stand-in card: no stream or device switch, and a
    library whose ``take_capped_launches`` hands out the counts queued in
    the returned list (0 once it is empty)."""
    queued = []
    monkeypatch.setitem(sweep_cuda.LAUNCHES, "warp", 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *a: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    take = lambda: queued.pop(0) if queued else 0  # noqa: E731
    monkeypatch.setattr(sweep_cuda, "_kernel",
                        lambda name: {"take_capped_launches": take}[name])
    return queued


def _fn(rc=0):
    def fn(*args):
        return rc

    fn.__name__ = "warp_relax"
    return fn


@pytest.mark.parametrize("reported,counted", [([1, 0, 0], 1),
                                              ([0, 0, 0], 0),
                                              ([1, 1, 1], 3)],
                         ids=["one-capped", "none-capped", "all-capped"])
def test_a_launch_counts_what_the_library_reports(card, reported, counted):
    card.extend(reported)
    t = StageTimer(sync_enabled=False)
    with timing.current(t):
        with t.stage("Post: warp"):
            for _ in reported:
                sweep_cuda._launch(_fn(), "warp", "card")
    assert sweep_cuda.LAUNCHES["warp"] == 3
    assert t.capped == counted and t.stages[0].capped == counted
    assert card == []


def test_a_refused_launch_counts_nothing(card):
    card.append(1)
    t = StageTimer(sync_enabled=False)
    with timing.current(t):
        with pytest.raises(RuntimeError, match="launch failed"):
            sweep_cuda._launch(_fn(rc=1), "warp", "card")
    assert t.capped == 0 and sweep_cuda.LAUNCHES["warp"] == 0


def test_a_launch_outside_a_command_counts_nowhere(card):
    card.append(1)
    sweep_cuda._launch(_fn(), "warp", "card")
    assert card == [] and sweep_cuda.LAUNCHES["warp"] == 1


def test_the_library_declares_and_counts_capped_launches():
    """The entry point has its ctypes signature, and the source counts a
    capped plan's launch in the cooperative launch path and clears the
    count where it hands it out."""
    assert sweep_cuda._ARGTYPES["take_capped_launches"] == []
    src = open(sweep_cuda.SOURCE).read()
    body = src[src.index("int launch_relax("):]
    body = body[:body.index("\n}\n")]
    assert "if (p.T < p.t_free) ++g_capped_launches;" in body
    take = src[src.index("int take_capped_launches()"):]
    assert "g_capped_launches = 0;" in take[:take.index("\n}\n")]


# ── the plain versions ───────────────────────────────────────────────────

def test_cpu_launches_count_nothing(monkeypatch):
    """A generate and a reapply on CPU tensors run the plain versions: the
    capped count is never asked, and every span reads 0."""
    asked = []
    monkeypatch.setattr(sweep_cuda, "_kernel",
                        lambda name: asked.append(name))
    eng = PlanetEngine(device="cpu", timing=False)
    res = eng.generate(GenerationParams(seed=5, n_cells=2000, n_plates=10,
                                        num_continents=2, skip_climate=False))
    again = eng.reapply(sculpt=dict(glacial_erosion=0.5, terrain_warp=0.6,
                                    smoothing=0.5))
    assert res.error is None and again.error is None
    for r in (res, again):
        assert r.timing.capped == 0
        assert r.timing.stages and all(s.capped == 0
                                       for s in r.timing.stages)
    assert asked == []
