"""The port's span tree (pipeline/timing.py): ``StageTimer`` spans with
depth, host start and end and convergence reads, the thread's current
timer, and the sub-stage spans the stage code opens, on 2000-cell planets
on the CPU.

Contracts:

- every span unpacks as ``(name, ms)``; it carries ``depth``, ``start``,
  ``end`` (``time.perf_counter()``) and ``reads`` (inclusive of its
  children) as attributes; a raising body still records its span and
  restores the depth; ``span()`` with no current timer does nothing; each
  thread records into its own current timer.
- a command's ``reads`` is the number of ``spmd.flag_any`` calls it made
  (on a split, shard 0's, whose thread records into the command's timer).
- the sub-stage spans sit inside their stage and change no result: a
  generate and a reapply equal, bit for bit, the same commands with
  ``span()`` a no-op; timing mode syncs once per synced stage, never per
  sub-stage span.
"""

import json
import pickle
import sys
import threading
import time

import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.parallel import spmd
from planet_heightmap_generation_torch.pipeline import timing
from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine
from planet_heightmap_generation_torch.pipeline.timing import (
    Span, StageTimer)

PARAMS = GenerationParams(seed=7, n_cells=2000, n_plates=10,
                          num_continents=2, skip_climate=False)
SCULPT = dict(glacial_erosion=0.5, hydraulic_erosion=0.6,
              thermal_erosion=0.3, ridge_sharpening=0.4, smoothing=0.5,
              terrain_warp=0.6)

ELEVATION = ("Elevation: collisions", "Elevation: stress propagation",
             "Elevation: seeds and masks", "Elevation: distance BFS",
             "Elevation: coast distance BFS", "Elevation: coast carry BFS",
             "Elevation: structural carry BFS", "Elevation: assembly",
             "Elevation: coastal roughening and island arcs",
             "Elevation: hotspots and peaks")
POST = ("Post: warp", "Post: smoothing", "Post: edge lengths",
        "Post: open-ocean mask", "Post: flood carve",
        "Post: hydraulic receivers", "Post: flow accumulation",
        "Post: stream power", "Post: thermal step", "Post: re-flood",
        "Post: ridge sharpening", "Post: soil creep")
GLACIAL = ("Post: glaciation index", "Post: glacial step",
           "Post: glacial post-smooth")
WIND = ("Wind: ITCZ bins", "Wind: ITCZ spline on the host",
        "Wind: continentality", "Wind: pressure and flow",
        "Wind: ITCZ samples")
PRECIPITATION = ("Precipitation: gradients", "Precipitation: seasonal blend",
                 "Precipitation: convergence",
                 "Precipitation: moisture advection",
                 "Precipitation: mechanisms", "Precipitation: rain shadow",
                 "Precipitation: heuristic blend",
                 "Precipitation: normalise")
SYNCED = ("Sphere mesh + upload", "Upload plates, domes + noise tables",
          "Project plates", "Smooth + reconnect plates", "Elevation",
          "Terrain post-processing", "Triangle elevations",
          "Climate: coast fields", "Climate: wind", "Climate: ocean currents",
          "Climate: precipitation", "Climate: temperature", "Climate: Köppen")


def _by_name(timer):
    out = {}
    for s in timer.stages:
        out.setdefault(s[0], []).append(s)
    return out


def _parent(timer, child):
    """The depth-0 span holding ``child``."""
    holders = [s for s in timer.stages if s.depth == 0
               and s.start <= child.start and child.end <= s.end]
    assert len(holders) == 1, (child, holders)
    return holders[0]


# ── the record ───────────────────────────────────────────────────────────

def test_spans_nest_with_depth_inside_their_parent():
    t = StageTimer(sync_enabled=False)
    with t.stage("A"):
        with t.stage("a1"):
            with t.stage("a1x"):
                time.sleep(0.001)
        with t.stage("a2"):
            pass
    with t.stage("B"):
        pass
    s = {x[0]: x for x in t.stages}
    assert [x[0] for x in t.stages] == ["a1x", "a1", "a2", "A", "B"]
    assert [x[0] for x in t.opened()] == ["A", "a1", "a1x", "a2", "B"]
    assert {k: v.depth for k, v in s.items()} == dict(A=0, a1=1, a1x=2,
                                                       a2=1, B=0)
    for child, parent in (("a1", "A"), ("a1x", "a1"), ("a2", "A")):
        assert s[parent].start <= s[child].start <= s[child].end \
            <= s[parent].end
    assert s["a1"].end <= s["a2"].start and s["A"].end <= s["B"].start
    assert s["A"][1] == pytest.approx((s["A"].end - s["A"].start) * 1e3)
    assert s["a1x"][1] >= 1.0


def test_span_unpacks_as_name_and_ms():
    t = StageTimer(sync_enabled=False)
    with t.stage("Elevation"):
        pass
    (span,) = t.stages
    name, ms = span
    assert (name, ms) == ("Elevation", span[1]) and ms >= 0
    assert tuple(span) == (name, ms) and span == (name, ms)
    assert len(span) == 2 and dict(t.stages) == {"Elevation": ms}
    assert json.loads(json.dumps(t.stages)) == [["Elevation", ms]]
    back = pickle.loads(pickle.dumps(span))
    assert back == span and isinstance(back, Span)
    assert (back.depth, back.start, back.end, back.reads) == \
        (span.depth, span.start, span.end, span.reads)


def test_a_raising_body_records_its_span_and_restores_the_depth():
    t = StageTimer(sync_enabled=True)
    with t.stage("A"):
        with pytest.raises(ValueError):
            with t.stage("fails", sync=True):
                with t.stage("inner"):
                    raise ValueError("stage error")
        with t.stage("after"):
            pass
    s = {x[0]: x for x in t.stages}
    assert set(s) == {"A", "fails", "inner", "after"}
    assert (s["fails"].depth, s["inner"].depth, s["after"].depth) == \
        (1, 2, 1)
    assert t.syncs == 0          # the raising stage made no sync
    with t.stage("B"):
        pass
    assert t.stages[-1].depth == 0


def test_reads_count_inside_spans_children_included():
    t = StageTimer(sync_enabled=False)
    with timing.current(t):
        timing.count_read()
        with timing.span("A"):
            timing.count_read()
            with timing.span("a1"):
                timing.count_read()
                timing.count_read()
            with timing.span("a2"):
                pass
        with timing.span("B"):
            timing.count_read()
    s = {x[0]: x.reads for x in t.stages}
    assert s == dict(A=3, a1=2, a2=0, B=1)
    assert t.reads == 5


def test_no_current_timer_means_span_does_nothing():
    t = StageTimer(sync_enabled=False)
    with timing.span("nothing"):
        timing.count_read()
    with timing.current(t):
        with timing.current(None):
            with timing.span("nothing either"):
                timing.count_read()
        with timing.span("recorded"):
            pass
    assert [s[0] for s in t.stages] == ["recorded"] and t.reads == 0
    with timing.span("after"):
        pass
    assert len(t.stages) == 1


def test_span_opens_through_the_class_stage_method(monkeypatch):
    """Every span opens through ``StageTimer.stage`` looked up on the
    class: a wrapper patched there sees the sub-stage spans too."""
    seen, orig = [], StageTimer.stage

    def stage(self, name, sync=None):
        seen.append(name)
        return orig(self, name, sync)

    monkeypatch.setattr(StageTimer, "stage", stage)
    t = StageTimer(sync_enabled=False)
    with timing.current(t), t.stage("A"), timing.span("a1"):
        pass
    assert seen == ["A", "a1"]


def test_threads_record_into_their_own_timers():
    n_threads, rounds = 8, 40
    timers = [StageTimer(sync_enabled=False) for _ in range(n_threads)]
    gate = threading.Barrier(n_threads, timeout=30)
    errors = []

    def body(i):
        try:
            with timing.current(timers[i]):
                gate.wait()
                for r in range(rounds):
                    with timing.span(f"t{i}"):
                        for _ in range(i + 1):
                            timing.count_read()
                        time.sleep(0)
        except BaseException as e:  # noqa: BLE001 — checked below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    for i, t in enumerate(timers):
        assert {s[0] for s in t.stages} == {f"t{i}"}
        assert len(t.stages) == rounds and t.reads == rounds * (i + 1)
        assert all(s.depth == 0 and s.reads == i + 1 for s in t.stages)


def test_table_indents_by_depth_and_sums_repeats():
    t = StageTimer(sync_enabled=False)
    with t.stage("Post"):
        for _ in range(3):
            with t.stage("step"):
                pass
    with t.stage("Climate"):
        with t.stage("step"):
            pass
    lines = t.table().splitlines()
    assert lines[0].startswith("Post ")
    assert lines[1].startswith("  step ×3 ")
    assert lines[2].startswith("Climate ")
    assert lines[3].startswith("  step ") and "×" not in lines[3]
    assert lines[4].startswith("TOTAL ")
    totals = t.totals()
    assert list(totals) == ["Post", "step", "Climate"]
    assert totals["step"] == pytest.approx(
        sum(ms for name, ms in t.stages if name == "step"))


# ── the engine ───────────────────────────────────────────────────────────

class _FlagCount:
    """``spmd.flag_any`` wrapped: the calls made on each thread."""

    def __init__(self, monkeypatch):
        self.calls, orig = {}, spmd.flag_any

        def flag_any(flag):
            name = threading.current_thread().name
            self.calls[name] = self.calls.get(name, 0) + 1
            return orig(flag)

        monkeypatch.setattr(spmd, "flag_any", flag_any)

    def take(self, thread=None):
        out = (sum(self.calls.values()) if thread is None
               else self.calls.get(thread, 0))
        self.calls.clear()
        return out


def _commands(engine):
    gen = engine.generate(PARAMS)
    rea = engine.reapply(sculpt=SCULPT)
    return gen, rea


@pytest.fixture(scope="module")
def recorded():
    """A production-mode generate and reapply (climate on), with each
    command's ``flag_any`` calls."""
    with pytest.MonkeyPatch.context() as mp:
        count = _FlagCount(mp)
        engine = PlanetEngine(device="cpu", timing=False)
        gen = engine.generate(PARAMS)
        n_gen = count.take()
        rea = engine.reapply(sculpt=SCULPT)
        n_rea = count.take()
    return gen, rea, n_gen, n_rea


def test_sub_spans_sit_inside_their_stages(recorded):
    gen, rea, _, _ = recorded
    assert gen.error is None and rea.error is None
    want = [(gen, "Elevation", ELEVATION), (gen, "Terrain post-processing",
                                            POST),
            (rea, "Terrain post-processing", POST + GLACIAL),
            (gen, "Climate: wind", WIND), (rea, "Climate: wind", WIND),
            (gen, "Climate: precipitation", PRECIPITATION),
            (rea, "Climate: precipitation", PRECIPITATION)]
    for res, stage, names in want:
        spans = _by_name(res.timing)
        for name in names:
            assert name in spans, (stage, name)
            for s in spans[name]:
                assert s.depth == 1
                assert _parent(res.timing, s)[0] == stage
        inside = [s[0] for s in res.timing.stages if s.depth == 1
                  and _parent(res.timing, s)[0] == stage]
        assert set(inside) == set(names), stage
    # one span a step: 12 hydraulic steps, 5 glacial, 3 thermal
    spans = _by_name(rea.timing)
    assert len(spans["Post: hydraulic receivers"]) == 12
    assert len(spans["Post: glacial step"]) == 5
    assert len(spans["Post: thermal step"]) == 3
    for res in (gen, rea):
        assert all(s.depth <= 1 for s in res.timing.stages)
        for name in (s[0] for s in res.timing.stages):
            assert not name.startswith(" ")


def test_climate_sub_spans_name_no_wind_or_ocean_outside_them(recorded):
    gen, _, _, _ = recorded
    for s in gen.timing.stages:
        if s.depth and _parent(gen.timing, s)[0] in (
                "Climate: precipitation", "Climate: temperature",
                "Climate: Köppen"):
            assert "wind" not in s[0].lower()
            assert "ocean" not in s[0].lower()


def test_reads_equal_the_flag_any_calls(recorded):
    gen, rea, n_gen, n_rea = recorded
    assert n_gen > 0
    for res, n in ((gen, n_gen), (rea, n_rea)):
        assert res.timing.reads == n
        assert sum(s.reads for s in res.timing.stages if s.depth == 0) == n
    # the reads sit in the stages that run the host-driven loops: the
    # plates' flood assign, the carry BFS, the pointer-doubling stops of
    # the flood carves and the stream power
    loops = {"Smooth + reconnect plates": (), "Elevation": (
        "Elevation: coast carry BFS", "Elevation: structural carry BFS"),
        "Terrain post-processing": ("Post: flood carve", "Post: re-flood",
                                    "Post: stream power")}
    for res in (gen, rea):
        by_stage = {}
        for s in res.timing.stages:
            by_stage[s[0]] = by_stage.get(s[0], 0) + s.reads
        read = {k for k, v in by_stage.items() if v}
        assert read <= set(loops) | {x for v in loops.values() for x in v}
        for stage, subs in loops.items():
            if subs:
                assert by_stage.get(stage, 0) == sum(by_stage.get(x, 0)
                                                     for x in subs)
        assert by_stage["Post: stream power"] > 0
        assert by_stage["Post: flood carve"] > 0


def test_spans_change_no_result(recorded, monkeypatch):
    """The commands with every ``span`` a no-op give the same bits."""
    def no_span(name):
        import contextlib
        return contextlib.nullcontext()

    patched, orig = 0, timing.span
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith(
                "planet_heightmap_generation_torch") and \
                getattr(mod, "span", None) is orig:
            monkeypatch.setattr(mod, "span", no_span)
            patched += 1
    assert patched >= 5       # timing and the four stage modules
    gen0, rea0, _, _ = recorded
    gen1, rea1 = _commands(PlanetEngine(device="cpu", timing=False))
    assert not any(s.depth for s in gen1.timing.stages + rea1.timing.stages)
    for a, b in ((gen0, gen1), (rea0, rea1)):
        assert torch.equal(a.elevation, b.elevation)
        assert torch.equal(a.pre_post_elevation, b.pre_post_elevation)
        for part in ("precip", "temp"):
            for k, v in a.climate[part].items():
                assert torch.equal(v, b.climate[part][k]), (part, k)
        assert torch.equal(a.climate["koppen"], b.climate["koppen"])


def test_timing_mode_syncs_once_per_synced_stage():
    res = PlanetEngine(device="cpu", timing=True).generate(PARAMS)
    synced = [s for s in res.timing.stages if s[0] in SYNCED]
    assert len(synced) == len(SYNCED) and all(s.depth == 0 for s in synced)
    assert res.timing.syncs == len(SYNCED)
    assert sum(s.depth == 1 for s in res.timing.stages) >= 30


def test_perf_log_sums_repeated_names(recorded, tmp_path, monkeypatch):
    path = tmp_path / "perf.jsonl"
    monkeypatch.setenv("PLANET_PERF_LOG", str(path))
    engine = PlanetEngine(device="cpu", timing=False)
    engine.generate(PARAMS.replace(skip_climate=True))
    res = engine.reapply(sculpt=SCULPT, skip_climate=True)
    rec = [json.loads(line) for line in open(path)][-1]
    assert rec["kind"] == "reapply"
    steps = [ms for name, ms in res.timing.stages
             if name == "Post: hydraulic receivers"]
    assert len(steps) == 12
    assert rec["stages"]["Post: hydraulic receivers"] == \
        pytest.approx(sum(steps), abs=0.01)
    assert rec["stages"]["Terrain post-processing"] == pytest.approx(
        dict(res.timing.stages)["Terrain post-processing"], abs=0.01)


def test_a_climate_failure_keeps_the_span_tree(recorded, monkeypatch):
    """The climate seam catches the error: the failing stage and its open
    sub-span are recorded, and the stages after it sit at depth 0."""
    from planet_heightmap_generation_torch.climate import precipitation

    def fail(*a, **kw):
        raise RuntimeError("advection failed")

    monkeypatch.setattr(precipitation, "_advect_moisture2", fail)
    engine = PlanetEngine(device="cpu", timing=False)
    res = engine.generate(PARAMS)
    assert res.error is not None and "advection failed" in \
        res.error["message"]
    spans = _by_name(res.timing)
    assert spans["Precipitation: moisture advection"][0].depth == 1
    assert spans["Climate: precipitation"][0].depth == 0
    assert "Precipitation: mechanisms" not in spans
    res = engine.reapply(sculpt=dict(smoothing=0.2))
    assert _by_name(res.timing)["Triangle elevations"][0].depth == 0


def test_split_generate_records_shard_zero_into_the_command(monkeypatch):
    from planet_heightmap_generation_torch.parallel.sharding import (
        cells_mesh)

    count = _FlagCount(monkeypatch)
    params = PARAMS.replace(skip_climate=True)
    engine = PlanetEngine(device="cpu", timing=False,
                          mesh=cells_mesh(4, ["cpu"] * 4))
    res = engine.generate(params)
    assert engine.split_stats is not None
    calls = dict(count.calls)
    assert res.timing.reads == calls.get("split-shard-0", 0) > 0
    # each shard reads its sweep loops' stops; shard 0, the leader, also
    # runs the gathered calls (the pointer-doubling loops) for all
    others = {calls.get(f"split-shard-{c}", 0) for c in (1, 2, 3)}
    assert len(others) == 1 and 0 < others.pop() < res.timing.reads
    assert set(calls) == {f"split-shard-{c}" for c in range(4)}
    spans = _by_name(res.timing)
    for name in ELEVATION + ("Post: flood carve", "Post: re-flood"):
        assert [s.depth for s in spans[name]] == [1], name
    assert spans["Elevation"][0].depth == 0
    assert spans["Split placement"][0].depth == 0
