"""The port engine's timing mode, mesh prefetch and device priming, on
2000-cell planets on the CPU.

Contracts:

- ``PlanetEngine(timing=...)`` (default ``PLANET_TIMING == "1"``) selects
  per-stage syncs: a timing-mode generate makes one per ``sync=True``
  stage, the production default none (it syncs once at the end of the
  command); the ``PLANET_PERF_LOG`` record's ``fused`` is ``not timing``,
  as in the JAX engine; the elevation is the same in both modes, bit for
  bit.
- ``prefetch_mesh`` then ``generate`` adopts the prefetched graph and
  host products and equals a generate without prefetch bit for bit;
  toggled params prefetch the mesh only; an error raised in the prefetch
  thread is reported with a warning and the mesh rebuilt on the caller's
  thread, as in the JAX engine, so only an error of the rebuild raises.
- ``prime_device_transfer`` starts nothing on the CPU.
"""

import json
import threading
import time

import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.pipeline import engine as eng_mod
from planet_heightmap_generation_torch.pipeline.engine import (
    PlanetEngine, prefetch_mesh, prime_device_transfer)

PARAMS = GenerationParams(seed=5, n_cells=2000, n_plates=10,
                          num_continents=2, skip_climate=True)


@pytest.fixture(scope="module")
def reference():
    """A production-mode generate without prefetch."""
    return PlanetEngine(device="cpu", timing=False).generate(PARAMS)


@pytest.fixture(autouse=True)
def _no_prefetch_left():
    yield
    eng_mod._MESH_PREFETCH.clear()


def _sync_stages(res):
    return sum(1 for name, _ in res.timing.stages
               if name in ("Sphere mesh + upload",
                           "Upload plates, domes + noise tables",
                           "Project plates", "Smooth + reconnect plates",
                           "Elevation", "Terrain post-processing",
                           "Triangle elevations"))


@pytest.mark.parametrize("timing,env,syncs", [
    (True, None, True), (False, None, False), (None, "1", True),
    (None, "0", False), (None, None, False), (False, "1", False)])
def test_timing_mode_selects_stage_syncs(reference, monkeypatch, tmp_path,
                                         timing, env, syncs):
    if env is None:
        monkeypatch.delenv("PLANET_TIMING", raising=False)
    else:
        monkeypatch.setenv("PLANET_TIMING", env)
    log = tmp_path / "perf.jsonl"
    monkeypatch.setenv("PLANET_PERF_LOG", str(log))
    engine = PlanetEngine(device="cpu", timing=timing)
    res = engine.generate(PARAMS)
    assert res.timing.syncs == (_sync_stages(res) if syncs else 0)
    assert _sync_stages(res) == 7
    rec = json.loads(log.read_text().splitlines()[0])
    assert rec["fused"] is (not syncs)
    assert torch.equal(res.elevation, reference.elevation)
    # the command's total is frozen at its end
    total = res.timing.total_ms
    time.sleep(0.002)
    assert res.timing.total_ms == total


def test_load_session_takes_timing(reference, tmp_path):
    engine = PlanetEngine(device="cpu")
    engine.generate(PARAMS)
    path = str(tmp_path / "s.npz")
    engine.save_session(path)
    loaded = PlanetEngine.load_session(path, device="cpu", timing=True)
    res = loaded.reapply(skip_climate=True)
    assert res.timing.syncs == 2       # post-processing, triangles
    assert torch.equal(res.elevation, reference.elevation)


def test_prefetch_is_adopted_and_changes_nothing(reference):
    prefetch_mesh(PARAMS.replace(skip_climate=False))   # same key
    holder = eng_mod._MESH_PREFETCH[eng_mod._prefetch_key(PARAMS)]
    holder["thread"].join()
    assert "error" not in holder
    res = PlanetEngine(device="cpu").generate(PARAMS)
    assert res.graph is holder["graph"]
    assert not eng_mod._MESH_PREFETCH
    # the host products came from the thread too: the coarse-plate stage
    # did not run on the caller's thread
    assert "Coarse plates" not in dict(res.timing.stages)
    for name in ("elevation", "pre_post_elevation", "r_plate", "stress"):
        assert torch.equal(getattr(res, name), getattr(reference, name))


def test_prefetch_of_toggled_params_builds_the_mesh_only(reference):
    toggled = PARAMS.replace(toggled_indices=(0,))
    prefetch_mesh(PARAMS.replace(seed=6))
    prefetch_mesh(toggled)
    # the earlier, unclaimed entry was dropped
    assert list(eng_mod._MESH_PREFETCH) == [eng_mod._prefetch_key(toggled)]
    graph, products = eng_mod._take_prefetched_mesh(toggled)
    assert graph is not None
    assert (graph.pos == reference.graph.pos).all()
    assert products is None
    assert eng_mod._take_prefetched_mesh(toggled) == (None, None)


def test_prefetch_error_surfaces_from_generate(monkeypatch, reference):
    """A build that fails only on the prefetch thread is reported with a
    warning and rebuilt on the caller's thread, as the JAX engine rebuilds:
    the planet equals an unprefetched generate. A build that fails on both
    threads raises from ``generate``."""
    build = eng_mod.build_sphere

    def fails_in_thread(*args, **kw):
        if threading.current_thread() is not threading.main_thread():
            raise ValueError("mesh build failed in the prefetch thread")
        return build(*args, **kw)

    monkeypatch.setattr(eng_mod, "build_sphere", fails_in_thread)
    prefetch_mesh(PARAMS)
    with pytest.warns(RuntimeWarning, match="prefetch"):
        res = PlanetEngine(device="cpu").generate(PARAMS)
    assert not eng_mod._MESH_PREFETCH
    for name in ("elevation", "pre_post_elevation", "r_plate", "stress"):
        assert torch.equal(getattr(res, name), getattr(reference, name))

    def fails_always(*args, **kw):
        raise ValueError("mesh build failed")

    monkeypatch.setattr(eng_mod, "build_sphere", fails_always)
    prefetch_mesh(PARAMS)
    with pytest.warns(RuntimeWarning, match="prefetch"):
        with pytest.raises(ValueError, match="mesh build failed"):
            PlanetEngine(device="cpu").generate(PARAMS)


def test_prime_device_transfer_is_a_no_op_on_the_cpu(monkeypatch):
    monkeypatch.setattr(eng_mod, "_TRANSFER_PRIMED", False)
    started = []
    monkeypatch.setattr(threading.Thread, "start",
                        lambda self: started.append(self.name))
    prime_device_transfer("cpu")
    prime_device_transfer(torch.device("cpu"))
    PlanetEngine(device="cpu")
    assert started == []
    assert eng_mod._TRANSFER_PRIMED is False
