"""The port's retained-state engine commands and worker protocol, held to
the contracts of tests/test_pipeline.py and tests/test_protocol.py on the
port's own 2000-cell planets (no JAX generate runs here), and its
sessions held against the JAX package's session format.

Contracts taken over:

- generate: finite terrain, land fraction in (0.1, 0.5), the whole
  climate, one triangle elevation per triangle, the debug layers; progress
  events from 0;
- reapply: a no-change reapply reproduces the generate's final elevation
  EXACTLY (atol 0); a sculpted one keeps the pre-post elevation and moves
  the final one;
- edit_recompute: the toggled plate flips against the generate's own flags
  (and stays flipped on a repeated edit: toggles start from those flags
  every call), and the elevation changes;
- compute_climate: the second call with only an offset changed runs no
  wind and no ocean-current stage;
- import_heightmap: an equatorial land band comes back as land (> 80 % of
  cells within 20° of the equator), the poles as ocean (> 90 % beyond
  60°), with at least two synthetic plates;
- sessions: save → load → no-change reapply equals the live engine's
  retained final elevation (atol 0); a session the port writes loads in
  the JAX ``PlanetEngine.load_session`` and one the JAX package writes
  loads in the port, with equal plate map, pre-post elevation and plate
  ocean flags;
- against the JAX engine on that shared session: ``reapply`` (the
  default sliders) keeps the same pre-post elevation and gives
  the final one by distribution, as tests/test_torch_slice.py holds the
  post stage; ``edit_recompute`` toggles the same plate flags and
  densities and rebuilds the same super plates (from the coarse map),
  hotspot domes and noise tables as the JAX edit's host half, exactly.
  The JAX edit's elevation stage is not run here: its first call
  compiles ``assign_elevation`` for about 160 s on the CPU, and that
  stage is held against JAX on identical inputs by
  tests/test_torch_elevation.py and tests/test_torch_slice.py;
- the import helpers against the JAX ``_grayscale_to_elevation``,
  ``_sample_heightmap`` and ``_derive_synthetic_plates`` on the
  ``tiny_sphere`` mesh: the height curve within rtol 1e-6, the bilinear
  sample within rtol 1e-5 / atol 5e-5 (f32 ``asin`` / ``atan2`` move the
  sample points in the last bits) with the same ocean cells, and the same
  plate partition, seeds and plate flags;
- protocol: typed done responses with progress events, error envelopes
  (unknown command, bad params, reapply without state), the climate
  resilience seam (generate and reapply return the terrain with an
  ``error``, a later compute_climate heals; edit_recompute raises), and
  the PLANET_PERF_LOG record.
"""

import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine
from planet_heightmap_generation_torch.pipeline.protocol import (
    COMMANDS, WorkerProtocol)

PARAMS = GenerationParams(seed=3, n_cells=2000, n_plates=10,
                          num_continents=2, skip_climate=False)


@pytest.fixture(scope="module")
def engine_and_result():
    """The module's engine and its generate; the tests below run in file
    order and own the command-order state, as in tests/test_pipeline.py."""
    engine = PlanetEngine(device="cpu")
    return engine, engine.generate(PARAMS)


def test_generate_complete(engine_and_result):
    _, r = engine_and_result
    d = r.diagnostics()
    assert d["nan_count"] == 0
    assert 0.1 < d["land_fraction"] < 0.5
    assert r.error is None
    assert set(r.climate) == {"wind", "ocean", "precip", "temp", "koppen"}
    assert r.t_elevation.shape[0] == len(r.graph.triangles)
    for k in ("base", "tectonic", "noise", "hotspot", "erosionDelta",
              "koppen", "continentality"):
        assert k in r.debug, k


def test_progress_events():
    events = []
    PlanetEngine(device="cpu").generate(
        PARAMS.replace(skip_climate=True),
        on_progress=lambda pct, label: events.append((pct, label)))
    assert len(events) >= 4
    assert events[0][0] == 0


def test_reapply_without_change_reproduces_generate(engine_and_result):
    engine, first = engine_and_result
    r = engine.reapply(skip_climate=True)
    assert torch.equal(r.elevation, first.elevation)
    assert torch.equal(r.pre_post_elevation, first.pre_post_elevation)


def test_reapply_changes_only_post(engine_and_result):
    engine, first = engine_and_result
    r2 = engine.reapply(sculpt=dict(smoothing=1.0, hydraulic_erosion=0.0,
                                    thermal_erosion=0.0, glacial_erosion=0.0,
                                    ridge_sharpening=0.0, terrain_warp=0.0),
                        skip_climate=True)
    assert torch.equal(r2.pre_post_elevation, first.pre_post_elevation)
    assert bool((r2.elevation != first.elevation).any())
    assert engine._w["params"].smoothing == 1.0


def test_edit_recompute_flips_plate(engine_and_result):
    engine, first = engine_and_result
    orig = engine._w["original_is_ocean"].copy()
    r2 = engine.edit_recompute([0], skip_climate=True)
    assert r2.plate_is_ocean[0] == (not orig[0])
    assert (r2.plate_is_ocean[1:] == orig[1:]).all()
    assert bool((r2.elevation != first.elevation).any())
    assert r2.diagnostics()["nan_count"] == 0
    # a repeated edit starts again from the generate's flags: no drift
    r3 = engine.edit_recompute([0], skip_climate=True)
    assert r3.plate_is_ocean[0] == (not orig[0])
    assert torch.equal(r3.elevation, r2.elevation)


def test_compute_climate_cached(engine_and_result):
    engine, _ = engine_and_result
    out0 = engine.compute_climate()
    assert "koppen" in out0
    stages0 = [s.lower() for s, _ in out0["timing"].stages]
    assert any("wind" in s for s in stages0)    # the skip-climate edit
    out1 = engine.compute_climate(temperature_offset=5.0)
    stages = [s.lower() for s, _ in out1["timing"].stages]
    assert not any("wind" in s for s in stages), stages
    assert not any("ocean" in s for s in stages), stages
    assert out1["wind"] is out0["wind"]
    t0 = out0["temp"]["r_temperature_summer"]
    t1 = out1["temp"]["r_temperature_summer"]
    assert float((t1 - t0).mean()) > 0     # warmer everywhere on average


def test_session_save_load_reapply_consistent(engine_and_result, tmp_path):
    engine, _ = engine_and_result
    p = tmp_path / "sess.npz"
    engine.save_session(str(p))
    eng2 = PlanetEngine.load_session(str(p), device="cpu")
    w1, w2 = engine._w, eng2._w
    assert w2["params"] == w1["params"]
    assert torch.equal(w2["r_plate"], w1["r_plate"])
    np.testing.assert_array_equal(w2["plates"].is_ocean,
                                  w1["plates"].is_ocean)
    assert torch.equal(w2["pre_post"], w1["pre_post"])
    r2 = eng2.reapply(skip_climate=True)
    np.testing.assert_allclose(r2.elevation.numpy(),
                               w1["elevation_final"].numpy(), rtol=0, atol=0)


@pytest.fixture(scope="module")
def sessions(engine_and_result, tmp_path_factory):
    """(port engine, JAX engine loaded from the port's session, port
    engine loaded from the session the JAX engine wrote back, port engine
    loaded from the port's session)."""
    from planet_heightmap_generation_tpu.pipeline import (
        PlanetEngine as JaxEngine)

    engine, _ = engine_and_result
    d = tmp_path_factory.mktemp("sessions")
    engine.save_session(str(d / "port.npz"))
    jax_engine = JaxEngine.load_session(str(d / "port.npz"))
    jax_engine.save_session(str(d / "jax.npz"))
    back = PlanetEngine.load_session(str(d / "jax.npz"), device="cpu")
    mine = PlanetEngine.load_session(str(d / "port.npz"), device="cpu")
    return engine, jax_engine, back, mine


def test_port_session_loads_in_jax(sessions):
    engine, jax_engine, _, _ = sessions
    w, wj = engine._w, jax_engine._w
    assert json.dumps(wj["params"].__dict__, default=list, sort_keys=True) \
        == json.dumps(w["params"].__dict__, default=list, sort_keys=True)
    np.testing.assert_array_equal(np.asarray(wj["r_plate"]),
                                  w["r_plate"].numpy())
    np.testing.assert_array_equal(np.asarray(wj["pre_post"]),
                                  w["pre_post"].numpy())
    np.testing.assert_array_equal(wj["plates"].is_ocean,
                                  w["plates"].is_ocean)


def test_jax_session_loads_in_port(sessions):
    engine, _, back, _ = sessions
    w, wb = engine._w, back._w
    assert wb["params"] == w["params"]
    assert torch.equal(wb["r_plate"], w["r_plate"])
    assert torch.equal(wb["pre_post"], w["pre_post"])
    np.testing.assert_array_equal(wb["plates"].is_ocean,
                                  w["plates"].is_ocean)
    assert torch.equal(wb["elevation_final"], w["elevation_final"])


def test_reapply_matches_jax(sessions):
    """Both engines reapply the same sculpt (the default sliders) from the
    same retained state, hotspot and warp tables included."""
    _, jax_engine, _, mine = sessions
    sculpt = dict(smoothing=0.3, hydraulic_erosion=0.5, thermal_erosion=0.1,
                  glacial_erosion=0.0, ridge_sharpening=0.35,
                  terrain_warp=0.5)
    rj = jax_engine.reapply(sculpt=sculpt, skip_climate=True)
    rp = mine.reapply(sculpt=sculpt, skip_climate=True)
    assert rp.error is None and rj.error is None
    np.testing.assert_array_equal(np.asarray(rj.pre_post_elevation),
                                  rp.pre_post_elevation.numpy())
    a, b = np.asarray(rj.elevation), rp.elevation.numpy()
    valid = np.asarray(rp.graph.valid)
    d = np.abs(a - b)[valid]
    assert np.isfinite(b).all()
    assert (b != rp.pre_post_elevation.numpy())[valid].mean() > 0.5
    assert ((a > 0) == (b > 0))[valid].mean() >= 0.999
    assert (d < 1e-3).mean() >= 0.90, (d < 1e-3).mean()
    assert d.mean() < 5e-3, d.mean()


def test_edit_recompute_matches_jax_host_half(sessions):
    """The port's edit of plate 0 against the JAX edit's host half
    (pipeline/engine.py edit_recompute up to its elevation stage), run
    with the JAX functions on the JAX engine's retained state."""
    import copy

    from planet_heightmap_generation_tpu.pipeline.engine import (
        _host_prologue)
    from planet_heightmap_generation_tpu.tectonics.coarse import (
        assign_plate_densities)
    from planet_heightmap_generation_tpu.tectonics.super_plates import (
        build_super_plates)
    from planet_heightmap_generation_torch.pipeline.engine import (
        host_prologue)

    _, jax_engine, _, mine = sessions
    wj = jax_engine._w
    plates = copy.deepcopy(wj["plates"])
    plates.is_ocean = wj["original_is_ocean"].copy()
    plates.is_ocean[0] = not plates.is_ocean[0]
    assign_plate_densities(plates)
    sup_j = build_super_plates(wj["coarse"].graph, wj["coarse"].r_plate,
                               plates)
    domes_j, noise_j, _ = _host_prologue(wj["graph"], wj["coarse"], plates,
                                         wj["seed"], wj["params"].n_plates)

    r = mine.edit_recompute([0], skip_climate=True)
    w = mine._w
    assert r.diagnostics()["nan_count"] == 0
    np.testing.assert_array_equal(r.plate_is_ocean, plates.is_ocean)
    assert r.plate_is_ocean[0] != wj["original_is_ocean"][0]
    np.testing.assert_array_equal(r.plate_density, plates.density)
    sup = w["super_sp"]
    assert sup.num_super == sup_j.num_super
    for f in ("plate_to_super", "pole", "omega", "is_ocean", "density"):
        np.testing.assert_array_equal(getattr(sup, f), getattr(sup_j, f),
                                      err_msg=f)
    domes, _, _ = host_prologue(w["graph"], w["coarse"], w["plates"],
                                w["seed"], w["params"].n_plates, "cpu")
    assert set(domes) == set(domes_j)
    for k, v in domes_j.items():
        np.testing.assert_array_equal(domes[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert set(w["noise_pack"]) == set(noise_j)
    for k, v in noise_j.items():
        np.testing.assert_array_equal(w["noise_pack"][k].perm.numpy(),
                                      np.asarray(v.perm), err_msg=k)
        np.testing.assert_array_equal(w["noise_pack"][k].pm12.numpy(),
                                      np.asarray(v.pm12), err_msg=k)


@pytest.fixture(scope="module")
def import_pair(tiny_sphere):
    """(JAX DeviceGraph, port DeviceGraph, numpy-seeded [64, 128]
    grayscale: a bright noisy equatorial band, a tenth of its pixels below
    the ocean threshold, and dark poles)."""
    from planet_heightmap_generation_tpu.mesh.device import to_device
    from planet_heightmap_generation_torch import interop

    rng = np.random.default_rng(8)
    yy = np.linspace(-1, 1, 64)[:, None]
    band = np.clip(200 * (1 - np.abs(yy) * 1.6), 0, None)
    img = np.where(band > 0, band + 40 * rng.random((64, 128)), 0.0)
    img[rng.random((64, 128)) < 0.1] = 0.5
    return (to_device(tiny_sphere),
            interop.state_from_numpy(torch_parity.mesh_fields(tiny_sphere))
            ["g"], img.astype(np.float32))


@pytest.mark.parametrize("helper", ["grayscale", "sample", "plates"])
def test_import_helpers_match_jax(import_pair, helper):
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.pipeline import engine as jeng
    from planet_heightmap_generation_torch.pipeline import engine as peng

    g_j, g_t, img = import_pair
    valid = np.asarray(g_t.valid)
    if helper == "grayscale":
        gray = np.concatenate([img[:8].ravel(), [0.0, 0.999, 1.0, 255.0]])
        a = np.asarray(jeng._grayscale_to_elevation(jnp.asarray(gray)))
        b = peng.grayscale_to_elevation(torch.as_tensor(gray)).numpy()
        assert (a == -0.5).sum() > 50
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    elif helper == "sample":
        a = np.asarray(jeng._sample_heightmap(g_j, jnp.asarray(img)))
        b = peng.sample_heightmap(g_t, torch.as_tensor(img)).numpy()
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_array_equal(a <= 0, b <= 0)
        assert ((a <= 0) & valid).sum() > 50 and (a > 0.5).sum() > 50
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=5e-5)
    else:
        elev = np.asarray(jeng._sample_heightmap(g_j, jnp.asarray(img)))
        rj, pj = jeng._derive_synthetic_plates(g_j, jnp.asarray(elev))
        rt, pt = peng.derive_synthetic_plates(g_t, torch.tensor(elev))
        assert pt.num_plates == pj.num_plates >= 2
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(pt.seeds, pj.seeds)
        np.testing.assert_array_equal(pt.is_ocean, pj.is_ocean)
        assert pt.is_ocean.any() and not pt.is_ocean.all()


def test_import_heightmap():
    h, w = 64, 128
    img = np.zeros((h, w), np.float32)
    img[24:40, :] = 200.0   # mid-gray land band round the equator
    r = PlanetEngine(device="cpu").import_heightmap(
        img.ravel(), w, h, GenerationParams(seed=5, n_cells=2000,
                                            skip_climate=True))
    n = r.graph.n_cells
    e = r.elevation[:n].numpy()
    lat = np.degrees(np.arcsin(np.clip(r.graph.pos[:n, 1], -1, 1)))
    assert (e[np.abs(lat) < 20] > 0).mean() > 0.8
    assert (e[np.abs(lat) > 60] <= 0).mean() > 0.9
    assert r.plate_is_ocean.size >= 2


# ── worker protocol ──────────────────────────────────────────────────

PROTO = dict(seed=9, n_cells=2000, n_plates=10, num_continents=2,
             skip_climate=True)


@pytest.fixture(scope="module")
def worker_and_log():
    log = []
    return WorkerProtocol(engine=PlanetEngine(device="cpu"),
                          on_message=log.append), log


def test_protocol_generate_done(worker_and_log):
    w, log = worker_and_log
    resp = w.dispatch(dict(cmd="generate", params=PROTO))
    assert resp["type"] == "done", resp.get("stack")
    assert resp["diagnostics"]["nan_count"] == 0
    assert len(resp["elevation"]) == 2001    # N+1 with the pole
    assert isinstance(resp["elevation"], np.ndarray)
    assert "error" not in resp
    assert any(m.get("type") == "progress" for m in log)


@pytest.mark.parametrize("cmd", ["reapply", "editRecompute",
                                 "computeClimate", "importHeightmap"])
def test_protocol_command_done(worker_and_log, cmd):
    w, _ = worker_and_log
    msg = {
        "reapply": dict(sculpt=dict(smoothing=0.6), skipClimate=True),
        "editRecompute": dict(toggledIndices=(0,), skipClimate=True),
        "computeClimate": dict(temperatureOffset=2.0),
        "importHeightmap": dict(
            grayscale=np.where(np.arange(32)[:, None] % 16 < 8, 150.0,
                               0.0) * np.ones((1, 64)),
            width=64, height=32, params=PROTO),
    }[cmd]
    resp = w.dispatch(dict(cmd=cmd, **msg))
    want = dict(reapply="reapplyDone", editRecompute="editDone",
                computeClimate="climateDone", importHeightmap="done")[cmd]
    assert resp["type"] == want, resp.get("stack")
    assert cmd in COMMANDS
    if cmd == "computeClimate":
        assert resp["koppen"].shape == (2001,)
    else:
        assert np.isfinite(resp["elevation"]).all()


def test_unknown_command_is_error(worker_and_log):
    w, _ = worker_and_log
    resp = w.dispatch(dict(cmd="explode"))
    assert resp["type"] == "error"
    assert "explode" in resp["message"]
    assert "stack" in resp


def test_bad_params_is_error_not_raise(worker_and_log):
    w, _ = worker_and_log
    resp = w.dispatch(dict(cmd="generate", params=dict(seed=-5)))
    assert resp["type"] == "error"
    assert "seed" in resp["message"]


def test_reapply_without_state_is_error():
    w = WorkerProtocol(engine=PlanetEngine(device="cpu"))
    resp = w.dispatch(dict(cmd="reapply"))
    assert resp["type"] == "error"
    assert "retained" in resp["message"].lower()


def test_degraded_climate_returns_terrain(monkeypatch):
    """A climate failure leaves generate and reapply with the terrain and
    a structured error; compute_climate heals afterwards; edit_recompute
    lets the failure through, as the JAX engine does."""
    engine = PlanetEngine(device="cpu")
    boom = RuntimeError("climate OOM (injected)")

    def exploding_climate(*a, **k):
        raise boom

    monkeypatch.setattr(PlanetEngine, "_run_climate", exploding_climate)
    params = PARAMS.replace(seed=4)
    result = engine.generate(params)
    assert result.climate is None
    assert result.error["stage"] == "climate"
    assert "injected" in result.error["message"]
    e = result.elevation.numpy()
    assert np.isfinite(e).all() and (e > 0).any()
    again = engine.reapply(skip_climate=False)
    assert again.error["stage"] == "climate" and again.climate is None
    assert torch.equal(again.elevation, result.elevation)
    with pytest.raises(RuntimeError, match="injected"):
        engine.edit_recompute([1], skip_climate=False)

    monkeypatch.undo()
    cl = engine.compute_climate()
    assert "koppen" in cl and cl["koppen"].shape[0] >= 2000

    monkeypatch.setattr(PlanetEngine, "_run_climate", exploding_climate)
    w = WorkerProtocol(engine=engine)
    resp = w.dispatch(dict(cmd="generate",
                           params=dict(PROTO, skip_climate=False)))
    assert resp["type"] == "done"
    assert resp["error"]["stage"] == "climate"


def test_perf_log_written(tmp_path, monkeypatch):
    path = tmp_path / "perf.jsonl"
    monkeypatch.setenv("PLANET_PERF_LOG", str(path))
    engine = PlanetEngine(device="cpu")
    engine.generate(GenerationParams(**PROTO))
    engine.reapply(skip_climate=True)
    recs = [json.loads(line) for line in open(path)]
    assert [r["kind"] for r in recs] == ["generate", "reapply"]
    assert recs[0]["n_cells"] == 2000
    assert recs[0]["total_ms"] > 0
    assert "Elevation" in recs[0]["stages"]
