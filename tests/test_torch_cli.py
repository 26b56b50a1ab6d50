"""The port's command-line interface and multi-seed batch, on the CPU
(``--device cpu``) at 2000 cells, held to the JAX package's CLI contracts
(tests/test_pipeline.py) and against its pure-Python parts (``code``, the
npz keys ``_save_result`` writes), with no JAX pipeline run here.

Contracts:

- batch: ``generate_batch(params, [3, 9, 3])`` gives the same elevation
  bit for bit for the same seed, another for another, and each equals
  ``engine.generate`` of its seed bit for bit; ``lean=True`` keeps the
  elevation alone, on the host, and leaves the engine without retained
  state; ``sweep_heightmaps`` shares one raster at jitter 0 and exports
  each seed as ``export_map`` does; more than one device is refused;
- CLI, every subcommand: ``generate`` writes the JAX CLI's npz keys and
  values for the same result, and a code equal to the JAX
  ``encode_planet_code``; the session commands (``reapply``, ``edit``,
  ``climate``) round-trip through the session file; ``export`` writes a
  PNG of the asked width equal to the in-memory export; ``code`` prints
  what the JAX CLI prints; ``import-heightmap``, ``sweep``, ``inspect`` and
  ``globe`` write their outputs; a bad ``--code`` exits with "invalid
  planet code", an unknown ``--type`` raises ``ValueError``, a climate
  stage error exits 3, and ``--device`` defaults to the card (no silent
  CPU).
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_tpu import cli as jcli

from planet_heightmap_generation_torch import cli
from planet_heightmap_generation_torch.api.export import export_map
from planet_heightmap_generation_torch.api.imageio import load_png
from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.mesh.device import to_device
from planet_heightmap_generation_torch.parallel import (generate_batch,
                                                        sweep_heightmaps)
from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

TERRAIN = GenerationParams(seed=0, n_cells=2000, n_plates=10,
                           num_continents=2, skip_climate=True)
GEN = ["--cells", "2000", "--plates", "10", "--continents", "2",
       "--device", "cpu"]


def _run(argv):
    """stdout of ``cli.main(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


# ── batch ─────────────────────────────────────────────────────────────

def test_generate_batch_matches_sequential():
    eng = PlanetEngine(device="cpu")
    runs = generate_batch(TERRAIN, [3, 9, 3], engine=eng)
    assert [r.params.seed for r in runs] == [3, 9, 3]
    assert torch.equal(runs[0].elevation, runs[2].elevation)
    assert not torch.equal(runs[0].elevation, runs[1].elevation)
    for r in runs[:2]:
        ref = PlanetEngine(device="cpu").generate(r.params)
        assert torch.equal(r.elevation, ref.elevation)
        assert torch.equal(r.r_plate, ref.r_plate)

    seen = []
    lean = generate_batch(TERRAIN, [9], devices=["cpu"], lean=True,
                          vmap_chunk=4,
                          on_progress=lambda i, pct, label: seen.append(i))
    assert set(seen) == {0}
    r = lean[0]
    assert isinstance(r.elevation, np.ndarray)
    np.testing.assert_array_equal(r.elevation, runs[1].elevation.numpy())
    assert r.r_plate is None and r.stress is None and r.climate is None
    assert r.debug == {} and r.t_elevation is None
    assert r.diagnostics()["nan_count"] == 0
    with pytest.raises(ValueError, match="one device"):
        generate_batch(TERRAIN, [1], devices=["cpu", "cpu"])


def test_sweep_heightmaps_shares_the_raster():
    params = TERRAIN.replace(jitter=0.0)
    out = list(sweep_heightmaps(params, [1, 2], width=64, devices=["cpu"]))
    assert [s for s, _, _ in out] == [1, 2]
    for s, r, img in out:
        assert img.shape == (32, 64, 3)
        want = export_map(to_device(r.graph, "cpu"), r.elevation,
                          "heightmap", height=32, width=64)
        np.testing.assert_array_equal(img, want)
    assert not np.array_equal(out[0][2], out[1][2])


# ── CLI ───────────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The directory the CLI tests below share, in file order: generate
    writes the planet and the session the later commands read."""
    return tmp_path_factory.mktemp("cli")


def test_cli_generate_writes_the_jax_npz(work):
    out = _run(["generate", "--seed", "5", *GEN, "--out",
                str(work / "p.npz"), "--session", str(work / "s.npz")])
    assert "TOTAL" in out and "session saved" in out
    assert (work / "s.npz").exists()
    data = np.load(work / "p.npz")
    r = PlanetEngine(device="cpu").generate(GenerationParams(
        seed=5, n_cells=2000, n_plates=10, num_continents=2))
    np.testing.assert_array_equal(data["elevation"],
                                  r.elevation[:r.graph.n_cells].numpy())
    # the JAX CLI's _save_result on the same arrays writes the same npz
    j = r.__class__(**{**r.__dict__, **{
        k: jnp.asarray(getattr(r, k).numpy())
        for k in ("elevation", "r_plate", "stress")}})
    j.climate = {"koppen": jnp.asarray(r.climate["koppen"].numpy()),
                 **{part: {k: jnp.asarray(v.numpy())
                           for k, v in r.climate[part].items()}
                    for part in ("temp", "precip")}}
    jcli._save_result(j, str(work / "j.npz"))
    want = np.load(work / "j.npz")
    assert sorted(data.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(data[k], want[k], err_msg=k)


def test_cli_session_commands_round_trip(work):
    base = np.load(work / "p.npz")
    _run(["reapply", "--session", str(work / "s.npz"), "--smoothing", "1.0",
          "--hydraulic", "0.0", "--skip-climate", "--device", "cpu",
          "--out", str(work / "re.npz")])
    re = np.load(work / "re.npz")
    assert re["elevation"].shape == base["elevation"].shape
    assert (re["elevation"] != base["elevation"]).any()
    assert "koppen" not in re.files

    _run(["edit", "--session", str(work / "s.npz"), "--toggle", "0",
          "--device", "cpu", "--out", str(work / "ed.npz")])
    ed = np.load(work / "ed.npz")
    assert np.isfinite(ed["elevation"]).all() and "koppen" in ed.files
    assert bool(ed["plate_is_ocean"][0]) != bool(base["plate_is_ocean"][0])

    _run(["climate", "--session", str(work / "s.npz"),
          "--temperature-offset", "4", "--device", "cpu",
          "--out", str(work / "c.npz")])
    c = np.load(work / "c.npz")
    assert sorted(c.files) == sorted(
        ["koppen"] + [f"{f}_{s}" for f in ("temperature", "precip",
                                           "wind_speed")
                      for s in ("summer", "winter")])
    # the session keeps the edit and the offset
    eng = PlanetEngine.load_session(str(work / "s.npz"), device="cpu")
    assert eng._w["params"].temperature_offset == 4
    assert bool(eng._w["plates"].is_ocean[0]) == bool(ed["plate_is_ocean"][0])


def test_cli_export_writes_the_asked_width(work):
    _run(["export", "--in", str(work / "p.npz"), "--type", "heightmap",
          "--width", "128", "--device", "cpu", "--out",
          str(work / "m.png")])
    got = load_png(str(work / "m.png"))
    assert got.shape == (64, 128, 3)
    r = PlanetEngine(device="cpu").generate(GenerationParams(
        seed=5, n_cells=2000, n_plates=10, num_continents=2,
        skip_climate=True))
    mem = export_map(to_device(r.graph, "cpu"), r.elevation, "heightmap",
                     height=64, width=128)
    np.testing.assert_array_equal(
        got, np.clip(mem * 255 + 0.5, 0, 255).astype(np.uint8))
    _run(["export", "--in", str(work / "p.npz"), "--type", "koppen",
          "--width", "32", "--device", "cpu", "--out", str(work / "k.png")])
    assert load_png(str(work / "k.png")).shape == (16, 32, 3)
    with pytest.raises(ValueError, match="unknown export type"):
        _run(["export", "--in", str(work / "p.npz"), "--type", "nonsense",
              "--device", "cpu", "--out", str(work / "x.png")])


@pytest.mark.parametrize("argv", [
    ["--seed", "42", "--cells", "204000"],
    ["--seed", "7", "--cells", "2560000", "--plates", "30", "--warp", "0.2",
     "--land-coverage", "0.45"],
])
def test_cli_code_prints_the_jax_code(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main(["code", *argv])
    assert _run(["code", *argv]) == buf.getvalue()


def test_cli_bad_code_and_stage_error(work, monkeypatch):
    with pytest.raises(SystemExit) as e:
        _run(["generate", "--code", "!!bogus!!", "--device", "cpu"])
    assert "invalid planet code" in str(e.value.code)

    def fail(*args, **kw):
        raise RuntimeError("climate went away")

    monkeypatch.setattr(PlanetEngine, "_run_climate", fail)
    with pytest.raises(SystemExit) as e:
        _run(["generate", *GEN, "--out", str(work / "err.npz")])
    assert e.value.code == 3
    assert not (work / "err.npz").exists()


def test_cli_defaults_to_the_card(work, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(["generate", "--cells", "2000", "--out", str(work / "n.npz")])


def test_cli_import_inspect_globe_sweep(work, monkeypatch):
    img = np.zeros((32, 64), np.uint8)
    img[10:22] = 200            # an equatorial land band
    np.save(work / "band.npy", img)
    _run(["import-heightmap", "--image", str(work / "band.npy"), *GEN,
          "--skip-climate", "--out", str(work / "imp.npz")])
    imp = np.load(work / "imp.npz")
    lat = np.degrees(np.arcsin(np.clip(imp["pos"][:, 1], -1, 1)))
    assert (imp["elevation"][np.abs(lat) < 15] > 0).mean() > 0.8

    info = json.loads(_run(["inspect", "--lat", "10", "--lon", "20", *GEN,
                            "--skip-climate"]))
    assert info["cell"] >= 0 and "koppen" not in info

    out = _run(["globe", *GEN, "--skip-climate", "--layer",
                "terrain,plates", "--dir", str(work / "g")])
    assert "globe viewer written" in out
    manifest = json.load(open(work / "g" / "globe.json"))
    assert [m["name"] for m in manifest["layers"]] == ["terrain", "plates"]

    monkeypatch.chdir(work)
    lines = _run(["sweep", "--seeds", "1,2", *GEN, "--skip-climate",
                  "--export-width", "64"]).splitlines()
    assert [json.loads(x)["seed"] for x in lines] == [1, 2]
    for s in (1, 2):
        assert load_png(os.path.join(work, f"heightmap_seed{s}.png")
                        ).shape == (32, 64, 3)
