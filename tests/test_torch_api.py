"""The port's api/ (inspect layers, picking, overlays, map export, globe,
planet codes, image IO) held against the JAX package's api on identical
inputs: the port's own 2000-cell planet with climate, its arrays wrapped
for the JAX functions as JAX arrays (no JAX pipeline runs here).

Contracts:

- layers: the same available names; every layer's colors within atol
  1e-6; the same ValueErrors (climate-less, debug-less, unknown names);
- picking: ``nearest_region`` the same cell at 20 lat/lon points,
  ``cell_info`` the same fields (floats rtol 1e-6);
- overlays: the same arrow cells, arrows within atol 1e-5; plate borders,
  the ITCZ polyline and the lat/lon grid exact;
- export: ``rasterize_cell_ids`` at 256×128 the same ids except on score
  ties (|Δscore| ≤ 1e-6, at most 0.1 % of pixels); each export type
  within atol 1e-6 where the ids agree; the tiled export's PNG the JAX
  tiled export's pixels on ≥ 99.9 %, and ≥ 97 % of the in-memory export's
  (tests/test_export_tiled.py:58); ``save_png`` / ``load_png`` round trips;
- globe: the geometry within atol 1e-6; the manifest's keys and byte
  counts equal;
- planet codes and image IO: the JAX package's strings, dicts and arrays,
  exactly.
"""

import dataclasses
import json
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_tpu.api import export as jexport
from planet_heightmap_generation_tpu.api import globe as jglobe
from planet_heightmap_generation_tpu.api import imageio as jimageio
from planet_heightmap_generation_tpu.api import layers as jlayers
from planet_heightmap_generation_tpu.api import overlays as joverlays
from planet_heightmap_generation_tpu.api import picking as jpicking
from planet_heightmap_generation_tpu.api import planet_code as jcode
from planet_heightmap_generation_tpu.mesh.device import to_device as jdevice

from planet_heightmap_generation_torch.api import export as pexport
from planet_heightmap_generation_torch.api import globe as pglobe
from planet_heightmap_generation_torch.api import imageio as pimageio
from planet_heightmap_generation_torch.api import layers as players
from planet_heightmap_generation_torch.api import overlays as poverlays
from planet_heightmap_generation_torch.api import picking as ppicking
from planet_heightmap_generation_torch.api import planet_code as pcode
from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.mesh.device import to_device
from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

PARAMS = GenerationParams(seed=3, n_cells=2000, n_plates=10,
                          num_continents=2, skip_climate=False)
H, W = 128, 256


def _jax(x):
    """Tensors (nested in dicts) as JAX arrays of the same values."""
    if isinstance(x, dict):
        return {k: _jax(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return jnp.asarray(x.numpy())
    return x


@pytest.fixture(scope="module")
def results():
    """(port result, the same arrays as a result for the JAX api)."""
    r = PlanetEngine(device="cpu").generate(PARAMS)
    assert r.error is None and r.climate is not None
    j = dataclasses.replace(
        r, r_plate=_jax(r.r_plate), elevation=_jax(r.elevation),
        t_elevation=_jax(r.t_elevation), stress=_jax(r.stress),
        climate=_jax(r.climate), debug=_jax(r.debug))
    return r, j


def _terrain_only(r):
    """The result without climate: no climate fields, no climate layers."""
    climate_layers = set(players.LAYERS) - set(
        players.GEOLOGY_DEBUG + ["tecActivity", "superPlates"])
    return dataclasses.replace(
        r, climate=None,
        debug={k: v for k, v in r.debug.items()
               if k not in climate_layers and k != "koppen"})


# ── layers ────────────────────────────────────────────────────────────

def test_available_layers_match(results):
    r, j = results
    assert players.available_layers(r) == jlayers.available_layers(j)
    assert len(players.available_layers(r)) == len(players.LAYERS)
    assert (players.available_layers(_terrain_only(r))
            == jlayers.available_layers(_terrain_only(j)))


@pytest.mark.parametrize("name", players.LAYERS)
def test_layer_colors_match(results, name):
    r, j = results
    got = players.layer_color(r, name)
    assert got.dtype == torch.float32 and got.shape == (r.graph.n_padded, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jlayers.layer_color(j, name)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["biome", "koppen", "currents",
                                  "pressureSummer", "tempWinter", "nonsense"])
def test_layer_errors_match(results, name):
    r, j = results
    with pytest.raises(ValueError) as pe:
        players.layer_color(_terrain_only(r), name)
    with pytest.raises(ValueError) as je:
        jlayers.layer_color(_terrain_only(j), name)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("name", ["superPlates", "tecActivity", "base"])
def test_debug_layer_errors_match(results, name):
    r, j = results
    with pytest.raises(ValueError) as pe:
        players.layer_color(dataclasses.replace(r, debug={}), name)
    with pytest.raises(ValueError) as je:
        jlayers.layer_color(dataclasses.replace(j, debug={}), name)
    assert str(pe.value) == str(je.value)


# ── picking ───────────────────────────────────────────────────────────

def test_picking_matches(results):
    r, j = results
    rng = np.random.default_rng(11)
    for lat, lon in zip(rng.uniform(-90, 90, 20), rng.uniform(-180, 180, 20)):
        cell = ppicking.nearest_region(r, lat, lon)
        assert cell == jpicking.nearest_region(j, lat, lon), (lat, lon)
        got, want = ppicking.cell_info(r, cell), jpicking.cell_info(j, cell)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k
            else:
                assert got[k] == v, k
    with pytest.raises(ValueError):
        ppicking.cell_info(r, r.graph.n_cells)


# ── overlays ──────────────────────────────────────────────────────────

@pytest.mark.parametrize("kind", ["wind", "currents"])
@pytest.mark.parametrize("season", ["summer", "winter"])
def test_arrows_match(results, kind, season):
    r, j = results
    p_fn, j_fn = {"wind": (poverlays.wind_arrows, joverlays.wind_arrows),
                  "currents": (poverlays.ocean_current_arrows,
                               joverlays.ocean_current_arrows)}[kind]
    got, want = p_fn(r, season), j_fn(j, season)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["cells"], want["cells"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_polylines_and_borders_match(results):
    r, j = results
    for season in ("summer", "winter"):
        np.testing.assert_array_equal(poverlays.itcz_polyline(r, season),
                                      joverlays.itcz_polyline(j, season))
    for sp in (False, True):
        np.testing.assert_array_equal(poverlays.plate_border_edges(r, sp),
                                      joverlays.plate_border_edges(j, sp))
    for got, want in zip(poverlays.latlon_grid().values(),
                         joverlays.latlon_grid().values()):
        np.testing.assert_array_equal(got, want)
    terrain = _terrain_only(r)
    for fn in (poverlays.wind_arrows, poverlays.ocean_current_arrows,
               poverlays.itcz_polyline):
        with pytest.raises(ValueError):
            fn(terrain)


# ── export ────────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def rasters(results):
    """(port ids, JAX ids, JAX device graph) at H × W."""
    r, _ = results
    jg = jdevice(r.graph)
    got = pexport.rasterize_cell_ids(to_device(r.graph, "cpu"), H, W)
    return got.numpy(), np.asarray(jexport.rasterize_cell_ids(jg, H, W)), jg


def _pixel_pos(h, w):
    plat = (0.5 - (np.arange(h) + 0.5) / h) * np.pi
    plon = ((np.arange(w) + 0.5) / w * 2 - 1) * np.pi
    cl = np.cos(plat)[:, None]
    return np.stack([cl * np.sin(plon)[None], np.broadcast_to(
        np.sin(plat)[:, None], (h, w)), cl * np.cos(plon)[None]], -1)


def test_raster_ids_match_up_to_ties(results, rasters):
    r, _ = results
    got, want, _ = rasters
    assert got.dtype == np.int32 and got.shape == (H, W)
    assert got.min() >= 0 and got.max() < r.graph.n_cells
    diff = got != want
    assert diff.mean() <= 1e-3, diff.mean()
    pos = r.graph.pos.astype(np.float64)
    pp = _pixel_pos(H, W)[diff]
    s_got = np.einsum("nc,nc->n", pos[got[diff]], pp)
    s_want = np.einsum("nc,nc->n", pos[want[diff]], pp)
    np.testing.assert_allclose(s_got, s_want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", pexport.EXPORT_TYPES)
def test_export_types_match(results, rasters, kind):
    r, j = results
    got_ids, want_ids, jg = rasters
    kop = r.climate["koppen"]
    got = pexport.export_map(to_device(r.graph, "cpu"), r.elevation, kind,
                             H, W, koppen=kop,
                             cell_ids=torch.as_tensor(got_ids))
    want = jexport.export_map(jg, j.elevation, kind, H, W,
                              koppen=j.climate["koppen"],
                              cell_ids=jnp.asarray(want_ids))
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    same = got_ids == want_ids
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-6)


def test_export_errors(results):
    r, _ = results
    g = to_device(r.graph, "cpu")
    with pytest.raises(ValueError, match="unknown export type"):
        pexport.export_map(g, r.elevation, "nonsense", 8, 16)
    with pytest.raises(ValueError, match="requires the koppen"):
        pexport.export_map(g, r.elevation, "biome", 8, 16)
    imgs = pexport.export_map_batch(g, r.elevation, ("heightmap", "koppen"),
                                    16, 32, koppen=r.climate["koppen"])
    assert [v.shape for v in imgs.values()] == [(16, 32, 3)] * 2
    c = np.linspace(-0.5, 1.5, 41, dtype=np.float32)
    np.testing.assert_allclose(pexport.linear_to_srgb(torch.as_tensor(c)),
                               np.asarray(jexport.linear_to_srgb(c)),
                               rtol=1e-6, atol=1e-7)


def test_tiled_export_matches(results, rasters, tmp_path):
    r, j = results
    got_ids, _, jg = rasters
    kop = r.climate["koppen"]
    # an odd band height exercises the last partial band
    pexport.export_map_tiled(r.graph, r.elevation, "biome",
                             str(tmp_path / "p.png"), width=W, height=H,
                             koppen=kop, band_h=23)
    jexport.export_map_tiled(r.graph, j.elevation, "biome",
                             str(tmp_path / "j.png"), width=W, height=H,
                             koppen=j.climate["koppen"], band_h=23)
    got = pimageio.load_png(str(tmp_path / "p.png"))
    want = pimageio.load_png(str(tmp_path / "j.png"))
    assert got.shape == (H, W, 3)
    assert (got == want).all(axis=2).mean() >= 0.999
    ref = pexport.export_map(to_device(r.graph, "cpu"), r.elevation, "biome",
                             H, W, koppen=kop,
                             cell_ids=torch.as_tensor(got_ids))
    ref8 = np.clip(ref * 255 + 0.5, 0, 255).astype(np.uint8)
    close = np.abs(got.astype(int) - ref8.astype(int)).max(axis=2) <= 2
    assert close.mean() > 0.97


def test_tiled_band_height_rule():
    for width, kc in ((256, 16), (16384, 32), (65536, 48)):
        assert pexport.tiled_band_height(width, kc) == max(16, min(
            2048, (3 << 29) // (width * kc * 16)))


# ── globe ─────────────────────────────────────────────────────────────

def test_globe_geometry_matches(results):
    r, j = results
    got = pglobe.build_globe_geometry(r, "biome")
    want = jglobe.build_globe_geometry(j, "biome")
    assert got.keys() == want.keys()
    assert got["num_triangles"] == want["num_triangles"]
    assert got["num_cells"] == want["num_cells"]
    for k in ("positions", "colors"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_export_globe_matches(results, tmp_path):
    r, j = results
    layers = ["terrain", "plates", "tempSummer"]
    html = pglobe.export_globe(r, str(tmp_path / "p"), layer=layers,
                               view="map")
    jglobe.export_globe(j, str(tmp_path / "j"), layer=layers, view="map")
    got = json.load(open(tmp_path / "p" / "globe.json"))
    want = json.load(open(tmp_path / "j" / "globe.json"))
    assert got == want
    assert ((tmp_path / "p" / "globe.bin").stat().st_size
            == (tmp_path / "j" / "globe.bin").stat().st_size
            == got["total_bytes"])
    text = open(html).read()
    assert "planet_heightmap_generation_torch" in text
    assert text.count("<canvas") == open(
        tmp_path / "j" / "globe.html").read().count("<canvas")


# ── planet codes and image IO ─────────────────────────────────────────

CODE_DEFAULTS = dict(
    seed=123456, N=204000, jitter=0.75, P=80, numContinents=4,
    roughness=0.25, terrainWarp=0.5, smoothing=0.3, glacialErosion=0.0,
    hydraulicErosion=0.5, thermalErosion=0.1, ridgeSharpening=0.35,
    soilCreep=0.05, continentSizeVariety=0.0, temperatureOffset=0.0,
    precipitationOffset=0.0, landCoverage=0.3)
CODE_CASES = {
    "defaults": {},
    "extremes": dict(seed=16777215, N=2560000, jitter=1.0, P=120,
                     numContinents=10, roughness=0.5, terrainWarp=1.0,
                     smoothing=1.0, glacialErosion=1.0, hydraulicErosion=1.0,
                     thermalErosion=1.0, ridgeSharpening=1.0, soilCreep=1.0,
                     continentSizeVariety=1.0, temperatureOffset=15,
                     precipitationOffset=1.0, landCoverage=1.0),
    "minimums": dict(seed=0, N=5000, jitter=0.0, P=4, numContinents=1,
                     roughness=0.0, temperatureOffset=-15,
                     precipitationOffset=-1.0, landCoverage=0.0),
    "toggles": dict(toggledIndices=[0, 5, 79]),
    "toggle_out_of_range": dict(toggledIndices=[100]),
}


@pytest.mark.parametrize("case", sorted(CODE_CASES))
def test_planet_codes_match(case):
    kw = dict(CODE_DEFAULTS, **CODE_CASES[case])
    code = pcode.encode_planet_code(**kw)
    assert code == jcode.encode_planet_code(**kw)
    assert pcode.decode_planet_code(code) == jcode.decode_planet_code(code)
    # every shorter generation of the code decodes as the JAX package does
    base = code.split("-")[0]
    for n in pcode._FORMATS:
        assert (pcode.decode_planet_code(base[-n:])
                == jcode.decode_planet_code(base[-n:])), n


@pytest.mark.parametrize("code", ["", "!" * 22, "z" * 12, None, "0" * 22,
                                  "0" * 21 + "-zz", "0" * 13, "0" * 22 + "-1"])
def test_invalid_planet_codes_match(code):
    assert pcode.decode_planet_code(code) == jcode.decode_planet_code(code)


def _png_with_filters(img):
    """An 8-bit RGB PNG whose row y uses scanline filter y % 5."""
    def paeth(a, b, c):
        p = int(a) + int(b) - int(c)
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)

    h, w, _ = img.shape
    flat = img.reshape(h, w * 3).astype(np.int16)
    raw = b""
    prev = np.zeros(w * 3, np.int16)
    for y in range(h):
        f = y % 5
        row = flat[y]
        enc = row.copy()
        for x in range(w * 3):
            a = row[x - 3] if x >= 3 else 0
            b = prev[x]
            c = prev[x - 3] if x >= 3 else 0
            if f == 1:
                enc[x] = row[x] - a
            elif f == 2:
                enc[x] = row[x] - b
            elif f == 3:
                enc[x] = row[x] - ((int(a) + int(b)) >> 1)
            elif f == 4:
                enc[x] = row[x] - paeth(int(a), int(b), int(c))
        raw += bytes([f]) + (enc & 0xFF).astype(np.uint8).tobytes()
        prev = row

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_image_io_matches(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.random((37, 53, 3)).astype(np.float32)
    pexport.save_png(img, str(tmp_path / "p.png"))
    jexport.save_png(img, str(tmp_path / "j.png"))
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    back = pimageio.load_png(str(tmp_path / "p.png"))
    np.testing.assert_array_equal(
        back, np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(pimageio.luminance(back),
                                  jimageio.luminance(back))

    raw8 = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    (tmp_path / "f.png").write_bytes(_png_with_filters(raw8))
    np.testing.assert_array_equal(pimageio.load_png(str(tmp_path / "f.png")),
                                  raw8)
    np.save(tmp_path / "g.npy", raw8)
    np.testing.assert_array_equal(
        pimageio.load_heightmap_gray(str(tmp_path / "g.npy")),
        jimageio.load_heightmap_gray(str(tmp_path / "g.npy")))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        pimageio.load_png(str(tmp_path / "bad.png"))
