"""``PlanetEngine(mesh=)`` with climate on, and the state a split generate
leaves, on the CPU: ``cells_mesh(4, ["cpu"] * 4)`` at 2000 cells
(``seed=11, n_plates=10, num_continents=2``, ``timing=False``: the test
configuration turns timing mode on by default, and it never splits).

Contracts:

- The terrain as in ``test_torch_engine_mesh.py``: elevation within 2e-3
  of the single generate, ``r_plate`` exact, ``nan_count == 0``.
- Each climate field against the single generate's, within a tolerance
  of its own scale. The fields normalised to [0, 1] or ±1 (wind, ocean
  and precipitation speeds and amounts, temperatures, continentality,
  warmth, the rain shadow) within 1e-5: a last-bit difference in a
  smoothing or p95 input moves them by a few ULPs of 1. Pressure (hPa
  about 1013, stored as the deviation) within 1e-3, its ULP at 1013 being
  6e-5. Coast distances (hop counts) and the land mask and Köppen codes
  exactly: a hop count or a class either matches or the split is wrong.
  The split computes the single generate's climate bit for bit (pointwise
  work on the window, neighbour reads after an exchange, the smoothing
  and rain-shadow loops by their split routes, the geo bins and the p95
  normalisers on gathered arrays), so bit equality is asserted too.
- ``reapply`` after a split generate runs unsplit on ``device``, from the
  gathered retained state, and equals the single engine's ``reapply``
  bit for bit.
- ``load_session(path, mesh=)`` keeps the mesh for the engine's later
  generates, and its retained state matches the split engine's.
"""

import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.parallel import cells_mesh
from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

PARAMS = GenerationParams(seed=11, n_cells=2000, n_plates=10,
                          num_continents=2, skip_climate=False)
EXACT = ("r_is_land", "r_coast_dist_land", "r_lat", "r_lon")


def tolerance(name: str) -> float:
    if name in EXACT or name == "koppen":
        return 0.0
    if name.startswith("r_pressure"):
        return 1e-3
    return 1e-5


@pytest.fixture(scope="module")
def engines():
    single = PlanetEngine(device="cpu", timing=False)
    split = PlanetEngine(device="cpu", timing=False,
                         mesh=cells_mesh(4, ["cpu"] * 4))
    return single, single.generate(PARAMS), split, split.generate(PARAMS)


def fields(climate):
    for group in ("wind", "ocean", "precip", "temp"):
        for name, v in climate[group].items():
            if torch.is_tensor(v):
                yield f"{group}.{name}", name, v
    yield "koppen", "koppen", climate["koppen"]


def test_split_climate_matches_single(engines):
    _, ref, eng, res = engines
    assert eng.split_stats is not None and res.error is None
    d = (res.elevation - ref.elevation).abs().max().item()
    assert d < 2e-3, d
    assert torch.equal(res.r_plate, ref.r_plate)
    assert res.diagnostics()["nan_count"] == 0
    got = {key: v for key, _, v in fields(res.climate)}
    for key, name, want in fields(ref.climate):
        v = got[key]
        assert v.shape == want.shape and v.dtype == want.dtype, key
        if v.dtype.is_floating_point:
            ok = torch.isfinite(want)
            assert torch.equal(ok, torch.isfinite(v)), key
            assert (v[ok] - want[ok]).abs().max().item() <= tolerance(name), \
                key
        assert torch.equal(v, want), key
    assert set(res.debug) == set(ref.debug)


def test_reapply_after_split_runs_on_device(engines):
    single, _, eng, _ = engines
    assert eng._w["g"].n_padded == eng._w["elevation_final"].shape[0]
    sculpt = dict(smoothing=0.6, terrain_warp=0.3)
    want = single.reapply(sculpt)
    got = eng.reapply(sculpt)
    assert got.elevation.device == eng.device
    assert torch.equal(got.elevation, want.elevation)
    for key, _, v in fields(want.climate):
        assert torch.equal({k: x for k, _, x in fields(got.climate)}[key],
                           v), key


def test_load_session_keeps_the_mesh(engines, tmp_path):
    _, _, eng, _ = engines
    path = str(tmp_path / "split.npz")
    eng.save_session(path)
    mesh = cells_mesh(4, ["cpu"] * 4)
    loaded = PlanetEngine.load_session(path, timing=False, mesh=mesh)
    assert loaded._mesh is mesh and loaded.device == torch.device("cpu")
    assert loaded._splits(PARAMS)
    for k in ("pre_post", "r_plate", "elevation_final", "stress"):
        assert torch.equal(loaded._w[k], eng._w[k]), k
    with pytest.raises(ValueError, match="first device"):
        PlanetEngine.load_session(path, device="meta", mesh=mesh)
