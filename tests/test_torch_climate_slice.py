"""The climate slice as a whole: the port's ``PlanetEngine.generate`` of
the canonical 4K planet (seed 123, 12 plates) with climate on, against
the JAX package's pinned c4k_s123 snapshot
(tests/test_reference_parity.py:45-55, 139-142): each of the eight most
common Köppen classes within 0.03 of its pinned share (measured: within
0.0015), and the planet's climate fields finite, with valid Köppen codes
and the reference's debug layers.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp

# tests/test_reference_parity.py:52-53
KOPPEN_TOP = {0: 0.6896, 29: 0.045, 6: 0.0422, 19: 0.0362,
              3: 0.0307, 1: 0.0272, 30: 0.0247, 9: 0.0195}
DEBUG_LAYERS = ("pressureSummer", "pressureWinter", "windSpeedSummer",
                "windSpeedWinter", "continentality", "precipSummer",
                "precipWinter", "rainShadowSummer", "rainShadowWinter",
                "tempSummer", "tempWinter", "koppen")


@pytest.fixture(scope="module")
def generate_c4k_climate():
    import dataclasses

    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    kw = {f.name: getattr(tp.PARAMS, f.name)
          for f in dataclasses.fields(tp.PARAMS)}
    kw["skip_climate"] = None      # 4K ≤ the auto-climate threshold
    return PlanetEngine(device="cpu").generate(GenerationParams(**kw))


@pytest.mark.parametrize("cls", sorted(KOPPEN_TOP))
def test_generate_c4k_koppen_share(generate_c4k_climate, cls):
    res = generate_c4k_climate
    n = res.graph.n_cells
    kop = res.climate["koppen"][:n].numpy()
    assert abs((kop == cls).mean() - KOPPEN_TOP[cls]) < 0.03


def test_generate_c4k_climate_is_whole(generate_c4k_climate):
    from planet_heightmap_generation_torch.climate import KOPPEN_CODES

    res = generate_c4k_climate
    n = res.graph.n_cells
    assert set(res.climate) == {"wind", "ocean", "precip", "temp", "koppen"}
    kop = res.climate["koppen"][:n]
    assert kop.dtype == torch.int32
    assert int(kop.min()) >= 0 and int(kop.max()) < len(KOPPEN_CODES)
    for part in ("wind", "ocean", "precip", "temp"):
        for k, v in res.climate[part].items():
            if torch.is_tensor(v) and v.is_floating_point():
                rows = v[:n] if v.shape[0] == res.graph.n_padded else v
                assert torch.isfinite(rows).all(), (part, k)
    assert all(k in res.debug for k in DEBUG_LAYERS)
    m = tp.snapshot_metrics(res.elevation.numpy(), res.r_plate.numpy(), n)
    assert abs(m["land_fraction"] - tp.SNAPSHOT_C4K["land_fraction"]) < 0.02
    assert np.isfinite(res.elevation.numpy()).all()
