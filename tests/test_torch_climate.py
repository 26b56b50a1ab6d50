"""The climate stack of the port against the JAX package's, stage by
stage, on the canonical 4K planet (seed 123, 12 plates).

Both packages get identical inputs: the final elevation of the planet
(the port's terrain on the JAX plate map, tests/torch_parity.py), the JAX
plate map, the plate types and the seed's climate noise table, carried
across with ``interop.state_from_numpy``; each later stage gets the JAX
output of the stages before it. Contracts, with their reasons (measured
on this planet in brackets):

- coast fields: the seeds, barriers and the five hop-capped BFS distances
  EXACT (integer hops through the BFS kernel, components, order-free
  min).
- wind: geographic frame, continentality and ITCZ latitudes within 1e-6
  (1.2e-7); pressure within 1e-3 hPa of ~1013 hPa (1.8e-4: three f32
  ULPs at 1013); wind vectors within 2e-3 of the field's
  largest magnitude (6.1e-4) and speed within 5e-3 (1.2e-3). The JAX
  gradient takes differences of neighbour sums of p·f with f ≈ 1013 hPa,
  so a few ULPs of pressure become 1e-3-level relative differences in
  its gradient: the f32 conditioning of the reference formula, kept term
  for term by the port.
- ocean currents and warmth: all cells within 1e-5 (8.6e-7).
- precipitation: ≥ 99 % of cells within 1e-5 and all within 1e-3
  (99.7 %, 8.6e-5: where the two libraries round differently, the
  difference is carried through the advection hops and the smoothing
  passes); rain shadow within 1e-5 (1.2e-7).
- temperature: within 1e-5 (1.2e-7).
- Köppen on the JAX temperature and precipitation: ≥ 99 % of cells in the
  same class (100 %).
- the port's whole climate stack from the same elevation against the
  JAX stack: Köppen ≥ 99 % of cells in the same class (99.75 %),
  temperatures within 1e-3 on ≥ 99 % of cells (99.55 % summer, 100 %
  winter): the wind differences above carry through into the rain shadow
  and precipitation of a few cells.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp

STAGES = ("coast", "wind", "ocean", "precip", "temp")


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def jax_stack():
    """The JAX climate stages on the shared elevation, one by one."""
    import planet_heightmap_generation_tpu.climate as jc
    from planet_heightmap_generation_tpu.climate.wind import (
        climate_coast_fields, coast_bfs_seeds)

    s, _ = tp.setup()
    g = s.g
    elev = jnp.asarray(tp.final_elevation())
    rp = jnp.asarray(tp.plates_jax()[1])
    po = s.args[2][0]
    out = {}
    out["seeds"] = coast_bfs_seeds(g, elev, po, rp)[:2]
    d5, aux = climate_coast_fields(g, elev, po, rp)
    out["coast"] = dict(d5=d5)
    out["wind"] = jc.compute_wind(g, elev, po, rp, s.args[7],
                                  coast_d=d5[:, :2], gf=aux["gf"],
                                  is_land=aux["is_land"],
                                  plate_land=aux["plate_land"])
    out["ocean"] = jc.compute_ocean_currents(g, elev, out["wind"],
                                             coast_d=d5[:, 2:])
    out["precip"] = jc.compute_precipitation(g, elev, out["wind"],
                                             out["ocean"], 0.0, 0.3)
    out["temp"] = jc.compute_temperature(g, elev, out["wind"], out["ocean"],
                                         out["precip"], 0.0)
    out["koppen"] = jc.classify_koppen(
        elev, out["temp"]["r_temperature_summer"],
        out["temp"]["r_temperature_winter"],
        out["precip"]["r_precip_summer"], out["precip"]["r_precip_winter"])
    return {k: ({f: np.asarray(x) for f, x in v.items()}
                if isinstance(v, dict) else
                tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in out.items()}


def _port_stage(stage, ref):
    """The port's stage ``stage`` on the shared inputs and the JAX outputs
    of the stages before it."""
    import planet_heightmap_generation_torch.climate as pc
    from planet_heightmap_generation_torch.climate.wind import (
        climate_coast_fields, geo_frame)

    s, st = tp.setup()
    g = st["g"]
    elev = torch.as_tensor(tp.final_elevation())
    rp = _t(tp.plates_jax()[1])
    po = st["plates"][0]
    prev = {k: {f: _t(x) for f, x in ref[k].items()}
            for k in ("coast", "wind", "ocean", "precip", "temp")}
    if stage == "coast":
        return dict(d5=climate_coast_fields(g, elev, po, rp)[0])
    if stage == "wind":
        d5 = prev["coast"]["d5"]
        return pc.compute_wind(g, elev, po, rp, st["noise"]["climate"],
                               coast_d=d5[:, :2], gf=geo_frame(g.pos),
                               is_land=(elev > 0) & g.valid,
                               plate_land=(~po[rp.long()]) & g.valid)
    if stage == "ocean":
        return pc.compute_ocean_currents(g, elev, prev["wind"],
                                         coast_d=prev["coast"]["d5"][:, 2:])
    if stage == "precip":
        return pc.compute_precipitation(g, elev, prev["wind"], prev["ocean"],
                                        0.0, 0.3)
    return pc.compute_temperature(g, elev, prev["wind"], prev["ocean"],
                                  prev["precip"], 0.0)


def _close(a, b, atol, share=1.0):
    """≥ ``share`` of the valid cells within 1e-5 and all within ``atol``
    (finite where the reference is finite, inf where it is inf)."""
    valid = tp.setup()[0].graph.valid
    a, b = np.asarray(a), b.numpy()
    if a.shape[0] == valid.shape[0]:
        a, b = a[valid], b[valid]
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    d = np.abs(a[fin] - b[fin])
    assert d.max(initial=0.0) <= atol, d.max()
    assert (d < 1e-5).mean() >= share, (d < 1e-5).mean()


@pytest.mark.parametrize("stage", STAGES)
def test_climate_stage(jax_stack, stage):
    got = _port_stage(stage, jax_stack)
    ref = jax_stack[stage]
    assert set(got) == set(ref)
    for k, b in got.items():
        a = ref[k]
        assert b.shape == a.shape, k
        if b.dtype == torch.bool or k in ("d5", "r_coast_dist_land"):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
        elif stage == "wind" and k.startswith("r_pressure"):
            _close(a, b, 1e-3, share=0.9)
        elif stage == "wind" and k.startswith(("r_wind_east",
                                               "r_wind_north")):
            _close(a, b, 2e-3 * np.abs(a).max(), share=0.0)
        elif stage == "wind" and k.startswith("r_wind_speed"):
            _close(a, b, 5e-3, share=0.0)
        elif stage == "precip" and k.startswith("r_precip"):
            _close(a, b, 1e-3, share=0.99)
        else:
            _close(a, b, 1e-5 if stage != "wind" else 1e-6)


def test_coast_seeds_exact(jax_stack):
    from planet_heightmap_generation_torch.climate.wind import (
        coast_bfs_seeds)

    _, st = tp.setup()
    elev = torch.as_tensor(tp.final_elevation())
    seeds, barriers, _ = coast_bfs_seeds(st["g"], elev, st["plates"][0],
                                         _t(tp.plates_jax()[1]))
    np.testing.assert_array_equal(jax_stack["seeds"][0], seeds.numpy())
    np.testing.assert_array_equal(jax_stack["seeds"][1], barriers.numpy())
    assert seeds.any(0).all()


def test_koppen_on_jax_inputs(jax_stack):
    from planet_heightmap_generation_torch.climate import classify_koppen

    elev = torch.as_tensor(tp.final_elevation())
    t, p = jax_stack["temp"], jax_stack["precip"]
    k = classify_koppen(elev, _t(t["r_temperature_summer"]),
                        _t(t["r_temperature_winter"]),
                        _t(p["r_precip_summer"]), _t(p["r_precip_winter"]))
    assert k.dtype == torch.int32
    valid = tp.setup()[0].graph.valid
    assert (k.numpy() == jax_stack["koppen"])[valid].mean() >= 0.99


def test_climate_chain_koppen(jax_stack):
    """The port's whole climate stack (engine.climate_stack) from the same
    elevation, against the JAX stage chain."""
    from planet_heightmap_generation_torch.pipeline.engine import (
        climate_stack)
    from planet_heightmap_generation_torch.pipeline.timing import StageTimer

    _, st = tp.setup()
    debug = {}
    clim = climate_stack(st["g"], torch.as_tensor(tp.final_elevation()),
                         st["plates"][0], _t(tp.plates_jax()[1]),
                         st["noise"]["climate"], tp.PARAMS,
                         StageTimer(sync_enabled=False), debug)
    valid = tp.setup()[0].graph.valid
    agree = (clim["koppen"].numpy() == jax_stack["koppen"])[valid].mean()
    assert agree >= 0.99, agree
    for season in ("summer", "winter"):
        k = f"r_temperature_{season}"
        d = np.abs(clim["temp"][k].numpy() - jax_stack["temp"][k])[valid]
        assert (d < 1e-3).mean() >= 0.99, (d < 1e-3).mean()
    assert debug["koppen"] is clim["koppen"]
