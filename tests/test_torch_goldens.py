"""The reference-transcribed goldens of tests/test_reference_goldens.py,
run through the port: every golden there that names a function the port
has, with the same expected numbers and tolerances, parametrised as
there (the tables of rows are imported from that file, so they are one
source). The planet-code goldens run the reference file's own test bodies
with the port's ``encode_planet_code`` / ``decode_planet_code`` in place
of the JAX package's.

Then the climate structure checks of tests/test_climate.py (wind outputs,
zonal pressure, ocean gyres, precipitation / temperature / Köppen) on
that file's synthetic 4000-cell world, built once for this module and run
through the port's climate stages.
"""

import math

import numpy as np
import pytest
import torch

import torch_parity as tp
import test_reference_goldens as ref

from planet_heightmap_generation_torch.api import planet_code as tcode
from planet_heightmap_generation_torch.climate import (
    KOPPEN_CODES, classify_koppen, compute_ocean_currents,
    compute_precipitation, compute_temperature, compute_wind)

DEG = ref.DEG


def _f32(values):
    return torch.as_tensor(np.asarray(values, np.float32))


# ── Köppen truth table ───────────────────────────────────────────────

def test_koppen_reference_truth_table():
    rows = ref.KOPPEN_ROWS
    got = classify_koppen(_f32([r[1] for r in rows]),
                          _f32([ref._tn(r[2]) for r in rows]),
                          _f32([ref._tn(r[3]) for r in rows]),
                          _f32([ref._pn(r[4]) for r in rows]),
                          _f32([ref._pn(r[5]) for r in rows])).numpy()
    for i, row in enumerate(rows):
        assert got[i] == row[6], (
            f"{row[0]}: got {KOPPEN_CODES[int(got[i])]}, "
            f"expected {KOPPEN_CODES[row[6]]}")


# ── planet codes: the reference bodies with the port's codec ─────────

@pytest.fixture
def port_codec(monkeypatch):
    monkeypatch.setattr(ref, "encode_planet_code", tcode.encode_planet_code)
    monkeypatch.setattr(ref, "decode_planet_code", tcode.decode_planet_code)


def test_planet_code_hand_packed_bigint(port_codec):
    ref.test_planet_code_hand_packed_bigint()


@pytest.mark.parametrize("length,radices,idxs,fields,defaults",
                         ref.LEGACY_CASES,
                         ids=[str(c[0]) for c in ref.LEGACY_CASES])
def test_planet_code_legacy_formats(port_codec, length, radices, idxs,
                                    fields, defaults):
    ref.test_planet_code_legacy_formats(length, radices, idxs, fields,
                                        defaults)


def test_planet_code_rejects_invalid(port_codec):
    ref.test_planet_code_rejects_invalid()


# ── heightmap import curve ───────────────────────────────────────────

def test_import_grayscale_curve_goldens():
    from planet_heightmap_generation_torch.pipeline.engine import (
        grayscale_to_elevation)
    vals = [0.0, 0.5, 1.0, 2.0, 64.5, 128.0, 255.0]
    got = grayscale_to_elevation(_f32(vals)).numpy()
    exp = [(-0.5 if v < 1 else math.sqrt((v - 1) / 254.0)) for v in vals]
    np.testing.assert_allclose(got, exp, atol=1e-6)
    assert got[-1] == pytest.approx(1.0)


# ── wind / climate curves ────────────────────────────────────────────

@pytest.mark.parametrize("land,elev,expect_deg", [
    (0.0, 0.0, 5.0), (1.0, 0.0, 20.0), (0.25, 0.0, 12.5),
    (0.25, 0.5, 10.8125), (1.0, 1.0, 11.0)])
def test_itcz_latitude_formula(land, elev, expect_deg):
    from planet_heightmap_generation_torch.climate.wind import (
        _itcz_latitudes)

    nb = 36 * 72
    cnt = torch.ones(nb)
    for sign in (1.0, -1.0):
        lats = _itcz_latitudes(cnt, torch.full((nb,), land),
                               torch.full((nb,), elev), sign).numpy()
        np.testing.assert_allclose(lats, expect_deg * sign * DEG,
                                   rtol=0, atol=1e-4)


def _spline(ys):
    from planet_heightmap_generation_torch.climate.wind import (
        _build_periodic_spline, spline_to_device)
    return spline_to_device(
        _build_periodic_spline(np.asarray(ys, np.float32)), "cpu")


def test_periodic_spline_matches_reference_solver():
    """The reference solver transcribed in numpy (the reference test's
    own transcription), at knots and midpoints."""
    from planet_heightmap_generation_torch.climate.wind import (
        _ITCZ_LONS, NUM_ITCZ_LON, eval_spline)

    n = NUM_ITCZ_LON
    lons = np.asarray(_ITCZ_LONS, np.float64)
    ys = (12.0 + 4.0 * np.sin(2 * lons) + 2.0 * np.cos(5 * lons)) * DEG
    h = 2 * np.pi / n
    alpha = (3 / h) * (np.roll(ys, -1) - ys) - (3 / h) * (ys - np.roll(ys, 1))
    c = np.zeros(n)
    for _ in range(20):
        for i in range(n):
            c[i] = (alpha[i] - h * c[(i - 1) % n]
                    - h * c[(i + 1) % n]) / (4 * h)
    b = (np.roll(ys, -1) - ys) / h - h * (np.roll(c, -1) + 2 * c) / 3
    d = (np.roll(c, -1) - c) / (3 * h)

    sp = _spline(ys)
    got_knots = eval_spline(sp, _f32(lons)).numpy()
    np.testing.assert_allclose(got_knots, ys, rtol=0, atol=5e-5)
    mid = lons + h / 2
    want_mid = ys + b * (h / 2) + c * (h / 2) ** 2 + d * (h / 2) ** 3
    got_mid = eval_spline(sp, _f32(mid)).numpy()
    np.testing.assert_allclose(got_mid, want_mid, rtol=0, atol=5e-4)


@pytest.mark.parametrize("lat,cont,elev,season,expect", ref.PRESSURE_ROWS)
def test_pressure_field_goldens(lat, cont, elev, season, expect):
    from planet_heightmap_generation_torch.climate.util import geo_frame
    from planet_heightmap_generation_torch.climate.wind import (
        NUM_ITCZ_LON, _pressure_kernel)
    from planet_heightmap_generation_torch.ops.noise import fbm, tables

    is_summer = season == "summer"
    itcz_deg = 5.0 if is_summer else -5.0
    sp = _spline(np.full(NUM_ITCZ_LON, itcz_deg * DEG))
    lat_r, lon_r = lat * DEG, 0.3
    pos = _f32([[math.cos(lat_r) * math.sin(lon_r), math.sin(lat_r),
                 math.cos(lat_r) * math.cos(lon_r)]])
    gf = geo_frame(pos)
    t = tables(3.0)
    p = _pressure_kernel(pos, gf, sp, _f32([cont]), _f32([elev]), t,
                         is_summer)
    noise = fbm(t, pos[:, 0] * 2, pos[:, 1] * 2, pos[:, 2] * 2, 3) * 2
    got = float(p[0] - noise[0])
    assert abs(got - expect) < 5e-3, (got, expect)


def test_zonal_base_curve_goldens():
    from planet_heightmap_generation_torch.climate.heuristic_precip import (
        zonal_base)

    got = zonal_base(_f32([r[0] for r in ref.ZONAL_ROWS])).numpy()
    want = np.asarray([r[1] for r in ref.ZONAL_ROWS], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ── elevation / erosion formulas ─────────────────────────────────────

def test_base_blend_goldens():
    from planet_heightmap_generation_torch.elevation.assemble import (
        base_blend)

    inf = np.inf
    rows = [
        (2.0, 8.0, 4.0, 0.5, 0.25707858979018045),
        (2.0, 8.0, 4.0, 0.9, 0.20196767871332036),
        (2.0, 8.0, 4.0, 0.1, 0.3297014360208033),
        (inf, 3.0, 5.0, 0.5, -0.3749812546863284),
        (3.0, inf, 5.0, 0.5, 0.3749812546863284),
        (inf, inf, 5.0, 0.5, 0.06),
    ]
    dm, do, dc, sf, want = (np.array(c, np.float32) for c in zip(*rows))
    got = base_blend(_f32(dm), _f32(do), _f32(dc), _f32(sf)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_ocean_floor_profile_goldens():
    from planet_heightmap_generation_torch.elevation.assemble import (
        ocean_floor_profile)

    rows = [(0.0, 0.02, -0.04), (2.5, 0.02, -0.07), (4.999, 0.02, -0.099988),
            (5.0, 0.02, -0.10), (8.5, 0.02, -0.225), (12.0, 0.02, -0.33),
            (100.0, -0.01, -0.36)]
    dc, nz, want = (np.array(c, np.float32) for c in zip(*rows))
    got = ocean_floor_profile(_f32(dc), _f32(nz)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def _chain_graph():
    """2 → 1 → 0 → ocean(3), in receiver arrays (-1: none)."""
    return (_f32([0.1, 0.3, 0.6, -0.2]), torch.tensor([0, 0, 0, 1]).bool(),
            torch.ones(4, dtype=torch.bool), torch.tensor([3, 0, 1, -1]),
            torch.ones(4), torch.zeros(4, dtype=torch.bool))


def test_flow_accumulation_chain_golden():
    from planet_heightmap_generation_torch.erosion.fluvial import (
        flow_accumulation)

    _, is_ocean, valid, rcv, _, is_pit = _chain_graph()
    flow = flow_accumulation((~is_ocean) & valid, rcv, is_pit).numpy()
    np.testing.assert_array_equal(flow, [3.0, 2.0, 1.0, 3.0])


def test_stream_power_chain_golden():
    from planet_heightmap_generation_torch.erosion.fluvial import (
        stream_power_solve)

    elev, is_ocean, valid, rcv, dist, is_pit = _chain_graph()
    got = stream_power_solve(elev, is_ocean, valid, rcv, dist, is_pit,
                             _f32([3.0, 2.0, 1.0, 0.0]), k_coeff=0.1,
                             m_exp=0.5, dt=1.0).numpy()
    np.testing.assert_allclose(
        got, [0.08610834, 0.27482338, 0.57030827, -0.2], atol=3e-5)


def _line_graph(n=8):
    """1-D line mesh (i ↔ i±1) in banded form, band_off=(-1, +1), with no
    remainder edges (the port keeps only real ones)."""
    band_mask = torch.zeros((n, 2), dtype=torch.bool)
    band_mask[1:, 0] = True
    band_mask[:-1, 1] = True
    none = torch.zeros(0, dtype=torch.int64)
    return ((-1, 1), band_mask, band_mask.float(), none, none,
            torch.zeros(0))


def test_thermal_talus_goldens():
    from planet_heightmap_generation_torch.erosion.thermal import (
        thermal_step)

    band_off, band_mask, band_dist, rem_src, rem_dst, rem_dist = \
        _line_graph()
    n = 8
    valid = torch.ones(n, dtype=torch.bool)
    no_ocean = torch.zeros(n, dtype=torch.bool)
    elev = np.zeros(n, np.float32)
    elev[1] = 0.5

    def run(e, is_ocean):
        return thermal_step(_f32(e), is_ocean, valid, band_off, band_mask,
                            band_dist, rem_src, rem_dst, rem_dist,
                            torch.tensor(0.3), torch.tensor(0.5)).numpy()

    want = np.zeros(n, np.float32)
    want[0], want[1], want[2] = 0.05, 0.4, 0.05
    np.testing.assert_allclose(run(elev, no_ocean), want, atol=1e-6)
    is_ocean = no_ocean.clone()
    is_ocean[0] = True
    want = np.zeros(n, np.float32)
    want[1], want[2] = 0.45, 0.05
    np.testing.assert_allclose(run(elev, is_ocean), want, atol=1e-6)
    gentle = np.linspace(0.0, 0.2, n).astype(np.float32)
    np.testing.assert_allclose(run(gentle, no_ocean), gentle, atol=1e-7)


def test_smooth_elevation_goldens():
    from planet_heightmap_generation_torch.erosion.smooth import (
        smooth_elevation)

    band_off, band_mask, _, rem_src, rem_dst, _ = _line_graph()
    n = 8
    valid = torch.ones(n, dtype=torch.bool)
    elev = np.zeros(n, np.float32)
    elev[1] = 0.5
    got = smooth_elevation(_f32(elev), torch.zeros(n, dtype=torch.bool),
                           valid, band_off, band_mask, rem_src, rem_dst, 1,
                           torch.tensor(0.4)).numpy()
    want = np.zeros(n, np.float32)
    want[0], want[1], want[2] = 0.2, 0.3, (0.1 / 1.2) * 0.4
    np.testing.assert_allclose(got, want, atol=1e-6)

    elev2 = np.zeros(n, np.float32)
    elev2[0], elev2[1] = -0.1, 0.5
    is_ocean = torch.zeros(n, dtype=torch.bool)
    is_ocean[0] = True
    got = smooth_elevation(_f32(elev2), is_ocean, valid, band_off,
                           band_mask, rem_src, rem_dst, 1,
                           torch.tensor(0.4)).numpy()
    want = np.zeros(n, np.float32)
    want[0] = -0.1 + (0.5 - (-0.1)) * 0.4
    want[1] = 0.5
    want[2] = (0.1 / 1.2) * 0.4
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharpen_ridges_goldens():
    from planet_heightmap_generation_torch.erosion.smooth import (
        sharpen_ridges)

    band_off, band_mask, _, rem_src, rem_dst, _ = _line_graph()
    n = 8
    valid = torch.ones(n, dtype=torch.bool)
    elev = np.zeros(n, np.float32)
    elev[1] = 0.5

    def run(strength):
        return sharpen_ridges(_f32(elev), torch.zeros(n, dtype=torch.bool),
                              valid, band_off, band_mask, rem_src, rem_dst,
                              1, torch.tensor(strength)).numpy()

    want = np.zeros(n, np.float32)
    want[1] = 0.75
    np.testing.assert_allclose(run(0.5), want, atol=1e-6)
    assert abs(float(run(0.8)[1]) - 0.75) < 1e-6


def test_soil_creep_goldens():
    from planet_heightmap_generation_torch.erosion.smooth import (
        apply_soil_creep)

    band_off, band_mask, _, rem_src, rem_dst, _ = _line_graph()
    n = 8
    valid = torch.ones(n, dtype=torch.bool)
    elev = np.zeros(n, np.float32)
    elev[0], elev[1] = -0.1, 0.5
    is_ocean = torch.zeros(n, dtype=torch.bool)
    is_ocean[0] = True
    got = apply_soil_creep(_f32(elev), is_ocean, valid, band_off, band_mask,
                           rem_src, rem_dst, 1,
                           torch.tensor(0.1125)).numpy()
    want = elev.copy()
    want[2] = 0.0 + (0.25 - 0.0) * 0.1125
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_glaciation_index_goldens():
    from planet_heightmap_generation_torch.erosion.glacial import (
        glaciation_index)

    s60, s80 = math.sin(math.pi / 3), math.sin(80 * math.pi / 180)
    rows = [(1.0, 0.3, 1.0, False, 1.0), (s60, 0.7, 1.0, False, 0.15625),
            (0.0, 1.0, 1.0, False, 0.09), (s80, 0.2, 0.5, False, 0.25),
            (0.5, 0.6, 0.8, False, 0.01398), (1.0, 0.3, 1.0, True, 0.0)]
    y = np.array([r[0] for r in rows], np.float32)
    pos = np.stack([np.sqrt(np.maximum(0, 1 - y * y)), y,
                    np.zeros_like(y)], axis=1)
    elev = _f32([r[1] for r in rows])
    oc = torch.tensor([r[3] for r in rows])
    valid = torch.ones(len(rows), dtype=torch.bool)
    for s in sorted({r[2] for r in rows}):
        got = glaciation_index(_f32(pos), elev, oc, valid,
                               torch.tensor(s, dtype=torch.float32)).numpy()
        for i in [i for i, r in enumerate(rows) if r[2] == s]:
            assert abs(got[i] - rows[i][4]) < 2e-6, (i, got[i], rows[i][4])


def test_temperature_kernel_goldens():
    from planet_heightmap_generation_torch.climate.temperature import (
        _temperature_kernel)

    summer_rows = [
        (0.0, -0.5, False, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 28.0),
        (0.0, -0.5, False, 0.0, 0.0, 1.0, 0.25, 0.5, 0.0, 0.0, 32.0),
        (0.0, 0.5, True, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 20.69425),
        (45.0, 0.0, True, 1.0, 0.0, 0.0, 0.0, 0.4, 0.0, 0.0, 26.83531),
        (-65.0, 0.0, True, 1.0, 0.0, 0.0, 0.0, 0.4, 0.0, 0.0, -15.38977),
        (0.0, -0.5, False, 0.0, 0.0, 0.0, 0.0, 0.9, 0.0, 0.0, 26.11840),
        (30.0, 0.1, True, 0.2, 0.3, 0.0, 0.0, 0.5, 0.8, 0.0, 33.33431),
        (0.0, -0.5, False, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 3.0, 31.0),
    ]
    winter_rows = [
        (60.0, -0.5, False, 0.0, 0.0, 0.0, 0.0, 0.4, 0.0, 0.0, -2.01176),
    ]
    for rows, is_summer in ((summer_rows, True), (winter_rows, False)):
        col = [_f32([r[k] for r in rows]) for k in range(11)]
        got = _temperature_kernel(
            col[0] * DEG, torch.zeros(len(rows)), col[1],
            torch.tensor([r[2] for r in rows]), col[3], col[4],
            torch.zeros(72), col[5], col[6], col[7], col[8], col[9],
            is_summer=is_summer).numpy()
        np.testing.assert_allclose(got, [r[10] for r in rows], atol=2e-3)


def test_stress_propagation_goldens():
    from planet_heightmap_generation_torch.ops.banded import (
        band_gate, propagate_stress_banded, rem_gate_eq)

    band_off, band_mask, _, rem_src, rem_dst, _ = _line_graph()
    n = 8

    def run(stress0, sf0, r_plate, plate_ocean, decay, sub, passes):
        rp = torch.as_tensor(np.asarray(r_plate, np.int32))
        gate = band_gate(rp, band_off, band_mask)
        rgate = rem_gate_eq(rp, rem_src, rem_dst)
        oc = torch.as_tensor(np.asarray(plate_ocean))[rp.long()]
        st, sf = propagate_stress_banded(
            _f32(stress0)[:, None], _f32(sf0)[:, None], (gate,),
            rgate[:, None], oc[:, None], band_off, band_mask, rem_src,
            rem_dst, decay, sub, passes)
        return st[:, 0].numpy(), sf[:, 0].numpy()

    one_plate = np.zeros(n, np.int32)
    s0 = np.zeros(n, np.float32)
    s0[0] = 1.0
    f0 = np.full(n, 0.2, np.float32)
    f0[0] = 0.6
    st, sf = run(s0, f0, one_plate, [False], 0.8, 0.5, 4)
    np.testing.assert_allclose(
        st, [1.0, 0.5, 0.25, 0.125, 0.0625, 0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(sf[:5], [0.6] * 5, atol=1e-6)
    np.testing.assert_allclose(sf[5:], [0.2] * 3, atol=1e-6)

    f0 = np.full(n, 0.2, np.float32)
    st, _ = run(s0, f0, one_plate, [False], 0.8, 0.5, 3)
    np.testing.assert_allclose(
        st, [1.0, 0.8, 0.64, 0.512, 0, 0, 0, 0], atol=1e-6)

    s0 = np.zeros(n, np.float32)
    s0[0] = 0.011
    st, _ = run(s0, f0, one_plate, [False], 0.4, 0.2, 3)
    np.testing.assert_allclose(st, s0, atol=1e-7)
    st, _ = run(s0, f0, one_plate, [False], 0.5, 0.2, 3)
    assert abs(st[1] - 0.0055) < 1e-6

    s0 = np.zeros(n, np.float32)
    s0[0] = 1.0
    st, _ = run(s0, f0, one_plate, [True], 0.8, 0.5, 4)
    np.testing.assert_allclose(st, s0, atol=1e-7)

    rp = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int32)
    s0 = np.zeros(n, np.float32)
    s0[3] = 1.0
    st, _ = run(s0, f0, rp, [False, False], 0.8, 0.5, 5)
    np.testing.assert_allclose(
        st, [0.512, 0.64, 0.8, 1.0, 0, 0, 0, 0], atol=1e-6)


def test_pressure_to_wind_goldens():
    from planet_heightmap_generation_torch.climate.wind import (
        _pressure_to_wind)

    sin5 = math.sin(5 * math.pi / 180)
    rows = [
        (0.0, 0.6 * math.cos(20 * DEG), 0.6 * math.sin(20 * DEG)),
        (0.5, 0.6 * math.cos(50 * DEG), -0.6 * math.sin(50 * DEG)),
        (-0.5, 0.6 * math.cos(50 * DEG), 0.6 * math.sin(50 * DEG)),
        (sin5 * 0.5, 0.6 * math.cos(15 * DEG), -0.6 * math.sin(15 * DEG)),
    ]
    we, wn, speed = _pressure_to_wind(torch.full((len(rows),), -1.0),
                                      torch.zeros(len(rows)),
                                      _f32([r[0] for r in rows]))
    np.testing.assert_allclose(we.numpy(), [r[1] for r in rows], atol=2e-6)
    np.testing.assert_allclose(wn.numpy(), [r[2] for r in rows], atol=2e-6)
    np.testing.assert_allclose(speed.numpy(), [0.6] * len(rows), atol=2e-6)


def test_heuristic_wind_belt_goldens():
    from planet_heightmap_generation_torch.climate.heuristic_precip import (
        heuristic_wind)

    rows = [
        (0.0, 1.0, 0.0, -0.1), (3.0, -1.0, 0.0, 0.1),
        (10.0, 1.0, -0.4, -0.15), (18.0, 1.0, -0.8, -0.3),
        (28.0, 1.0, -0.48513, -0.18192), (35.0, 1.0, 0.45, 0.125),
        (47.5, 1.0, 0.9, 0.25), (47.5, -1.0, 0.9, -0.25),
        (65.0, 1.0, -0.2, -0.075), (75.0, 1.0, -0.4, -0.15),
    ]
    we, wn = heuristic_wind(_f32([r[0] for r in rows]),
                            _f32([r[1] for r in rows]))
    np.testing.assert_allclose(we.numpy(), [r[2] for r in rows], atol=2e-5)
    np.testing.assert_allclose(wn.numpy(), [r[3] for r in rows], atol=2e-5)


# ── tests/test_climate.py's structure checks on its synthetic world ───

@pytest.fixture(scope="module")
def world():
    """tests/test_climate.py's world (one continent blob and a tilted
    terrain on the 4000-cell jitter-0.5 mesh of seed 9, two plates that
    mirror land), as port tensors, with the port's wind."""
    from planet_heightmap_generation_tpu.mesh import build_sphere
    from planet_heightmap_generation_tpu.ops.noise import SimplexNoise
    from planet_heightmap_generation_torch import interop
    from planet_heightmap_generation_torch.ops.noise import tables

    mesh = build_sphere(4000, 0.5, seed=9.0)
    g = interop.state_from_numpy(tp.mesh_fields(mesh))["g"]
    pos = mesh.pos
    e = np.asarray(SimplexNoise(9.0).fbm(pos[:, 0] * 1.5, pos[:, 1] * 1.5,
                                         pos[:, 2] * 1.5)) * 0.8
    e = np.where(mesh.valid, e - 0.15, 0.0).astype(np.float32)
    elev = torch.as_tensor(e)
    r_plate = torch.as_tensor((e > 0).astype(np.int32))
    plate_is_ocean = torch.tensor([True, False])
    wind = compute_wind(g, elev, plate_is_ocean, r_plate, tables(9.0))
    return mesh, g, elev, wind


@pytest.fixture(scope="module")
def ocean(world):
    _, g, elev, wind = world
    return compute_ocean_currents(g, elev, wind)


def _n(x, n):
    return x.numpy()[:n]


def test_wind_outputs(world):
    mesh, _, _, wind = world
    n = mesh.n_cells
    for k in ("r_pressure_summer", "r_wind_east_summer",
              "r_wind_speed_winter", "r_continentality", "itcz_lats_summer"):
        assert k in wind
    sp = _n(wind["r_wind_speed_summer"], n)
    assert (sp >= 0).all() and (sp <= 1 + 1e-6).all()
    lats = np.degrees(wind["itcz_lats_summer"].numpy())
    assert (lats >= 4.9).all() and (lats <= 20.1).all()
    lats_w = np.degrees(wind["itcz_lats_winter"].numpy())
    assert (lats_w <= -4.9).all() and (lats_w >= -20.1).all()
    cont = _n(wind["r_continentality"], n)
    land = _n(wind["r_is_land"], n)
    assert cont[land].mean() > cont[~land].mean()


def test_pressure_has_zonal_structure(world):
    mesh, _, _, wind = world
    n = mesh.n_cells
    lat = np.degrees(_n(wind["r_lat"], n))
    p = _n(wind["r_pressure_summer"], n)
    subtrop = p[(np.abs(lat) > 25) & (np.abs(lat) < 40)].mean()
    subpolar = p[(np.abs(lat) > 55) & (np.abs(lat) < 65)].mean()
    assert subtrop > subpolar


def test_ocean_currents(world, ocean):
    mesh, _, _, wind = world
    n = mesh.n_cells
    ce = _n(ocean["r_ocean_current_east_summer"], n)
    land = _n(wind["r_is_land"], n)
    assert (ce[land] == 0).all()
    assert np.abs(ce[~land]).max() > 0
    w = _n(ocean["r_ocean_warmth_summer"], n)
    assert (w >= -1).all() and (w <= 1).all()
    lat = np.degrees(_n(wind["r_lat"], n))
    mask = (~land) & (np.abs(lat) > 10) & (np.abs(lat) < 25)
    if mask.sum() > 30:
        assert ce[mask].mean() < 0


def test_precip_temp_koppen(world, ocean):
    mesh, g, elev, wind = world
    n = mesh.n_cells
    precip = compute_precipitation(g, elev, wind, ocean)
    for season in ("summer", "winter"):
        p = _n(precip[f"r_precip_{season}"], n)
        assert (p >= 0).all() and (p <= 1 + 1e-6).all()
        assert p.std() > 0.05

    temp = compute_temperature(g, elev, wind, ocean, precip)
    t = _n(temp["r_temperature_summer"], n)
    assert (t >= 0).all() and (t <= 1).all()
    lat = _n(wind["r_lat"], n)
    assert t[np.abs(lat) < 0.3].mean() > t[np.abs(lat) > 1.2].mean() + 0.1

    kop = _n(classify_koppen(
        elev, temp["r_temperature_summer"], temp["r_temperature_winter"],
        precip["r_precip_summer"], precip["r_precip_winter"]), n)
    assert (kop >= 0).all() and (kop < len(KOPPEN_CODES)).all()
    land = _n(wind["r_is_land"], n)
    assert (kop[~land] == 0).all()
    assert (kop[land] != 0).all()
    assert len(np.unique(kop[land])) >= 5
