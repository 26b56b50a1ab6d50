"""Wind simulation — ITCZ-tracking seasonal pressure fields and wind
vectors; the JAX package's climate/wind.py in torch.

- The ITCZ is sampled from per-cell aggregates scattered into 36×72
  lat/lon bins; the 288 circular samples reduce over that small grid.
- The periodic cubic spline through the 72 ITCZ latitudes is solved by the
  reference's 20-sweep Gauss-Seidel relaxation (js/wind.js:12-71). That is
  1,440 dependent scalar updates: on the card each would be a launch, so
  the port solves it on the host in float32, in the same update order, as
  an explicit host step (its own span, "Wind: ITCZ spline on the host"),
  and evaluates the spline per cell on the device.
- Continentality comes from the main-ocean coast BFS (the shared distance
  BFS kernel) through a smoothstep over 2000 km; pressure, least-squares
  gradients and the geostrophic / friction rotation are per-cell maps.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..mesh.device import DeviceGraph
from ..ops.noise import Tables, fbm
from ..ops.banded import (bfs_hops_multi_banded, smooth_field_banded,
                          banded_sum, compute_gradients_banded, dot3,
                          ordered_index_sum)
from ..erosion.flood import open_ocean_mask, connected_components_banded
from ..parallel import spmd
from ..pipeline.timing import span
from .util import (GeoFrame, geo_frame, smoothstep, percentile95,
                   elev_to_height_km)

DEG = math.pi / 180.0
LAT_BINS, LON_BINS = 36, 72
NUM_ITCZ_LON = 72

_ITCZ_LONS = (-np.pi + (np.arange(NUM_ITCZ_LON) + 0.5)
              * (2 * np.pi / NUM_ITCZ_LON)).astype(np.float32)
_SAMPLE_DEGS = np.array([5.0, 10.0, 15.0, 20.0], np.float32)


def _bin_aggregates(lat, lon, elev, is_land, valid):
    """Scatter per-cell land/elev into the 36×72 geo bins
    (js/wind.js:88-118), each bin's cells added in cell order
    (ops.banded.ordered_index_sum; padding goes to a dropped slot).
    Returns (count, land count, elevation sum)."""
    bi = torch.clamp(((lat + math.pi / 2) / math.pi * LAT_BINS)
                     .to(torch.int64), 0, LAT_BINS - 1)
    bj = torch.clamp(((lon + math.pi) / (2 * math.pi) * LON_BINS)
                     .to(torch.int64), 0, LON_BINS - 1)
    b = torch.where(valid, bi * LON_BINS + bj, LAT_BINS * LON_BINS)
    nb = LAT_BINS * LON_BINS
    vals = torch.stack([torch.ones_like(lat), is_land.to(torch.float32),
                        torch.clamp(elev, min=0.0)], 1)
    s = ordered_index_sum(nb, b, vals)
    return s[:, 0], s[:, 1], s[:, 2]


def _elev_to_km_vec(e):
    t = torch.clamp(e, max=1.0)
    t2 = t * t      # t**4 as XLA's integer power evaluates it
    return torch.where(e <= 0, e * 10.0, 6 * (t2 * t2) * (5 - 4 * t))


def _itcz_latitudes(cnt, land, esum, season_sign: float):
    """ITCZ latitude per longitude (js/wind.js:174-232): the 72×4 sample
    circles reduce over the [36,72] bin grid with a broadcast mask."""
    dev = cnt.device
    cnt2 = cnt.reshape(LAT_BINS, LON_BINS)
    land2 = land.reshape(LAT_BINS, LON_BINS)
    esum2 = esum.reshape(LAT_BINS, LON_BINS)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    lat_c = t((np.arange(LAT_BINS) + 0.5) / LAT_BINS * np.pi - np.pi / 2)
    lon_c = t((np.arange(LON_BINS) + 0.5) / LON_BINS * 2 * np.pi - np.pi)
    lat_s = t(_SAMPLE_DEGS * season_sign * DEG)[:, None, None, None]
    lon_s = t(_ITCZ_LONS)[None, :, None, None]
    cos_d = (torch.sin(lat_s) * torch.sin(lat_c)[None, None, :, None]
             + torch.cos(lat_s) * torch.cos(lat_c)[None, None, :, None]
             * torch.cos(lon_c[None, None, None, :] - lon_s))
    sel = (cos_d >= math.cos(20 * DEG)).to(torch.float32)   # [4,72,36,72]

    tot = (sel * cnt2).sum((2, 3))
    lnd = (sel * land2).sum((2, 3))
    elv = (sel * esum2).sum((2, 3))
    lf = torch.where(tot > 0, lnd / torch.clamp(tot, min=1.0), 0.0)
    ae = torch.where(tot > 0, elv / torch.clamp(tot, min=1.0), 0.0)
    avg_land = lf.mean(0)
    avg_elev = ae.mean(0)

    land_pull = torch.clamp(avg_land * 2, max=1.0)
    itcz_deg = 5 + land_pull * 15 - _elev_to_km_vec(avg_elev) * 1.5
    lats = torch.clamp(itcz_deg, 5.0, 20.0) * season_sign * DEG

    # 3-pass periodic [0.25, 0.5, 0.25] smoothing + re-clamp
    # (js/wind.js:212-228)
    for _ in range(3):
        lats = (0.25 * torch.roll(lats, 1) + 0.5 * lats
                + 0.25 * torch.roll(lats, -1))
    lo = (5 if season_sign > 0 else -20) * DEG
    hi = (20 if season_sign > 0 else -5) * DEG
    return torch.clamp(lats, lo, hi)


def _build_periodic_spline(ys: np.ndarray):
    """Periodic cubic spline with the reference's 20-sweep Gauss-Seidel
    relaxation solve (js/wind.js:12-53), uniform knots, on the HOST in
    float32: the 72-knot solve is 1,440 dependent scalar updates, which as
    device work would be as many tiny launches. Every operation is an f32
    operation in the order of the JAX package's device loop. Returns
    (x0, h, ys, b, c, d) as numpy f32 for :func:`spline_to_device`."""
    n = NUM_ITCZ_LON
    f32 = np.float32
    h = f32(2 * np.pi / n)
    ys = np.asarray(ys, f32)
    k3 = f32(3) / h
    alpha = k3 * (np.roll(ys, -1) - ys) - k3 * (ys - np.roll(ys, 1))
    four_h = f32(4) * h
    c = [f32(0)] * n
    for _ in range(20):
        for i in range(n):
            c[i] = (alpha[i] - h * c[(i - 1) % n] - h * c[(i + 1) % n]) \
                / four_h
    c = np.asarray(c, f32)
    b = (np.roll(ys, -1) - ys) / h - h * (np.roll(c, -1) + f32(2) * c) / f32(3)
    d = (np.roll(c, -1) - c) / (f32(3) * h)
    return (f32(_ITCZ_LONS[0]), h, ys, b.astype(f32), c, d.astype(f32))


def spline_to_device(spline, device):
    x0, h, ys, b, c, d = spline
    return (float(x0), float(h)) + tuple(
        torch.as_tensor(a, device=device) for a in (ys, b, c, d))


def eval_spline(spline_arrs, lon):
    """Spline evaluation with uniform segments (js/wind.js:55-71)."""
    x0, h, ys, b, c, d = spline_arrs
    n = ys.shape[0]
    period = 2 * math.pi
    t = torch.remainder(torch.remainder(lon - x0, period) + period, period)
    seg = torch.clamp((t / h).to(torch.int64), 0, n - 1)
    dx = t - seg.to(torch.float32) * h
    return (ys[seg] + b[seg] * dx + c[seg] * dx * dx
            + d[seg] * dx * dx * dx)


def _pressure_kernel(pos, gf: GeoFrame, spline_arrs, continentality, elev,
                     noise_t: Tables, is_summer: bool):
    """Per-cell pressure (js/wind.js:239-301)."""
    lat, lon = gf.lat, gf.lon
    itcz_lat = eval_spline(spline_arrs, lon)
    lat_deg = lat / DEG
    season_sign = 1.0 if is_summer else -1.0

    p = 1013.0
    d_itcz = (lat - itcz_lat) / DEG
    p = p - 15 * torch.exp(-0.5 * (d_itcz / 8) ** 2)

    shift = season_sign * 5
    high_i = 12 * (1 - 0.3 * continentality)
    p = p + high_i * torch.exp(-0.5 * ((lat_deg - (30 + shift)) / 10) ** 2)
    p = p + high_i * torch.exp(-0.5 * ((lat_deg + (30 - shift)) / 10) ** 2)
    p = p - 10 * torch.exp(-0.5 * ((lat_deg - 60) / 10) ** 2)
    p = p - 10 * torch.exp(-0.5 * ((lat_deg + 60) / 10) ** 2)
    p = p + 8 * torch.exp(-0.5 * ((lat_deg - 85) / 8) ** 2)
    p = p + 8 * torch.exp(-0.5 * ((lat_deg + 85) / 8) ** 2)

    # continental thermal modifier (js/wind.js:267-289)
    cont_scale = smoothstep(0.2, 0.5, continentality)
    abs_lat = torch.abs(lat) / DEG
    lat_factor = torch.where(
        abs_lat < 15, 0.0,
        torch.where(abs_lat < 30, 0.75 * smoothstep(15, 30, abs_lat),
        torch.where(abs_lat < 45, 0.75 + 0.25 * smoothstep(30, 45, abs_lat),
        torch.where(abs_lat < 60, 1.0, smoothstep(90, 60, abs_lat)))))
    in_summer_hemi = (lat > 0) if is_summer else (lat < 0)
    thermal = torch.where(in_summer_hemi, -10.0 * lat_factor * cont_scale,
                          14.0 * lat_factor * cont_scale)
    p = p + torch.where(cont_scale > 0.001, thermal, 0.0)

    p = p - 3 * elev_to_height_km(torch.clamp(elev, min=0.0))
    p = p + fbm(noise_t, pos[:, 0] * 2, pos[:, 1] * 2, pos[:, 2] * 2, 3) * 2
    return p.to(torch.float32)


def _pressure_to_wind(grad_e, grad_n, sin_lat):
    """PGF rotation by geostrophic deflection − friction
    (js/wind.js:343-378). Returns (east, north, speed)."""
    pgf_e, pgf_n = -grad_e, -grad_n
    sin5 = math.sin(5 * DEG)
    geo_angle = 70 * DEG * smoothstep(0.0, sin5, torch.abs(sin_lat))
    total = torch.where(sin_lat >= 0, -1.0, 1.0) * (geo_angle - 20 * DEG)
    ca, sa = torch.cos(total), torch.sin(total)
    we = (pgf_e * ca - pgf_n * sa) * 0.6
    wn = (pgf_e * sa + pgf_n * ca) * 0.6
    return we, wn, torch.sqrt(we * we + wn * wn)


def coast_bfs_seeds(g: DeviceGraph, elev, plate_is_ocean, r_plate):
    """Seeds and barriers of the five coast-distance BFS fields the climate
    stack needs (wind continentality + plate variant, ocean all / west /
    east coast), relaxed together in one loop. Returns (seeds [N,5],
    barriers [N,5], aux dict)."""
    gf = geo_frame(g.pos)
    is_land = (elev > 0) & g.valid
    is_ocean_cell = (~is_land) & g.valid
    main_ocean = open_ocean_mask(is_ocean_cell, g.valid, *g.bands)
    rp = r_plate.long()
    plate_land = (~plate_is_ocean[rp]) & g.valid
    plate_ocean_cell = plate_is_ocean[rp]
    # neighbour counts + land direction in one stacked banded sum:
    # Σ_j {main_ocean_j, plate_ocean_j, land_j, land_j·p_j}
    land_f = is_land.to(torch.float32)
    stack = torch.cat([
        main_ocean.to(torch.float32)[:, None],
        plate_ocean_cell.to(torch.float32)[:, None],
        land_f[:, None], land_f[:, None] * g.pos], 1)
    ssum = banded_sum(stack, *g.bands)
    coast_seeds = is_land & (ssum[:, 0] > 0)
    p_seeds = plate_land & (ssum[:, 1] > 0)

    # ocean coast classification (js/ocean.js:13-55):
    # land_dir = Σ_j land_j (p_j - p_i) = Σ land_j·p_j - (Σ land_j)·p_i
    land_cnt = ssum[:, 2]
    land_dir = ssum[:, 3:6] - land_cnt[:, None] * g.pos
    coast_o = is_ocean_cell & (land_cnt > 0)
    normal_e = dot3(land_dir, gf.east)
    # js/ocean.js:35's branch structure reduces to normal_e <= 0
    west = coast_o & (normal_e <= 0)
    east_c = coast_o & (~west)

    seeds = torch.stack([coast_seeds, p_seeds, coast_o, west, east_c], 1)
    barriers = torch.stack([~is_land, ~plate_land, is_land, is_land,
                            is_land], 1)
    aux = dict(gf=gf, is_land=is_land, plate_land=plate_land,
               is_ocean_cell=is_ocean_cell)
    return seeds, barriers, aux


def coast_threshold(n: int) -> int:
    """Boundary-current reach in hops: ``max(5, round(0.035·√N))``
    (js/ocean.js:306-310)."""
    return max(5, round(math.sqrt(n) * 0.035))


def climate_coast_cap(n: int) -> int:
    """Sweep bound of the merged climate coast BFS: every consumer
    saturates by 3000 km of land or 2·coast_threshold hops of ocean, so
    hop distances beyond the cap are indistinguishable from the cap."""
    avg_edge_km = (math.pi * 6371) / math.sqrt(n)
    return max(math.ceil(3000.0 / avg_edge_km) + 2,
               2 * coast_threshold(n) + 2)


def _seeded_component(member, lab, seed):
    """Members whose component (label ``lab``, at most N) holds a
    ``seed`` cell."""
    has_seed = torch.zeros(lab.shape[0] + 1, dtype=torch.int32,
                           device=lab.device).scatter_reduce(
        0, lab, seed.to(torch.int32), "amax")
    return member & (has_seed[lab] > 0)


def climate_coast_fields(g: DeviceGraph, elev, plate_is_ocean, r_plate):
    """coast_bfs_seeds → hop-capped 5-field BFS → exact saturation
    fix-ups. Returns (d5 [N,5] f32, aux)."""
    seeds5, barriers5, aux = coast_bfs_seeds(g, elev, plate_is_ocean,
                                             r_plate)
    cap = climate_coast_cap(g.n_cells)
    d5 = bfs_hops_multi_banded(seeds5, barriers5, *g.bands, max_hops=cap)
    capf = float(cap + 1)

    # col 0 — land continentality / precip coast cutoff: far-but-reachable
    # land (in the land component of a main-ocean coast seed) saturates;
    # land unreachable from the main-ocean coast stays inf
    lab = connected_components_banded(aux["is_land"], *g.bands).long()
    reach0 = spmd.gathered(_seeded_component, aux["is_land"], lab,
                           seeds5[:, 0])
    d0 = torch.where(torch.isfinite(d5[:, 0]), d5[:, 0],
                     torch.where(reach0, capf, math.inf))
    # col 1 — plate continentality: reachable ⟺ any seed exists
    reach1 = aux["plate_land"] & spmd.gathered(torch.any, seeds5[:, 1])
    d1 = torch.where(torch.isfinite(d5[:, 1]), d5[:, 1],
                     torch.where(reach1, capf, math.inf))
    # cols 2-4 (ocean all/west/east coast): weights are exactly 0 beyond
    # 2·coast_threshold < cap, so inf ↦ -1 stays exact
    d5 = torch.cat([d0[:, None], d1[:, None], d5[:, 2:]], 1)
    return d5, aux


def compute_wind(g: DeviceGraph, elev, plate_is_ocean, r_plate,
                 noise_t: Tables, seed: int = 0, coast_d=None,
                 gf=None, is_land=None, plate_land=None) -> Dict:
    """Full wind stage (js/wind.js:394-687). Returns a dict of tensors.
    ``coast_d`` (+ the aux fields): precomputed columns 0-1 of the merged
    climate coast BFS. Its phases are sub-stage spans of the current
    timer (pipeline/timing.py ``span``)."""
    n = g.n_cells
    dev = g.device
    avg_edge_km = (math.pi * 6371) / math.sqrt(n)

    if gf is None:
        gf = geo_frame(g.pos)
    if is_land is None:
        is_land = (elev > 0) & g.valid

    with span("Wind: ITCZ bins"):
        cnt, land_cnt, esum = _bin_aggregates(gf.lat, gf.lon, elev, is_land,
                                              g.valid)
        lats2 = torch.stack([_itcz_latitudes(cnt, land_cnt, esum, 1.0),
                             _itcz_latitudes(cnt, land_cnt, esum, -1.0)])
    with span("Wind: ITCZ spline on the host"):
        lats_np = lats2.cpu().numpy()
        sp_summer, sp_winter = (
            spline_to_device(_build_periodic_spline(lats_np[s]), dev)
            for s in range(2))

    with span("Wind: continentality"):
        if coast_d is None:
            d5, aux = climate_coast_fields(g, elev, plate_is_ocean, r_plate)
            coast_d = d5[:, :2]
            plate_land = aux["plate_land"]
        coast_dist, p_dist = coast_d[:, 0], coast_d[:, 1]
        cont2 = torch.stack([
            torch.where(is_land & torch.isfinite(coast_dist),
                        smoothstep(0.0, 2000.0, coast_dist * avg_edge_km),
                        0.0),
            torch.where(plate_land & torch.isfinite(p_dist),
                        smoothstep(0.0, 2000.0, p_dist * avg_edge_km), 0.0),
        ], 1).to(torch.float32)
        cont_passes = max(1, round(100 / avg_edge_km))
        cont2 = smooth_field_banded(cont2, *g.bands, cont_passes)
        cont, p_cont = cont2[:, 0], cont2[:, 1]

        result = dict(
            r_lat=gf.lat, r_lon=gf.lon, r_sin_lat=gf.sin_lat,
            r_east=gf.east, r_north=gf.north,
            r_is_land=is_land,
            r_continentality=cont,
            r_coast_dist_land=torch.where(torch.isfinite(coast_dist),
                                          coast_dist, -1.0),
            r_plate_continentality=p_cont,
        )

    with span("Wind: pressure and flow"):
        press_passes = max(1, round(75 / avg_edge_km))
        # both seasons' pressure fields smooth + differentiate stacked
        press2 = torch.stack([
            _pressure_kernel(g.pos, gf, sp_summer, cont, elev, noise_t,
                             is_summer=True),
            _pressure_kernel(g.pos, gf, sp_winter, cont, elev, noise_t,
                             is_summer=False)], 1)
        press2 = smooth_field_banded(press2, *g.bands, press_passes)
        ge2, gn2 = compute_gradients_banded(g.pos, press2, gf.east, gf.north,
                                            *g.bands)
        for s, name in enumerate(("summer", "winter")):
            we, wn, speed = _pressure_to_wind(ge2[:, s], gn2[:, s], gf.sin_lat)
            p95 = spmd.gathered(percentile95, speed, g.valid)
            speed = torch.clamp(speed / p95, max=1.0)
            result[f"r_pressure_{name}"] = press2[:, s] - 1013.0
            result[f"r_wind_east_{name}"] = we
            result[f"r_wind_north_{name}"] = wn
            result[f"r_wind_speed_{name}"] = speed

    # ITCZ samples for downstream lookup + visualization (360 points)
    with span("Wind: ITCZ samples"):
        m = 360
        vlons = torch.as_tensor(
            (-np.pi + (np.arange(m) + 0.5) * (2 * np.pi / m)).astype(
                np.float32),
            device=dev)
        result["itcz_lons"] = vlons
        result["itcz_lats_summer"] = eval_spline(sp_summer, vlons)
        result["itcz_lats_winter"] = eval_spline(sp_winter, vlons)
    return result
