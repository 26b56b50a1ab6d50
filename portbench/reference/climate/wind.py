"""Wind simulation — ITCZ-tracking seasonal pressure fields and wind vectors.

Re-design of reference js/wind.js. Structure:

- geographic sampling for the ITCZ uses per-bin aggregates scattered on
  device (36×72 lat/lon bins) instead of the reference's CSR cell scan —
  the 288 circular samples then reduce over the tiny [36,72] grid on host;
- the periodic cubic spline (72 knots, iterative relaxation solve,
  js/wind.js:12-71) is reproduced on host in numpy and evaluated per cell
  on device (uniform knots → closed-form segment lookup);
- continentality is the main-ocean coast BFS → smoothstep(0, 2000 km)
  (js/wind.js:476-594) using the shared device BFS kernels;
- pressure, least-squares gradients and the geostrophic/friction rotation
  are fused per-cell maps.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict

import numpy as np
from ..backend import jax
from ..backend import jnp

from ..mesh.device import DeviceGraph
from ..ops.noise import Tables, fbm
from ..ops.banded import (bfs_hops_multi_banded, smooth_field_banded,
                          banded_sum, compute_gradients_banded)
from ..erosion.flood import open_ocean_mask
from .util import (GeoFrame, geo_frame, smoothstep, smooth_field,
                   percentile, elev_to_height_km, itcz_lookup,
                   compute_gradients)

DEG = math.pi / 180.0
LAT_BINS, LON_BINS = 36, 72
NUM_ITCZ_LON = 72


@jax.jit
def _bin_aggregates(lat, lon, elev, is_land, valid):
    """Scatter per-cell land/elev into the 36×72 geo bins (js/wind.js:88-118)."""
    bi = jnp.clip(((lat + jnp.pi / 2) / jnp.pi * LAT_BINS).astype(jnp.int32),
                  0, LAT_BINS - 1)
    bj = jnp.clip(((lon + jnp.pi) / (2 * jnp.pi) * LON_BINS).astype(jnp.int32),
                  0, LON_BINS - 1)
    b = jnp.where(valid, bi * LON_BINS + bj, LAT_BINS * LON_BINS)
    nb = LAT_BINS * LON_BINS + 1
    cnt = jnp.zeros(nb, jnp.float32).at[b].add(1.0)
    land = jnp.zeros(nb, jnp.float32).at[b].add(is_land.astype(jnp.float32))
    esum = jnp.zeros(nb, jnp.float32).at[b].add(jnp.maximum(0.0, elev))
    return cnt[:-1], land[:-1], esum[:-1]


_ITCZ_LONS = (-np.pi + (np.arange(NUM_ITCZ_LON) + 0.5)
              * (2 * np.pi / NUM_ITCZ_LON)).astype(np.float32)
_SAMPLE_DEGS = np.array([5.0, 10.0, 15.0, 20.0], np.float32)


def _elev_to_km_vec(e):
    t = jnp.minimum(e, 1.0)
    return jnp.where(e <= 0, e * 10.0, 6 * t**4 * (5 - 4 * t))


def _itcz_latitudes(cnt, land, esum, season_sign: float):
    """ITCZ latitude per longitude (js/wind.js:174-232) — device version.
    The reference scans CSR cells per circular sample; here the 72×4 sample
    circles reduce over the [36,72] bin grid with a broadcast mask."""
    cnt2 = cnt.reshape(LAT_BINS, LON_BINS)
    land2 = land.reshape(LAT_BINS, LON_BINS)
    esum2 = esum.reshape(LAT_BINS, LON_BINS)

    lat_c = ((np.arange(LAT_BINS) + 0.5) / LAT_BINS * np.pi
             - np.pi / 2).astype(np.float32)
    lon_c = ((np.arange(LON_BINS) + 0.5) / LON_BINS * 2 * np.pi
             - np.pi).astype(np.float32)
    lat_s = (_SAMPLE_DEGS * season_sign * DEG)[:, None, None, None]  # [4,1,1,1]
    lon_s = _ITCZ_LONS[None, :, None, None]                          # [1,72,1,1]
    cos_d = (jnp.sin(lat_s) * jnp.sin(lat_c)[None, None, :, None]
             + jnp.cos(lat_s) * jnp.cos(lat_c)[None, None, :, None]
             * jnp.cos(lon_c[None, None, None, :] - lon_s))
    sel = (cos_d >= math.cos(20 * DEG)).astype(jnp.float32)  # [4,72,36,72]

    tot = jnp.einsum("dlij,ij->dl", sel, cnt2)
    lnd = jnp.einsum("dlij,ij->dl", sel, land2)
    elv = jnp.einsum("dlij,ij->dl", sel, esum2)
    lf = jnp.where(tot > 0, lnd / jnp.maximum(tot, 1.0), 0.0)
    ae = jnp.where(tot > 0, elv / jnp.maximum(tot, 1.0), 0.0)
    avg_land = jnp.mean(lf, axis=0)   # [72]
    avg_elev = jnp.mean(ae, axis=0)

    land_pull = jnp.minimum(1.0, avg_land * 2)
    itcz_deg = 5 + land_pull * 15 - _elev_to_km_vec(avg_elev) * 1.5
    lats = jnp.clip(itcz_deg, 5.0, 20.0) * season_sign * DEG

    # 3-pass periodic [0.25, 0.5, 0.25] smoothing + re-clamp (js/wind.js:212-228)
    for _ in range(3):
        lats = 0.25 * jnp.roll(lats, 1) + 0.5 * lats + 0.25 * jnp.roll(lats, -1)
    lo = (5 if season_sign > 0 else -20) * DEG
    hi = (20 if season_sign > 0 else -5) * DEG
    return jnp.clip(lats, lo, hi)


def _build_periodic_spline(ys):
    """Periodic cubic spline with the reference's 20-iteration Gauss-Seidel
    relaxation solve (js/wind.js:12-53), uniform knots — device version
    (lax.fori over the sequential sweep, 20×72 trivial steps). Returns the
    (x0, h, ys, b, c, d) tuple eval_spline consumes."""
    n = NUM_ITCZ_LON
    period = 2 * np.pi
    h = np.float32(period / n)
    ys = ys.astype(jnp.float32)
    alpha = (3 / h) * (jnp.roll(ys, -1) - ys) - (3 / h) * (ys - jnp.roll(ys, 1))

    def sweep(_, c):
        def body(i, c):
            prev = (i - 1) % n
            nxt = (i + 1) % n
            val = (alpha[i] - h * c[prev] - h * c[nxt]) / (4 * h)
            return c.at[i].set(val)
        return jax.lax.fori_loop(0, n, body, c)

    c = jax.lax.fori_loop(0, 20, sweep, jnp.zeros(n, jnp.float32))
    b = (jnp.roll(ys, -1) - ys) / h - h * (jnp.roll(c, -1) + 2 * c) / 3
    d = (jnp.roll(c, -1) - c) / (3 * h)
    return (jnp.float32(_ITCZ_LONS[0]), jnp.float32(h), ys, b, c, d)


def eval_spline(spline_arrs, lon):
    """Device spline evaluation with uniform segments (js/wind.js:55-71)."""
    x0, h, ys, b, c, d = spline_arrs
    n = ys.shape[0]
    period = 2 * jnp.pi
    t = jnp.mod(jnp.mod(lon - x0, period) + period, period)
    seg = jnp.clip((t / h).astype(jnp.int32), 0, n - 1)
    dx = t - seg * h
    return ys[seg] + b[seg] * dx + c[seg] * dx * dx + d[seg] * dx * dx * dx


@partial(jax.jit, static_argnames=("is_summer",))
def _pressure_kernel(pos, gf: GeoFrame, spline_arrs, continentality, elev,
                     noise_t: Tables, is_summer: bool):
    """Per-cell pressure (js/wind.js:239-301)."""
    lat, lon = gf.lat, gf.lon
    itcz_lat = eval_spline(spline_arrs, lon)
    lat_deg = lat / DEG
    season_sign = 1.0 if is_summer else -1.0

    p = 1013.0
    d_itcz = (lat - itcz_lat) / DEG
    p = p - 15 * jnp.exp(-0.5 * (d_itcz / 8) ** 2)

    shift = season_sign * 5
    high_i = 12 * (1 - 0.3 * continentality)
    p = p + high_i * jnp.exp(-0.5 * ((lat_deg - (30 + shift)) / 10) ** 2)
    p = p + high_i * jnp.exp(-0.5 * ((lat_deg + (30 - shift)) / 10) ** 2)
    p = p - 10 * jnp.exp(-0.5 * ((lat_deg - 60) / 10) ** 2)
    p = p - 10 * jnp.exp(-0.5 * ((lat_deg + 60) / 10) ** 2)
    p = p + 8 * jnp.exp(-0.5 * ((lat_deg - 85) / 8) ** 2)
    p = p + 8 * jnp.exp(-0.5 * ((lat_deg + 85) / 8) ** 2)

    # continental thermal modifier (js/wind.js:267-289)
    cont_scale = smoothstep(0.2, 0.5, continentality)
    abs_lat = jnp.abs(lat) / DEG
    lat_factor = jnp.where(
        abs_lat < 15, 0.0,
        jnp.where(abs_lat < 30, 0.75 * smoothstep(15, 30, abs_lat),
        jnp.where(abs_lat < 45, 0.75 + 0.25 * smoothstep(30, 45, abs_lat),
        jnp.where(abs_lat < 60, 1.0, smoothstep(90, 60, abs_lat)))))
    in_summer_hemi = (lat > 0) if is_summer else (lat < 0)
    thermal = jnp.where(in_summer_hemi, -10.0 * lat_factor * cont_scale,
                        14.0 * lat_factor * cont_scale)
    p = p + jnp.where(cont_scale > 0.001, thermal, 0.0)

    p = p - 3 * elev_to_height_km(jnp.maximum(0.0, elev))
    p = p + fbm(noise_t, pos[:, 0] * 2, pos[:, 1] * 2, pos[:, 2] * 2, 3) * 2
    return p.astype(jnp.float32)


@jax.jit
def _pressure_to_wind(grad_e, grad_n, sin_lat):
    """PGF rotation by geostrophic deflection − friction (js/wind.js:343-378)."""
    pgf_e, pgf_n = -grad_e, -grad_n
    sin5 = math.sin(5 * DEG)
    geo_angle = 70 * DEG * smoothstep(0.0, sin5, jnp.abs(sin_lat))
    total = jnp.where(sin_lat >= 0, -1.0, 1.0) * (geo_angle - 20 * DEG)
    ca, sa = jnp.cos(total), jnp.sin(total)
    we = (pgf_e * ca - pgf_n * sa) * 0.6
    wn = (pgf_e * sa + pgf_n * ca) * 0.6
    return we.astype(jnp.float32), wn.astype(jnp.float32), jnp.sqrt(we * we + wn * wn).astype(jnp.float32)


def coast_bfs_seeds(g: DeviceGraph, elev, plate_is_ocean, r_plate):
    """Seeds/barriers for ALL five coast-distance BFS fields the climate
    stack needs (wind continentality + plate variant, ocean all/west/east
    coast) so one bfs_hops_multi loop can relax them together — TPU gathers
    are index-bound, so five fields cost ~one. Returns (seeds [N,5],
    barriers [N,5], aux dict)."""
    gf = geo_frame(g.pos)
    is_land = (elev > 0) & g.valid
    is_ocean_cell = (~is_land) & g.valid
    main_ocean = open_ocean_mask(is_ocean_cell, g.valid, *g.bands)
    plate_land = (~plate_is_ocean[r_plate]) & g.valid
    plate_ocean_cell = plate_is_ocean[r_plate]
    # neighbor counts + land direction in one stacked banded sum:
    # Σ_j {main_ocean_j, plate_ocean_j, land_j, land_j·p_j}
    land_f = is_land.astype(jnp.float32)
    stack = jnp.concatenate([
        main_ocean.astype(jnp.float32)[:, None],
        plate_ocean_cell.astype(jnp.float32)[:, None],
        land_f[:, None], land_f[:, None] * g.pos], axis=1)
    ssum = banded_sum(stack, *g.bands)
    coast_seeds = is_land & (ssum[:, 0] > 0)
    p_seeds = plate_land & (ssum[:, 1] > 0)

    # ocean coast classification (js/ocean.js:13-55):
    # land_dir = Σ_j land_j (p_j - p_i) = Σ land_j·p_j - (Σ land_j)·p_i
    land_cnt = ssum[:, 2]
    land_dir = ssum[:, 3:6] - land_cnt[:, None] * g.pos
    coast_o = is_ocean_cell & (land_cnt > 0)
    normal_e = jnp.einsum("nc,nc->n", land_dir, gf.east)
    # js/ocean.js:35's branch structure reduces to normal_e <= 0
    west = coast_o & (normal_e <= 0)
    east_c = coast_o & (~west)

    seeds = jnp.stack([coast_seeds, p_seeds, coast_o, west, east_c], 1)
    barriers = jnp.stack([~is_land, ~plate_land, is_land, is_land,
                          is_land], 1)
    aux = dict(gf=gf, is_land=is_land, plate_land=plate_land,
               is_ocean_cell=is_ocean_cell)
    return seeds, barriers, aux


def coast_threshold(n: int) -> int:
    """Boundary-current reach in hops: ``max(5, round(0.035·√N))``
    (js/ocean.js:306-310). THE single definition — ocean-current deflection
    / warmth consume it and :func:`climate_coast_cap` must bound
    2·coast_threshold, so both import this helper (two diverging copies
    would silently break the saturation guarantee)."""
    return max(5, round(math.sqrt(n) * 0.035))


def climate_coast_cap(n: int) -> int:
    """Sweep bound for the merged climate coast BFS. Relaxing to a fixed
    point costs O(mesh diameter) sweeps (O(N^1.5) total work), but every
    consumer saturates: land/plate continentality at the 2000 km smoothstep
    (js/wind.js:531-554) plus precipitation's hard 3000 km coast cutoff
    (js/precipitation.js:462-487), ocean west/east coast deflection and
    warmth at 2·coast_threshold hops (js/ocean.js:306-324, 120-164). Hop
    distances beyond the cap are indistinguishable from the cap."""
    avg_edge_km = (math.pi * 6371) / math.sqrt(n)
    return max(math.ceil(3000.0 / avg_edge_km) + 2,
               2 * coast_threshold(n) + 2)


def climate_coast_fields(g: DeviceGraph, elev, plate_is_ocean, r_plate):
    """coast_bfs_seeds → hop-capped 5-field BFS → exact saturation fixups.
    Returns (d5 [N,5] f32, aux). Semantics match the unbounded relaxation
    for every downstream consumer (see :func:`climate_coast_cap`)."""
    from ..erosion.flood import connected_components_banded

    seeds5, barriers5, aux = coast_bfs_seeds(g, elev, plate_is_ocean,
                                             r_plate)
    npad = seeds5.shape[0]
    cap = climate_coast_cap(g.n_cells)
    d5 = bfs_hops_multi_banded(seeds5, barriers5, *g.bands, max_hops=cap)
    capf = jnp.float32(cap + 1)

    # col 0 — land continentality / precip coast cutoff: far-but-reachable
    # land (same land component as any main-ocean coast seed) saturates at
    # ≥3000 km; land unreachable from the main-ocean coast (islands inside
    # enclosed seas) stays inf → the reference's unvisited -1 downstream.
    lab = connected_components_banded(aux["is_land"], *g.bands)
    has_seed = jax.ops.segment_max(seeds5[:, 0].astype(jnp.int32), lab,
                                   num_segments=npad + 1)
    reach0 = aux["is_land"] & (has_seed[lab] > 0)
    d0 = jnp.where(jnp.isfinite(d5[:, 0]), d5[:, 0],
                   jnp.where(reach0, capf, jnp.inf))
    # col 1 — plate continentality: on a sphere every plate-land
    # component's boundary is adjacent to plate-ocean cells, i.e. contains
    # seeds — so reachable ⟺ any seed exists (all-land planets keep inf)
    reach1 = aux["plate_land"] & jnp.any(seeds5[:, 1])
    d1 = jnp.where(jnp.isfinite(d5[:, 1]), d5[:, 1],
                   jnp.where(reach1, capf, jnp.inf))
    # cols 2-4 (ocean all/west/east coast): deflection and warmth weights
    # are exactly 0 beyond 2·coast_threshold < cap — inf ↦ -1 stays exact
    d5 = jnp.concatenate([d0[:, None], d1[:, None], d5[:, 2:]], 1)
    return d5, aux


def compute_wind(g: DeviceGraph, elev, plate_is_ocean, r_plate,
                 noise_t: Tables, seed: int = 0, coast_d=None,
                 gf=None, is_land=None, plate_land=None) -> Dict:
    """Full wind stage (js/wind.js:394-687). Returns dict of device arrays +
    host ITCZ metadata. ``coast_d`` (+ the aux fields): precomputed columns
    0-1 of the merged climate coast BFS (see :func:`coast_bfs_seeds`)."""
    n = g.n_cells
    avg_edge_km = (math.pi * 6371) / math.sqrt(n)

    if gf is None:
        gf = geo_frame(g.pos)
    if is_land is None:
        is_land = (elev > 0) & g.valid

    # ITCZ — fully on device (bin aggregates → circular samples → spline),
    # so the wind stage runs with zero host round trips
    cnt, land_cnt, esum = _bin_aggregates(gf.lat, gf.lon, elev, is_land, g.valid)
    sp_summer = _build_periodic_spline(_itcz_latitudes(cnt, land_cnt, esum, 1.0))
    sp_winter = _build_periodic_spline(_itcz_latitudes(cnt, land_cnt, esum, -1.0))

    # continentality: BFS from main-ocean coast through land
    # (js/wind.js:476-554) + the plate-based variant (:556-593). When the
    # caller (fused pipeline) precomputed the merged 5-field climate BFS,
    # columns 0-1 arrive via ``coast_d``; standalone calls relax the pair
    # here ([N,2], one gather per sweep).
    if coast_d is None:
        d5, aux = climate_coast_fields(g, elev, plate_is_ocean, r_plate)
        coast_d = d5[:, :2]
        plate_land = aux["plate_land"]
    coast_dist, p_dist = coast_d[:, 0], coast_d[:, 1]
    cont2 = jnp.stack([
        jnp.where(is_land & jnp.isfinite(coast_dist),
                  smoothstep(0.0, 2000.0, coast_dist * avg_edge_km), 0.0),
        jnp.where(plate_land & jnp.isfinite(p_dist),
                  smoothstep(0.0, 2000.0, p_dist * avg_edge_km), 0.0),
    ], axis=1).astype(jnp.float32)
    cont_passes = max(1, round(100 / avg_edge_km))
    cont2 = smooth_field_banded(cont2, *g.bands, cont_passes)
    cont, p_cont = cont2[:, 0], cont2[:, 1]

    result = dict(
        r_lat=gf.lat, r_lon=gf.lon, r_sin_lat=gf.sin_lat,
        r_east=gf.east, r_north=gf.north,
        r_is_land=is_land,
        r_continentality=cont,
        r_coast_dist_land=jnp.where(jnp.isfinite(coast_dist), coast_dist, -1.0),
        r_plate_continentality=p_cont,
    )

    press_passes = max(1, round(75 / avg_edge_km))
    # both seasons' pressure fields smooth + differentiate stacked
    press2 = jnp.stack([
        _pressure_kernel(g.pos, gf, sp_summer, cont, elev, noise_t,
                         is_summer=True),
        _pressure_kernel(g.pos, gf, sp_winter, cont, elev, noise_t,
                         is_summer=False)], axis=1)
    press2 = smooth_field_banded(press2, *g.bands, press_passes)
    ge2, gn2 = compute_gradients_banded(g.pos, press2, gf.east, gf.north,
                                        *g.bands)
    for s, name in enumerate(("summer", "winter")):
        we, wn, speed = _pressure_to_wind(ge2[:, s], gn2[:, s], gf.sin_lat)
        p95 = percentile(speed, 0.95, g.valid)
        speed = jnp.minimum(1.0, speed / p95)
        result[f"r_pressure_{name}"] = press2[:, s] - 1013.0
        result[f"r_wind_east_{name}"] = we
        result[f"r_wind_north_{name}"] = wn
        result[f"r_wind_speed_{name}"] = speed

    # ITCZ samples for downstream lookup + visualization (360 points)
    m = 360
    vlons = jnp.asarray(
        -np.pi + (np.arange(m) + 0.5) * (2 * np.pi / m), jnp.float32)
    result["itcz_lons"] = vlons
    result["itcz_lats_summer"] = eval_spline(sp_summer, vlons)
    result["itcz_lats_winter"] = eval_spline(sp_winter, vlons)
    return result
