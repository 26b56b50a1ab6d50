"""Ocean currents — rule-based wind-belt gyres with coast deflection.

Re-design of reference js/ocean.js: coast side classification (land
direction · east frame), three ocean BFS distance fields, circumpolar
channel detection (72 longitude bins), per-season zonal base flow + western
intensification / eastern equatorward deflection, circumpolar override,
ocean-masked smoothing, geographic warmth classification with heavy
smoothing, p95 speed normalization.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict

from ..backend import jax
from ..backend import jnp

from ..mesh.device import DeviceGraph
from ..ops.banded import (bfs_hops_multi_banded, smooth_masked_banded,
                          banded_sum)
from .util import smoothstep, smooth_masked, percentile, itcz_lookup
from .wind import coast_threshold

DEG = math.pi / 180.0


@partial(jax.jit, static_argnames=("band_off",))
def _coast_classification(pos, is_ocean, east, band_off, band_mask,
                          rem_src, rem_dst):
    """West/east coast seeds from land-direction · east (js/ocean.js:13-55).
    Banded: Σ_j land_j (p_j - p_i) decomposes into neighbor sums."""
    land_f = (~is_ocean).astype(jnp.float32)
    stack = jnp.concatenate([land_f[:, None], land_f[:, None] * pos], axis=1)
    ssum = banded_sum(stack, band_off, band_mask, rem_src, rem_dst)
    land_dir = ssum[:, 1:4] - ssum[:, 0:1] * pos
    coast = is_ocean & (ssum[:, 0] > 0)
    normal_e = jnp.einsum("nc,nc->n", land_dir, east)
    west = coast & ((normal_e < -0.2) | ((normal_e >= -0.2) & (normal_e <= 0.2) & (normal_e <= 0)))
    east_c = coast & (~west)
    return coast, west, east_c


@jax.jit
def _circumpolar(lat, lon, is_ocean, valid, target_lat, band):
    """All 72 longitude bins have ocean within the band? (js/ocean.js:91-111)."""
    nb = 72
    in_band = is_ocean & valid & (lat >= target_lat - band) & (lat <= target_lat + band)
    b = jnp.clip(((lon + jnp.pi) / (2 * jnp.pi) * nb).astype(jnp.int32), 0, nb - 1)
    b = jnp.where(in_band, b, nb)
    hits = jnp.zeros(nb + 1, jnp.int32).at[b].add(1)[:nb]
    return jnp.all(hits > 0)


@jax.jit
def _season_vectors(lat, lon, is_ocean, itcz_lats,
                    west_dist, east_dist,
                    circ_nh, circ_sh, coast_threshold, shift_deg):
    """Base zonal flow + coast deflection + circumpolar override
    (js/ocean.js:266-333)."""
    abs_lat_deg = jnp.abs(lat) / DEG
    hemi = jnp.where(lat >= 0, 1.0, -1.0)
    band_lat = jnp.abs(lat / DEG - shift_deg)
    itcz_lat = itcz_lookup(itcz_lats, lon)
    dist_itcz = jnp.abs(lat - itcz_lat) / DEG

    base_e = jnp.where(
        dist_itcz < 3, 1 - 2 * smoothstep(0.0, 3.0, dist_itcz),
        jnp.where(band_lat < 30, -1.0,
        jnp.where(band_lat < 35, -1 + 2 * smoothstep(30.0, 35.0, band_lat),
        jnp.where(band_lat < 58, 1.0,
        jnp.where(band_lat < 65, 1 - 1.5 * smoothstep(58.0, 65.0, band_lat),
                  -0.5)))))

    cur_e = base_e
    cur_n = jnp.zeros_like(base_e)

    w_ok = (west_dist >= 0) & (west_dist < coast_threshold)
    tw = 1 - west_dist / coast_threshold
    cur_n = cur_n + jnp.where(w_ok, hemi * tw * tw * 2.0, 0.0)
    cur_e = cur_e * jnp.where(w_ok, 1 - tw * tw * 0.7, 1.0)

    e_ok = (east_dist >= 0) & (east_dist < coast_threshold)
    te = 1 - east_dist / coast_threshold
    cur_n = cur_n - jnp.where(e_ok, hemi * te * te * 0.8, 0.0)
    cur_e = cur_e * jnp.where(e_ok, 1 - te * te * 0.5, 1.0)

    is_circ = ((lat > 0) & circ_nh) | ((lat < 0) & circ_sh)
    c_ok = is_circ & (abs_lat_deg >= 55) & (abs_lat_deg <= 75)
    cs = 1 - jnp.abs(abs_lat_deg - 65) / 10
    cur_e = jnp.where(c_ok, cur_e * (1 - cs) + 1.5 * cs, cur_e)
    cur_n = jnp.where(c_ok, cur_n * (1 - cs * 0.8), cur_n)

    cur_e = jnp.where(is_ocean, cur_e, 0.0)
    cur_n = jnp.where(is_ocean, cur_n, 0.0)
    return cur_e.astype(jnp.float32), cur_n.astype(jnp.float32)


@jax.jit
def _classify_warmth(is_ocean, lat, west_dist, east_dist, fade_range, shift_deg):
    """Coast-side × wind-cell warmth (js/ocean.js:120-164)."""
    band_lat = jnp.abs(lat / DEG - shift_deg)
    cell_sign = jnp.where(
        band_lat < 28, 1.0,
        jnp.where(band_lat < 35, 1 - 2 * smoothstep(28.0, 35.0, band_lat),
        jnp.where(band_lat < 55, -1.0,
        jnp.where(band_lat < 65, -1 + 2 * smoothstep(55.0, 65.0, band_lat),
                  1.0))))
    warm = jnp.zeros_like(lat)
    w_ok = (west_dist >= 0) & (west_dist < fade_range)
    tw = 1 - west_dist / fade_range
    warm = warm + jnp.where(w_ok, cell_sign * tw * tw, 0.0)
    e_ok = (east_dist >= 0) & (east_dist < fade_range)
    te = 1 - east_dist / fade_range
    warm = warm - jnp.where(e_ok, cell_sign * te * te, 0.0)
    return jnp.where(is_ocean, jnp.clip(warm, -1.0, 1.0), 0.0).astype(jnp.float32)


def compute_ocean_currents(g: DeviceGraph, elev, wind: Dict,
                           coast_d=None) -> Dict:
    """``coast_d``: precomputed columns 2-4 of the merged climate coast BFS
    (wind.coast_bfs_seeds) — all/west/east coast distances through ocean."""
    n = g.n_cells
    avg_edge_km = (math.pi * 6371) / math.sqrt(n)
    is_ocean = (~wind["r_is_land"]) & g.valid
    lat, lon = wind["r_lat"], wind["r_lon"]

    if coast_d is None:
        coast, west, east_c = _coast_classification(
            g.pos, is_ocean, wind["r_east"], *g.bands)
        barrier = ~is_ocean
        # the three coast fields relax together ([N,3], one gather/sweep);
        # hop-capped: every consumer's weight is exactly 0 beyond
        # 2·coast_threshold hops (see climate.wind.climate_coast_cap)
        from .wind import climate_coast_cap
        cap = climate_coast_cap(n)
        assert cap >= 2 * coast_threshold(n) + 2, (cap, coast_threshold(n))
        coast_d = bfs_hops_multi_banded(
            jnp.stack([coast, west, east_c], 1),
            jnp.stack([barrier, barrier, barrier], 1),
            *g.bands, max_hops=cap)
    # convert inf → -1 convention of the reference
    d_west = jnp.where(jnp.isfinite(coast_d[:, 1]), coast_d[:, 1], -1.0)
    d_east = jnp.where(jnp.isfinite(coast_d[:, 2]), coast_d[:, 2], -1.0)

    circ_nh = _circumpolar(lat, lon, is_ocean, g.valid, 60 * DEG, 5 * DEG)
    circ_sh = _circumpolar(lat, lon, is_ocean, g.valid, -60 * DEG, 5 * DEG)

    thr = coast_threshold(n)
    warmth_range = thr * 2
    smooth_passes = max(2, round(125 / avg_edge_km))
    warmth_passes = max(3, round(900 / avg_edge_km))

    cur_l, warm_l = [], []
    for name, shift in (("summer", 5.0), ("winter", -5.0)):
        itcz_lats = wind[f"itcz_lats_{name}"]
        cur_e, cur_n = _season_vectors(
            lat, lon, is_ocean, itcz_lats, d_west, d_east,
            circ_nh, circ_sh, jnp.float32(thr), jnp.float32(shift))
        cur_l += [cur_e, cur_n]
        warm_l.append(_classify_warmth(
            is_ocean, lat, d_west, d_east,
            jnp.float32(warmth_range), jnp.float32(shift)))

    # both seasons' vectors (and warmths) smooth stacked — one gather/pass
    cur4 = smooth_masked_banded(jnp.stack(cur_l, 1), is_ocean,
                                *g.bands, smooth_passes)
    cur4 = jnp.where(is_ocean[:, None], cur4, 0.0)
    warm2 = smooth_masked_banded(jnp.stack(warm_l, 1), is_ocean,
                                 *g.bands, warmth_passes)

    result = {}
    for s, name in enumerate(("summer", "winter")):
        cur_e, cur_n = cur4[:, 2 * s], cur4[:, 2 * s + 1]
        speed = jnp.sqrt(cur_e * cur_e + cur_n * cur_n)
        p95 = percentile(speed, 0.95, is_ocean & (speed > 0))
        speed = jnp.minimum(1.0, speed / p95)
        result[f"r_ocean_current_east_{name}"] = cur_e
        result[f"r_ocean_current_north_{name}"] = cur_n
        result[f"r_ocean_speed_{name}"] = speed.astype(jnp.float32)
        result[f"r_ocean_warmth_{name}"] = warm2[:, s]
    return result
