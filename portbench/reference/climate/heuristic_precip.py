"""Heuristic zonal precipitation model (blended 50-50 with the advection
model). Re-design of reference js/heuristic-precip.js: multiplicative zonal
base curve vs ITCZ distance, idealized wind belts, seasonal modifier with
west-coast-weighted Mediterranean suppression, continental dryness,
orographic modifier, hard coast cutoff.
"""

from __future__ import annotations

import math
from functools import partial

from ..backend import jax
from ..backend import jnp

from ..ops.banded import banded_sum, smooth_field_banded
from .util import smoothstep, elev_to_height_km, itcz_lookup

DEG = math.pi / 180.0


def zonal_base(dist_deg):
    """Zonal precipitation curve vs ITCZ distance (js/heuristic-precip.js:16-37)."""
    return jnp.where(
        dist_deg < 5, 1.0,
        jnp.where(dist_deg < 10, 1.0 - 0.65 * smoothstep(5.0, 10.0, dist_deg),
        jnp.where(dist_deg < 33, 0.35 - 0.33 * smoothstep(10.0, 28.0, dist_deg),
        jnp.where(dist_deg < 55, 0.02 + 0.48 * smoothstep(33.0, 55.0, dist_deg),
        jnp.where(dist_deg < 70, 0.5 - 0.2 * smoothstep(55.0, 70.0, dist_deg),
                  0.3 - 0.2 * smoothstep(70.0, 90.0, dist_deg))))))


def heuristic_wind(dist_deg, hemi_sign):
    """Idealized wind belts (js/heuristic-precip.js:51-81)."""
    trade = smoothstep(5.0, 15.0, dist_deg) * (1 - smoothstep(25.0, 32.0, dist_deg))
    west = smoothstep(30.0, 40.0, dist_deg) * (1 - smoothstep(55.0, 65.0, dist_deg))
    polar = smoothstep(60.0, 70.0, dist_deg)
    we = jnp.where(
        dist_deg < 5, 0.0,
        jnp.where(dist_deg < 30, -trade * 0.8,
        jnp.where(dist_deg < 60, west * 0.9, -polar * 0.4)))
    wn = jnp.where(
        dist_deg < 5, -hemi_sign * 0.1,
        jnp.where(dist_deg < 30, -hemi_sign * trade * 0.3,
        jnp.where(dist_deg < 60, hemi_sign * west * 0.25,
                  -hemi_sign * polar * 0.15)))
    return we, wn


@jax.jit
def heuristic_wind_field(lat, lon, itcz_lats):
    """Idealized wind for a full season (js/heuristic-precip.js:86-102).
    ITCZ displacement dampened to 30%."""
    itcz_lat = itcz_lookup(itcz_lats, lon) * 0.3
    signed = lat - itcz_lat
    dist_deg = jnp.abs(signed) / DEG
    hemi = jnp.where(signed > 0, 1.0, -1.0)
    return heuristic_wind(dist_deg, hemi)


@partial(jax.jit, static_argnames=("band_off", "wc_passes"))
def west_coast_signal(pos, is_land, coast_dist_land, east,
                      band_off, band_mask, rem_src, rem_dst, wc_passes: int):
    """West-coast signal: +1 west coast, -1 east coast, diffused ~300 km
    through land (js/heuristic-precip.js:128-166). Season-independent, so
    computed once and shared between the two seasonal evaluations.
    Banded: Σ_j ocean_j (p_j - p_i)·east_i decomposes into neighbor sums of
    {ocean_j, ocean_j·p_j}; the diffusion is a masked banded smooth."""
    oc = (~is_land).astype(jnp.float32)
    s4 = banded_sum(jnp.concatenate([oc[:, None], oc[:, None] * pos], axis=1),
                    band_off, band_mask, rem_src, rem_dst)
    ocean_cnt = s4[:, 0]
    ocean_dot_east = jnp.einsum(
        "nc,nc->n", s4[:, 1:4] - ocean_cnt[:, None] * pos, east)
    coast_cell = is_land & (coast_dist_land == 0)
    west_coast = jnp.where(coast_cell & (ocean_cnt > 0),
                           jnp.where(ocean_dot_east < 0, 1.0, -1.0), 0.0)
    land_f = is_land.astype(jnp.float32)
    c = 1 + banded_sum(land_f, band_off, band_mask, rem_src, rem_dst)

    def body(_, wc):
        contrib = jnp.where(is_land, wc, 0.0)
        s = wc + banded_sum(contrib, band_off, band_mask, rem_src, rem_dst)
        return jnp.where(is_land, s / c, 0.0)

    west_coast = jax.lax.fori_loop(0, wc_passes, body,
                                   west_coast.astype(jnp.float32))
    return west_coast.astype(jnp.float32)


@partial(jax.jit, static_argnames=("band_off", "wc_passes", "smooth_passes",
                                   "is_summer"))
def heuristic_precip_season(pos, lat, lon, elev, is_land, continentality,
                            coast_dist_land, elev_grad_e, elev_grad_n,
                            east, itcz_lats, band_off, band_mask,
                            rem_src, rem_dst,
                            avg_edge_km: float, wc_passes: int,
                            smooth_passes: int, is_summer: bool):
    """One season of the heuristic model (js/heuristic-precip.js:119-266)."""
    west_coast = west_coast_signal(pos, is_land, coast_dist_land, east,
                                   band_off, band_mask, rem_src, rem_dst,
                                   wc_passes)
    raw = heuristic_precip_raw(lat, lon, elev, is_land, continentality,
                               coast_dist_land, elev_grad_e, elev_grad_n,
                               west_coast, itcz_lats,
                               avg_edge_km, is_summer)
    return smooth_field_banded(raw, band_off, band_mask, rem_src, rem_dst,
                               smooth_passes)


@partial(jax.jit, static_argnames=("is_summer",))
def heuristic_precip_raw(lat, lon, elev, is_land, continentality,
                         coast_dist_land, elev_grad_e, elev_grad_n,
                         west_coast, itcz_lats,
                         avg_edge_km: float, is_summer: bool):
    """Per-cell heuristic stack before the final smoothing — pure map, no
    gathers; the caller smooths both seasons stacked."""
    itcz_lat = itcz_lookup(itcz_lats, lon) * 0.3
    signed = lat - itcz_lat
    dist_deg = jnp.abs(signed) / DEG
    hemi = jnp.where(signed > 0, 1.0, -1.0)
    zonal = zonal_base(dist_deg)

    abs_lat = jnp.abs(lat) / DEG
    in_summer_hemi = (lat >= 0) if is_summer else (lat < 0)
    season_mod = jnp.where(in_summer_hemi, 1.1, 0.9)
    med = smoothstep(22.0, 30.0, abs_lat) * (1 - smoothstep(38.0, 45.0, abs_lat))
    strength = 0.15 + west_coast * 0.20
    season_mod = season_mod * jnp.where(
        in_summer_hemi & (abs_lat > 22) & (abs_lat < 45),
        1 - med * jnp.maximum(0.0, strength), 1.0)

    cont = jnp.where(is_land, continentality, 0.0)
    cont_mod = jnp.where(cont > 0, 1.0 - cont * cont * 0.65, 1.0)

    we, wn = heuristic_wind(dist_deg, hemi)
    wdg = we * elev_grad_e + wn * elev_grad_n
    uplift = jnp.minimum(1.0, wdg * 15)
    h_km = elev_to_height_km(jnp.maximum(0.0, elev))
    h_scale = jnp.minimum(1.0, h_km / 3)
    shadow = jnp.minimum(1.0, -wdg * 18)
    oro = jnp.where(
        is_land & (elev > 0),
        jnp.where(wdg > 0, 1.0 + uplift * 0.6,
                  jnp.maximum(0.3, 1.0 - shadow * 0.7 * h_scale)),
        1.0)

    dist_km = coast_dist_land * avg_edge_km
    dist_mod = jnp.where(
        is_land & (coast_dist_land > 0) & (dist_km > 2000),
        jnp.maximum(0.03, 1 - smoothstep(2000.0, 3000.0, dist_km)), 1.0)

    precip = jnp.maximum(0.05, zonal * season_mod * cont_mod * oro * dist_mod)
    return precip.astype(jnp.float32)
