"""Precipitation — upwind moisture advection + mechanism stack + rain-shadow
propagation, blended 50-50 with the heuristic zonal model.

Re-design of reference js/precipitation.js. The advection and shadow loops
are directed propagation sweeps: the wind-alignment weights are
loop-invariant, so they are computed once as [N,K] arrays and each sweep is
a masked weighted gather — ~100 full-mesh passes per season in the
reference become fused VPU iterations here.

Both seasons run STACKED ([N,2] fields, [N,K,2] weights): TPU gathers with
arbitrary indices are index-processing bound, so two seasons through one
gather cost about the same as one. The rain-shadow stage goes further and
stacks {shadow, windward} × {summer, winter} into a single [N,4] sweep.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict

import numpy as np
from ..backend import jax
from ..backend import jnp

from ..mesh.device import DeviceGraph
from ..ops.banded import (banded_sum, banded_count, band_shift,
                          smooth_field_banded, compute_gradients_banded)
from .util import (smoothstep, percentile, elev_to_height_km,
                   itcz_lookup, compute_gradients)
from .heuristic_precip import (heuristic_wind_field, heuristic_precip_raw,
                               west_coast_signal)

DEG = math.pi / 180.0


@partial(jax.jit, static_argnames=("band_off",))
def _wind_convergence2(pos, wind3d2, band_off, band_mask, rem_src, rem_dst):
    """Net inward flux per season (js/precipitation.js:19-52). [N,2].

    Banded: -Σ_j (w_j + w_i)·(p_j - p_i) expands into plain neighbor sums
    of per-cell fields (w_j·p_j, w_j, p_j, degree), so the whole stencil is
    ONE banded_sum of an [N,11] stack — no per-edge gather."""
    n = pos.shape[0]
    a2 = jnp.einsum("nsc,nc->ns", wind3d2, pos)             # w_j·p_j
    stack = jnp.concatenate(
        [a2, wind3d2.reshape(n, 6), pos], axis=1)            # [N,11]
    s = banded_sum(stack, band_off, band_mask, rem_src, rem_dst)
    s_a, s_w, s_p = s[:, :2], s[:, 2:8].reshape(n, 2, 3), s[:, 8:11]
    deg = banded_count(band_mask, rem_src, dtype=jnp.float32)
    wp = jnp.einsum("nsc,nc->ns", wind3d2, pos)
    conv = -(s_a - jnp.einsum("nsc,nc->ns", s_w, pos)
             + jnp.einsum("nsc,nc->ns", wind3d2, s_p) - deg[:, None] * wp)
    cnt = jnp.maximum(1.0, deg)[:, None]
    return (conv / cnt).astype(jnp.float32)


# Above this many (padded) cells the loop-invariant [N,D,·] weight stacks
# stop being materialized (512 MB at 1M cells for the [N,D,4] rain-shadow
# stack) and are recomputed per band inside the sweep — a few extra
# roll-shift reads per band against the whole stack living in HBM.
_LAZY_WEIGHTS_ABOVE = 400_000


def _upwind_band_w(pos, wind3d2, off, mask_d, cell_gate=None):
    """[N,2] upwind weight for ONE band offset: wind AT the neighbor
    j = i+off pointing toward i, max(0, wind[j,s]·(p_i − p_j))."""
    w = jnp.einsum("nsc,nc->ns", band_shift(wind3d2, off),
                   pos - band_shift(pos, off))
    m = mask_d if cell_gate is None else (mask_d & cell_gate)
    return jnp.where(m[:, None] & (w > 0), w, 0.0)


def _upwind_rem_w(pos, wind3d2, rem_src, rem_dst, cell_gate=None):
    """Remainder-edge upwind weights [M,2] (the ~0.5% of edges outside the
    Fibonacci bands)."""
    npad = pos.shape[0]
    src = jnp.clip(rem_src, 0, npad - 1)
    wr = jnp.einsum("msc,mc->ms", wind3d2[rem_dst], pos[src] - pos[rem_dst])
    ok = (rem_src < npad)
    if cell_gate is not None:
        ok = ok & cell_gate[src]
    return jnp.where(ok[:, None] & (wr > 0), wr, 0.0)


def _upwind_band_weights(pos, wind3d2, band_off, band_mask, rem_src, rem_dst,
                         cell_gate=None):
    """Materialized upwind weights: banded [N,D,2] + remainder [M,2]
    (loop-invariant; shared by advection and rain shadow at small N)."""
    wb = jnp.stack([_upwind_band_w(pos, wind3d2, off, band_mask[:, d],
                                   cell_gate)
                    for d, off in enumerate(band_off)], axis=1)
    wr = _upwind_rem_w(pos, wind3d2, rem_src, rem_dst, cell_gate)
    return wb, wr


def _banded_weighted_sum(field2, wb, wr, band_off, rem_src, rem_dst):
    """Σ_j w_ij · field[j] for [N,F] fields with banded weights
    wb [N,D,F] / wr [M,F]. Returns [N,F]."""
    out = jnp.zeros_like(field2)
    for d, off in enumerate(band_off):
        out = out + wb[:, d] * band_shift(field2, off)
    return out.at[rem_src].add(wr * field2[rem_dst], mode="drop")


@partial(jax.jit, static_argnames=("band_off", "max_hops"))
def _advect_moisture2(pos, height_km, is_land, wind3d2, warmth2,
                      coast_dist_land, band_off, band_mask, rem_src, rem_dst,
                      max_hops: int):
    """Upwind moisture advection, both seasons stacked
    (js/precipitation.js:59-182). wind3d2: [N,2,3]; warmth2: [N,2].
    Banded: seed geometry via one stacked neighbor sum, the advection loop
    as roll-shifted weighted sums with loop-invariant [N,D,2] weights."""
    n = pos.shape[0]
    # seed moisture (season-independent geometry, per-season warmth):
    # Σ_j ocean_j·{1, p_j, warmth_j} in one [N,6] banded sum
    oc = (~is_land).astype(jnp.float32)
    stack = jnp.concatenate(
        [oc[:, None], oc[:, None] * pos, oc[:, None] * warmth2], axis=1)
    s = banded_sum(stack, band_off, band_mask, rem_src, rem_dst)
    ocean_cnt = s[:, 0]
    ocean_dir = s[:, 1:4] - ocean_cnt[:, None] * pos
    warmth_avg2 = s[:, 4:6] / jnp.maximum(1.0, ocean_cnt)[:, None]
    wind_dot_ocean2 = jnp.einsum("nsc,nc->ns", wind3d2, ocean_dir)
    onshore2 = jnp.where(wind_dot_ocean2 < 0, 1.0, 0.25)
    warmth_factor2 = 0.5 + 0.5 * jnp.clip(warmth_avg2, -0.8, 1.0)
    coast_seed = is_land & (coast_dist_land == 0) & (ocean_cnt > 0)
    moisture2 = jnp.where(
        (~is_land)[:, None], 0.4 + 0.35 * jnp.maximum(0.0, warmth2),
        jnp.where(coast_seed[:, None], onshore2 * warmth_factor2,
                  0.0)).astype(jnp.float32)

    # upwind weights: wind at nb pointing toward r. Materialized as a
    # loop-invariant [N,D,2] stack at small N, recomputed per band inside
    # the sweep at large N (HBM: the stack is 256 MB at 1M cells).
    up_wr = _upwind_rem_w(pos, wind3d2, rem_src, rem_dst)
    if n > _LAZY_WEIGHTS_ABOVE:
        def wsum(field2):
            out = jnp.zeros_like(field2)
            for d, off in enumerate(band_off):
                w = _upwind_band_w(pos, wind3d2, off, band_mask[:, d])
                out = out + w * band_shift(field2, off)
            return out.at[rem_src].add(up_wr * field2[rem_dst], mode="drop")
    else:
        up_wb = jnp.stack(
            [_upwind_band_w(pos, wind3d2, off, band_mask[:, d])
             for d, off in enumerate(band_off)], axis=1)

        def wsum(field2):
            return _banded_weighted_sum(field2, up_wb, up_wr, band_off,
                                        rem_src, rem_dst)

    up_sum2 = wsum(jnp.ones((n, 2), jnp.float32))            # [N,2]
    has_up2 = up_sum2 > 0

    up_height2 = (wsum(jnp.broadcast_to(height_km[:, None], (n, 2)))
                  / jnp.maximum(up_sum2, 1e-20))
    height_gain2 = jnp.maximum(0.0, height_km[:, None] - up_height2)
    depletion_base = 1 - 0.78 ** (1.0 / max_hops)
    elev_depletion2 = jnp.minimum(0.8, height_gain2 * max_hops * 0.55)
    retain2 = jnp.maximum(0.0, 1 - (depletion_base + elev_depletion2))

    wind_ok2 = jnp.einsum("nsc,nsc->ns", wind3d2, wind3d2) >= 1e-6
    active2 = is_land[:, None] & wind_ok2 & has_up2

    def body(_, m):
        incoming = wsum(m) / jnp.maximum(up_sum2, 1e-20)
        carried = incoming * retain2
        return jnp.where(active2, jnp.maximum(m, carried), m)

    return jax.lax.fori_loop(0, max_hops, body, moisture2)


@partial(jax.jit, static_argnames=("max_hops", "lee_hops"))
def _mechanisms2(lat, lon, elev, height_km, is_land, continentality,
                 coast_dist_land, moisture2, convergence2, pressure_dev2,
                 we2, wn2, elev_grad_e, elev_grad_n, dist_itcz2,
                 avg_edge_rad, avg_edge_km, precipitation_offset,
                 land_coverage, max_hops: int, lee_hops: int):
    """The per-cell mechanism stack for both seasons
    (js/precipitation.js:307-487). Column 0 = summer, 1 = winter."""
    abs_lat = (jnp.abs(lat) / DEG)[:, None]
    p = moisture2

    # (a) ITCZ uplift
    itcz_strength = smoothstep(15.0, 0.0, dist_itcz2)
    core = jnp.where(dist_itcz2 < 5, 1.5, 1.0)
    p = jnp.where(dist_itcz2 < 15,
                  p * (1 + itcz_strength * core) + itcz_strength * 0.3, p)

    # (b) convergence boost
    conv_strength = jnp.minimum(1.0, (convergence2 / avg_edge_rad) * 0.055)
    p = jnp.where(convergence2 > 0,
                  p * (1 + conv_strength * 1.2)
                  + conv_strength * moisture2 * 0.4, p)

    # (c) local orographic windward/lee
    wdg2 = we2 * elev_grad_e[:, None] + wn2 * elev_grad_n[:, None]
    uplift = jnp.minimum(1.0, wdg2 * 15)
    shadow = jnp.minimum(1.0, -wdg2 * 18)
    oro_land = (is_land & (elev > 0))[:, None]
    p = jnp.where(oro_land & (wdg2 > 0), p + uplift * 1.0, p)
    p = jnp.where(oro_land & (wdg2 <= 0),
                  p * jnp.maximum(0.02, 1 - shadow * 0.95), p)

    # (d) seasonal subtropical suppression + monsoon relief + pressure mod
    # column s is in local summer where its hemisphere matches the season
    in_local_summer = jnp.stack([lat >= 0, lat < 0], axis=1)
    subtrop_center = jnp.where(in_local_summer, 30.0, 24.0)
    subtrop_width = jnp.where(in_local_summer, 16.0, 12.0)
    subtrop_peak = jnp.where(in_local_summer, 0.50, 0.30)

    poleward_wind2 = jnp.where(lat[:, None] >= 0, wn2, -wn2)
    coast_dist = jnp.where(coast_dist_land >= 0, coast_dist_land,
                           float(max_hops))[:, None]
    coast_prox = 1 - smoothstep(0.0, max_hops * 0.4, coast_dist)
    monsoon = smoothstep(0.0, 0.15, poleward_wind2) * coast_prox
    subtrop_peak = subtrop_peak * jnp.where(
        is_land[:, None] & in_local_summer & (poleward_wind2 > 0),
        1 - monsoon * 0.7, 1.0)

    subtrop_dist = jnp.abs(abs_lat - subtrop_center)
    lat_suppress = jnp.where(
        subtrop_dist < subtrop_width,
        smoothstep(subtrop_width, jnp.zeros_like(subtrop_width),
                   subtrop_dist) * subtrop_peak,
        0.0)
    pressure_mod = jnp.where(
        pressure_dev2 > 0, smoothstep(0.0, 12.0, pressure_dev2) * 0.25,
        -smoothstep(0.0, 15.0, -pressure_dev2) * 0.2)
    total_suppress = lat_suppress + pressure_mod
    p = jnp.where(total_suppress > 0,
                  p * jnp.maximum(0.05, 1 - total_suppress),
                  p * (1 - total_suppress))

    # (e) polar front
    polar = smoothstep(40.0, 70.0, abs_lat)
    inland_fade = 1 - smoothstep(0.0, float(max_hops), coast_dist)
    p = jnp.where(abs_lat > 40,
                  (p + polar * 0.10 + polar * 0.20 * inland_fade)
                  * (1 + polar * 0.15), p)

    # (f) continental dryness
    cont = jnp.where(is_land, continentality, 0.0)[:, None]
    p = jnp.where(cont > 0, p * jnp.maximum(0.03, 1 - cont * cont * 0.55), p)

    # (g) lee cyclogenesis
    p = p + jnp.where(
        is_land[:, None] & (height_km[:, None] > 1.5) & (wdg2 < -0.01)
        & (coast_dist_land[:, None] >= 0)
        & (coast_dist_land[:, None] < lee_hops),
        0.15 * jnp.minimum(1.0, height_km[:, None] / 5), 0.0)

    # ocean baseline
    hp_fade = jnp.where(pressure_dev2 > 0,
                        smoothstep(0.0, 12.0, pressure_dev2), 0.0)
    p = jnp.where((~is_land)[:, None],
                  jnp.maximum(p, 0.15 * (1 - hp_fade)), p)

    # (h) hard coast cutoff
    dist_km = (coast_dist_land * avg_edge_km)[:, None]
    fade = 1 - smoothstep(2000.0, 3000.0, dist_km)
    p = jnp.where(is_land[:, None] & (coast_dist_land[:, None] > 0)
                  & (dist_km > 2000),
                  p * jnp.maximum(0.03, fade), p)

    p = p * (1 + precipitation_offset * 0.5)
    t_lc = jnp.maximum(0.0, (land_coverage - 0.4) / 0.6)
    p = p * (1 - t_lc * t_lc * 0.98)
    return jnp.maximum(0.0, p).astype(jnp.float32)


def _rain_shadow2(pos, elev, height_km, is_land, wind3d2, wdg2,
                  band_off, band_mask, rem_src, rem_dst,
                  shadow_hops: int, windward_hops: int):
    """Rain shadow: the hop-synchronous banded loop."""
    return _rain_shadow2_jnp(pos, elev, height_km, is_land, wind3d2, wdg2,
                band_off, band_mask, rem_src, rem_dst,
                shadow_hops, windward_hops)


def _shadow_seeds2(elev, height_km, is_land, wdg2):
    """[N,2] signed seed field: + windward uplift, − lee shadow on ≥0.8 km
    slopes (js/precipitation.js:500-516)."""
    h_scale = jnp.minimum(1.0, (height_km - 0.5) / 2.5)[:, None]
    seed_ok = (is_land & (elev > 0) & (height_km >= 0.8))[:, None]
    return jnp.where(
        seed_ok & (wdg2 > 0), jnp.minimum(1.0, wdg2 * 20) * h_scale,
        jnp.where(seed_ok & (wdg2 < 0),
                  -jnp.minimum(1.0, -wdg2 * 18) * h_scale,
                  0.0)).astype(jnp.float32)


@partial(jax.jit, static_argnames=("band_off", "shadow_hops",
                                   "windward_hops"))
def _rain_shadow2_jnp(pos, elev, height_km, is_land, wind3d2, wdg2,
                      band_off, band_mask, rem_src, rem_dst,
                      shadow_hops: int, windward_hops: int):
    """Rain-shadow diagnostic for both seasons: seed on ≥0.8 km slopes,
    propagate shadow downwind / windward rain upwind
    (js/precipitation.js:496-607). {shadow, windward} × {summer, winter}
    stack into ONE [N,4] banded sweep loop (the wind-aligned weights are
    loop-invariant [N,D,4] band arrays). Returns [N,2]."""
    npad = pos.shape[0]
    h_scale = jnp.minimum(1.0, (height_km - 0.5) / 2.5)[:, None]
    seed_ok = (is_land & (elev > 0) & (height_km >= 0.8))[:, None]
    seed2 = jnp.where(
        seed_ok & (wdg2 > 0), jnp.minimum(1.0, wdg2 * 20) * h_scale,
        jnp.where(seed_ok & (wdg2 < 0),
                  -jnp.minimum(1.0, -wdg2 * 18) * h_scale,
                  0.0)).astype(jnp.float32)

    # up: wind AT the neighbor toward the receiver; dn: wind AT the receiver
    # toward the neighbor — both gated on receiver land.
    def band_w4(d, off):
        """[N,4] weights {up×2, dn×2} for one band offset."""
        delta = band_shift(pos, off) - pos
        up = jnp.einsum("nsc,nc->ns", band_shift(wind3d2, off), -delta)
        dn = jnp.einsum("nsc,nc->ns", wind3d2, delta)
        m = band_mask[:, d] & is_land
        w4 = jnp.concatenate([up, dn], axis=1)
        return jnp.where(m[:, None] & (w4 > 0), w4, 0.0)

    up_wr = _upwind_rem_w(pos, wind3d2, rem_src, rem_dst, cell_gate=is_land)
    src = jnp.clip(rem_src, 0, npad - 1)
    dn_r = jnp.einsum("msc,mc->ms", wind3d2[src], pos[rem_dst] - pos[src])
    dn_wr = jnp.where(((rem_src < npad) & is_land[src])[:, None]
                      & (dn_r > 0), dn_r, 0.0)

    s_dec = 1 - 0.15 ** (1.0 / shadow_hops)
    w_dec = 1 - 0.25 ** (1.0 / windward_hops)

    f0 = jnp.concatenate([seed2, seed2], axis=1)            # [N,4]
    if npad > _LAZY_WEIGHTS_ABOVE:
        get_w4 = band_w4                  # recompute per band in the sweep
    else:
        w4b = jnp.stack([band_w4(d, off)
                         for d, off in enumerate(band_off)], axis=1)

        def get_w4(d, off):
            return w4b[:, d]
    w4r = jnp.concatenate([up_wr, dn_wr], axis=1)            # [M,4]
    sign4 = np.asarray([-1.0, -1.0, 1.0, 1.0], np.float32)
    decay4 = np.asarray([s_dec, s_dec, w_dec, w_dec], np.float32)
    cap4 = np.asarray([shadow_hops, shadow_hops,
                       windward_hops, windward_hops], np.int32)

    def body(i, s):
        wsum = jnp.zeros_like(s)
        wacc = jnp.zeros_like(s)
        for d, off in enumerate(band_off):
            vals = band_shift(s, off)                       # [N,4]
            w = jnp.where(vals * sign4[None, :] > 0, get_w4(d, off), 0.0)
            wsum = wsum + w
            wacc = wacc + w * vals
        vals_r = s[rem_dst]
        w_r = jnp.where(vals_r * sign4[None, :] > 0, w4r, 0.0)
        wsum = wsum.at[rem_src].add(w_r, mode="drop")
        wacc = wacc.at[rem_src].add(w_r * vals_r, mode="drop")
        carried = wacc / jnp.maximum(wsum, 1e-20) * (1 - decay4)[None, :]
        ext = jnp.where(sign4[None, :] < 0,
                        jnp.minimum(s, carried), jnp.maximum(s, carried))
        upd = (wsum > 0) & (i < cap4)[None, :]
        return jnp.where(upd, ext, s)

    f = jax.lax.fori_loop(0, max(shadow_hops, windward_hops), body, f0)
    shadow2 = jnp.minimum(f[:, :2], seed2)
    windward2 = jnp.maximum(f[:, 2:], seed2)
    return jnp.where(shadow2 < 0, shadow2, windward2).astype(jnp.float32)


def compute_precipitation(g: DeviceGraph, elev, wind: Dict, ocean: Dict,
                          precipitation_offset: float = 0.0,
                          land_coverage: float = 0.3) -> Dict:
    n = g.n_cells
    avg_edge_km = (math.pi * 6371) / math.sqrt(n)
    avg_edge_rad = math.pi / math.sqrt(n)
    max_hops = max(8, min(20, round(2000 / avg_edge_km)))

    lat, lon = wind["r_lat"], wind["r_lon"]
    is_land = wind["r_is_land"]
    cont = wind["r_continentality"]
    coast_dist = wind["r_coast_dist_land"]
    east, north = wind["r_east"], wind["r_north"]

    # smoothed elevation gradients (js/precipitation.js:216-233)
    elev_passes = max(2, round(200 / avg_edge_km))
    elev_sm = smooth_field_banded(elev.astype(jnp.float32), *g.bands,
                                  elev_passes)
    elev_sm = elev_sm * 0.6 + elev * 0.4
    grad_e, grad_n = compute_gradients_banded(g.pos, elev_sm, east, north,
                                              *g.bands)
    height_km = elev_to_height_km(jnp.maximum(0.0, elev))

    conv_passes = max(3, round(400 / avg_edge_km))
    shadow_hops = max(8, round(2500 / avg_edge_km))
    windward_hops = max(6, round(1500 / avg_edge_km))
    rs_passes = max(2, round(150 / avg_edge_km))
    precip_passes = max(1, round(100 / avg_edge_km))
    wc_passes = max(2, round(300 / avg_edge_km))

    # per-season wind (50-50 blend with the heuristic zonal wind,
    # js/precipitation.js:262-270), stacked [N,2]
    we_l, wn_l, itcz_l = [], [], []
    for name in ("summer", "winter"):
        itcz_lats = wind[f"itcz_lats_{name}"]
        h_we, h_wn = heuristic_wind_field(lat, lon, itcz_lats)
        we_l.append(0.5 * wind[f"r_wind_east_{name}"] + 0.5 * h_we)
        wn_l.append(0.5 * wind[f"r_wind_north_{name}"] + 0.5 * h_wn)
        itcz_l.append(itcz_lookup(itcz_lats, lon))
    we2 = jnp.stack(we_l, 1)
    wn2 = jnp.stack(wn_l, 1)
    dist_itcz2 = jnp.abs(lat[:, None] - jnp.stack(itcz_l, 1)) / DEG
    wind3d2 = (we2[:, :, None] * east[:, None, :]
               + wn2[:, :, None] * north[:, None, :])      # [N,2,3]
    warmth2 = jnp.stack([ocean["r_ocean_warmth_summer"],
                         ocean["r_ocean_warmth_winter"]], 1)
    pressure2 = jnp.stack([wind["r_pressure_summer"],
                           wind["r_pressure_winter"]], 1)

    conv2 = _wind_convergence2(g.pos, wind3d2, *g.bands)
    conv2 = smooth_field_banded(conv2, *g.bands, conv_passes)

    moisture2 = _advect_moisture2(g.pos, height_km, is_land, wind3d2,
                                  warmth2, coast_dist, *g.bands, max_hops)

    precip2 = _mechanisms2(
        lat, lon, elev, height_km, is_land, cont, coast_dist,
        moisture2, conv2, pressure2, we2, wn2, grad_e, grad_n, dist_itcz2,
        jnp.float32(avg_edge_rad), jnp.float32(avg_edge_km),
        jnp.float32(precipitation_offset), jnp.float32(land_coverage),
        max_hops, max(2, round(200 / avg_edge_km)))

    wdg2 = we2 * grad_e[:, None] + wn2 * grad_n[:, None]
    rs2 = _rain_shadow2(g.pos, elev, height_km, is_land, wind3d2, wdg2,
                        *g.bands, shadow_hops, windward_hops)
    rs2 = smooth_field_banded(rs2, *g.bands, rs_passes)

    # apply propagated shadow (js/precipitation.js:616-627)
    strength = jnp.minimum(1.0, -rs2 * 2.25)
    precip2 = jnp.where(is_land[:, None] & (rs2 < -0.01),
                        precip2 * jnp.maximum(0.02, 1 - strength * 0.92),
                        precip2)
    precip2 = jnp.where(is_land[:, None] & (rs2 > 0.01),
                        precip2 + rs2 * 1.2, precip2)

    precip2 = smooth_field_banded(precip2, *g.bands, precip_passes)

    # heuristic blend (js/precipitation.js:644-679) — west-coast signal is
    # season-independent (computed once); both seasons smooth stacked
    west_coast = west_coast_signal(g.pos, is_land, coast_dist, east,
                                   *g.bands, wc_passes)
    heur2 = jnp.stack([
        heuristic_precip_raw(lat, lon, elev, is_land, cont, coast_dist,
                             grad_e, grad_n, west_coast,
                             wind[f"itcz_lats_{name}"], avg_edge_km,
                             name == "summer")
        for name in ("summer", "winter")], 1)
    heur2 = smooth_field_banded(heur2, *g.bands, precip_passes)

    blended2 = 0.5 * precip2 + 0.5 * heur2
    cap = 1.0 - smoothstep(0.5, 1.0, cont) * 0.80

    result = {}
    for s, name in enumerate(("summer", "winter")):
        blended = blended2[:, s]
        p95 = percentile(blended, 0.95, g.valid)
        blended = jnp.minimum(1.0, blended / p95)
        blended = jnp.where(is_land & (cont > 0.5),
                            jnp.minimum(blended, cap), blended)
        result[f"r_precip_{name}"] = blended.astype(jnp.float32)
        result[f"r_rainshadow_{name}"] = rs2[:, s]
    return result
