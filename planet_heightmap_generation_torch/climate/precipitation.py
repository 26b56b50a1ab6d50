"""Precipitation — upwind moisture advection, the mechanism stack and the
rain-shadow propagation, blended 50-50 with the heuristic zonal model; the
JAX package's climate/precipitation.py in torch.

Both seasons run stacked ([N,2] fields). The advection loop is plain torch
(20 hops of 32-band weighted sums; the JAX package has no kernel for it).
The rain shadow stacks {shadow, windward} × {summer, winter} into one
[4, N] state and runs all its hops in one launch of the rain-shadow kernel
of ops/sweep_cuda.py, which computes each edge's wind-aligned weights on
the first hop and reads them back on the others.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..mesh.device import DeviceGraph
from ..ops import sweep_cuda
from ..ops.banded import (banded_sum, banded_count, band_shift, dot3,
                          pack_band_bits, rem_csr, smooth_field_banded,
                          compute_gradients_banded, rem_add, rem_gather)
from ..parallel import spmd
from ..pipeline.timing import span
from .util import (smoothstep, percentile95, elev_to_height_km,
                   itcz_lookup)
from .heuristic_precip import (heuristic_wind_field, heuristic_precip_raw,
                               west_coast_signal)

DEG = math.pi / 180.0


def _dot_sc(w2, v):
    """The jnp einsum "nsc,nc->ns": [N,S,3]·[N,3] → [N,S]."""
    return dot3(w2, v[:, None, :])


def _wind_convergence2(pos, wind3d2, band_off, band_mask, rem_src,
                       rem_dst):
    """Net inward flux per season (js/precipitation.js:19-52), [N,2]:
    −Σ_j (w_j + w_i)·(p_j − p_i) expanded into neighbour sums of per-cell
    fields, ONE banded_sum of an [N,11] stack."""
    n = pos.shape[0]
    a2 = _dot_sc(wind3d2, pos)                                 # w_j·p_j
    stack = torch.cat([a2, wind3d2.reshape(n, 6), pos], 1)     # [N,11]
    s = banded_sum(stack, band_off, band_mask, rem_src, rem_dst)
    s_a, s_w, s_p = s[:, :2], s[:, 2:8].reshape(n, 2, 3), s[:, 8:11]
    deg = banded_count(band_mask, rem_src, dtype=torch.float32)
    wp = _dot_sc(wind3d2, pos)
    conv = -(s_a - _dot_sc(s_w, pos) + _dot_sc(wind3d2, s_p)
             - deg[:, None] * wp)
    cnt = torch.clamp(deg, min=1.0)[:, None]
    return (conv / cnt).to(torch.float32)


def _upwind_band_w(pos, wind3d2, off, mask_d):
    """[N,2] upwind weight for ONE band offset: the wind AT the neighbour
    j = i+off pointing toward i, max(0, wind[j,s]·(p_i − p_j))."""
    w = _dot_sc(band_shift(wind3d2, off), pos - band_shift(pos, off))
    return torch.where(mask_d[:, None] & (w > 0), w, 0.0)


def _upwind_rem_w(pos, wind3d2, rem_src, rem_dst):
    """Remainder-edge upwind weights [M,2]."""
    wr = _dot_sc(rem_gather(wind3d2, rem_dst),
                 pos[rem_src] - rem_gather(pos, rem_dst))
    return torch.where(wr > 0, wr, 0.0)


def _advect_moisture2(pos, height_km, is_land, wind3d2, warmth2,
                      coast_dist_land, band_off, band_mask, rem_src,
                      rem_dst, max_hops: int):
    """Upwind moisture advection, both seasons stacked
    (js/precipitation.js:59-182), with loop-invariant [N,D,2] upwind
    weights (the JAX path below 400K cells)."""
    n = pos.shape[0]
    # seed moisture: Σ_j ocean_j·{1, p_j, warmth_j} in one [N,6] sum
    oc = (~is_land).to(torch.float32)
    stack = torch.cat([oc[:, None], oc[:, None] * pos,
                       oc[:, None] * warmth2], 1)
    s = banded_sum(stack, band_off, band_mask, rem_src, rem_dst)
    ocean_cnt = s[:, 0]
    ocean_dir = s[:, 1:4] - ocean_cnt[:, None] * pos
    warmth_avg2 = s[:, 4:6] / torch.clamp(ocean_cnt, min=1.0)[:, None]
    wind_dot_ocean2 = _dot_sc(wind3d2, ocean_dir)
    onshore2 = torch.where(wind_dot_ocean2 < 0, 1.0, 0.25)
    warmth_factor2 = 0.5 + 0.5 * torch.clamp(warmth_avg2, -0.8, 1.0)
    coast_seed = is_land & (coast_dist_land == 0) & (ocean_cnt > 0)
    moisture2 = torch.where(
        (~is_land)[:, None], 0.4 + 0.35 * torch.clamp(warmth2, min=0.0),
        torch.where(coast_seed[:, None], onshore2 * warmth_factor2,
                    0.0)).to(torch.float32)

    up_wr = _upwind_rem_w(pos, wind3d2, rem_src, rem_dst)
    up_wb = [_upwind_band_w(pos, wind3d2, off, band_mask[:, d])
             for d, off in enumerate(band_off)]

    def wsum(field2):
        out = torch.zeros_like(field2)
        for d, off in enumerate(band_off):
            out = out + up_wb[d] * band_shift(field2, off)
        return rem_add(out, up_wr * rem_gather(field2, rem_dst), rem_src,
                       rem_dst)

    up_sum2 = wsum(torch.ones((n, 2), dtype=torch.float32,
                              device=pos.device))
    has_up2 = up_sum2 > 0

    up_height2 = (wsum(height_km[:, None].expand(n, 2).contiguous())
                  / torch.clamp(up_sum2, min=1e-20))
    height_gain2 = torch.clamp(height_km[:, None] - up_height2, min=0.0)
    depletion_base = 1 - 0.78 ** (1.0 / max_hops)
    elev_depletion2 = torch.clamp(height_gain2 * max_hops * 0.55, max=0.8)
    retain2 = torch.clamp(1 - (depletion_base + elev_depletion2), min=0.0)

    wind_ok2 = dot3(wind3d2, wind3d2) >= 1e-6
    active2 = is_land[:, None] & wind_ok2 & has_up2

    m = moisture2
    for _ in range(max_hops):
        incoming = wsum(m) / torch.clamp(up_sum2, min=1e-20)
        carried = incoming * retain2
        m = torch.where(active2, torch.maximum(m, carried), m)
    return m


def _mechanisms2(lat, lon, elev, height_km, is_land, continentality,
                 coast_dist_land, moisture2, convergence2, pressure_dev2,
                 we2, wn2, elev_grad_e, elev_grad_n, dist_itcz2,
                 avg_edge_rad: float, avg_edge_km: float,
                 precipitation_offset: float, land_coverage: float,
                 max_hops: int, lee_hops: int):
    """The per-cell mechanism stack for both seasons
    (js/precipitation.js:307-487). Column 0 = summer, 1 = winter."""
    abs_lat = (torch.abs(lat) / DEG)[:, None]
    p = moisture2

    # (a) ITCZ uplift
    itcz_strength = smoothstep(15.0, 0.0, dist_itcz2)
    core = torch.where(dist_itcz2 < 5, 1.5, 1.0)
    p = torch.where(dist_itcz2 < 15,
                    p * (1 + itcz_strength * core) + itcz_strength * 0.3, p)

    # (b) convergence boost
    conv_strength = torch.clamp((convergence2 / avg_edge_rad) * 0.055,
                                max=1.0)
    p = torch.where(convergence2 > 0,
                    p * (1 + conv_strength * 1.2)
                    + conv_strength * moisture2 * 0.4, p)

    # (c) local orographic windward/lee
    wdg2 = we2 * elev_grad_e[:, None] + wn2 * elev_grad_n[:, None]
    uplift = torch.clamp(wdg2 * 15, max=1.0)
    shadow = torch.clamp(-wdg2 * 18, max=1.0)
    oro_land = (is_land & (elev > 0))[:, None]
    p = torch.where(oro_land & (wdg2 > 0), p + uplift * 1.0, p)
    p = torch.where(oro_land & (wdg2 <= 0),
                    p * torch.clamp(1 - shadow * 0.95, min=0.02), p)

    # (d) seasonal subtropical suppression + monsoon relief + pressure mod
    in_local_summer = torch.stack([lat >= 0, lat < 0], 1)
    subtrop_center = torch.where(in_local_summer, 30.0, 24.0)
    subtrop_width = torch.where(in_local_summer, 16.0, 12.0)
    subtrop_peak = torch.where(in_local_summer, 0.50, 0.30)

    poleward_wind2 = torch.where(lat[:, None] >= 0, wn2, -wn2)
    coast_dist = torch.where(coast_dist_land >= 0, coast_dist_land,
                             float(max_hops))[:, None]
    coast_prox = 1 - smoothstep(0.0, max_hops * 0.4, coast_dist)
    monsoon = smoothstep(0.0, 0.15, poleward_wind2) * coast_prox
    subtrop_peak = subtrop_peak * torch.where(
        is_land[:, None] & in_local_summer & (poleward_wind2 > 0),
        1 - monsoon * 0.7, 1.0)

    subtrop_dist = torch.abs(abs_lat - subtrop_center)
    lat_suppress = torch.where(
        subtrop_dist < subtrop_width,
        smoothstep(subtrop_width, torch.zeros_like(subtrop_width),
                   subtrop_dist) * subtrop_peak,
        0.0)
    pressure_mod = torch.where(
        pressure_dev2 > 0, smoothstep(0.0, 12.0, pressure_dev2) * 0.25,
        -smoothstep(0.0, 15.0, -pressure_dev2) * 0.2)
    total_suppress = lat_suppress + pressure_mod
    p = torch.where(total_suppress > 0,
                    p * torch.clamp(1 - total_suppress, min=0.05),
                    p * (1 - total_suppress))

    # (e) polar front
    polar = smoothstep(40.0, 70.0, abs_lat)
    inland_fade = 1 - smoothstep(0.0, float(max_hops), coast_dist)
    p = torch.where(abs_lat > 40,
                    (p + polar * 0.10 + polar * 0.20 * inland_fade)
                    * (1 + polar * 0.15), p)

    # (f) continental dryness
    cont = torch.where(is_land, continentality, 0.0)[:, None]
    p = torch.where(cont > 0,
                    p * torch.clamp(1 - cont * cont * 0.55, min=0.03), p)

    # (g) lee cyclogenesis
    p = p + torch.where(
        is_land[:, None] & (height_km[:, None] > 1.5) & (wdg2 < -0.01)
        & (coast_dist_land[:, None] >= 0)
        & (coast_dist_land[:, None] < lee_hops),
        0.15 * torch.clamp(height_km[:, None] / 5, max=1.0), 0.0)

    # ocean baseline
    hp_fade = torch.where(pressure_dev2 > 0,
                          smoothstep(0.0, 12.0, pressure_dev2), 0.0)
    p = torch.where((~is_land)[:, None],
                    torch.maximum(p, 0.15 * (1 - hp_fade)), p)

    # (h) hard coast cutoff
    dist_km = (coast_dist_land * avg_edge_km)[:, None]
    fade = 1 - smoothstep(2000.0, 3000.0, dist_km)
    p = torch.where(is_land[:, None] & (coast_dist_land[:, None] > 0)
                    & (dist_km > 2000),
                    p * torch.clamp(fade, min=0.03), p)

    # the slider terms are f32 arithmetic on f32 scalars, as in the JAX
    # function (which receives them as traced f32 values)
    f32 = np.float32
    p = p * float(f32(1) + f32(precipitation_offset) * f32(0.5))
    t_lc = max(f32(0), (f32(land_coverage) - f32(0.4)) / f32(0.6))
    p = p * float(f32(1) - t_lc * t_lc * f32(0.98))
    return torch.clamp(p, min=0.0).to(torch.float32)


def _shadow_seeds2(elev, height_km, is_land, wdg2):
    """[N,2] signed seed field: + windward uplift, − lee shadow on ≥ 0.8 km
    slopes (js/precipitation.js:500-516)."""
    h_scale = torch.clamp((height_km - 0.5) / 2.5, max=1.0)[:, None]
    seed_ok = (is_land & (elev > 0) & (height_km >= 0.8))[:, None]
    return torch.where(
        seed_ok & (wdg2 > 0), torch.clamp(wdg2 * 20, max=1.0) * h_scale,
        torch.where(seed_ok & (wdg2 < 0),
                    -torch.clamp(-wdg2 * 18, max=1.0) * h_scale,
                    0.0)).to(torch.float32)


def shadow_retain(shadow_hops: int, windward_hops: int):
    """Per-hop retention of the shadow and windward columns, 1 − f32(decay)
    rounded to f32, as the JAX package computes it."""
    s_dec = 1 - 0.15 ** (1.0 / shadow_hops)
    w_dec = 1 - 0.25 ** (1.0 / windward_hops)
    retain = np.float32(1.0) - np.asarray([s_dec, w_dec], np.float32)
    return float(retain[0]), float(retain[1])


def _rain_shadow2(pos, elev, height_km, is_land, wind3d2, wdg2, band_off,
                  band_mask, rem_src, rem_dst, shadow_hops: int,
                  windward_hops: int):
    """Rain-shadow diagnostic for both seasons (js/precipitation.js:
    496-607): seed on ≥ 0.8 km slopes, propagate shadow downwind and
    windward rain upwind, all hops in one launch of the rain-shadow kernel
    (ops/sweep_cuda.py ``shadow_relax``); the windward columns stop after
    ``windward_hops`` hops and the shadow columns after ``shadow_hops``
    (the JAX per-column cap ``i < cap4``). Returns [N,2]."""
    seed2 = _shadow_seeds2(elev, height_km, is_land, wdg2)
    state = torch.cat([seed2, seed2], 1).T.contiguous()          # [4,N]
    aux = torch.cat([pos.T, wind3d2[:, 0].T, wind3d2[:, 1].T],
                    0).to(torch.float32).contiguous()            # [9,N]
    land = is_land.to(torch.float32).contiguous()
    bits = pack_band_bits(band_mask)
    ptr, nbr = rem_csr(rem_src, rem_dst, pos.shape[0])
    retain_s, retain_w = shadow_retain(shadow_hops, windward_hops)
    state, _ = spmd.launch("shadow_relax", sweep_cuda.shadow_relax, state,
                           aux, land, bits, band_off, ptr, nbr, retain_s,
                           retain_w, shadow_hops, windward_hops)
    f = state.T
    shadow2 = torch.minimum(f[:, :2], seed2)
    windward2 = torch.maximum(f[:, 2:], seed2)
    return torch.where(shadow2 < 0, shadow2, windward2).to(torch.float32)


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
    with span("Precipitation: gradients"):
        elev_passes = max(2, round(200 / avg_edge_km))
        elev_sm = smooth_field_banded(elev.to(torch.float32), *g.bands,
                                      elev_passes)
        elev_sm = elev_sm * 0.6 + elev * 0.4
        grad_e, grad_n = compute_gradients_banded(g.pos, elev_sm, east, north,
                                                  *g.bands)
        height_km = elev_to_height_km(torch.clamp(elev, min=0.0))

    conv_passes = max(3, round(400 / avg_edge_km))
    shadow_hops = max(8, round(2500 / avg_edge_km))
    windward_hops = max(6, round(1500 / avg_edge_km))
    rs_passes = max(2, round(150 / avg_edge_km))
    precip_passes = max(1, round(100 / avg_edge_km))
    wc_passes = max(2, round(300 / avg_edge_km))

    # per-season wind (50-50 blend with the heuristic zonal wind,
    # js/precipitation.js:262-270), stacked [N,2]
    with span("Precipitation: seasonal blend"):
        we_l, wn_l, itcz_l = [], [], []
        for name in ("summer", "winter"):
            itcz_lats = wind[f"itcz_lats_{name}"]
            h_we, h_wn = heuristic_wind_field(lat, lon, itcz_lats)
            we_l.append(0.5 * wind[f"r_wind_east_{name}"] + 0.5 * h_we)
            wn_l.append(0.5 * wind[f"r_wind_north_{name}"] + 0.5 * h_wn)
            itcz_l.append(itcz_lookup(itcz_lats, lon))
        we2 = torch.stack(we_l, 1)
        wn2 = torch.stack(wn_l, 1)
        dist_itcz2 = torch.abs(lat[:, None] - torch.stack(itcz_l, 1)) / DEG
        wind3d2 = (we2[:, :, None] * east[:, None, :]
                   + wn2[:, :, None] * north[:, None, :])            # [N,2,3]
        warmth2 = torch.stack([ocean["r_ocean_warmth_summer"],
                               ocean["r_ocean_warmth_winter"]], 1)
        pressure2 = torch.stack([wind["r_pressure_summer"],
                                 wind["r_pressure_winter"]], 1)

    with span("Precipitation: convergence"):
        conv2 = _wind_convergence2(g.pos, wind3d2, *g.bands)
        conv2 = smooth_field_banded(conv2, *g.bands, conv_passes)

    with span("Precipitation: moisture advection"):
        moisture2 = _advect_moisture2(g.pos, height_km, is_land, wind3d2,
                                      warmth2, coast_dist, *g.bands, max_hops)

    with span("Precipitation: mechanisms"):
        f32 = np.float32
        precip2 = _mechanisms2(
            lat, lon, elev, height_km, is_land, cont, coast_dist,
            moisture2, conv2, pressure2, we2, wn2, grad_e, grad_n, dist_itcz2,
            float(f32(avg_edge_rad)), float(f32(avg_edge_km)),
            float(f32(precipitation_offset)), float(f32(land_coverage)),
            max_hops, max(2, round(200 / avg_edge_km)))

    with span("Precipitation: rain shadow"):
        wdg2 = we2 * grad_e[:, None] + wn2 * grad_n[:, None]
        rs2 = _rain_shadow2(g.pos, elev, height_km, is_land, wind3d2, wdg2,
                            *g.bands, shadow_hops, windward_hops)
        rs2 = smooth_field_banded(rs2, *g.bands, rs_passes)

        # apply propagated shadow (js/precipitation.js:616-627)
        strength = torch.clamp(-rs2 * 2.25, max=1.0)
        precip2 = torch.where(is_land[:, None] & (rs2 < -0.01),
                              precip2 * torch.clamp(1 - strength * 0.92,
                                                    min=0.02),
                              precip2)
        precip2 = torch.where(is_land[:, None] & (rs2 > 0.01),
                              precip2 + rs2 * 1.2, precip2)

    with span("Precipitation: heuristic blend"):
        precip2 = smooth_field_banded(precip2, *g.bands, precip_passes)

        # heuristic blend (js/precipitation.js:644-679): the west-coast signal
        # is season-independent; both seasons smooth stacked
        west_coast = west_coast_signal(g.pos, is_land, coast_dist, east,
                                       *g.bands, wc_passes)
        heur2 = torch.stack([
            heuristic_precip_raw(lat, lon, elev, is_land, cont, coast_dist,
                                 grad_e, grad_n, west_coast,
                                 wind[f"itcz_lats_{name}"], avg_edge_km,
                                 name == "summer")
            for name in ("summer", "winter")], 1)
        heur2 = smooth_field_banded(heur2, *g.bands, precip_passes)

        blended2 = 0.5 * precip2 + 0.5 * heur2
        cap = 1.0 - smoothstep(0.5, 1.0, cont) * 0.80

    with span("Precipitation: normalise"):
        result = {}
        for s, name in enumerate(("summer", "winter")):
            blended = blended2[:, s]
            p95 = spmd.gathered(percentile95, blended, g.valid)
            blended = torch.clamp(blended / p95, max=1.0)
            blended = torch.where(is_land & (cont > 0.5),
                                  torch.minimum(blended, cap), blended)
            result[f"r_precip_{name}"] = blended.to(torch.float32)
            result[f"r_rainshadow_{name}"] = rs2[:, s]
    return result
