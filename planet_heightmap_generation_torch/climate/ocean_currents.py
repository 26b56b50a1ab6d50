"""Ocean currents — rule-based wind-belt gyres with coast deflection; the
JAX package's climate/ocean_currents.py in torch: coast side
classification, circumpolar channel detection (72 longitude bins), the
per-season zonal base flow with western intensification / eastern
equatorward deflection, ocean-masked smoothing (the smoothing kernel),
geographic warmth with heavy smoothing, p95 speed normalization."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..mesh.device import DeviceGraph
from ..ops.banded import (bfs_hops_multi_banded, smooth_masked_banded,
                          banded_sum, dot3)
from .util import smoothstep, percentile95, itcz_lookup
from .wind import coast_threshold, climate_coast_cap
from ..parallel import spmd

DEG = math.pi / 180.0


def _coast_classification(pos, is_ocean, east, band_off, band_mask,
                          rem_src, rem_dst):
    """West/east coast seeds from land-direction · east
    (js/ocean.js:13-55); Σ_j land_j (p_j − p_i) as neighbour sums."""
    land_f = (~is_ocean).to(torch.float32)
    stack = torch.cat([land_f[:, None], land_f[:, None] * pos], 1)
    ssum = banded_sum(stack, band_off, band_mask, rem_src, rem_dst)
    land_dir = ssum[:, 1:4] - ssum[:, 0:1] * pos
    coast = is_ocean & (ssum[:, 0] > 0)
    normal_e = dot3(land_dir, east)
    west = coast & ((normal_e < -0.2)
                    | ((normal_e >= -0.2) & (normal_e <= 0.2)
                       & (normal_e <= 0)))
    return coast, west, coast & (~west)


def _circumpolar(lat, lon, is_ocean, valid, target_lat, band):
    """All 72 longitude bins have ocean within the band?
    (js/ocean.js:91-111). A 0-d bool tensor."""
    nb = 72
    # the band edges are f32 sums of f32 arguments, as in the JAX function
    lo = float(np.float32(target_lat) - np.float32(band))
    hi = float(np.float32(target_lat) + np.float32(band))
    in_band = is_ocean & valid & (lat >= lo) & (lat <= hi)
    b = torch.clamp(((lon + math.pi) / (2 * math.pi) * nb).to(torch.int64),
                    0, nb - 1)
    b = torch.where(in_band, b, nb)
    hits = torch.bincount(b, minlength=nb + 1)[:nb]
    return torch.all(hits > 0)


def _circumpolar2(lat, lon, is_ocean, valid):
    """(northern, southern) circumpolar channels at ±60°."""
    return (_circumpolar(lat, lon, is_ocean, valid, 60 * DEG, 5 * DEG),
            _circumpolar(lat, lon, is_ocean, valid, -60 * DEG, 5 * DEG))


def _season_vectors(lat, lon, is_ocean, itcz_lats, west_dist, east_dist,
                    circ_nh, circ_sh, coast_thr: float, shift_deg: float):
    """Base zonal flow + coast deflection + circumpolar override
    (js/ocean.js:266-333)."""
    abs_lat_deg = torch.abs(lat) / DEG
    hemi = torch.where(lat >= 0, 1.0, -1.0)
    band_lat = torch.abs(lat / DEG - shift_deg)
    itcz_lat = itcz_lookup(itcz_lats, lon)
    dist_itcz = torch.abs(lat - itcz_lat) / DEG

    base_e = torch.where(
        dist_itcz < 3, 1 - 2 * smoothstep(0.0, 3.0, dist_itcz),
        torch.where(band_lat < 30, -1.0,
        torch.where(band_lat < 35, -1 + 2 * smoothstep(30.0, 35.0, band_lat),
        torch.where(band_lat < 58, 1.0,
        torch.where(band_lat < 65, 1 - 1.5 * smoothstep(58.0, 65.0, band_lat),
                    -0.5)))))

    cur_e = base_e
    cur_n = torch.zeros_like(base_e)

    w_ok = (west_dist >= 0) & (west_dist < coast_thr)
    tw = 1 - west_dist / coast_thr
    cur_n = cur_n + torch.where(w_ok, hemi * tw * tw * 2.0, 0.0)
    cur_e = cur_e * torch.where(w_ok, 1 - tw * tw * 0.7, 1.0)

    e_ok = (east_dist >= 0) & (east_dist < coast_thr)
    te = 1 - east_dist / coast_thr
    cur_n = cur_n - torch.where(e_ok, hemi * te * te * 0.8, 0.0)
    cur_e = cur_e * torch.where(e_ok, 1 - te * te * 0.5, 1.0)

    is_circ = ((lat > 0) & circ_nh) | ((lat < 0) & circ_sh)
    c_ok = is_circ & (abs_lat_deg >= 55) & (abs_lat_deg <= 75)
    cs = 1 - torch.abs(abs_lat_deg - 65) / 10
    cur_e = torch.where(c_ok, cur_e * (1 - cs) + 1.5 * cs, cur_e)
    cur_n = torch.where(c_ok, cur_n * (1 - cs * 0.8), cur_n)

    cur_e = torch.where(is_ocean, cur_e, 0.0)
    cur_n = torch.where(is_ocean, cur_n, 0.0)
    return cur_e, cur_n


def _classify_warmth(is_ocean, lat, west_dist, east_dist, fade_range: float,
                     shift_deg: float):
    """Coast-side × wind-cell warmth (js/ocean.js:120-164)."""
    band_lat = torch.abs(lat / DEG - shift_deg)
    cell_sign = torch.where(
        band_lat < 28, 1.0,
        torch.where(band_lat < 35, 1 - 2 * smoothstep(28.0, 35.0, band_lat),
        torch.where(band_lat < 55, -1.0,
        torch.where(band_lat < 65, -1 + 2 * smoothstep(55.0, 65.0, band_lat),
                    1.0))))
    warm = torch.zeros_like(lat)
    w_ok = (west_dist >= 0) & (west_dist < fade_range)
    tw = 1 - west_dist / fade_range
    warm = warm + torch.where(w_ok, cell_sign * tw * tw, 0.0)
    e_ok = (east_dist >= 0) & (east_dist < fade_range)
    te = 1 - east_dist / fade_range
    warm = warm - torch.where(e_ok, cell_sign * te * te, 0.0)
    return torch.where(is_ocean, torch.clamp(warm, -1.0, 1.0), 0.0)


def compute_ocean_currents(g: DeviceGraph, elev, wind: Dict,
                           coast_d=None) -> Dict:
    """``coast_d``: precomputed columns 2-4 of the merged climate coast BFS
    (wind.coast_bfs_seeds) — all/west/east coast distances through ocean;
    relaxed here when None."""
    n = g.n_cells
    avg_edge_km = (math.pi * 6371) / math.sqrt(n)
    is_ocean = (~wind["r_is_land"]) & g.valid
    lat, lon = wind["r_lat"], wind["r_lon"]

    if coast_d is None:
        coast, west, east_c = _coast_classification(
            g.pos, is_ocean, wind["r_east"], *g.bands)
        barrier = ~is_ocean
        coast_d = bfs_hops_multi_banded(
            torch.stack([coast, west, east_c], 1),
            torch.stack([barrier, barrier, barrier], 1),
            *g.bands, max_hops=climate_coast_cap(n))
    # inf → the reference's -1 convention
    d_west = torch.where(torch.isfinite(coast_d[:, 1]), coast_d[:, 1], -1.0)
    d_east = torch.where(torch.isfinite(coast_d[:, 2]), coast_d[:, 2], -1.0)

    circ_nh, circ_sh = spmd.gathered(_circumpolar2, lat, lon, is_ocean,
                                     g.valid)

    thr = coast_threshold(n)
    warmth_range = thr * 2
    smooth_passes = max(2, round(125 / avg_edge_km))
    warmth_passes = max(3, round(900 / avg_edge_km))

    cur_l, warm_l = [], []
    for name, shift in (("summer", 5.0), ("winter", -5.0)):
        itcz_lats = wind[f"itcz_lats_{name}"]
        cur_e, cur_n = _season_vectors(lat, lon, is_ocean, itcz_lats, d_west,
                                       d_east, circ_nh, circ_sh, float(thr),
                                       shift)
        cur_l += [cur_e, cur_n]
        warm_l.append(_classify_warmth(is_ocean, lat, d_west, d_east,
                                       float(warmth_range), shift))

    # both seasons' vectors (and warmths) smooth stacked
    cur4 = smooth_masked_banded(torch.stack(cur_l, 1), is_ocean, *g.bands,
                                smooth_passes)
    cur4 = torch.where(is_ocean[:, None], cur4, 0.0)
    warm2 = smooth_masked_banded(torch.stack(warm_l, 1), is_ocean, *g.bands,
                                 warmth_passes)

    result = {}
    for s, name in enumerate(("summer", "winter")):
        cur_e, cur_n = cur4[:, 2 * s], cur4[:, 2 * s + 1]
        speed = torch.sqrt(cur_e * cur_e + cur_n * cur_n)
        p95 = spmd.gathered(percentile95, speed, is_ocean & (speed > 0))
        speed = torch.clamp(speed / p95, max=1.0)
        result[f"r_ocean_current_east_{name}"] = cur_e
        result[f"r_ocean_current_north_{name}"] = cur_n
        result[f"r_ocean_speed_{name}"] = speed
        result[f"r_ocean_warmth_{name}"] = warm2[:, s]
    return result
