"""Temperature — ITCZ-based curves, moisture-dependent lapse, ocean
warmth, maritime/continental seasonal swing; the JAX package's
climate/temperature.py in torch. The diffused-ocean-warmth loop runs
through the smoothing kernel; everything else is a per-cell map. Output
normalized to [0,1] over −45..+45 °C."""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..mesh.device import DeviceGraph
from ..ops.banded import banded_count, smooth_field_banded, smooth_passes
from .util import smoothstep, elev_to_height_km, itcz_lookup

DEG = math.pi / 180.0
T_MIN, T_MAX = -45.0, 45.0


def _diffuse_ocean_warmth(warmth2, is_land, plate_cont, band_off,
                          band_mask, rem_src, rem_dst, passes: int):
    """js/temperature.js:19-54 — all cells diffuse except deep continental
    interiors (plate continentality ≥ 0.95), which keep their value but
    still contribute (the JAX ``_diffuse_warmth_jnp`` restores them after
    every pass). Both seasons diffuse stacked ([N,2])."""
    field = torch.where((~is_land)[:, None], warmth2, 0.0).to(torch.float32)
    thaw = (plate_cont < 0.95).to(torch.float32)
    c = 1 + banded_count(band_mask, rem_src, dtype=torch.float32)
    return smooth_passes(field, c, band_off, band_mask, rem_src, rem_dst,
                         passes, upd=thaw)


def _temperature_kernel(lat, lon, elev, is_land, cont, p_cont, itcz_lats,
                        warmth, speed, precip, coastal_warmth,
                        temperature_offset: float, is_summer: bool):
    tropical_hw = 13.0
    max_dist = 90.0 - tropical_hw

    itcz_lat = itcz_lookup(itcz_lats, lon)
    dist_itcz = torch.abs(lat - itcz_lat) / DEG
    t_itcz = torch.clamp(dist_itcz - tropical_hw, min=0.0) / max_dist
    T_i = 28 - 47 * torch.pow(t_itcz, 1.4)

    flat_itcz = (5.0 if is_summer else -5.0) * DEG
    dist_flat = torch.abs(lat - flat_itcz) / DEG
    t_flat = torch.clamp(dist_flat - tropical_hw, min=0.0) / max_dist
    T_f = 28 - 47 * torch.pow(t_flat, 1.4)

    abs_lat = torch.abs(lat) / DEG
    blend = smoothstep(45.0, 90.0, abs_lat)
    T = T_i * (1 - blend) + T_f * blend

    lapse = 4.5 + 4.8 * (1 - precip)
    h_km = elev_to_height_km(elev)
    T = T - torch.where(is_land & (elev > 0), lapse * h_km, 0.0)

    # ocean SST shift / coastal diffused warmth (js/temperature.js:151-165)
    T = T + torch.where(
        ~is_land, warmth * torch.clamp(speed * 2, max=1.0) * 16,
        torch.where(torch.abs(coastal_warmth) > 0.001,
                    coastal_warmth * (1 - smoothstep(0.0, 0.95, p_cont))
                    * 20, 0.0))

    # cloud moderation (js/temperature.js:167-180)
    T = torch.where(precip > 0.5,
                    T * (1 - smoothstep(0.5, 1.0, precip) * 0.15), T)
    T = torch.where(precip < 0.3,
                    T * (1 + smoothstep(0.3, 0.0, precip) * 0.15), T)

    # maritime/continental seasonal swing (js/temperature.js:186-208)
    dist_ann = abs_lat
    t_ann = torch.clamp(dist_ann - tropical_hw, min=0.0) / max_dist
    T_annual = 28 - 47 * torch.pow(t_ann, 1.4)
    T_ann_adj = torch.where(is_land & (elev > 0), T_annual - lapse * h_km,
                            T_annual)
    deviation = T - T_ann_adj
    seasonal_boost = 12 * smoothstep(10.0, 55.0, dist_ann) * (
        1 - smoothstep(75.0, 90.0, dist_ann))
    is_local_summer = (lat >= 0) if is_summer else (lat < 0)
    season_sign = torch.where(is_local_summer, 1.0, -1.0)
    maritime = 0.50 + cont * 0.70
    T = T_ann_adj + (deviation + season_sign * seasonal_boost) * maritime

    return (T + temperature_offset).to(torch.float32)


def compute_temperature(g: DeviceGraph, elev, wind: Dict, ocean: Dict,
                        precip: Dict, temperature_offset: float = 0.0
                        ) -> Dict:
    n = g.n_cells
    avg_edge_km = (math.pi * 6371) / math.sqrt(n)
    warmth_passes = max(4, round(1400 / avg_edge_km))

    lat, lon = wind["r_lat"], wind["r_lon"]
    is_land = wind["r_is_land"]
    cont = wind["r_continentality"]
    p_cont = wind["r_plate_continentality"]

    warmth2 = torch.stack([ocean["r_ocean_warmth_summer"],
                           ocean["r_ocean_warmth_winter"]], 1)
    coastal2 = _diffuse_ocean_warmth(warmth2, is_land, p_cont, *g.bands,
                                     warmth_passes)

    t_l = []
    for s, name in enumerate(("summer", "winter")):
        t_l.append(_temperature_kernel(
            lat, lon, elev, is_land, cont, p_cont,
            wind[f"itcz_lats_{name}"], warmth2[:, s],
            ocean[f"r_ocean_speed_{name}"], precip[f"r_precip_{name}"],
            coastal2[:, s], temperature_offset,
            is_summer=(name == "summer")))
    t2 = smooth_field_banded(torch.stack(t_l, 1), *g.bands, 1)

    result = {}
    for s, name in enumerate(("summer", "winter")):
        result[f"r_temperature_{name}"] = torch.clamp(
            (t2[:, s] - T_MIN) / (T_MAX - T_MIN), 0.0, 1.0)
    return result
