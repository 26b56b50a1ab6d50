"""Inspect layers — the full per-cell visualization surface.

The reference exposes 26 inspect layers in a dropdown (reference
index.html:286-325) colored by per-layer maps in js/planet-mesh.js
(diverging debug :83-93, precipitation :96-116, rain shadow :118-131,
continentality :133-158, temperature bands :160-172, ocean currents
:505-529, plates :180-197) and js/color-map.js (terrain ramp, biome). Here
each layer is a name → [N,3] float32 color tensor computed from a
``PlanetResult`` on the result's device; renderers and the PNG exporter
consume them uniformly. Every color map is elementwise torch over [N]
fields.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .colors import (elevation_to_color, biome_color, heightmap_color,
                     land_heightmap_color, land_mask_color, table)
from ..climate.koppen import KOPPEN_COLORS


# ── scalar color maps ─────────────────────────────────────────────────


def diverging_color(v, scale=1.0):
    """Blue ← 0 → red diverging map for the signed geology debug layers
    (js/planet-mesh.js:83-93 equivalent)."""
    t = torch.clamp(v * scale, -1.0, 1.0)
    pos = torch.clamp(t, min=0.0)
    neg = torch.clamp(-t, min=0.0)
    return torch.stack([0.93 - 0.83 * neg, 0.93 - 0.73 * (pos + neg),
                        0.93 - 0.83 * pos], dim=-1).to(torch.float32)


def magnitude_color(v, scale=1.0):
    """White → saturated red for non-negative magnitude layers (stress,
    wind speed): 0 = pale, 1 = strong."""
    t = torch.clamp(v * scale, 0.0, 1.0)
    return torch.stack([0.95 - 0.10 * t, 0.95 - 0.80 * t, 0.95 - 0.85 * t],
                       dim=-1).to(torch.float32)


def precipitation_color(p):
    """Brown (arid) → green → blue (wet) ramp
    (js/planet-mesh.js:96-116 equivalent)."""
    t = torch.clamp(p, 0.0, 1.0)
    # two-segment blend: brown→green over [0,0.5), green→blue over [0.5,1]
    t1 = torch.clamp(t / 0.5, 0.0, 1.0)
    t2 = torch.clamp((t - 0.5) / 0.5, 0.0, 1.0)
    brown = table([0.55, 0.40, 0.20], t)
    green = table([0.15, 0.55, 0.20], t)
    blue = table([0.10, 0.30, 0.75], t)
    c = brown + (green - brown) * t1[..., None]
    c = torch.where(t[..., None] > 0.5, green + (blue - green) * t2[..., None],
                    c)
    return c.to(torch.float32)


def rain_shadow_color(s):
    """Windward (teal, s>0) vs shadowed (orange, s<0)
    (js/planet-mesh.js:118-131 equivalent)."""
    t = torch.clamp(s, -1.0, 1.0)
    wind = torch.clamp(t, min=0.0)
    shad = torch.clamp(-t, min=0.0)
    r = 0.92 - 0.75 * wind + 0.03 * shad
    g = 0.92 - 0.25 * wind - 0.45 * shad
    b = 0.92 - 0.20 * wind - 0.80 * shad
    return torch.stack([torch.clamp(r, 0, 1), torch.clamp(g, 0, 1),
                        torch.clamp(b, 0, 1)], dim=-1).to(torch.float32)


def continentality_color(c):
    """Ocean-blue → coastal green → deep-interior ochre
    (js/planet-mesh.js:133-158 equivalent)."""
    t = torch.clamp(c, 0.0, 1.0)
    coast = table([0.25, 0.60, 0.40], t)
    interior = table([0.75, 0.55, 0.20], t)
    return (coast + (interior - coast) * t[..., None]).to(torch.float32)


def temperature_color(t01):
    """Cold blue → white → hot red banded ramp on the fixed −45..45 °C
    normalization (js/planet-mesh.js:160-172 equivalent)."""
    t = torch.clamp(t01, 0.0, 1.0)
    # quantize to 12 bands like the reference's discrete legend
    tq = torch.floor(t * 12) / 12
    cold = table([0.15, 0.25, 0.75], t)
    mid = table([0.93, 0.93, 0.90], t)
    hot = table([0.80, 0.15, 0.10], t)
    lo = cold + (mid - cold) * torch.clamp(tq / 0.5, 0, 1)[..., None]
    hi = mid + (hot - mid) * torch.clamp((tq - 0.5) / 0.5, 0, 1)[..., None]
    return torch.where(tq[..., None] < 0.5, lo, hi).to(torch.float32)


def pressure_color(p_anom_hpa):
    """Diverging pressure-anomaly map (low = purple, high = orange); the
    wind stage stores pressure − 1013 hPa."""
    t = torch.clamp(p_anom_hpa / 25.0, -1.0, 1.0)
    low = table([0.45, 0.20, 0.65], t)
    mid = table([0.93, 0.93, 0.93], t)
    high = table([0.90, 0.55, 0.15], t)
    c_lo = mid + (low - mid) * torch.clamp(-t, min=0.0)[..., None]
    c_hi = mid + (high - mid) * torch.clamp(t, min=0.0)[..., None]
    return torch.where(t[..., None] < 0, c_lo, c_hi).to(torch.float32)


def current_color(warmth, speed):
    """Ocean-current layer: warm currents red, cold blue, intensity by
    speed (js/planet-mesh.js:505-529 equivalent)."""
    s = torch.clamp(speed, 0.0, 1.0)
    w = torch.clamp(warmth, -1.0, 1.0)
    base = table([0.15, 0.20, 0.35], w)
    tint = torch.where(w[..., None] >= 0, table([0.85, 0.25, 0.15], w),
                       table([0.20, 0.55, 0.95], w))
    amt = (torch.abs(w) * s)[..., None]
    return (base + (tint - base) * amt).to(torch.float32)


def plate_colors(r_plate, plate_is_ocean, num_plates: int,
                 valid=None) -> torch.Tensor:
    """Distinct per-plate colors, green-family for land plates and
    blue-family for ocean plates (js/planet-mesh.js:180-197 equivalent).
    Hues are golden-angle spaced per plate id for maximal separation."""
    ids = np.arange(num_plates)
    hue_t = (ids * 0.6180339887) % 1.0
    light = 0.35 + 0.35 * ((ids * 0.7548776662) % 1.0)
    is_ocean = np.asarray(plate_is_ocean)[:num_plates]

    # land: hue 70°-150° (greens); ocean: 190°-260° (blues)
    hue = np.where(is_ocean, 190 + hue_t * 70, 70 + hue_t * 80) / 360.0
    sat = np.where(is_ocean, 0.55, 0.50)

    def hsl_to_rgb(h, s, l):
        c = (1 - np.abs(2 * l - 1)) * s
        hp = h * 6.0
        x = c * (1 - np.abs(hp % 2 - 1))
        m = l - c / 2
        r = np.select([hp < 1, hp < 2, hp < 3, hp < 4, hp < 5],
                      [c, x, 0, 0, x], default=c)
        g = np.select([hp < 1, hp < 2, hp < 3, hp < 4, hp < 5],
                      [x, c, c, x, 0], default=0)
        b = np.select([hp < 1, hp < 2, hp < 3, hp < 4, hp < 5],
                      [0, 0, x, c, c], default=x)
        return np.stack([r + m, g + m, b + m], axis=-1)

    colors = table(hsl_to_rgb(hue, sat, light), r_plate)
    out = colors[torch.clamp(r_plate.long(), 0, num_plates - 1)]
    if valid is not None:
        out = torch.where(valid[..., None], out, 0.0)
    return out


# ── the layer registry ────────────────────────────────────────────────

GEOLOGY_DEBUG = ["base", "tectonic", "noise", "interior", "coastal",
                 "ocean", "hotspot", "backArc", "foldRidge",
                 "orogenicPower", "margins", "erosionDelta"]

LAYERS: List[str] = [
    "terrain", "biome", "koppen", "heightmap", "landheightmap", "landmask",
    "plates", "stress", "tecActivity", "superPlates",
    "pressureSummer", "pressureWinter", "windSpeedSummer", "windSpeedWinter",
    "continentality", "precipSummer", "precipWinter",
    "rainShadowSummer", "rainShadowWinter", "tempSummer", "tempWinter",
    "currents",
] + GEOLOGY_DEBUG


def available_layers(result) -> List[str]:
    """Layers computable from this result (climate layers require climate)."""
    out = ["terrain", "heightmap", "landheightmap", "landmask", "plates",
           "stress"]
    dbg = result.debug or {}
    out += [l for l in GEOLOGY_DEBUG + ["tecActivity", "superPlates"]
            if l in dbg]
    if result.climate is not None:
        out += ["biome", "koppen", "currents"]
        out += [l for l in LAYERS if l in dbg and l not in out]
    return out


def koppen_color(kop) -> torch.Tensor:
    """The reference's Köppen class colors (js/koppen.js:19-51)."""
    return table(KOPPEN_COLORS, kop)[
        torch.clamp(kop.long(), 0, len(KOPPEN_COLORS) - 1)]


def layer_color(result, name: str) -> torch.Tensor:
    """[N,3] float colors for the named inspect layer of a PlanetResult."""
    e = result.elevation
    dbg = result.debug or {}
    cl = result.climate

    if name == "terrain":
        return elevation_to_color(e)
    if name == "heightmap":
        return heightmap_color(e)
    if name == "landheightmap":
        return land_heightmap_color(e)
    if name == "landmask":
        return land_mask_color(e)
    if name == "plates":
        return plate_colors(result.r_plate, result.plate_is_ocean,
                            len(result.plate_is_ocean))
    if name == "stress":
        return magnitude_color(result.stress)
    if name in ("biome", "koppen"):
        if cl is None:
            raise ValueError(f"layer {name!r} requires climate")
        kop = cl["koppen"]
        if name == "koppen":
            return koppen_color(kop)
        return biome_color(kop, e)
    if name == "currents":
        if cl is None:
            raise ValueError("layer 'currents' requires climate")
        oc = cl["ocean"]
        return current_color(oc["r_ocean_warmth_summer"],
                             oc["r_ocean_speed_summer"])
    if name.startswith(("pressure", "windSpeed", "precip", "rainShadow",
                        "temp")) or name == "continentality":
        # climate-derived debug layers share the ValueError contract of
        # biome/koppen/currents when climate was skipped
        if name not in dbg:
            raise ValueError(f"layer {name!r} requires climate")
        if name.startswith("pressure"):
            return pressure_color(dbg[name])
        if name.startswith("windSpeed"):
            return magnitude_color(dbg[name])
        if name == "continentality":
            return continentality_color(dbg[name])
        if name.startswith("precip"):
            return precipitation_color(dbg[name])
        if name.startswith("rainShadow"):
            return rain_shadow_color(dbg[name])
        return temperature_color(dbg[name])
    if name == "superPlates":
        if name not in dbg:
            raise ValueError("layer 'superPlates' not recorded "
                             "(needs >=8 plates and a full generate)")
        sp = dbg[name].to(torch.int32)
        n_sp = int(sp.max()) + 1
        return plate_colors(sp, np.zeros(max(n_sp, 1), bool), max(n_sp, 1))
    if name == "tecActivity":
        if name not in dbg:
            raise ValueError("layer 'tecActivity' not recorded "
                             "(imported planets have no tectonic assembly)")
        return magnitude_color(dbg[name])
    if name in GEOLOGY_DEBUG:
        if name not in dbg:
            raise ValueError(f"debug layer {name!r} not recorded")
        return diverging_color(dbg[name], scale=3.0)
    raise ValueError(f"unknown layer {name!r}")
