"""Color maps — elementwise torch re-designs of js/color-map.js and the
export color functions in js/planet-mesh.js:61-100, on any device. Each
takes [...] tensors and returns [..., 3] float32 colors on their device."""

from __future__ import annotations

import numpy as np
import torch

from ..climate.util import elev_to_height_km

# Satellite-view biome palette indexed by Köppen id (js/color-map.js:16-47);
# index 0 (Ocean) delegated to the elevation ramp.
BIOME_COLORS = np.array([
    [0.30, 0.50, 0.20],  # 0 Ocean placeholder (unused)
    [0.05, 0.30, 0.05], [0.08, 0.33, 0.07], [0.42, 0.50, 0.18],
    [0.82, 0.72, 0.50], [0.60, 0.55, 0.48], [0.72, 0.62, 0.30],
    [0.55, 0.52, 0.32], [0.18, 0.42, 0.12], [0.12, 0.38, 0.10],
    [0.10, 0.28, 0.10], [0.45, 0.48, 0.22], [0.40, 0.45, 0.20],
    [0.35, 0.40, 0.20], [0.20, 0.44, 0.14], [0.15, 0.40, 0.12],
    [0.12, 0.32, 0.10], [0.12, 0.36, 0.08], [0.10, 0.32, 0.08],
    [0.06, 0.22, 0.08], [0.05, 0.18, 0.07], [0.38, 0.38, 0.18],
    [0.35, 0.35, 0.17], [0.08, 0.22, 0.08], [0.06, 0.18, 0.07],
    [0.14, 0.36, 0.10], [0.12, 0.32, 0.09], [0.07, 0.22, 0.08],
    [0.05, 0.18, 0.07], [0.35, 0.32, 0.22], [0.78, 0.80, 0.84],
], dtype=np.float32)

ROCK_COLOR = np.asarray([0.42, 0.38, 0.32], np.float32)
SNOW_COLOR = np.asarray([0.92, 0.93, 0.96], np.float32)


# altitude thresholds [alpine, snow] per Köppen id (js/color-map.js:56-68)
def _thresholds_table():
    out = np.zeros((31, 2), np.float32)
    for cid in range(31):
        if cid <= 0:
            t = (0.0, 0.0)
        elif cid <= 3:
            t = (3.5, 5.5)
        elif cid <= 7:
            t = (3.0, 5.0)
        elif cid <= 16:
            t = (2.0, 3.5)
        elif cid <= 18 or cid in (21, 22, 25, 26):
            t = (1.5, 3.0)
        elif cid <= 28:
            t = (0.8, 2.0)
        elif cid == 29:
            t = (0.4, 1.5)
        else:
            t = (0.0, 0.5)
        out[cid] = t
    return out


ALTITUDE_THRESHOLDS = _thresholds_table()


def table(rows, like: torch.Tensor) -> torch.Tensor:
    """A numpy / list color table as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(rows, np.float32), device=like.device)


def gray(t) -> torch.Tensor:
    return torch.stack([t, t, t], dim=-1).to(torch.float32)


def elevation_to_color(e):
    """Terrain ramp (js/color-map.js:116-125). Returns [N,3]."""
    segs = [
        (-0.50, None, [0.04, 0.06, 0.30], None),
        (-0.10, -0.50, [0.04, 0.06, 0.30], [0.11, 0.20, 0.48]),
        (0.00, -0.10, [0.11, 0.20, 0.48], [0.30, 0.42, 0.60]),
        (0.03, 0.00, [0.72, 0.68, 0.46], [0.80, 0.66, 0.36]),
        (0.25, 0.03, [0.20, 0.54, 0.12], [0.14, 0.42, 0.20]),
        (0.50, 0.25, [0.14, 0.42, 0.20], [0.44, 0.28, 0.14]),
        (0.75, 0.50, [0.44, 0.28, 0.14], [0.60, 0.40, 0.32]),
    ]
    t_top = torch.clamp((e - 0.75) / 0.20, max=1.0)
    rgb = [0.60 + t_top * 0.35, 0.40 + t_top * 0.50, 0.32 + t_top * 0.60]
    for hi, lo, c0, c1 in reversed(segs):
        below = e < hi
        if lo is None:
            rgb = [torch.where(below, c0[i], rgb[i]) for i in range(3)]
        else:
            t = (e - lo) / (hi - lo)
            rgb = [torch.where(below, c0[i] + t * (c1[i] - c0[i]), rgb[i])
                   for i in range(3)]
    return torch.stack(rgb, dim=-1).to(torch.float32)


def biome_color(koppen_id, elevation):
    """Satellite biome color with alpine/snow lines (js/color-map.js:73-114)."""
    kid = torch.clamp(koppen_id.long(), 0, 30)
    base = table(BIOME_COLORS, elevation)[kid]
    h = elev_to_height_km(elevation)
    thr = table(ALTITUDE_THRESHOLDS, elevation)[kid]
    alpine, snow = thr[..., 0], thr[..., 1]

    c = base
    dark = torch.where(h < 0.2, 0.93 + 0.07 * (h / 0.2), 1.0)
    c = c * dark[..., None]
    t_mid = torch.clamp((h - 0.2) / torch.clamp(alpine - 0.2, min=1e-6),
                        0.0, 1.0)
    darken = torch.where((alpine > 0) & (h > 0.2) & (h < alpine),
                         1.0 - t_mid * 0.15, 1.0)
    c = c * darken[..., None]
    rock_zone = torch.where(snow > alpine, snow - alpine, 2.0)
    rock_t = torch.clamp((h - alpine) / torch.clamp(rock_zone, min=1e-6),
                         0.0, 1.0)
    s_rock = torch.where((alpine > 0) & (h > alpine), rock_t * rock_t, 0.0)
    c = c + (table(ROCK_COLOR, c) - c) * s_rock[..., None]
    snow_t = torch.clamp((h - snow) / 2.5, 0.0, 1.0)
    s_snow = torch.where((snow > 0) & (h > snow), snow_t * snow_t, 0.0)
    c = c + (table(SNOW_COLOR, c) - c) * s_snow[..., None]

    ocean = (koppen_id == 0) | (elevation <= 0)
    return torch.where(ocean[..., None], elevation_to_color(elevation), c)


def heightmap_color(elevation):
    """Absolute -5..6 km grayscale (js/planet-mesh.js:64-68)."""
    h = elev_to_height_km(elevation)
    return gray(torch.clamp((h + 5) / 11, 0.0, 1.0))


def land_heightmap_color(elevation):
    """Ocean black, land 0..6 km grayscale (js/planet-mesh.js:71-75)."""
    t = torch.clamp(elev_to_height_km(elevation) / 6, 0.0, 1.0)
    return gray(torch.where(elevation <= 0, 0.0, t))


def land_mask_color(elevation):
    return gray(torch.where(elevation > 0, 1.0, 0.0))
