"""Region picking and cell inspection — the edit-mode/hover-card API.

The reference picks regions analytically (O(N) max-dot nearest region, no
mesh raycast — js/edit-mode.js:18-98) and shows a hover card with elevation
km, lat/lon, temperature, precipitation and Köppen class
(js/edit-mode.js:101-163). Here the same surface is an argmax on the
result's device plus a pure lookup over a ``PlanetResult``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..climate.koppen import KOPPEN_CODES
from ..climate.util import elev_to_height_km


def _query(lat_deg: float, lon_deg: float) -> np.ndarray:
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    return np.asarray([math.cos(lat) * math.sin(lon), math.sin(lat),
                       math.cos(lat) * math.cos(lon)], np.float32)


def nearest_region(result, lat_deg: float, lon_deg: float) -> int:
    """Cell index nearest to (lat, lon) in degrees — the globe/map picking
    primitive (js/edit-mode.js:18-98). Y-up frame with lon = atan2(x, z),
    matching the mesh/export convention. Runs on the device of the
    result's elevation."""
    dev = result.elevation.device
    g = result.graph
    pos = torch.as_tensor(g.pos, device=dev)
    qx, qy, qz = (float(v) for v in _query(lat_deg, lon_deg))
    # three products and two adds in a fixed order: the same score bits
    # on the card as on the CPU, so both pick the same cell
    score = pos[:, 0] * qx + pos[:, 1] * qy + pos[:, 2] * qz
    valid = torch.as_tensor(g.valid, device=dev)
    return int(torch.argmax(torch.where(valid, score, -2.0)))


def _at(x, cell: int) -> float:
    return float(x[cell])


def cell_info(result, cell: int) -> Dict:
    """Hover-card fields for one cell (js/edit-mode.js:101-163): lat/lon,
    elevation km, plate id/type, and (when climate was computed) summer and
    winter temperature °C, precipitation, and the Köppen code string."""
    g = result.graph
    if not (0 <= cell < g.n_cells):
        raise ValueError(f"cell {cell} out of range [0, {g.n_cells})")
    x, y, z = (float(v) for v in g.pos[cell])
    lat = math.degrees(math.asin(max(-1.0, min(1.0, y))))
    lon = math.degrees(math.atan2(x, z))
    elev = _at(result.elevation, cell)
    plate = int(result.r_plate[cell])
    info: Dict = dict(
        cell=cell, lat=lat, lon=lon,
        elevation=elev,
        height_km=float(elev_to_height_km(torch.tensor(elev,
                                                       dtype=torch.float32))),
        plate=plate,
        plate_is_ocean=bool(result.plate_is_ocean[plate]),
        stress=_at(result.stress, cell),
    )
    cl = result.climate
    if cl is not None:
        def temp_c(t01):
            return -45.0 + max(0.0, min(1.0, t01)) * 90.0
        info.update(
            temperature_summer_c=temp_c(_at(
                cl["temp"]["r_temperature_summer"], cell)),
            temperature_winter_c=temp_c(_at(
                cl["temp"]["r_temperature_winter"], cell)),
            precip_summer=_at(cl["precip"]["r_precip_summer"], cell),
            precip_winter=_at(cl["precip"]["r_precip_winter"], cell),
            koppen=KOPPEN_CODES[int(cl["koppen"][cell])],
        )
    return info
