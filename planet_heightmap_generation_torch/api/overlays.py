"""Overlay geometry — wind/current arrows, ITCZ polylines, plate borders,
lat/lon grids.

The reference draws these as Three.js line segments (wind arrows with
3°-binned nearest-region sampling js/planet-mesh.js:1289-1542, ocean-current
arrows :1545-1749, super-plate black borders :531-617, lat/lon grids
:384-503, ITCZ spline polyline on pressure layers). The port is
renderer-agnostic: each overlay returns plain numpy arrays (unit-sphere
points, tangent vectors, per-arrow scalars, index pairs) that any
frontend — the reference's Three.js scene included — can upload directly.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..interop import to_numpy

_SAMPLE_CHUNK = 512


def _nearest_chunk(q, pos, valid):
    """Nearest valid cell of each of the [chunk, 3] queries: the argmax of
    the [chunk, NP] scores, a full-float32 product (no TF32 on the card)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        score = q @ pos.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.argmax(torch.where(valid[None, :], score, -2.0), dim=1)


def _grid_sample_cells(graph, spacing_deg: float, device) -> np.ndarray:
    """Nearest region per lat/lon bin center (js/planet-mesh.js:1300-1340's
    binning, computed exactly with an argmax on ``device`` per bin chunk).
    Chunking (512 bin centers at a time) bounds the [chunk, NP] score
    matrix to 512 rows whatever the spacing: the default 3° spacing is 7200
    bins."""
    lats = np.arange(-90 + spacing_deg / 2, 90, spacing_deg)
    lons = np.arange(-180 + spacing_deg / 2, 180, spacing_deg)
    glat, glon = np.meshgrid(np.radians(lats), np.radians(lons), indexing="ij")
    q = np.stack([np.cos(glat) * np.sin(glon),
                  np.sin(glat),
                  np.cos(glat) * np.cos(glon)], axis=-1).reshape(-1, 3)
    q = torch.as_tensor(q.astype(np.float32), device=device)
    pos = torch.as_tensor(graph.pos, device=device)
    valid = torch.as_tensor(graph.valid, device=device)
    out = [_nearest_chunk(c, pos, valid)
           for c in torch.split(q, _SAMPLE_CHUNK)]
    return torch.cat(out).cpu().numpy()


def _tangent_frames(pos: np.ndarray):
    """East/north unit tangents in the Y-up frame (lon = atan2(x, z))."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    lon = np.arctan2(x, z)
    east = np.stack([np.cos(lon), np.zeros_like(lon), -np.sin(lon)], axis=-1)
    north = np.cross(pos, east)
    north /= np.maximum(1e-12, np.linalg.norm(north, axis=-1))[:, None]
    return east, north


def _arrow_field(graph, east_c, north_c, speed_c, extra: Dict,
                 spacing_deg: float, mask: Optional[np.ndarray] = None):
    cells = _grid_sample_cells(graph, spacing_deg, east_c.device)
    cells = np.unique(cells)
    if mask is not None:
        cells = cells[mask[cells]]
    pos = graph.pos[cells]
    east, north = _tangent_frames(pos)
    e = to_numpy(east_c)[cells]
    n = to_numpy(north_c)[cells]
    s = to_numpy(speed_c)[cells]
    direction = east * e[:, None] + north * n[:, None]
    nrm = np.maximum(1e-12, np.linalg.norm(direction, axis=-1))
    out = dict(
        cells=cells, origin=pos.astype(np.float32),
        direction=(direction / nrm[:, None]).astype(np.float32),
        speed=s.astype(np.float32),
    )
    for k, field in extra.items():
        out[k] = to_numpy(field)[cells].astype(np.float32)
    return out


def wind_arrows(result, season: str = "summer",
                spacing_deg: float = 3.0) -> Dict:
    """Arrow field for the wind overlay: unit origins on the sphere, unit
    tangent directions, and normalized speeds (js/planet-mesh.js:1289-1542).
    One arrow per ~spacing_deg bin, deduplicated to distinct regions."""
    if result.climate is None:
        raise ValueError("wind overlay requires climate")
    w = result.climate["wind"]
    return _arrow_field(
        result.graph, w[f"r_wind_east_{season}"], w[f"r_wind_north_{season}"],
        w[f"r_wind_speed_{season}"], {}, spacing_deg)


def ocean_current_arrows(result, season: str = "summer",
                         spacing_deg: float = 3.0) -> Dict:
    """Current arrows with per-arrow warmth for coloring
    (js/planet-mesh.js:1545-1749); emitted only on ocean cells."""
    if result.climate is None:
        raise ValueError("current overlay requires climate")
    oc = result.climate["ocean"]
    is_ocean = to_numpy(result.elevation) <= 0
    return _arrow_field(
        result.graph, oc[f"r_ocean_current_east_{season}"],
        oc[f"r_ocean_current_north_{season}"], oc[f"r_ocean_speed_{season}"],
        dict(warmth=oc[f"r_ocean_warmth_{season}"]), spacing_deg,
        mask=is_ocean)


def itcz_polyline(result, season: str = "summer") -> np.ndarray:
    """[M,3] unit-sphere polyline of the ITCZ spline for the pressure
    overlay (js/planet-mesh.js ITCZ polyline)."""
    if result.climate is None:
        raise ValueError("ITCZ overlay requires climate")
    w = result.climate["wind"]
    lons = to_numpy(w["itcz_lons"])
    lats = to_numpy(w[f"itcz_lats_{season}"])
    return np.stack([np.cos(lats) * np.sin(lons),
                     np.sin(lats),
                     np.cos(lats) * np.cos(lons)], axis=-1).astype(np.float32)


def plate_border_edges(result, super_plates: bool = False) -> np.ndarray:
    """[E,2] cell-index pairs straddling a plate (or super-plate) boundary —
    the data behind the black border overlay (js/planet-mesh.js:531-617).
    Each undirected edge appears once (i < j)."""
    g = result.graph
    labels = to_numpy(result.r_plate)[: g.n_cells]
    if super_plates:
        sp = (result.debug or {}).get("superPlates")
        if sp is None:
            raise ValueError("no super-plate layer recorded for this planet")
        labels = to_numpy(sp).astype(np.int64)[: g.n_cells]
    nbr = g.nbr_idx[: g.n_cells]
    msk = g.nbr_mask[: g.n_cells]
    src = np.repeat(np.arange(g.n_cells), nbr.shape[1])
    dst = nbr.reshape(-1)
    ok = msk.reshape(-1) & (dst < g.n_cells) & (src < dst)
    src, dst = src[ok], dst[ok]
    diff = labels[src] != labels[dst]
    return np.stack([src[diff], dst[diff]], axis=-1).astype(np.int32)


def latlon_grid(spacing_deg: float = 15.0, segments: int = 180) -> Dict:
    """Lat/lon grid polylines on the unit sphere
    (js/planet-mesh.js:384-503). Returns dict of [L, segments+1, 3]."""
    t = np.linspace(-np.pi, np.pi, segments + 1)
    parallels = []
    for lat_d in np.arange(-90 + spacing_deg, 90, spacing_deg):
        lat = math.radians(lat_d)
        parallels.append(np.stack([
            np.cos(lat) * np.sin(t), np.full_like(t, np.sin(lat)),
            np.cos(lat) * np.cos(t)], axis=-1))
    meridians = []
    s = np.linspace(-np.pi / 2, np.pi / 2, segments + 1)
    for lon_d in np.arange(-180, 180, spacing_deg):
        lon = math.radians(lon_d)
        meridians.append(np.stack([
            np.cos(s) * np.sin(lon), np.sin(s),
            np.cos(s) * np.cos(lon)], axis=-1))
    return dict(parallels=np.asarray(parallels, np.float32),
                meridians=np.asarray(meridians, np.float32))
