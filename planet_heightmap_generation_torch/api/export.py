"""Equirectangular map export — Voronoi rasterization on the device.

The reference renders the Voronoi map mesh with WebGL in ≤2048² tiles and
stitches a PNG up to 65_536 px wide (js/planet-mesh.js:1752-1950). The
port rasterizes directly, two ways:

- in-memory rasters: each cell id is scattered to its equirect pixel, then
  a **jump-flood (JFA) Voronoi fill** propagates the nearest cell id across
  the image in O(log max_dim) gather passes — the nearest-cell metric is
  the true spherical dot product, and horizontal neighbors wrap.
- huge exports (up to the reference's 65_536 px): ``export_map_tiled``
  renders in ROW BANDS, each band's pixels resolved to their exact nearest
  cell through a covering lat/lon candidate index (mesh/geobins.py), and
  streams the PNG band by band — no full-image array ever exists, so width
  is bounded by disk, not device memory.

Color space: the reference's WebGL path converts its sRGB palette to linear
for rendering and back to sRGB on readback (js/planet-mesh.js:1752-1950) —
a round trip. Here cells are flat-colored with the sRGB palette directly
(no linear-space interpolation happens), so written PNGs already match the
reference's output space; ``linear_to_srgb`` is provided for custom fields.

Export types mirror the reference's six (color / biome / koppen /
heightmap / landheightmap / landmask, js/planet-mesh.js:1782-1792).

Pixel and cell indices are int64: a 65_536 × 32_768 raster has 2^31
pixels.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..mesh.device import DeviceGraph
from ..mesh.geobins import build_geobins, nearest_cell
from .colors import (elevation_to_color, biome_color, heightmap_color,
                     land_heightmap_color, land_mask_color)
from .layers import koppen_color


def _dot3(cx, cy, cz, px, py, pz):
    """Three products and two adds in a fixed order, on any device."""
    return cx * px + cy * py + cz * pz


def jfa_steps(height: int, width: int):
    """The jump lengths: max(H, W) // 2, halved down to 1."""
    steps = []
    k = max(height, width) // 2
    while k >= 1:
        steps.append(k)
        k //= 2
    if steps and steps[-1] != 1:
        steps.append(1)
    return steps


def rasterize_cell_ids(g: DeviceGraph, height: int, width: int
                       ) -> torch.Tensor:
    """[H, W] int32 nearest-cell ids via scatter-seed + jump flooding, on
    the graph's device. A pixel that several cells fall in is seeded with
    the largest of them (the last write of the scatter, in cell order).

    The transcendental functions (each cell's pixel, each pixel row's and
    column's angle) run on the host: the card's ``asin`` / ``sin`` round
    differently from the CPU's in the last bit, and the jump flood carries
    one moved seed into non-tied pixels. The rest — gathers, products,
    sums of three, compares — rounds alike on every device, so the card
    rasterizes the CPU's ids."""
    dev = g.device
    pos = g.pos.cpu()
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    lat = torch.asin(torch.clamp(y, -1.0, 1.0))
    lon = torch.atan2(x, z)
    px = torch.clamp(((lon / math.pi + 1) * 0.5 * width).to(torch.int64),
                     0, width - 1)
    py = torch.clamp(((0.5 - lat / math.pi) * height).to(torch.int64),
                     0, height - 1)

    n = g.pos.shape[0]
    flat = torch.where(g.valid.cpu(), py * width + px,
                       height * width).to(dev)
    ids = torch.full((height * width + 1,), -1, dtype=torch.int64,
                     device=dev).scatter_reduce(
        0, flat, torch.arange(n, dtype=torch.int64, device=dev), "amax")
    ids = ids[:-1].reshape(height, width)

    # pixel sphere positions, matching lon = atan2(x, z)
    plat = (0.5 - (torch.arange(height, dtype=torch.float32) + 0.5)
            / height) * math.pi
    plon = ((torch.arange(width, dtype=torch.float32) + 0.5)
            / width * 2 - 1) * math.pi
    cl = torch.cos(plat).to(dev)[:, None]
    ppx = cl * torch.sin(plon).to(dev)[None, :]
    ppy = torch.sin(plat).to(dev)[:, None].expand(height, width)
    ppz = cl * torch.cos(plon).to(dev)[None, :]

    zero = torch.zeros(1, dtype=g.pos.dtype, device=dev)
    ext = [torch.cat([g.pos[:, c], zero]) for c in range(3)]

    def score(ids_hw):
        idx = torch.where(ids_hw >= 0, ids_hw, n)
        s = _dot3(ext[0][idx], ext[1][idx], ext[2][idx], ppx, ppy, ppz)
        return torch.where(ids_hw >= 0, s, -2.0)

    for k in jfa_steps(height, width):
        best = ids
        best_s = score(ids)
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dx == 0 and dy == 0:
                    continue
                cand = torch.roll(ids, (dy, dx), dims=(0, 1))
                # vertical shifts must not wrap across poles
                if dy > 0:
                    cand[:dy, :] = -1
                elif dy < 0:
                    cand[dy:, :] = -1
                s = score(cand)
                take = s > best_s
                best = torch.where(take, cand, best)
                best_s = torch.where(take, s, best_s)
        ids = best
    return ids.to(torch.int32)


EXPORT_TYPES = ("color", "biome", "koppen", "heightmap", "landheightmap",
                "landmask")


def _check_type(export_type: str, koppen) -> None:
    if export_type not in EXPORT_TYPES:
        raise ValueError(f"unknown export type {export_type!r}")
    if export_type in ("biome", "koppen") and koppen is None:
        raise ValueError(f"{export_type} export requires the koppen field")


def _on(device, elevation, koppen):
    """(elevation, koppen) as tensors on ``device`` (koppen may be None)."""
    return (torch.as_tensor(elevation, device=device),
            None if koppen is None else torch.as_tensor(koppen,
                                                        device=device))


def _colorize(ids, elevation, koppen, export_type: str):
    """[..., 3] colors of the cells ``ids`` for one export type."""
    ids = ids.long()
    e = elevation[ids]
    if export_type == "heightmap":
        return heightmap_color(e)
    if export_type == "landheightmap":
        return land_heightmap_color(e)
    if export_type == "landmask":
        return land_mask_color(e)
    if export_type == "color":
        return elevation_to_color(e)
    kop = koppen[ids]
    if export_type == "koppen":
        return koppen_color(kop)
    return biome_color(kop, e)


def export_map(g: DeviceGraph, elevation, export_type: str = "heightmap",
               height: int = 1024, width: int = 2048,
               koppen: Optional[torch.Tensor] = None,
               cell_ids: Optional[torch.Tensor] = None) -> np.ndarray:
    """Render one export type to an [H, W, 3] float32 image (0..1).
    Pass a precomputed ``cell_ids`` raster to share it across types
    (the reference's exportMapBatch, js/planet-mesh.js:1965-2180)."""
    _check_type(export_type, koppen)
    if cell_ids is None:
        cell_ids = rasterize_cell_ids(g, height, width)
    return _colorize(cell_ids, *_on(g.device, elevation, koppen),
                     export_type).cpu().numpy()


def export_map_batch(g: DeviceGraph, elevation, types, height=1024,
                     width=2048, koppen=None):
    """Shared-raster multi-type export (Export All)."""
    ids = rasterize_cell_ids(g, height, width)
    return {t: export_map(g, elevation, t, height, width, koppen, cell_ids=ids)
            for t in types}


def linear_to_srgb(c):
    """IEC 61966-2-1 linear → sRGB transfer (js/planet-mesh.js:1930-1941's
    readback conversion), for custom linear-space fields."""
    c = torch.clamp(torch.as_tensor(c), 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def _band_cell_ids(bins_idx, bins_mask, bins_points, n_lat: int,
                   n_lon: int, band_row: int, band_h: int, height: int,
                   width: int):
    """Exact nearest-cell ids [band_h, W] of one row band via the covering
    index."""
    dev = bins_points.device
    rows = (torch.arange(band_h, dtype=torch.float32, device=dev)
            + float(band_row))
    plat = (0.5 - (rows + 0.5) / height) * math.pi
    plon = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
            / width * 2 - 1) * math.pi
    cl = torch.cos(plat)[:, None]
    ppos = torch.stack([
        cl * torch.sin(plon)[None, :],
        torch.sin(plat)[:, None].expand(band_h, width),
        cl * torch.cos(plon)[None, :],
    ], dim=-1).reshape(-1, 3)
    ids = nearest_cell(bins_idx, bins_mask, bins_points, n_lat, n_lon, ppos)
    return ids.reshape(band_h, width)


def tiled_band_height(width: int, k_c: int) -> int:
    """Rows a band holds: the [band_h*W, K_c, 3] candidate gather bounded
    to ~1.5 GB, between 16 and 2048 rows."""
    return max(16, min(2048, (3 << 29) // max(1, width * k_c * 16)))


def export_map_tiled(graph, elevation, export_type: str, path: str,
                     width: int = 16384, height: Optional[int] = None,
                     koppen: Optional[torch.Tensor] = None,
                     band_h: Optional[int] = None) -> None:
    """Stream one export type to a PNG of arbitrary width (reference ceiling
    65_536 px, js/planet-mesh.js:1856-1864) in ``band_h``-row bands, on the
    device of ``elevation``.

    ``graph`` is the host SphereGraph (the covering candidate index is built
    from its real-cell positions, sized so bands resolve EXACT nearest
    cells). Peak memory is one band, not the image.
    """
    _check_type(export_type, koppen)
    height = height or width // 2
    elevation = torch.as_tensor(elevation)
    dev = elevation.device
    elevation, koppen = _on(dev, elevation, koppen)

    n = graph.n_cells
    # bin grid ~mesh-resolution so candidate lists stay narrow
    n_lat = int(min(512, max(45, math.sqrt(n) / 4)))
    bins = build_geobins(graph.pos[:n], n_lat=n_lat, n_lon=2 * n_lat)
    bi = torch.as_tensor(bins.cand_idx.astype(np.int64), device=dev)
    bm = torch.as_tensor(bins.cand_mask, device=dev)
    bp = torch.as_tensor(bins.points, device=dev)
    if band_h is None:
        band_h = tiled_band_height(width, bins.cand_idx.shape[1])

    with _PngStream(path, width, height) as png:
        for row in range(0, height, band_h):
            h = min(band_h, height - row)
            ids = _band_cell_ids(bi, bm, bp, bins.n_lat, bins.n_lon,
                                 row, band_h, height, width)[:h]
            png.write_rows(_colorize(ids, elevation, koppen,
                                     export_type).cpu().numpy())


class _PngStream:
    """Incremental 8-bit RGB PNG writer: one IDAT stream fed band by band,
    so a 65_536×32_768 export never holds the image in memory."""

    def __init__(self, path: str, width: int, height: int):
        self.path = path
        self.w = width
        self.h = height
        self.rows_written = 0

    def __enter__(self):
        import struct
        import zlib
        self._struct = struct
        self._zlib = zlib
        self.f = open(self.path, "wb")
        self.f.write(b"\x89PNG\r\n\x1a\n")
        header = struct.pack(">IIBBBBB", self.w, self.h, 8, 2, 0, 0, 0)
        self._chunk(b"IHDR", header)
        self._comp = zlib.compressobj(6)
        self._buf = b""
        return self

    def _chunk(self, tag, data):
        s = self._struct
        self.f.write(s.pack(">I", len(data)) + tag + data
                     + s.pack(">I", self._zlib.crc32(tag + data) & 0xFFFFFFFF))

    def write_rows(self, band: np.ndarray):
        rgb8 = np.clip(band * 255.0 + 0.5, 0, 255).astype(np.uint8)
        filt = np.concatenate(
            [np.zeros((rgb8.shape[0], 1), np.uint8),
             rgb8.reshape(rgb8.shape[0], -1)], axis=1)
        self._buf += self._comp.compress(filt.tobytes())
        if len(self._buf) > (1 << 22):
            self._chunk(b"IDAT", self._buf)
            self._buf = b""
        self.rows_written += rgb8.shape[0]

    def __exit__(self, et, ev, tb):
        if et is None:
            self._buf += self._comp.flush()
            if self._buf:
                self._chunk(b"IDAT", self._buf)
            self._chunk(b"IEND", b"")
        self.f.close()
        return False


def save_png(image: np.ndarray, path: str) -> None:
    """Minimal PNG writer (no external deps): 8-bit RGB."""
    import struct
    import zlib

    h, w = image.shape[:2]
    rgb8 = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    raw = b"".join(
        b"\x00" + rgb8[row].tobytes() for row in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
