"""Shared climate utilities — the JAX package's climate/util.py in torch:
smoothstep, the gather-form smoothing and gradients, the sort-based
percentile, the elevation → km curve, the per-cell geographic frame and
the periodic ITCZ lookup. The climate stack runs the banded forms of
ops/banded.py (``smooth_field_banded``, ``smooth_masked_banded``,
``compute_gradients_banded``); the gather forms here, over the [N, K]
``nbr_idx`` / ``nbr_mask``, are their oracle, as in the JAX package."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.banded import dot3


def smoothstep(e0, e1, x):
    """Reference smoothstep (js/wind.js:75-79); handles e0 > e1 reversal."""
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def smooth_field(field, nbr_idx, nbr_mask, passes: int):
    """Laplacian smoothing including the cell itself, ``passes`` times
    (js/climate-util.js:5-25). ``field`` may be [N] or [N, F]."""
    m, c = nbr_mask, 1 + nbr_mask.sum(1)
    if field.dim() == 2:
        m, c = m[:, :, None], c[:, None]
    f = field.to(torch.float32)
    for _ in range(int(passes)):
        f = (f + torch.where(m, f[nbr_idx], 0.0).sum(1)) / c
    return f


def smooth_masked(field, mask, nbr_idx, nbr_mask, passes: int):
    """Smoothing restricted to ``mask`` cells: the others pass through and
    do not contribute (js/ocean.js:168-189). ``field`` may be [N] or
    [N, F]."""
    ok = nbr_mask & mask[nbr_idx]
    c, okx, maskx = 1 + ok.sum(1), ok, mask
    if field.dim() == 2:
        c, okx, maskx = c[:, None], ok[:, :, None], mask[:, None]
    f = field.to(torch.float32)
    for _ in range(int(passes)):
        s = f + torch.where(okx, f[nbr_idx], 0.0).sum(1)
        f = torch.where(maskx, s / c, f)
    return f


def compute_gradients(pos, field, east, north, nbr_idx, nbr_mask):
    """Per-axis least-squares tangent gradients (js/wind.js:306-339).
    ``field`` may be [N] or [N, F]. Returns (ge, gn) f32."""
    d = pos[nbr_idx] - pos[:, None, :]                     # [N, K, 3]
    de = torch.where(nbr_mask, dot3(d, east[:, None, :]), 0.0)
    dn = torch.where(nbr_mask, dot3(d, north[:, None, :]), 0.0)
    sum_ee = (de * de).sum(1)
    sum_nn = (dn * dn).sum(1)
    if field.dim() == 2:
        dp = torch.where(nbr_mask[:, :, None],
                         field[nbr_idx] - field[:, None, :], 0.0)
        sum_ep = (de[:, :, None] * dp).sum(1)
        sum_np = (dn[:, :, None] * dp).sum(1)
        sum_ee, sum_nn = sum_ee[:, None], sum_nn[:, None]
    else:
        dp = torch.where(nbr_mask, field[nbr_idx] - field[:, None], 0.0)
        sum_ep = (de * dp).sum(1)
        sum_np = (dn * dp).sum(1)
    ge = torch.where(sum_ee > 1e-12,
                     sum_ep / torch.clamp(sum_ee, min=1e-20), 0.0)
    gn = torch.where(sum_nn > 1e-12,
                     sum_np / torch.clamp(sum_nn, min=1e-20), 0.0)
    return ge.to(torch.float32), gn.to(torch.float32)


def percentile(values, p: float, mask):
    """Value at index floor(n*p) of the sorted masked values, n the mask
    count; 1 when that value is 0 (js/climate-util.js:103-110). A 0-d
    tensor: no host round trip."""
    cnt = mask.sum().to(torch.float32)
    v = torch.sort(torch.where(mask, values, math.inf)).values
    idx = torch.clamp(torch.floor(cnt * p).to(torch.int64), 0,
                      values.shape[0] - 1)
    out = v[idx]
    out = torch.where(torch.isfinite(out), out, 0.0)
    return torch.where(out == 0, 1.0, out)


def percentile95(values, mask):
    """:func:`percentile` at 0.95, the climate's speed and precipitation
    normaliser."""
    return percentile(values, 0.95, mask)


def elev_to_height_km(elev):
    """Hybrid S-curve elevation → km (js/color-map.js:7-13)."""
    t = torch.clamp(elev, 0.0, 1.0)
    t2 = t * t
    land = 6 * t2 * t2 * (5 - 4 * t)
    return torch.where(elev <= 0, elev * 10.0, land)


class GeoFrame(NamedTuple):
    """Per-cell lat/lon and tangent frames, Y-up convention
    (js/wind.js:418-443): lat from y, lon = atan2(x, z)."""

    lat: torch.Tensor
    lon: torch.Tensor
    sin_lat: torch.Tensor
    cos_lat: torch.Tensor
    east: torch.Tensor    # [N, 3]
    north: torch.Tensor   # [N, 3]


def geo_frame(pos) -> GeoFrame:
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    lat = torch.asin(torch.clamp(y, -1.0, 1.0))
    lon = torch.atan2(x, z)
    cos_lat = torch.clamp(torch.sqrt(torch.clamp(1 - y * y, min=0.0)),
                          min=0.01)

    ex, ez = z, -x
    elen = torch.sqrt(ex * ex + ez * ez)
    ok = elen >= 1e-10
    ex = torch.where(ok, ex / torch.clamp(elen, min=1e-20), 1.0)
    ez = torch.where(ok, ez / torch.clamp(elen, min=1e-20), 0.0)
    ey = torch.zeros_like(ex)

    nx = y * ez - z * ey
    ny = z * ex - x * ez
    nz = x * ey - y * ex
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    nlen = torch.where(nlen == 0, 1.0, nlen)
    return GeoFrame(
        lat=lat, lon=lon, sin_lat=y, cos_lat=cos_lat,
        east=torch.stack([ex, ey, ez], 1),
        north=torch.stack([nx / nlen, ny / nlen, nz / nlen], 1))


def itcz_lookup(itcz_lats, lon):
    """Periodic linear interpolation over the ITCZ longitude samples
    (js/climate-util.js:29-42)."""
    n = itcz_lats.shape[0]
    step = 2 * math.pi / n
    lon_start = -math.pi + step * 0.5
    fi = (lon - lon_start) / step
    fi = torch.remainder(torch.remainder(fi, n) + n, n)
    i0 = torch.remainder(torch.floor(fi).to(torch.int64), n)
    i1 = (i0 + 1) % n
    frac = fi - torch.floor(fi)
    return itcz_lats[i0] * (1 - frac) + itcz_lats[i1] * frac
