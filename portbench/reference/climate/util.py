"""Shared climate utilities — device re-designs of js/climate-util.js and
the geometric helpers in js/wind.js:404-443 / js/color-map.js:7-13."""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

from ..backend import jax
from ..backend import jnp


def smoothstep(e0, e1, x):
    """Reference smoothstep (js/wind.js:75-79); handles e0 > e1 reversal."""
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


@partial(jax.jit, static_argnames=("passes",))
def smooth_field(field, nbr_idx, nbr_mask, passes: int):
    """Laplacian smoothing incl. self (js/climate-util.js:5-25).

    ``field`` may be [N] or [N,F]: stacking independent fields (e.g. the two
    seasons) amortizes the index-bound TPU gather — F fields cost ~one."""
    if field.ndim == 2:
        m = nbr_mask[:, :, None]
        c = (1 + jnp.sum(nbr_mask, axis=1))[:, None]
    else:
        m = nbr_mask
        c = 1 + jnp.sum(nbr_mask, axis=1)

    def body(_, f):
        return (f + jnp.sum(jnp.where(m, f[nbr_idx], 0.0), axis=1)) / c

    return jax.lax.fori_loop(0, passes, body,
                             field.astype(jnp.float32))


@partial(jax.jit, static_argnames=("passes",))
def smooth_masked(field, mask, nbr_idx, nbr_mask, passes: int):
    """Smoothing restricted to ``mask`` cells; others pass through but do
    not contribute (js/ocean.js:168-189). ``field`` may be [N] or [N,F]
    (stacked fields share the index-bound gather)."""
    ok = nbr_mask & mask[nbr_idx]
    if field.ndim == 2:
        c = (1 + jnp.sum(ok, axis=1))[:, None]
        okx = ok[:, :, None]
        maskx = mask[:, None]
    else:
        c = 1 + jnp.sum(ok, axis=1)
        okx = ok
        maskx = mask

    def body(_, f):
        s = f + jnp.sum(jnp.where(okx, f[nbr_idx], 0.0), axis=1)
        return jnp.where(maskx, s / c, f)

    return jax.lax.fori_loop(0, passes, body, field.astype(jnp.float32))


@jax.jit
def percentile(values, p, mask):
    """Value at index floor(n*p) of the sorted masked values; returns 1 when
    the result is 0 (js/climate-util.js:103-110)."""
    cnt = jnp.sum(mask)
    v = jnp.sort(jnp.where(mask, values, jnp.inf))
    idx = jnp.clip(jnp.floor(cnt * p).astype(jnp.int32), 0, values.shape[0] - 1)
    out = v[idx]
    out = jnp.where(jnp.isfinite(out), out, 0.0)
    return jnp.where(out == 0, 1.0, out)


def elev_to_height_km(elev):
    """Hybrid S-curve elevation → km (js/color-map.js:7-13)."""
    t = jnp.clip(elev, 0.0, 1.0)
    t2 = t * t
    land = 6 * t2 * t2 * (5 - 4 * t)
    return jnp.where(elev <= 0, elev * 10.0, land)


class GeoFrame(NamedTuple):
    """Per-cell lat/lon and tangent frames, Y-up convention
    (js/wind.js:418-443): lat from y, lon = atan2(x, z)."""

    lat: jax.Array
    lon: jax.Array
    sin_lat: jax.Array
    cos_lat: jax.Array
    east: jax.Array    # [N, 3]
    north: jax.Array   # [N, 3]


@jax.jit
def geo_frame(pos) -> GeoFrame:
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    lat = jnp.arcsin(jnp.clip(y, -1.0, 1.0))
    lon = jnp.arctan2(x, z)
    sin_lat = y
    cos_lat = jnp.maximum(jnp.sqrt(jnp.maximum(0.0, 1 - y * y)), 0.01)

    ex, ez = z, -x
    elen = jnp.sqrt(ex * ex + ez * ez)
    ok = elen >= 1e-10
    ex = jnp.where(ok, ex / jnp.maximum(elen, 1e-20), 1.0)
    ez = jnp.where(ok, ez / jnp.maximum(elen, 1e-20), 0.0)
    ey = jnp.zeros_like(ex)

    nx = y * ez - z * ey
    ny = z * ex - x * ez
    nz = x * ey - y * ex
    nlen = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    nlen = jnp.where(nlen == 0, 1.0, nlen)

    return GeoFrame(
        lat=lat.astype(jnp.float32), lon=lon.astype(jnp.float32),
        sin_lat=sin_lat.astype(jnp.float32), cos_lat=cos_lat.astype(jnp.float32),
        east=jnp.stack([ex, ey, ez], 1).astype(jnp.float32),
        north=jnp.stack([nx / nlen, ny / nlen, nz / nlen], 1).astype(jnp.float32),
    )


def itcz_lookup(itcz_lats, lon):
    """Periodic linear interpolation over the 72 ITCZ longitude samples
    (js/climate-util.js:29-42)."""
    n = itcz_lats.shape[0]
    step = 2 * jnp.pi / n
    lon_start = -jnp.pi + step * 0.5
    fi = (lon - lon_start) / step
    fi = jnp.mod(jnp.mod(fi, n) + n, n)
    i0 = jnp.floor(fi).astype(jnp.int32) % n
    i1 = (i0 + 1) % n
    frac = fi - jnp.floor(fi)
    return itcz_lats[i0] * (1 - frac) + itcz_lats[i1] * frac


@jax.jit
def compute_gradients(pos, field, east, north, nbr_idx, nbr_mask):
    """Per-axis least-squares tangent gradients (js/wind.js:306-339).

    ``field`` may be [N] or [N,F] (F independent fields share the geometry
    terms and the index-bound gather)."""
    d = pos[nbr_idx] - pos[:, None, :]                     # [N, K, 3]
    de = jnp.einsum("nkc,nc->nk", d, east)
    dn = jnp.einsum("nkc,nc->nk", d, north)
    de = jnp.where(nbr_mask, de, 0.0)
    dn = jnp.where(nbr_mask, dn, 0.0)
    sum_ee = jnp.sum(de * de, axis=1)
    sum_nn = jnp.sum(dn * dn, axis=1)
    if field.ndim == 2:
        dp = field[nbr_idx] - field[:, None, :]            # [N, K, F]
        dp = jnp.where(nbr_mask[:, :, None], dp, 0.0)
        sum_ep = jnp.sum(de[:, :, None] * dp, axis=1)      # [N, F]
        sum_np = jnp.sum(dn[:, :, None] * dp, axis=1)
        sum_ee = sum_ee[:, None]
        sum_nn = sum_nn[:, None]
    else:
        dp = jnp.where(nbr_mask, field[nbr_idx] - field[:, None], 0.0)
        sum_ep = jnp.sum(de * dp, axis=1)
        sum_np = jnp.sum(dn * dp, axis=1)
    ge = jnp.where(sum_ee > 1e-12, sum_ep / jnp.maximum(sum_ee, 1e-20), 0.0)
    gn = jnp.where(sum_nn > 1e-12, sum_np / jnp.maximum(sum_nn, 1e-20), 0.0)
    return ge.astype(jnp.float32), gn.astype(jnp.float32)
