"""Bilateral smoothing, ridge sharpening, soil creep — banded roll kernels.

Re-designs of reference smoothElevation (js/terrain-post.js:317-354),
sharpenRidges (:713-751) and applySoilCreep (:758-794). Iteration counts are
static so the loops unroll under jit; each pass is D masked roll shifts over
the Fibonacci spiral ordering plus the remainder-edge scatter (ops/banded).
"""

from __future__ import annotations

from functools import partial

from ..backend import jax
from ..backend import jnp

from ..ops.banded import (banded_sum, banded_count, band_shift, _rem_real)


@partial(jax.jit, static_argnames=("band_off", "iterations"))
def smooth_elevation(elev, is_ocean, valid, band_off, band_mask,
                     rem_src, rem_dst, iterations: int, strength):
    """Bilateral-weighted Laplacian: weight 1/(1+8|Δh|) preserves ridges;
    coastline cells (land with an ocean neighbor) are locked."""
    n = band_mask.shape[0]
    land = (~is_ocean) & valid
    ocean_nb = banded_sum(is_ocean.astype(jnp.float32), band_off, band_mask,
                          rem_src, rem_dst)
    locked = land & (ocean_nb > 0)
    movable = valid & (~locked)
    real = _rem_real(rem_src, n)

    for _ in range(iterations):
        w_sum = jnp.zeros(n, jnp.float32)
        hw = jnp.zeros(n, jnp.float32)
        for d, off in enumerate(band_off):
            nh = band_shift(elev, off)
            w = jnp.where(band_mask[:, d],
                          1.0 / (1.0 + jnp.abs(nh - elev) * 8.0), 0.0)
            w_sum = w_sum + w
            hw = hw + nh * w
        nh_r = elev[rem_dst]
        w_r = jnp.where(real, 1.0 / (1.0 + jnp.abs(
            nh_r - elev[jnp.clip(rem_src, 0, n - 1)]) * 8.0), 0.0)
        w_sum = w_sum.at[rem_src].add(w_r, mode="drop")
        hw = hw.at[rem_src].add(nh_r * w_r, mode="drop")
        h_avg = hw / jnp.maximum(w_sum, 1e-20)
        new = elev + (h_avg - elev) * strength
        elev = jnp.where(movable & (w_sum > 0), new, elev)
    return elev.astype(jnp.float32)


@partial(jax.jit, static_argnames=("band_off", "iterations"))
def sharpen_ridges(elev, is_ocean, valid, band_off, band_mask,
                   rem_src, rem_dst, iterations: int, strength):
    """h += (h - avgNbr)·strength when above the neighborhood mean,
    capped at 1.5× the pre-sharpening elevation."""
    land = (~is_ocean) & valid
    original = elev
    c = banded_count(band_mask, rem_src)
    for _ in range(iterations):
        s = banded_sum(elev, band_off, band_mask, rem_src, rem_dst)
        avg = s / jnp.maximum(c, 1)
        new = elev + (elev - avg) * strength
        new = jnp.minimum(new, original * 1.5)
        elev = jnp.where(land & (elev > avg) & (c > 0), new, elev)
    return elev.astype(jnp.float32)


@partial(jax.jit, static_argnames=("band_off", "iterations"))
def apply_soil_creep(elev, is_ocean, valid, band_off, band_mask,
                     rem_src, rem_dst, iterations: int, strength):
    """Plain Laplacian diffusion on interior land (coastline locked)."""
    land = (~is_ocean) & valid
    ocean_nb = banded_sum(is_ocean.astype(jnp.float32), band_off, band_mask,
                          rem_src, rem_dst)
    interior = land & (ocean_nb == 0)
    land_f = land.astype(jnp.float32)
    c = banded_sum(land_f, band_off, band_mask, rem_src, rem_dst)
    for _ in range(iterations):
        contrib = jnp.where(land, elev, 0.0)
        s = banded_sum(contrib, band_off, band_mask, rem_src, rem_dst)
        avg = s / jnp.maximum(c, 1)
        new = elev + (avg - elev) * strength
        elev = jnp.where(interior & (c > 0), new, elev)
    return elev.astype(jnp.float32)
