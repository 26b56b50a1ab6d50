"""Glacial erosion — latitude/elevation glaciation, ice flow, U-valley
carving, moraines, fjords.

Re-design of the glacial block of erodeComposite
(js/terrain-post.js:404-557, 689-706): the sequential descending-order ice
flow becomes the same pointer-doubling accumulation used for water; valley
widening and moraine deposition are reformulated from the receiving cell's
perspective over the Fibonacci roll bands (ops/banded) — the only index
operations left are the pointer-doubling jumps.
"""

from __future__ import annotations

from functools import partial

import numpy as np
from ..backend import jax
from ..backend import jnp

from ..ops.banded import banded_sum, band_shift, banded_select, _rem_real

G_FLOW_THRESHOLD = 0.1
G_FJORD_THRESHOLD = 0.5


def _smoothstep(x, e0, e1):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


@jax.jit
def glaciation_index(pos, elev, is_ocean, valid, strength):
    """Latitude/elevation glaciation index (js/terrain-post.js:416-427).
    NOTE the reference reads r_xyz[3r+1] (its y axis) as the pole axis."""
    y = pos[:, 1]
    polar = jnp.abs(jnp.arcsin(jnp.clip(y, -1.0, 1.0)))
    threshold_lat = jnp.pi / 2 - strength * jnp.pi / 4.5
    lat_factor = _smoothstep(polar, threshold_lat, jnp.pi / 2)
    elev_factor = _smoothstep(elev, 0.5, 0.9)
    lat_scale = _smoothstep(polar, jnp.pi / 8, jnp.pi / 3)
    g = jnp.maximum(lat_factor, elev_factor * 0.3 * (0.3 + 0.7 * lat_scale))
    return jnp.where((~is_ocean) & valid, g * strength, 0.0).astype(jnp.float32)


@partial(jax.jit, static_argnames=("band_off",))
def glacial_step(elev, is_ocean, valid, band_off, band_mask, band_dist,
                 rem_src, rem_dst, rem_dist, glac_idx, strength, g_scale):
    """One glacial iteration. ``g_scale`` = 1/gIters."""
    n = band_mask.shape[0]
    land = (~is_ocean) & valid
    real = _rem_real(rem_src, n)
    src = jnp.clip(rem_src, 0, n - 1)

    # ice drainage: steepest strict descent = the min-elevation neighbor
    # (banded argmin; ties resolve by band order instead of slot order)
    idx_f = jnp.arange(n, dtype=jnp.float32)
    band_idx = idx_f[:, None] + np.asarray(band_off, np.float32)[None, :]
    min_elev, _, (tgt_f,) = banded_select(
        elev, [], band_off, band_mask, rem_src, rem_dst, minimize=True,
        edge_payloads=[jnp.broadcast_to(band_idx, band_mask.shape)],
        rem_edge_payloads=[rem_dst.astype(jnp.float32)])
    best_drop = elev - min_elev
    has_target = land & (glac_idx > 0) & (best_drop > 0) & jnp.isfinite(min_elev)
    ice_target = jnp.where(has_target, tgt_f, -1.0).astype(jnp.int32)

    # ice flow: pointer-doubled accumulation seeded with glac_idx
    sink = n
    p = jnp.where(has_target, jnp.clip(ice_target, 0, n - 1), sink)

    def step(carry, _):
        s, p = carry
        added = jnp.zeros(n + 1, s.dtype).at[p].add(s)
        s2 = s + added[:n]
        p2 = jnp.concatenate([p, np.array([sink], p.dtype)])[p]
        return (s2, p2), None

    (ice_flow, _), _ = jax.lax.scan(
        step, (glac_idx.astype(jnp.float32), p.astype(jnp.int32)), None,
        length=22)

    carving = land & (ice_flow > G_FLOW_THRESHOLD)
    deepening = jnp.where(
        carving, 0.02 * g_scale * jnp.power(ice_flow, 0.6) * strength, 0.0)

    delta = -deepening

    # valley widening + moraines + tributary count, one banded sweep set.
    # points_at_me[edge j→i]: ice_target[j] == i.
    num_upstream = jnp.zeros(n, jnp.int32)
    widen = jnp.zeros(n, jnp.float32)
    deposit = jnp.zeros(n, jnp.float32)
    moraine_amt = 0.005 * g_scale * jnp.power(ice_flow, 0.3)
    flow_ok = ice_flow > G_FLOW_THRESHOLD
    for d, off in enumerate(band_off):
        ok = band_mask[:, d]
        nb_land = band_shift(land, off)
        points_at_me = ok & (band_shift(ice_target, off)
                             == jnp.arange(n, dtype=jnp.int32))
        num_upstream = num_upstream + points_at_me.astype(jnp.int32)
        # widening: I receive from each carving neighbor
        slope = jnp.abs(elev - band_shift(elev, off)) / jnp.maximum(
            band_dist[:, d], 1e-6)
        widen = widen + jnp.where(
            ok & band_shift(carving, off) & land & nb_land,
            band_shift(deepening, off) * 0.4 * jnp.maximum(0.0, 1 - slope),
            0.0)
        # moraine deposition at termini
        dep_ok = (points_at_me & land
                  & band_shift(flow_ok, off)
                  & (glac_idx < band_shift(glac_idx, off) * 0.3))
        deposit = deposit + jnp.where(dep_ok, band_shift(moraine_amt, off),
                                      0.0)
    # remainder edges (receiver = rem_src, sender = rem_dst)
    points_r = real & (ice_target[rem_dst] == rem_src)
    num_upstream = num_upstream.at[rem_src].add(
        points_r.astype(jnp.int32), mode="drop")
    slope_r = jnp.abs(elev[src] - elev[rem_dst]) / jnp.maximum(rem_dist, 1e-6)
    widen = widen.at[rem_src].add(
        jnp.where(real & carving[rem_dst] & land[src] & land[rem_dst],
                  deepening[rem_dst] * 0.4 * jnp.maximum(0.0, 1 - slope_r),
                  0.0), mode="drop")
    dep_ok_r = (points_r & land[src] & flow_ok[rem_dst]
                & (glac_idx[src] < glac_idx[rem_dst] * 0.3))
    deposit = deposit.at[rem_src].add(
        jnp.where(dep_ok_r, moraine_amt[rem_dst], 0.0), mode="drop")

    delta = delta - widen
    delta = delta - jnp.where(
        carving & (num_upstream >= 2),
        0.01 * g_scale * jnp.power(ice_flow, 0.4), 0.0)
    delta = delta + deposit

    new = elev + jnp.where(land, delta, 0.0)

    # fjord carve on glaciated coastal cells
    ocean_nb = banded_sum(is_ocean.astype(jnp.float32), band_off, band_mask,
                          rem_src, rem_dst)
    fjord = (land & (ocean_nb > 0) & (glac_idx > 0.2)
             & (ice_flow > G_FJORD_THRESHOLD))
    new = jnp.where(
        fjord,
        jnp.maximum(0.0, new - 0.015 * g_scale * jnp.power(ice_flow, 0.5)),
        new)

    # clamp: land stays land
    new = jnp.where(land, jnp.maximum(new, 0.0), new)
    return new.astype(jnp.float32)


@partial(jax.jit, static_argnames=("band_off",))
def glacial_post_smooth(elev, is_ocean, valid, band_off, band_mask,
                        rem_src, rem_dst, glac_idx):
    """Post-loop Laplacian blend on glaciated land (js/terrain-post.js:689-706)."""
    land = (~is_ocean) & valid
    land_f = land.astype(jnp.float32)
    c = banded_sum(land_f, band_off, band_mask, rem_src, rem_dst)
    s = banded_sum(jnp.where(land, elev, 0.0), band_off, band_mask,
                   rem_src, rem_dst)
    avg = s / jnp.maximum(c, 1)
    blended = elev + (avg - elev) * 0.3
    return jnp.where(land & (glac_idx > 0) & (c > 0), blended,
                     elev).astype(jnp.float32)
