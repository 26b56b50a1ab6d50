"""Thermal (talus-angle) erosion — banded gather-free re-design.

The reference (js/terrain-post.js:644-686) scatters slope-excess material
from each cell to its lower neighbors through a delta buffer. Here the
symmetric-edge reformulation (shed = per-edge excess above the talus slope;
received = the higher neighbor's transfer times this edge's share of its
total excess) runs over the Fibonacci roll bands: every per-edge quantity is
a shifted elementwise expression, no index gather. ``band_dist`` is the
[N,D] banded edge length (ops.banded.band_nbr_dist), passed in so the
composite loop computes it once.
"""

from __future__ import annotations

from functools import partial

from ..backend import jax
from ..backend import jnp

from ..ops.banded import band_shift, _rem_real


@partial(jax.jit, static_argnames=("band_off",))
def thermal_step(elev, is_ocean, valid, band_off, band_mask, band_dist,
                 rem_src, rem_dst, rem_dist, talus_slope, k_thermal):
    n = band_mask.shape[0]
    land = (~is_ocean) & valid
    real = _rem_real(rem_src, n)
    src = jnp.clip(rem_src, 0, n - 1)

    # pass 1: total slope excess shed by each cell (land→land edges only)
    def edge_excess(h_me, h_nb, d, ok):
        slope = (h_me - h_nb) / jnp.maximum(d, 1e-6)
        return jnp.where(ok & (slope > talus_slope),
                         (slope - talus_slope) * jnp.maximum(d, 1e-6), 0.0)

    total_excess = jnp.zeros(n, jnp.float32)
    for d, off in enumerate(band_off):
        ok = band_mask[:, d] & land & band_shift(land, off)
        total_excess = total_excess + edge_excess(
            elev, band_shift(elev, off), band_dist[:, d], ok)
    ok_r = real & land[src] & land[rem_dst]
    total_excess = total_excess.at[rem_src].add(
        edge_excess(elev[src], elev[rem_dst], rem_dist, ok_r), mode="drop")

    transfer = k_thermal * total_excess * 0.5
    shed = jnp.where(total_excess > 0, transfer, 0.0)

    # pass 2: received from each higher neighbor — the neighbor's transfer
    # share across this edge (the neighbor's excess on this edge equals the
    # flipped-sign slope computed from our side)
    nb_share = jnp.where(total_excess > 0,
                         transfer / jnp.maximum(total_excess, 1e-20), 0.0)
    recv = jnp.zeros(n, jnp.float32)
    for d, off in enumerate(band_off):
        ok = band_mask[:, d] & land & band_shift(land, off)
        excess_in = edge_excess(band_shift(elev, off), elev,
                                band_dist[:, d], ok)
        recv = recv + excess_in * band_shift(nb_share, off)
    # remainder: every directed edge appears exactly once across bands +
    # remainder, so one (src ← dst) pass covers all remaining flow
    excess_in_r = edge_excess(elev[rem_dst], elev[src], rem_dist, ok_r)
    recv = recv.at[rem_src].add(excess_in_r * nb_share[rem_dst], mode="drop")

    out = elev + jnp.where(land, recv - shed, 0.0)
    return out.astype(jnp.float32)
