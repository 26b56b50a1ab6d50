"""Hydraulic erosion: steepest-descent routing, flow accumulation, and the
Braun-Willett implicit stream-power solve — all as log-depth pointer-doubling
kernels.

The reference (js/terrain-post.js:560-641) sorts land by descending
elevation, accumulates flow sequentially, then solves
``h' = (h + F·h'_rcv)/(1+F)`` in ascending order. TPU re-design:

- receivers: one masked [N,K] argmax (steepest drop; pits → no erosion,
  they are rare after priority-flood).
- flow accumulation: (S, P) pointer doubling — S ← S + scatter_add(S, P),
  P ← P[P] — log(max chain) rounds (Barnes 2016-style parallel accumulation).
- implicit solve: the per-cell update is affine in the receiver's NEW value,
  h'_i = a_i + b_i·h'_rcv with a = h/(1+F), b = F/(1+F) < 1, so the chain
  solution composes associatively: (a,b)∘(a',b') = (a + b·a', b·b').
  Pointer doubling yields the exact sequential solution in O(log depth).
- sediment deposition: eroded mass scatter-adds onto receivers with the
  slope-dependent deposit fraction, capped at the donor's new height
  (parallel form of js/terrain-post.js:626-638).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
from ..backend import jax
from ..backend import jnp


def _log_rounds(n: int) -> int:
    """Pointer-doubling round count covering any chain on an N-cell mesh:
    ceil(log2 N) + 2 margin (a fixed 22 under-covered >4M and over-ran
    small meshes). The loops also early-exit once every pointer
    reaches the sink, so this is a cap, not a cost."""
    return max(8, math.ceil(math.log2(max(2, n))) + 2)


@partial(jax.jit, static_argnames=("band_off",))
def steepest_receivers(elev, is_ocean, valid, band_off, band_mask, band_dist,
                       rem_src, rem_dst, rem_dist):
    """Per land cell: steepest-descent neighbor, else least-ascent (pit).
    Returns (receiver[N] i32 (-1 none), dist[N], is_pit[N]).

    Steepest descent = the minimum-elevation neighbor, so one banded argmin
    over the roll bands yields receiver, edge length, and pit flag (ties
    resolve by band order; the gather form used slot order)."""
    from ..ops.banded import banded_select

    n = band_mask.shape[0]
    land = (~is_ocean) & valid
    idx_f = jnp.arange(n, dtype=jnp.float32)
    band_idx = idx_f[:, None] + np.asarray(band_off, np.float32)[None, :]
    min_elev, _, (tgt_f, dist_f) = banded_select(
        elev, [], band_off, band_mask, rem_src, rem_dst, minimize=True,
        edge_payloads=[band_idx, band_dist],
        rem_edge_payloads=[rem_dst.astype(jnp.float32), rem_dist])
    has = jnp.isfinite(min_elev) & land
    best_drop = elev - min_elev
    rcv = jnp.where(has, tgt_f, -1.0).astype(jnp.int32)
    dist = jnp.maximum(jnp.where(has, dist_f, 0.0), 1e-6)
    is_pit = has & (best_drop <= 0)
    return rcv, dist, is_pit


@partial(jax.jit, static_argnames=("rounds",))
def flow_accumulation(land, rcv, is_pit, rounds: int = 0):
    """Upstream drainage area (cell count), pointer-doubled with early exit.
    Pits route to the sink so pointer cycles cannot inflate flow."""
    n = land.shape[0]
    if rounds <= 0:
        rounds = _log_rounds(n)
    sink = n
    p = jnp.where(land & (rcv >= 0) & (~is_pit), rcv, sink).astype(jnp.int32)
    s = jnp.where(land, 1.0, 0.0).astype(jnp.float32)

    def cond(state):
        i, _, p = state
        return (i < rounds) & jnp.any(p != sink)

    def body(state):
        i, s, p = state
        added = jnp.zeros(n + 1, s.dtype).at[p].add(s)
        s2 = s + added[:n]
        p2 = jnp.concatenate([p, np.array([sink], p.dtype)])[p]
        return i + 1, s2, p2

    _, s, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), s, p))
    return s


@partial(jax.jit, static_argnames=("rounds",))
def stream_power_solve(elev, is_ocean, valid, rcv, dist, is_pit, flow,
                       k_coeff, m_exp, dt, rounds: int = 0):
    """Exact Braun-Willett implicit solve via affine pointer doubling,
    followed by parallel sediment deposition. Returns new elevation."""
    n = elev.shape[0]
    land = (~is_ocean) & valid
    active = land & (rcv >= 0) & (~is_pit)
    rcv_c = jnp.clip(rcv, 0, n - 1)

    factor = jnp.where(
        active, k_coeff * jnp.power(jnp.maximum(flow, 0.0), m_exp) * dt / dist, 0.0)
    a = jnp.where(active, elev / (1 + factor), elev)
    b = jnp.where(active, factor / (1 + factor), 0.0)

    # terminal values: ocean receivers contribute max(elev, 0); pits and
    # ocean cells resolve to their own (clamped) height
    term = jnp.where(is_ocean, jnp.maximum(elev, 0.0), elev).astype(jnp.float32)

    if rounds <= 0:
        rounds = _log_rounds(n)

    # affine composition toward roots: h'_i = A_i + B_i * term[root_i].
    # Each round's four neighbor reads (A, B, next pointer, activity) pack
    # into ONE [N+1,4] gather — TPU gathers are index-bound, so packing is
    # ~4x per round (pointer bitcast to f32 rides the float gather).
    p = jnp.where(active, rcv_c, n).astype(jnp.int32)

    def cond(state):
        i, _, _, _, changed = state
        return (i < rounds) & changed

    def body(state):
        i, A, B, p, _ = state
        packed = jnp.stack([
            jnp.concatenate([A, np.array([0.0], A.dtype)]),
            jnp.concatenate([B, np.array([1.0], B.dtype)]),
            jnp.concatenate(
                [p, np.array([n], p.dtype)]).view(jnp.float32),
            jnp.concatenate(
                [active, np.array([False])]).astype(jnp.float32),
        ], axis=1)                                           # [N+1, 4]
        gp = packed[p]                                       # [N, 4]
        Ap, Bp = gp[:, 0], gp[:, 1]
        pp = gp[:, 2].view(jnp.int32)
        active_p = gp[:, 3] > 0.5
        # only compose when p is a real cell that itself is active; when p
        # points at a root (inactive cell), B*term resolves at the end.
        ok = (p < n) & active_p
        A2 = jnp.where(ok, A + B * Ap, A)
        B2 = jnp.where(ok, B * Bp, B)
        p2 = jnp.where(ok, pp, p)
        return i + 1, A2, B2, p2, jnp.any(ok)

    _, A, B, p, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), a.astype(jnp.float32), b.astype(jnp.float32), p,
         jnp.bool_(True)))

    root_term = jnp.concatenate([term, np.array([0.0], term.dtype)])[p]
    h_new = jnp.where(active, A + B * root_term, elev)

    # clamps (js/terrain-post.js:623-624): not below receiver, not below 0
    rcv_new = jnp.concatenate([h_new, np.array([0.0], np.float32)])[
        jnp.where(rcv >= 0, rcv_c, n)]
    rcv_floor = jnp.where(is_ocean[rcv_c] & (rcv >= 0), 0.0,
                          jnp.where(rcv >= 0, jnp.maximum(rcv_new, 0.0), 0.0))
    h_new = jnp.where(active, jnp.maximum(jnp.maximum(h_new, rcv_floor), 0.0),
                      h_new)

    # sediment deposition (js/terrain-post.js:626-638)
    eroded = jnp.where(active, jnp.maximum(0.0, elev - h_new), 0.0)
    rcv_of_rcv = jnp.where(rcv >= 0, rcv[rcv_c], -1)
    rr_c = jnp.clip(rcv_of_rcv, 0, n - 1)
    rcv_slope = jnp.where(
        (rcv_of_rcv >= 0) & (dist[rcv_c] > 0),
        jnp.abs(h_new[rcv_c] - h_new[rr_c]) / jnp.maximum(dist[rcv_c], 1e-6),
        0.0)
    deposit_frac = 0.5 / (1 + rcv_slope * 50.0)
    deposit = jnp.where(
        active & (~is_ocean[rcv_c]), eroded * deposit_frac, 0.0)

    dep_sum = jnp.zeros(n + 1, jnp.float32).at[
        jnp.where(rcv >= 0, rcv_c, n)].add(deposit)[:n]
    # cap: receiver must stay below the lowest donor's new height
    donor_min = jnp.full(n + 1, jnp.inf, jnp.float32).at[
        jnp.where((rcv >= 0) & (deposit > 0), rcv_c, n)].min(
        jnp.where(deposit > 0, h_new, jnp.inf))[:n]
    target = h_new + dep_sum
    target = jnp.where(jnp.isfinite(donor_min),
                       jnp.minimum(target, donor_min), target)
    h_new = jnp.where(land & (dep_sum > 0), jnp.maximum(h_new, target), h_new)
    # note: jnp.maximum keeps cells from being LOWERED by the cap

    return h_new.astype(jnp.float32)
