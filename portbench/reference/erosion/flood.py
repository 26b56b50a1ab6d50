"""Priority-flood pit resolution with canyon carving — parallel re-design.

The reference (js/terrain-post.js:59-215) uses a sequential min-heap flood
(Barnes et al.) with noise-perturbed keys, then per-cell drain-path tracing
to redistribute fill deficit as carving, then a monotonic-drainage sweep in
ascending surface order. None of that maps to a TPU, so each pass becomes an
established parallel equivalent:

- Pass 1 (fill): the parallel epsilon-fill iteration
  ``surface ← max(elev, min_nbr(surface) + ε)`` run to fixed point, seeded
  from land adjacent to the largest (open) ocean component; inland seas are
  opaque to the flood exactly as in the reference (their cells are marked
  visited upfront, js/terrain-post.js:119). Converges to the same surface as
  the heap flood; the per-cell Knuth-hash noise that meanders the reference's
  flood fronts perturbs the drain-pointer selection instead.
- Pass 2 (carve): instead of tracing every drain path, the carve share of
  each pit's deficit is ACCUMULATED DOWNSTREAM along the drain forest with
  pointer doubling (log-depth scatter-add rounds) and applied where the flux
  crosses locally prominent ground — concentrating cuts at spill barriers
  (an aesthetics-preserving approximation; the fill share is exact).
- Pass 3 (monotonic enforcement): the fixpoint of
  ``elev[r] = max(elev0[r], elev[drain[r]] + ε)`` — what the reference's
  ascending sweep computes — solved exactly in O(log depth) rounds of
  max-plus pointer doubling.

The "every land cell drains monotonically to water" invariant is preserved
exactly and is tested (SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

from functools import partial

import numpy as np
from ..backend import jax
from ..backend import jnp

from ..ops.graph import hash01
from ..ops.banded import banded_min, banded_sum, banded_count, band_shift
from .fluvial import _log_rounds

EPS = 1e-6  # reference uses 1e-7; promoted one decade so the increment
            # survives float32 rounding at elevations ~0.5


def open_ocean_mask(is_ocean, valid, band_off, band_mask, rem_src, rem_dst):
    """Largest connected ocean component (js/terrain-post.js:64-94).

    NOT jitted: connected_components_banded dispatches pallas-vs-jnp at
    plain-Python level, and a jit here would bake that choice into an
    avals-only cache key — a staged TPU trace would then alias its
    pallas-containing jaxpr into the sharded/no-pallas programs (the same
    hazard _epsilon_fill documents). The callees are individually jitted."""
    labels = connected_components_banded(
        is_ocean & valid, band_off, band_mask, rem_src, rem_dst)
    return _largest_component_mask(is_ocean & valid, labels)


@jax.jit
def _largest_component_mask(in_set, labels):
    n = in_set.shape[0]
    labels = jnp.where(in_set, labels, n)
    sizes = jax.ops.segment_sum(
        in_set.astype(jnp.int32), labels, num_segments=n + 1)
    sizes = sizes.at[n].set(0)
    main = jnp.argmax(sizes)
    return in_set & (labels == main)


def connected_components_banded(in_set, band_off, band_mask, rem_src,
                                rem_dst):
    """Min-label components of the subgraph induced by ``in_set`` cells.
    Non-members get label N. Root-hooked + compressed (see
    ops.banded.connected_components_gated for the convergence argument:
    plain propagation was LINEAR in component diameter — 505 iterations on
    the 1M-cell ocean)."""
    return _cc_inset_jnp(in_set, band_off, band_mask, rem_src, rem_dst)


@partial(jax.jit, static_argnames=("band_off",))
def _cc_inset_jnp(in_set, band_off, band_mask, rem_src, rem_dst):
    n = band_mask.shape[0]
    init = jnp.where(in_set, jnp.arange(n, dtype=jnp.int32), n)

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        labels, _ = state
        lab_m = jnp.where(in_set, labels, n)   # non-members never propagate
        best = banded_min(lab_m, band_off, band_mask, rem_src, rem_dst,
                          fill=n)
        new = jnp.where(in_set, jnp.minimum(labels, best), labels)
        # hook: merge touched regions through their roots (member labels
        # always point at member cells; non-members contribute n = no-op)
        new = new.at[jnp.clip(labels, 0, n - 1)].min(
            jnp.where(in_set, new, n))
        # pointer jumping ×2
        new = jnp.where(in_set, new[jnp.clip(new, 0, n - 1)], new)
        new = jnp.where(in_set, new[jnp.clip(new, 0, n - 1)], new)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
    return labels.astype(jnp.int32)


def _epsilon_fill(elev, is_ocean, open_ocean, valid,
                  band_off, band_mask, rem_src, rem_dst):
    """Parallel priority-flood fill → (surface, drain_to)."""
    return _epsilon_fill_jnp(elev, is_ocean, open_ocean, valid,
                band_off, band_mask, rem_src, rem_dst)


def _fill_common(elev, is_ocean, open_ocean, valid,
                 band_off, band_mask, rem_src, rem_dst):
    """Shared fill setup: inland barriers, seeds, initial surface.

    Inland seas (ocean cells outside the main component) are barriers: the
    flood neither relaxes through them nor drains into them. Neighbor-side
    pass gates are expressed by pre-masking the evolving surface with
    ``big`` (banded roll sweeps need no per-edge gate arrays)."""
    big = jnp.float32(1e9)
    inland = is_ocean & (~open_ocean)
    nbr_open_cnt = banded_sum(open_ocean.astype(jnp.float32),
                              band_off, band_mask, rem_src, rem_dst)
    seed = (~is_ocean) & valid & (nbr_open_cnt > 0)
    surface0 = jnp.where(
        is_ocean | seed, elev, jnp.where(valid, big, elev)).astype(jnp.float32)
    frozen = is_ocean | seed | (~valid)
    return big, inland, seed, surface0, frozen


@partial(jax.jit, static_argnames=("band_off",))
def _epsilon_fill_jnp(elev, is_ocean, open_ocean, valid,
                      band_off, band_mask, rem_src, rem_dst):
    big, inland, seed, surface0, frozen = _fill_common(
        elev, is_ocean, open_ocean, valid,
        band_off, band_mask, rem_src, rem_dst)

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        surf, _ = state
        # inland-sea cells are impassable: they present `big` to neighbors
        masked = jnp.where(inland, big, surf)
        min_nbr = banded_min(masked, band_off, band_mask,
                             rem_src, rem_dst, fill=big)
        cand = jnp.maximum(elev, min_nbr + EPS)
        new = jnp.where(frozen, surf, jnp.minimum(surf, cand))
        return new, jnp.any(new != surf)

    surface, _ = jax.lax.while_loop(
        cond, body, (surface0, jnp.bool_(True)))
    return _fill_finish(surface, elev, big, inland, seed, is_ocean,
                        open_ocean, valid, band_off, band_mask,
                        rem_src, rem_dst)


def _fill_finish(surface, elev, big, inland, seed, is_ocean, open_ocean,
                 valid, band_off, band_mask, rem_src, rem_dst):
    n = band_mask.shape[0]
    # cells the flood never reached (land enclosed by inland seas — e.g. an
    # island inside a landlocked basin) keep their ELEVATION, exactly like
    # the reference's surface = copy(r_elevation) init (js/terrain-post.js:
    # 106): no fill, no deficit. Leaving `big` here poisoned the elevation
    # with +5e8 at cell counts where such islands occur (>=160K).
    surface = jnp.where(surface >= big * 0.5, elev, surface)

    # drain pointers. The reference meanders flood fronts with hash noise on
    # the heap keys (js/terrain-post.js:96-113); its pop order still yields
    # acyclic drainTo. Here cycles must be impossible by construction (the
    # pointer forest feeds log-depth doubling solvers), so the noise selects
    # WHICH strictly-lower-surface neighbor to drain to, never a higher one:
    # every pointer strictly decreases surface → forest, guaranteed.
    # Banded argmin in two sweeps over the bands: first decide per cell
    # whether a strictly-lower passable neighbor exists, then select the
    # min-key neighbor under the matching key definition.
    noise = hash01(jnp.arange(n, dtype=jnp.int32), 7919) * 0.01
    surf_key = jnp.where(inland, jnp.inf, surface)          # impassable
    has_lower = jnp.zeros(n, bool)
    for d, off in enumerate(band_off):
        sj = jnp.where(band_mask[:, d], band_shift(surf_key, off), jnp.inf)
        has_lower = has_lower | (sj < surface - EPS * 0.5)
    rl = (surf_key[rem_dst] < surface[jnp.clip(rem_src, 0, n - 1)]
          - EPS * 0.5) & (rem_src < n)
    has_lower = has_lower | (jnp.zeros(n, jnp.int32).at[rem_src].add(
        rl.astype(jnp.int32), mode="drop") > 0)

    idx_f = jnp.arange(n, dtype=jnp.float32)
    best_key = jnp.full(n, jnp.inf)
    best_drain = jnp.full(n, -1.0)

    def edge_key(sj, noise_j, open_j):
        # strictly-lower edges keyed with meander noise; when the cell has
        # no lower edge, plain surface; seed cells only drain to open ocean
        lower = sj < surface - EPS * 0.5
        k = jnp.where(has_lower, jnp.where(lower, sj + noise_j, jnp.inf), sj)
        return jnp.where(seed & (~open_j), jnp.inf, k)

    for d, off in enumerate(band_off):
        sj = jnp.where(band_mask[:, d], band_shift(surf_key, off), jnp.inf)
        k = edge_key(sj, band_shift(noise, off), band_shift(open_ocean, off))
        upd = k < best_key
        best_key = jnp.where(upd, k, best_key)
        best_drain = jnp.where(upd, idx_f + off, best_drain)
    src = jnp.clip(rem_src, 0, n - 1)
    sj_r = jnp.where(rem_src < n, surf_key[rem_dst], jnp.inf)
    lower_r = sj_r < surface[src] - EPS * 0.5
    k_r = jnp.where(has_lower[src],
                    jnp.where(lower_r, sj_r + noise[rem_dst], jnp.inf),
                    sj_r)
    k_r = jnp.where(seed[src] & (~open_ocean[rem_dst]), jnp.inf, k_r)
    w = jnp.full(n, jnp.inf).at[rem_src].min(k_r, mode="drop")
    win_r = (k_r == w[src]) & (rem_src < n) & jnp.isfinite(k_r)
    d_r = jnp.full(n, -jnp.inf).at[rem_src].max(
        jnp.where(win_r, rem_dst.astype(jnp.float32), -jnp.inf), mode="drop")
    upd = w < best_key
    best_key = jnp.where(upd, w, best_key)
    best_drain = jnp.where(upd, d_r, best_drain)

    # last resort (land walled in by inland seas — no passable candidate):
    # drain to the min-surface neighbor over ALL edges, i.e. into the
    # inland sea, which IS water (matches the reference's behavior of
    # always assigning some drainTo, js/terrain-post.js:118-147)
    lr_key = jnp.full(n, jnp.inf)
    lr_drain = jnp.full(n, -1.0)
    for d, off in enumerate(band_off):
        sj = jnp.where(band_mask[:, d], band_shift(surface, off), jnp.inf)
        u = sj < lr_key
        lr_key = jnp.where(u, sj, lr_key)
        lr_drain = jnp.where(u, idx_f + off, lr_drain)
    sj_r2 = jnp.where(rem_src < n, surface[rem_dst], jnp.inf)
    w2 = jnp.full(n, jnp.inf).at[rem_src].min(sj_r2, mode="drop")
    win2 = (sj_r2 == w2[src]) & (rem_src < n) & jnp.isfinite(sj_r2)
    d2 = jnp.full(n, -jnp.inf).at[rem_src].max(
        jnp.where(win2, rem_dst.astype(jnp.float32), -jnp.inf), mode="drop")
    u2 = w2 < lr_key
    lr_drain = jnp.where(u2, d2, lr_drain)
    best_drain = jnp.where(jnp.isinf(best_key), lr_drain, best_drain)

    drain = jnp.where(is_ocean | (~valid) | (best_drain < 0), -1,
                      best_drain).astype(jnp.int32)
    return surface, drain


@partial(jax.jit, static_argnames=("rounds",))
def downstream_accumulate(values, pointers, sink_mask, rounds: int = 0):
    """For each cell, the sum of ``values`` over all upstream cells whose
    drain path passes through it (inclusive), via pointer doubling:
    S ← S + scatter_add(S along P), P ← P[P]. Cells where ``sink_mask``
    holds (and negative pointers) route to a virtual sink."""
    n = values.shape[0]
    if rounds <= 0:
        rounds = _log_rounds(n)
    sink = n
    p = jnp.where(sink_mask | (pointers < 0), sink, pointers)

    def cond(state):
        i, _, p = state
        return (i < rounds) & jnp.any(p != sink)

    def body(state):
        i, s, p = state
        added = jnp.zeros(n + 1, s.dtype).at[p].add(s)
        s2 = s + added[:n]
        p2 = jnp.concatenate([p, np.array([sink], p.dtype)])[p]
        return i + 1, s2, p2

    _, s, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), values, p))
    return s


@partial(jax.jit, static_argnames=("rounds",))
def monotonic_enforce(elev, drain, is_ocean, valid, rounds: int = 0):
    """Exact fixpoint of elev'[r] = max(elev[r], elev'[drain[r]] + ε), with
    ocean target elevation treated as 0 (js/terrain-post.js:198-214).

    Unrolled: elev'[r] = max_k ( g[d^k(r)] + k·ε ), g = elev on land, 0 on
    water. Solved by max-plus pointer doubling over (M, L, P): M covers the
    path prefix of length L ending at P.
    """
    n = elev.shape[0]
    if rounds <= 0:
        rounds = _log_rounds(n)
    land = (~is_ocean) & valid & (drain >= 0)
    g = jnp.where(is_ocean, 0.0, elev).astype(jnp.float32)

    m = g
    l = jnp.ones(n, jnp.float32)
    p = jnp.where(land, drain, n).astype(jnp.int32)

    def cond(state):
        i, _, _, p = state
        return (i < rounds) & jnp.any(p != n)

    def body(state):
        # one packed [N+1,3] gather per round (index-bound on TPU)
        i, m, l, p = state
        packed = jnp.stack([
            jnp.concatenate([m, np.array([-np.inf], m.dtype)]),
            jnp.concatenate([l, np.array([0.0], l.dtype)]),
            jnp.concatenate([p, np.array([n], p.dtype)]).view(jnp.float32),
        ], axis=1)
        gp = packed[p]
        m2 = jnp.maximum(m, gp[:, 0] + l * EPS)
        l2 = l + gp[:, 1]
        pp = gp[:, 2].view(jnp.int32)
        return i + 1, m2, l2, pp

    _, m, _, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), m, l, p))
    out = jnp.where(land, jnp.maximum(elev, m), elev)
    return out.astype(jnp.float32)


def priority_flood_carve(elev, is_ocean, valid, band_off, band_mask,
                         rem_src, rem_dst, carve_strength,
                         open_ocean=None):
    """Full pit resolution: fill + carve + monotonic drainage.
    Returns (elevation, drain_to, surface). Plain-Python (not jitted as a
    unit): the ε-fill dispatches between the pallas/jnp sweep variants at
    trace time, and that flag must never alias through an avals-keyed jit
    cache — callers trace this inside the fused program anyway.

    ``open_ocean``: optional precomputed largest-ocean-component mask.
    The ocean mask is frozen for the whole composite loop
    (erosion/composite.py:165), so the initial flood and the 75% re-flood
    share one components call — it is the most expensive single kernel in
    the flood."""
    if open_ocean is None:
        open_ocean = open_ocean_mask(is_ocean, valid, band_off, band_mask,
                                     rem_src, rem_dst)
    surface, drain = _epsilon_fill(elev, is_ocean, open_ocean, valid,
                                   band_off, band_mask, rem_src, rem_dst)
    deficit = jnp.where((~is_ocean) & valid,
                        jnp.maximum(0.0, surface - elev), 0.0)

    # fill share (exact): raise pit floors by (1 - carve) of the deficit
    elev2 = elev + deficit * (1.0 - carve_strength)

    # carve share (approximation): route carve flux downstream and cut where
    # it crosses locally prominent ground (spill barriers)
    flux = downstream_accumulate(deficit * carve_strength, drain,
                                 is_ocean | (~valid))
    nbr_sum = banded_sum(elev2, band_off, band_mask, rem_src, rem_dst)
    nbr_cnt = jnp.maximum(
        1, banded_count(band_mask, rem_src))
    prominence = jnp.maximum(0.0, elev2 - nbr_sum / nbr_cnt)
    carve = jnp.minimum(flux, prominence * 2.0 + flux * 0.25)
    carve = jnp.where((~is_ocean) & valid & (deficit <= EPS), carve, 0.0)
    elev3 = jnp.maximum(0.0, elev2 - carve)
    elev3 = jnp.where((~is_ocean) & valid, elev3, elev2)

    # monotonic drainage enforcement (exact)
    out = monotonic_enforce(elev3, drain, is_ocean, valid)
    return jnp.where(valid, out, elev).astype(jnp.float32), drain, surface
