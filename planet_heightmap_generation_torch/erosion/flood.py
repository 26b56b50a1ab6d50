"""Priority-flood pit resolution with canyon carving — parallel re-design.

The reference (js/terrain-post.js:59-215) uses a sequential min-heap flood
(Barnes et al.) with noise-perturbed keys, then per-cell drain-path tracing
to redistribute fill deficit as carving, then a monotonic-drainage sweep in
ascending surface order. Each pass becomes a parallel equivalent:

- Pass 1 (fill): the ε-fill iteration
  ``surface ← max(elev, min_nbr(surface) + ε)`` run to its fixpoint, seeded
  from land adjacent to the largest (open) ocean component; inland seas are
  opaque to the flood (js/terrain-post.js:119). One relax launch of the
  flood kernel (ops/sweep_cuda.py) runs it to the fixpoint. The per-cell Knuth-hash noise that
  meanders the reference's flood fronts perturbs the drain-pointer
  selection instead.
- Pass 2 (carve): the carve share of each pit's deficit is accumulated
  downstream along the drain forest with pointer doubling and applied where
  the flux crosses locally prominent ground.
- Pass 3 (monotonic enforcement): the fixpoint of
  ``elev[r] = max(elev0[r], elev[drain[r]] + ε)``, solved exactly by
  max-plus pointer doubling.
"""

from __future__ import annotations

import torch

from ..ops import sweep_cuda
from ..ops.graph import hash01
from ..ops.banded import (banded_sum, banded_count, band_shift, band_gate,
                          pack_band_bits, components_core, rem_csr,
                          rem_gather, pointer_accumulate)
from ..parallel import spmd
from .fluvial import log_rounds

EPS = 1e-6  # reference uses 1e-7; promoted one decade so the increment
            # survives float32 rounding at elevations ~0.5
BIG = 1e9
INF = float("inf")


def open_ocean_mask(is_ocean, valid, band_off, band_mask, rem_src, rem_dst):
    """Largest connected ocean component (js/terrain-post.js:64-94)."""
    labels = connected_components_banded(
        is_ocean & valid, band_off, band_mask, rem_src, rem_dst)
    return spmd.gathered(largest_component_mask, is_ocean & valid, labels)


def largest_component_mask(in_set, labels):
    n = in_set.shape[0]
    labels = torch.where(in_set, labels.to(torch.int64), n)
    sizes = torch.zeros(n + 1, dtype=torch.int64, device=in_set.device)
    sizes = sizes.index_add(0, labels, in_set.to(torch.int64))
    sizes[n] = 0
    return in_set & (labels == torch.argmax(sizes))


def connected_components_banded(in_set, band_off, band_mask, rem_src,
                                rem_dst):
    """Min-label components of the subgraph induced by ``in_set`` cells;
    non-members get label N. Returns [N] int32."""
    n = band_mask.shape[0]
    gate = band_gate(in_set, band_off, band_mask) & in_set[:, None]
    rem_ok = in_set[rem_src] & rem_gather(in_set, rem_dst)
    init = torch.where(in_set, spmd.arange(n, torch.float32, in_set.device),
                       float(spmd.total(n)))
    return components_core(init, in_set, pack_band_bits(gate), rem_ok,
                           band_off, rem_src, rem_dst)


def _fill_common(elev, is_ocean, open_ocean, valid, band_off, band_mask,
                 rem_src, rem_dst):
    """Shared fill setup: inland barriers, seeds, initial surface.

    Inland seas (ocean cells outside the main component) are barriers:
    the flood neither relaxes through them nor drains into them."""
    inland = is_ocean & (~open_ocean)
    nbr_open_cnt = banded_sum(open_ocean.to(torch.float32),
                              band_off, band_mask, rem_src, rem_dst)
    seed = (~is_ocean) & valid & (nbr_open_cnt > 0)
    surface0 = torch.where(is_ocean | seed, elev,
                           torch.where(valid, BIG, elev)).to(torch.float32)
    frozen = is_ocean | seed | (~valid)
    return inland, seed, surface0, frozen


def epsilon_fill(elev, is_ocean, open_ocean, valid, band_off, band_mask,
                 rem_src, rem_dst):
    """Parallel priority-flood fill → (surface, drain_to).

    Frozen cells are baked in by clamping their relax target to their own
    surface (cand = max(surface0, ·) keeps min(surf, cand) = surface0), so
    a Jacobi sweep of the flood kernel, remainder rows included, equals one
    iteration of the JAX jnp loop ``_epsilon_fill_jnp``. The whole loop is
    one relax launch (ops/sweep_cuda.py ``flood_relax``) with no host sync;
    its inner sweeps on stale halos reach the same fixpoint."""
    inland, seed, surface0, frozen = _fill_common(
        elev, is_ocean, open_ocean, valid, band_off, band_mask, rem_src,
        rem_dst)
    elev_baked = torch.where(frozen, surface0, elev).to(
        torch.float32).contiguous()
    inland_f = inland.to(torch.float32).contiguous()
    bits = pack_band_bits(band_mask)
    ptr, nbr = rem_csr(rem_src, rem_dst, band_mask.shape[0])
    surface, _ = spmd.launch("flood_relax", sweep_cuda.flood_relax,
                             surface0.contiguous(), inland_f, elev_baked,
                             bits, band_off, ptr, nbr, BIG, EPS)
    return _fill_finish(surface, elev, inland, seed, is_ocean, open_ocean,
                        valid, band_off, band_mask, rem_src, rem_dst)


def _fill_finish(surface, elev, inland, seed, is_ocean, open_ocean, valid,
                 band_off, band_mask, rem_src, rem_dst):
    n = band_mask.shape[0]
    dev = surface.device
    # cells the flood never reached (land enclosed by inland seas) keep
    # their elevation, like the reference's surface = copy(r_elevation)
    # init (js/terrain-post.js:106): no fill, no deficit
    surface = torch.where(surface >= BIG * 0.5, elev, surface)

    # drain pointers: the meander noise selects WHICH strictly-lower
    # neighbour to drain to, never a higher one, so every pointer strictly
    # decreases surface and the pointers form a forest. Banded argmin in two
    # sweeps over the bands: first whether a strictly-lower passable
    # neighbour exists, then the min-key neighbour under the matching key.
    noise = hash01(spmd.arange(n, device=dev), 7919) * 0.01
    surf_key = torch.where(inland, INF, surface)             # impassable
    lower_bound = surface - EPS * 0.5
    has_lower = torch.zeros(n, dtype=torch.bool, device=dev)
    for d, off in enumerate(band_off):
        sj = torch.where(band_mask[:, d], band_shift(surf_key, off), INF)
        has_lower = has_lower | (sj < lower_bound)
    rl = rem_gather(surf_key, rem_dst) < lower_bound[rem_src]
    has_lower = has_lower | (torch.zeros(n, dtype=torch.int64, device=dev)
                             .index_add(0, rem_src, rl.to(torch.int64)) > 0)

    idx_f = spmd.arange(n, torch.float32, dev)
    best_key = torch.full((n,), INF, device=dev)
    best_drain = torch.full((n,), -1.0, device=dev)

    def edge_key(sj, noise_j, open_j):
        # strictly-lower edges keyed with meander noise; with no lower
        # edge, plain surface; seed cells only drain to open ocean
        lower = sj < lower_bound
        k = torch.where(has_lower, torch.where(lower, sj + noise_j, INF), sj)
        return torch.where(seed & (~open_j), INF, k)

    for d, off in enumerate(band_off):
        sj = torch.where(band_mask[:, d], band_shift(surf_key, off), INF)
        k = edge_key(sj, band_shift(noise, off), band_shift(open_ocean, off))
        upd = k < best_key
        best_key = torch.where(upd, k, best_key)
        best_drain = torch.where(upd, idx_f + off, best_drain)
    src = rem_src
    sj_r = rem_gather(surf_key, rem_dst)
    lower_r = sj_r < lower_bound[src]
    k_r = torch.where(has_lower[src],
                      torch.where(lower_r, sj_r + noise[rem_dst], INF), sj_r)
    k_r = torch.where(seed[src] & (~rem_gather(open_ocean, rem_dst)), INF,
                      k_r)
    dst_f = spmd.global_index(rem_dst).to(torch.float32)
    w = torch.full((n,), INF, device=dev).scatter_reduce(0, src, k_r, "amin")
    win_r = (k_r == w[src]) & torch.isfinite(k_r)
    d_r = torch.full((n,), -INF, device=dev).scatter_reduce(
        0, src, torch.where(win_r, dst_f, -INF), "amax")
    upd = w < best_key
    best_key = torch.where(upd, w, best_key)
    best_drain = torch.where(upd, d_r, best_drain)

    # last resort (land walled in by inland seas): drain to the
    # min-surface neighbour over ALL edges, i.e. into the inland sea
    lr_key = torch.full((n,), INF, device=dev)
    lr_drain = torch.full((n,), -1.0, device=dev)
    for d, off in enumerate(band_off):
        sj = torch.where(band_mask[:, d], band_shift(surface, off), INF)
        u = sj < lr_key
        lr_key = torch.where(u, sj, lr_key)
        lr_drain = torch.where(u, idx_f + off, lr_drain)
    sj_r2 = rem_gather(surface, rem_dst)
    w2 = torch.full((n,), INF, device=dev).scatter_reduce(0, src, sj_r2,
                                                          "amin")
    win2 = (sj_r2 == w2[src]) & torch.isfinite(sj_r2)
    d2 = torch.full((n,), -INF, device=dev).scatter_reduce(
        0, src, torch.where(win2, dst_f, -INF), "amax")
    lr_drain = torch.where(w2 < lr_key, d2, lr_drain)
    best_drain = torch.where(torch.isinf(best_key), lr_drain, best_drain)

    drain = torch.where(is_ocean | (~valid) | (best_drain < 0), -1,
                        best_drain).to(torch.int32)
    return surface, drain


def downstream_accumulate(values, pointers, sink_mask, rounds: int = 0):
    """For each cell, the sum of ``values`` over all upstream cells whose
    drain path passes through it (inclusive), via pointer doubling:
    S ← S + scatter_add(S along P), P ← P[P] until no pointer is off the
    sink or ``rounds`` rounds ran, each target's adds in source order, the
    whole loop one launch (ops.banded.pointer_accumulate). Cells where
    ``sink_mask`` holds (and negative pointers) route to a virtual sink,
    which is never summed."""
    n = spmd.total(values.shape[0])
    rounds = rounds if rounds > 0 else log_rounds(n)
    p = torch.where(sink_mask | (pointers < 0), n, pointers.to(torch.int64))
    return pointer_accumulate(values.contiguous(), p, rounds)


def monotonic_enforce(elev, drain, is_ocean, valid, rounds: int = 0):
    """Exact fixpoint of elev'[r] = max(elev[r], elev'[drain[r]] + ε), with
    ocean target elevation treated as 0 (js/terrain-post.js:198-214).
    Unrolled: elev'[r] = max_k ( g[d^k(r)] + k·ε ), g = elev on land, 0 on
    water; solved by max-plus pointer doubling over (M, L, P): M covers
    the path prefix of length L ending at P."""
    n = elev.shape[0]
    dev = elev.device
    rounds = rounds if rounds > 0 else log_rounds(n)
    land = (~is_ocean) & valid & (drain >= 0)
    m = torch.where(is_ocean, 0.0, elev).to(torch.float32)
    l = torch.ones(n, dtype=torch.float32, device=dev)
    p = torch.where(land, drain.to(torch.int64), n)
    for _ in range(rounds):
        if not spmd.flag_any((p != n).any()):
            break
        mp = torch.cat([m, m.new_tensor([-INF])])[p]
        lp = torch.cat([l, l.new_tensor([0.0])])[p]
        m = torch.maximum(m, mp + l * EPS)
        l = l + lp
        p = torch.cat([p, p.new_tensor([n])])[p]
    return torch.where(land, torch.maximum(elev, m), elev).to(torch.float32)


def priority_flood_carve(elev, is_ocean, valid, band_off, band_mask,
                         rem_src, rem_dst, carve_strength, open_ocean=None):
    """Full pit resolution: fill + carve + monotonic drainage.
    Returns (elevation, drain_to, surface). ``open_ocean`` is the largest
    ocean component (computed here when not given)."""
    if open_ocean is None:
        open_ocean = open_ocean_mask(is_ocean, valid, band_off, band_mask,
                                     rem_src, rem_dst)
    surface, drain = epsilon_fill(elev, is_ocean, open_ocean, valid,
                                  band_off, band_mask, rem_src, rem_dst)
    land = (~is_ocean) & valid
    deficit = torch.where(land, torch.clamp(surface - elev, min=0.0), 0.0)

    # fill share (exact): raise pit floors by (1 - carve) of the deficit
    elev2 = elev + deficit * (1.0 - carve_strength)

    # carve share (approximation): route carve flux downstream and cut
    # where it crosses locally prominent ground (spill barriers)
    flux = downstream_accumulate(deficit * carve_strength, drain,
                                 is_ocean | (~valid))
    nbr_sum = banded_sum(elev2, band_off, band_mask, rem_src, rem_dst)
    nbr_cnt = torch.clamp(banded_count(band_mask, rem_src), min=1)
    prominence = torch.clamp(elev2 - nbr_sum / nbr_cnt, min=0.0)
    carve = torch.minimum(flux, prominence * 2.0 + flux * 0.25)
    carve = torch.where(land & (deficit <= EPS), carve, 0.0)
    elev3 = torch.clamp(elev2 - carve, min=0.0)
    elev3 = torch.where(land, elev3, elev2)

    out = spmd.gathered(monotonic_enforce, elev3, drain, is_ocean, valid)
    return torch.where(valid, out, elev).to(torch.float32), drain, surface
