"""Hydraulic erosion: steepest-descent routing, flow accumulation, and the
Braun-Willett implicit stream-power solve — all as log-depth
pointer-doubling loops.

The reference (js/terrain-post.js:560-641) sorts land by descending
elevation, accumulates flow sequentially, then solves
``h' = (h + F·h'_rcv)/(1+F)`` in ascending order. Parallel re-design:

- receivers: one banded argmin (steepest drop; pits → no erosion).
- flow accumulation: (S, P) pointer doubling — S ← S + scatter_add(S, P),
  P ← P[P], on int32 counts, the whole loop one launch
  (ops.banded.pointer_accumulate).
- implicit solve: h'_i = a_i + b_i·h'_rcv with a = h/(1+F), b = F/(1+F),
  composed associatively by pointer doubling: the exact sequential
  solution in O(log depth).
- sediment deposition: eroded mass adds onto receivers in donor order
  (ops.banded.ordered_index_sum) with the slope-dependent deposit
  fraction, capped at the donor's new height (js/terrain-post.js:626-638).
"""

from __future__ import annotations

import math

import torch

from ..ops.banded import (banded_select, band_off_tensor, ordered_index_sum,
                          pointer_accumulate)
from ..parallel import spmd


def log_rounds(n: int) -> int:
    """Pointer-doubling round cap covering any chain on an N-cell mesh:
    ceil(log2 N) + 2. The loops also stop once every pointer reaches the
    sink."""
    return max(8, math.ceil(math.log2(max(2, n))) + 2)


def steepest_receivers(elev, is_ocean, valid, band_off, band_mask, band_dist,
                       rem_src, rem_dst, rem_dist):
    """Per land cell: steepest-descent neighbour, else least-ascent (pit).
    The receivers are global cell indices (on a cells split too:
    parallel/spmd.py ``arange``). Returns (receiver [N] i64 (-1 none),
    dist [N], is_pit [N])."""
    n = band_mask.shape[0]
    dev = elev.device
    land = (~is_ocean) & valid
    idx_f = spmd.arange(n, torch.float32, dev)
    band_idx = idx_f[:, None] + band_off_tensor(band_off, dev)[None, :]
    min_elev, _, (tgt_f, dist_f) = banded_select(
        elev, [], band_off, band_mask, rem_src, rem_dst, minimize=True,
        edge_payloads=[band_idx, band_dist],
        rem_edge_payloads=[idx_f[rem_dst], rem_dist])
    has = torch.isfinite(min_elev) & land
    best_drop = elev - min_elev
    rcv = torch.where(has, tgt_f, -1.0).to(torch.int64)
    dist = torch.clamp(torch.where(has, dist_f, 0.0), min=1e-6)
    is_pit = has & (best_drop <= 0)
    return rcv, dist, is_pit


def flow_accumulation(land, rcv, is_pit, rounds: int = 0):
    """Upstream drainage area (cell count), pointer-doubled until no
    pointer is off the sink or ``rounds`` rounds ran. Pits route to the
    sink so pointer cycles cannot inflate flow. The counts add as int32
    (exact in any order: the JAX f32 counts are integers below 2^24) and
    return as float32."""
    n = spmd.total(land.shape[0])
    rounds = rounds if rounds > 0 else log_rounds(n)
    p = torch.where(land & (rcv >= 0) & (~is_pit), rcv, n)
    return pointer_accumulate(land.to(torch.int32), p,
                              rounds).to(torch.float32)


def stream_power_solve(elev, is_ocean, valid, rcv, dist, is_pit, flow,
                       k_coeff, m_exp, dt, rounds: int = 0):
    """Exact Braun-Willett implicit solve via affine pointer doubling,
    then parallel sediment deposition. Returns the new elevation."""
    n = elev.shape[0]
    dev = elev.device
    land = (~is_ocean) & valid
    active = land & (rcv >= 0) & (~is_pit)
    rcv_c = torch.clamp(rcv, 0, n - 1)

    factor = torch.where(
        active, k_coeff * torch.pow(torch.clamp(flow, min=0.0), m_exp)
        * dt / dist, 0.0)
    a = torch.where(active, elev / (1 + factor), elev).to(torch.float32)
    b = torch.where(active, factor / (1 + factor), 0.0).to(torch.float32)

    # terminal values: ocean receivers contribute max(elev, 0); pits and
    # ocean cells resolve to their own (clamped) height
    term = torch.where(is_ocean, torch.clamp(elev, min=0.0),
                       elev).to(torch.float32)
    rounds = rounds if rounds > 0 else log_rounds(n)

    # affine composition toward roots: h'_i = A_i + B_i * term[root_i]
    A, B = a, b
    p = torch.where(active, rcv_c, n)
    active_x = torch.cat([active, active.new_tensor([False])])
    for _ in range(rounds):
        ok = (p < n) & active_x[p]
        if not spmd.flag_any(ok.any()):
            break
        Ap = torch.cat([A, A.new_tensor([0.0])])[p]
        Bp = torch.cat([B, B.new_tensor([1.0])])[p]
        pp = torch.cat([p, p.new_tensor([n])])[p]
        A = torch.where(ok, A + B * Ap, A)
        B = torch.where(ok, B * Bp, B)
        p = torch.where(ok, pp, p)

    root_term = torch.cat([term, term.new_tensor([0.0])])[p]
    h_new = torch.where(active, A + B * root_term, elev)

    # clamps (js/terrain-post.js:623-624): not below receiver, not below 0
    has_rcv = rcv >= 0
    rcv_new = torch.cat([h_new, h_new.new_tensor([0.0])])[
        torch.where(has_rcv, rcv_c, n)]
    rcv_floor = torch.where(is_ocean[rcv_c] & has_rcv, 0.0,
                            torch.where(has_rcv,
                                        torch.clamp(rcv_new, min=0.0), 0.0))
    h_new = torch.where(active, torch.clamp(
        torch.maximum(h_new, rcv_floor), min=0.0), h_new)

    # sediment deposition (js/terrain-post.js:626-638)
    eroded = torch.where(active, torch.clamp(elev - h_new, min=0.0), 0.0)
    rcv_of_rcv = torch.where(has_rcv, rcv[rcv_c], -1)
    rr_c = torch.clamp(rcv_of_rcv, 0, n - 1)
    rcv_slope = torch.where(
        (rcv_of_rcv >= 0) & (dist[rcv_c] > 0),
        torch.abs(h_new[rcv_c] - h_new[rr_c])
        / torch.clamp(dist[rcv_c], min=1e-6), 0.0)
    deposit_frac = 0.5 / (1 + rcv_slope * 50.0)
    deposit = torch.where(active & (~is_ocean[rcv_c]), eroded * deposit_frac,
                          0.0)

    tgt = torch.where(has_rcv, rcv_c, n)
    dep_sum = ordered_index_sum(n, tgt, deposit.contiguous())
    # cap: receiver must stay below the lowest donor's new height
    donor_min = torch.full((n + 1,), float("inf"), device=dev).scatter_reduce(
        0, torch.where(has_rcv & (deposit > 0), rcv_c, n),
        torch.where(deposit > 0, h_new, float("inf")), "amin")[:n]
    target = h_new + dep_sum
    target = torch.where(torch.isfinite(donor_min),
                         torch.minimum(target, donor_min), target)
    h_new = torch.where(land & (dep_sum > 0), torch.maximum(h_new, target),
                        h_new)
    return h_new.to(torch.float32)
