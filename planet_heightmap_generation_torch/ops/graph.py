"""Gather-form graph kernels over the padded [NP, K] neighbour arrays
(``DeviceGraph.nbr_idx`` / ``nbr_mask``), and the per-cell uint32 hash.

The JAX package's ops/graph.py in torch, name for name: neighbour
gather-reduce, majority smoothing, connected components, flood assignment
and the hop, multi-field and carry BFS loops, each iterated to its fixpoint
(or its ``max_hops`` cap) exactly as the JAX ``while_loop`` iterates. The
production path runs the banded forms of ops/banded.py; these gather forms
are their independent oracle (tests/test_torch_graph.py). Each loop reads
its change flag on the host once a sweep, and runs on whatever device its
tensors are on.
"""

from __future__ import annotations

import math

import torch

from ..parallel import spmd

_U32 = 0xFFFFFFFF
INF = math.inf


def gather_nbrs(field, nbr_idx):
    """[N] field → [N, K] neighbour values (self where padded)."""
    return spmd.fresh(field)[nbr_idx]


def masked_min_nbr(field, nbr_idx, nbr_mask, fill=INF):
    return torch.where(nbr_mask, field[nbr_idx], fill).amin(1)


def masked_max_nbr(field, nbr_idx, nbr_mask, fill=-INF):
    return torch.where(nbr_mask, field[nbr_idx], fill).amax(1)


def masked_mean_nbr(field, nbr_idx, nbr_mask):
    s = torch.where(nbr_mask, field[nbr_idx], 0.0).sum(1)
    return s / torch.clamp(nbr_mask.sum(1), min=1)


def majority_smooth(labels, nbr_idx, nbr_mask, protect, num_passes: int = 3,
                    first_threshold: float = 0.4, threshold: float = 0.5):
    """Majority-vote boundary smoothing of an integer label field
    (reference js/plates.js:264-286): a cell adopts the most common
    neighbour label when its vote count exceeds ``deg * threshold`` (0.4
    on pass 0, then 0.5). Synchronous passes; ties go to the first slot
    (``torch.argmax`` returns the first maximum, as ``jnp.argmax``)."""
    deg = nbr_mask.sum(1)
    pair = nbr_mask[:, None, :] & nbr_mask[:, :, None]
    for p in range(num_passes):
        thr = first_threshold if p == 0 else threshold
        nl = gather_nbrs(labels, nbr_idx)                      # [N, K]
        same = (nl[:, :, None] == nl[:, None, :]) & pair       # [N, K, K]
        counts = torch.where(nbr_mask, same.sum(2), -1)
        best_slot = torch.argmax(counts, dim=1, keepdim=True)
        best_count = torch.gather(counts, 1, best_slot)[:, 0]
        best_label = torch.gather(nl, 1, best_slot)[:, 0]
        adopt = (best_count > deg * thr) & (~protect) & (deg > 0)
        labels = torch.where(adopt, best_label, labels)
    return labels


def mul_u32(h, c: int):
    """(h * c) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow (c split into 16-bit halves)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash01(idx, salt: int):
    """Deterministic per-cell hash → [0,1) (uint32 mix emulated in int64),
    used to randomize BFS fronts like the reference's Knuth-hash priority
    noise (js/terrain-post.js:96-105)."""
    h = (idx.to(torch.int64) + (int(salt) & _U32)) & _U32
    h = mul_u32(h, 2654435761)
    h = mul_u32(h ^ (h >> 16), 0x45D9F3B)
    h = h ^ (h >> 16)
    return (h % (1 << 24)).to(torch.float32) / float(1 << 24)


def connected_components(nbr_idx, nbr_mask, same):
    """Min-label connected components over the edges where ``same[n, k]``
    holds: each sweep takes the min label over same-class neighbours, then
    jumps twice (label = label[label]), until no label changes. Returns
    [N] int32 labels (the min cell index of each component)."""
    n = nbr_idx.shape[0]
    labels = torch.arange(n, dtype=torch.int32, device=nbr_idx.device)
    ok = same & nbr_mask
    while True:
        nl = torch.where(ok, labels[nbr_idx], n)
        new = torch.minimum(labels, nl.amin(1))
        new = new[new.long()]
        new = new[new.long()]
        if not bool((new != labels).any()):
            return new
        labels = new


def flood_assign(value, frontier, nbr_idx, nbr_mask):
    """Propagate ``value`` outward from ``frontier`` cells (bool) to every
    reachable unassigned cell, breadth-first; ties toward the min value.
    Returns (value, reached)."""
    big = torch.iinfo(torch.int32).max
    val, reached = value, frontier
    while True:
        nv = torch.where(reached[nbr_idx] & nbr_mask, val[nbr_idx], big)
        best = nv.amin(1)
        newly = (~reached) & (best < big)
        if not bool(newly.any()):
            return val, reached
        val = torch.where(newly, best, val)
        reached = reached | newly


def _min_plus(seeds, barrier, nbr_idx, nbr_mask, max_hops, cost):
    """The hop loop of :func:`bfs_hops` over [N] or [N, F] state."""
    mask = nbr_mask if seeds.dim() == 1 else nbr_mask[:, :, None]
    dist = torch.where(seeds, 0.0, INF).to(torch.float32)
    i = 0
    while max_hops <= 0 or i < max_hops:
        relax = torch.where(mask, dist[nbr_idx], INF).amin(1) + cost
        new = torch.where(seeds, 0.0,
                          torch.where(barrier, INF,
                                      torch.minimum(dist, relax)))
        i += 1
        changed = bool((new != dist).any())
        dist = new
        if not changed:
            break
    return dist


def bfs_hops(seeds, barrier, nbr_idx, nbr_mask, max_hops: int = 0,
             rand_cost=None):
    """Hop-distance BFS from ``seeds`` (bool [N]), not crossing
    ``barrier`` cells: min-plus relaxation ``dist = min(dist,
    min_nbr(dist) + cost)`` with per-cell costs ``rand_cost`` (default 1).
    ``max_hops`` > 0 caps the sweeps. Returns f32 distances (inf where
    unreached or barrier)."""
    cost = (torch.ones(seeds.shape, dtype=torch.float32, device=seeds.device)
            if rand_cost is None else rand_cost)
    return _min_plus(seeds, barrier, nbr_idx, nbr_mask, max_hops, cost)


def bfs_hops_multi(seeds, barrier, nbr_idx, nbr_mask, max_hops: int = 0,
                   rand_cost=None):
    """F independent :func:`bfs_hops` fields in one loop: seeds / barrier
    [N, F] bool, rand_cost [N, F] f32 or None. Returns [N, F] f32."""
    return bfs_hops(seeds, barrier, nbr_idx, nbr_mask, max_hops, rand_cost)


def _pack_key(d, t):
    return d.to(torch.float32) * 2.0 - t


def _take(a, best):
    """a[n, best[n, f], f] of an [N, K, F] array."""
    return torch.gather(a, 1, best[:, None, :])[:, 0, :]


def band_bfs(seeds, carried, nbr_idx, nbr_mask, max_hops: int,
             hops_cap=None, allow=None, edge_gate=None, use_gate=None,
             tie=None, num_carry: int = 0):
    """F carry-propagating BFS bands in one loop (batched
    :func:`carry_bfs`). seeds [N, F] bool; carried [C, N, F] f32 or None;
    hops_cap [F] int per-field cap (default ``max_hops``); allow [N, F]
    cells that may be reached; edge_gate [N, K] bool shared edge gate,
    applied to the fields where use_gate [F] holds; tie [N, F] f32, higher
    wins among equal distances. Each sweep adopts, per field, the
    neighbour of the smallest packed key ``(d + 1)·2 − tie`` (first slot on
    ties). Returns (dist [N, F] f32 with inf unreached, tie [N, F], carr
    [C, N, F])."""
    n, f = seeds.shape
    dev = seeds.device
    c = max(num_carry, 0)
    dist = torch.where(seeds, 0, max_hops + 1).to(torch.int32)
    cap = (torch.full((f,), max_hops, dtype=torch.int32, device=dev)
           if hops_cap is None else torch.as_tensor(hops_cap, device=dev)
           .to(torch.int32))
    if allow is None:
        allow = torch.ones((n, f), dtype=torch.bool, device=dev)
    tie_c = (torch.zeros((n, f), dtype=torch.float32, device=dev)
             if tie is None else tie)
    carr = (torch.zeros((max(1, c), n, f), dtype=torch.float32, device=dev)
            if carried is None else carried)
    if edge_gate is None or use_gate is None:
        gate = torch.ones((n, nbr_idx.shape[1], f), dtype=torch.bool,
                          device=dev)
    else:
        gate = torch.where(use_gate[None, None, :], edge_gate[:, :, None],
                           True)
    i = 0
    while i < max_hops:
        packed = torch.cat([dist.to(torch.float32), tie_c]
                           + [carr[j] for j in range(c)], 1)
        gp = packed[nbr_idx]                             # [N, K, F(2+C)]
        nd = gp[:, :, :f].to(torch.int32) + 1
        ntie = gp[:, :, f:2 * f]
        ok = (nbr_mask[:, :, None] & gate & (nd <= cap[None, None, :])
              & allow[:, None, :])
        npack = torch.where(ok, _pack_key(nd, ntie), INF)
        best = torch.argmin(npack, dim=1)                # [N, F]
        adopt = _take(npack, best) < _pack_key(dist, tie_c)
        dist = torch.where(adopt, _take(nd, best), dist)
        tie_c = torch.where(adopt, _take(ntie, best), tie_c)
        if c:
            carr = torch.stack([
                torch.where(adopt,
                            _take(gp[:, :, (2 + j) * f:(3 + j) * f], best),
                            carr[j]) for j in range(c)])
        i += 1
        if not bool(adopt.any()):
            break
    dist_f = torch.where(dist > cap[None, :], INF, dist.to(torch.float32))
    return dist_f, tie_c, carr


def carry_bfs(seeds, carried, nbr_idx, nbr_mask, max_hops: int,
              allow=None, edge_same=None, tie=None, num_carry: int = 0):
    """Integer-hop BFS from ``seeds`` carrying per-seed values outward
    (the reference's carry-propagating queue BFS, js/elevation.js:462-631):
    per sweep each eligible cell adopts (dist + 1, tie, carried values)
    from the neighbour of the lexicographically smallest (dist, −tie),
    ties toward the first slot. carried [C, N] f32; allow [N] bool;
    edge_same [N, K] bool extra edge gate of the receiving cell; dist
    capped at ``max_hops``. Returns (dist [N] f32 with inf unreached, tie
    [N], carried [C, N])."""
    n = nbr_idx.shape[0]
    dev = nbr_idx.device
    dist = torch.where(seeds, 0, max_hops + 1).to(torch.int32)
    tie_c = (torch.zeros(n, dtype=torch.float32, device=dev)
             if tie is None else tie)
    if allow is None:
        allow = torch.ones(n, dtype=torch.bool, device=dev)
    if edge_same is None:
        edge_same = torch.ones_like(nbr_mask)
    carr = (torch.zeros((max(1, num_carry), n), dtype=torch.float32,
                        device=dev) if carried is None else carried)
    ok_edge = nbr_mask & edge_same & allow[:, None]
    i = 0
    while i < max_hops:
        nd = dist[nbr_idx] + 1
        npack = torch.where(ok_edge & (nd <= max_hops),
                            _pack_key(nd, tie_c[nbr_idx]), INF)
        best = torch.argmin(npack, dim=1, keepdim=True)
        adopt = torch.gather(npack, 1, best)[:, 0] < _pack_key(dist, tie_c)
        src = torch.gather(nbr_idx, 1, best)[:, 0]
        dist = torch.where(adopt, dist[src] + 1, dist)
        tie_c = torch.where(adopt, tie_c[src], tie_c)
        carr = torch.where(adopt[None, :], carr[:, src], carr)
        i += 1
        if not bool(adopt.any()):
            break
    dist_f = torch.where(dist > max_hops, INF, dist.to(torch.float32))
    return dist_f, tie_c, carr
