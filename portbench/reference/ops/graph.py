"""Device-side graph kernels over the padded neighbor arrays.

Every reference algorithm that walks the half-edge mesh with queues becomes
one of these vectorized forms (SURVEY.md §7 kernel families):

- neighbor gather-reduce: ``gather_nbrs`` + masked reductions
- majority-vote smoothing (reference js/plates.js:264-286)
- connected components: min-label propagation + pointer jumping
  (replaces the reference's per-plate BFS, js/plates.js:291-347)
- frontier BFS → iterated masked label/min-plus updates under
  ``lax.while_loop``

Performance note (measured on TPU v5e, 40K cells, K=12): an arbitrary-index
[N,K] gather costs ~3.7 ms per sweep and is INDEX-processing bound — four
stacked fields through one gather cost 1.7 ms total, eight cost 2.1 ms.
Hence the _multi/band kernels below, which pack every independent
propagation into one gather per sweep. A Pallas kernel cannot beat this:
Pallas TPU rejects per-lane integer indexing ("Cannot do int indexing on
TPU"), so XLA's gather is the only gather on this hardware and batching
payload per index is the optimization that remains.
"""

from __future__ import annotations

from ..backend import jax
from ..backend import jnp
from functools import partial


def gather_nbrs(field: jax.Array, nbr_idx: jax.Array) -> jax.Array:
    """[N] field → [N, K] neighbor values (self where padded)."""
    return field[nbr_idx]


def masked_min_nbr(field, nbr_idx, nbr_mask, fill=jnp.inf):
    v = field[nbr_idx]
    return jnp.min(jnp.where(nbr_mask, v, fill), axis=1)


def masked_max_nbr(field, nbr_idx, nbr_mask, fill=-jnp.inf):
    v = field[nbr_idx]
    return jnp.max(jnp.where(nbr_mask, v, fill), axis=1)


def masked_mean_nbr(field, nbr_idx, nbr_mask):
    v = field[nbr_idx]
    s = jnp.sum(jnp.where(nbr_mask, v, 0.0), axis=1)
    c = jnp.maximum(1, jnp.sum(nbr_mask, axis=1))
    return s / c


@partial(jax.jit, static_argnames=("num_passes",))
def majority_smooth(labels, nbr_idx, nbr_mask, protect, num_passes: int = 3,
                    first_threshold: float = 0.4, threshold: float = 0.5):
    """Majority-vote boundary smoothing of an integer label field.

    Re-design of reference smoothAndReconnectPlates' smoothing passes
    (js/plates.js:264-286): a cell adopts the most common neighbor label
    when its vote count exceeds ``deg * threshold`` (0.4 on pass 0, then
    0.5). Jacobi-style (synchronous) instead of the reference's in-place
    sweep — structurally equivalent, order-independent, fully parallel.

    For each cell we compare each neighbor's label against every other
    neighbor's ([N,K,K] comparisons, K≈8-16) — cheap VPU work that avoids
    any data-dependent histogram.
    """
    deg = jnp.sum(nbr_mask, axis=1)

    def one_pass(labels, thr):
        nl = labels[nbr_idx]                       # [N, K]
        same = (nl[:, :, None] == nl[:, None, :])  # [N, K, K]
        same = same & nbr_mask[:, None, :] & nbr_mask[:, :, None]
        counts = jnp.sum(same, axis=2)             # votes for each slot's label
        counts = jnp.where(nbr_mask, counts, -1)
        best_slot = jnp.argmax(counts, axis=1)
        best_count = jnp.take_along_axis(counts, best_slot[:, None], 1)[:, 0]
        best_label = jnp.take_along_axis(nl, best_slot[:, None], 1)[:, 0]
        adopt = (best_count > deg * thr) & (~protect) & (deg > 0)
        return jnp.where(adopt, best_label, labels)

    for p in range(num_passes):
        labels = one_pass(labels, first_threshold if p == 0 else threshold)
    return labels


@jax.jit
def connected_components(nbr_idx, nbr_mask, same):
    """Min-label connected components over edges where ``same[n,k]`` holds.

    Label propagation with pointer jumping: per sweep each cell takes the
    min label among same-class neighbors, then compresses twice
    (label = label[label]). Converges in O(log diameter) sweeps — the
    parallel replacement for the reference's sequential BFS floods.

    Returns [N] int32 labels (min cell index of each component).
    """
    n = nbr_idx.shape[0]
    init = jnp.arange(n, dtype=jnp.int32)

    def cond(state):
        labels, changed = state
        return changed

    def body(state):
        labels, _ = state
        nl = labels[nbr_idx]
        nl = jnp.where(same & nbr_mask, nl, n)
        new = jnp.minimum(labels, jnp.min(nl, axis=1))
        new = new[new]
        new = new[new]
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
    return labels


@jax.jit
def flood_assign(value, frontier, nbr_idx, nbr_mask):
    """Propagate ``value`` outward from ``frontier`` cells (bool mask) to all
    reachable unassigned cells, breadth-first; ties resolved by min value.

    Replaces the reference's queue-based reassignment BFS
    (js/plates.js:322-347). Returns (value, reached_mask).
    """
    n = nbr_idx.shape[0]
    big = jnp.iinfo(jnp.int32).max

    def cond(state):
        _, reached, changed = state
        return changed

    def body(state):
        val, reached, _ = state
        nv = jnp.where(reached[nbr_idx] & nbr_mask, val[nbr_idx], big)
        best = jnp.min(nv, axis=1)
        newly = (~reached) & (best < big)
        val = jnp.where(newly, best, val)
        reached2 = reached | newly
        return val, reached2, jnp.any(newly)

    val, reached, _ = jax.lax.while_loop(
        cond, body, (value, frontier, jnp.bool_(True))
    )
    return val, reached


@partial(jax.jit, static_argnames=("max_hops",))
def bfs_hops(seeds, barrier, nbr_idx, nbr_mask, max_hops: int = 0,
             rand_cost=None):
    """Hop-distance BFS from ``seeds`` (bool), not crossing ``barrier`` cells.

    The reference's randomized-frontier BFS (js/elevation.js:164-189) pops
    queue entries in random order, producing organic non-circular fronts.
    Here the same look is achieved with per-edge random hop costs
    (``rand_cost`` [N] in [0.5, 1.5]): iterated min-plus relaxation
    dist = min(dist, min_nbr(dist) + cost). Barrier cells never relax.

    Returns float32 distances (inf where unreached / barrier).
    """
    n = nbr_idx.shape[0]
    inf = jnp.float32(jnp.inf)
    dist0 = jnp.where(seeds, 0.0, inf).astype(jnp.float32)
    cost = jnp.ones(n, jnp.float32) if rand_cost is None else rand_cost

    def cond(state):
        i, _, changed = state
        if max_hops > 0:
            return changed & (i < max_hops)
        return changed

    def body(state):
        i, dist, _ = state
        nd = jnp.where(nbr_mask, dist[nbr_idx], inf)
        relax = jnp.min(nd, axis=1) + cost
        new = jnp.minimum(dist, relax)
        new = jnp.where(barrier, inf, new)
        new = jnp.where(seeds, 0.0, new)
        return i + 1, new, jnp.any(new != dist)

    _, dist, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), dist0, jnp.bool_(True))
    )
    return dist


@partial(jax.jit, static_argnames=("max_hops",))
def bfs_hops_multi(seeds, barrier, nbr_idx, nbr_mask, max_hops: int = 0,
                   rand_cost=None):
    """F independent hop-distance BFS fields in ONE relaxation loop.

    TPU gathers with arbitrary [N,K] indices are index-processing bound:
    gathering F fields with one shared index array costs ~the same as one
    (measured: F=1 3.7ms, F=4 1.7ms, F=8 2.1ms per sweep @40K on v5e). The
    elevation stage's five distance fields (js/elevation.js:365-427) batch
    into a [N,F] min-plus loop — one gather per sweep instead of five loops.

    seeds/barrier: [N,F] bool; rand_cost: [N,F] f32 or None.
    Returns [N,F] f32 distances (inf where unreached / barrier).
    """
    n, f = seeds.shape
    inf = jnp.float32(jnp.inf)
    dist0 = jnp.where(seeds, 0.0, inf).astype(jnp.float32)
    cost = jnp.ones((n, f), jnp.float32) if rand_cost is None else rand_cost

    def cond(state):
        i, _, changed = state
        if max_hops > 0:
            return changed & (i < max_hops)
        return changed

    def body(state):
        i, dist, _ = state
        nd = jnp.where(nbr_mask[:, :, None], dist[nbr_idx], inf)  # [N,K,F]
        relax = jnp.min(nd, axis=1) + cost
        new = jnp.minimum(dist, relax)
        new = jnp.where(barrier, inf, new)
        new = jnp.where(seeds, 0.0, new)
        return i + 1, new, jnp.any(new != dist)

    _, dist, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), dist0, jnp.bool_(True))
    )
    return dist


@partial(jax.jit, static_argnames=("max_hops", "num_carry"))
def band_bfs(seeds, carried, nbr_idx, nbr_mask, max_hops: int,
             hops_cap=None, allow=None, edge_gate=None, use_gate=None,
             tie=None, num_carry: int = 0):
    """F carry-propagating BFS bands in ONE loop (batched carry_bfs).

    Everything the sweep needs from neighbors — distance, tie value, carried
    values — is packed into a single [N, F*(2+C)] matrix so each sweep costs
    ONE index-bound gather (see bfs_hops_multi note).

    - seeds: [N,F] bool.
    - carried: [C,N,F] f32 or None (C = num_carry).
    - hops_cap: [F] i32 per-field cap (defaults to max_hops).
    - allow: [N,F] bool cells permitted to be reached.
    - edge_gate: [N,K] bool shared per-edge constraint (e.g. same plate);
      use_gate: [F] bool — which fields apply it.
    - tie: [N,F] f32 — higher wins among equal distances (js/elevation.js:502).

    Returns (dist [N,F] f32 with inf unreached, tie_out [N,F], carr [C,N,F]).
    """
    n, f = seeds.shape
    c = max(num_carry, 0)
    inf_i = jnp.int32(max_hops + 1)
    dist0 = jnp.where(seeds, 0, inf_i).astype(jnp.int32)
    if hops_cap is None:
        hops_cap = jnp.full((f,), max_hops, jnp.int32)
    if allow is None:
        allow = jnp.ones((n, f), bool)
    if tie is None:
        tie = jnp.zeros((n, f), jnp.float32)
    if carried is None:
        carried = jnp.zeros((max(1, c), n, f), jnp.float32)
    if edge_gate is None or use_gate is None:
        gate = jnp.ones((n, nbr_idx.shape[1], f), bool)
    else:
        gate = jnp.where(use_gate[None, None, :], edge_gate[:, :, None], True)

    def pack_key(d, t):
        return d.astype(jnp.float32) * 2.0 - t

    def cond(state):
        i, _, _, _, changed = state
        return changed & (i < max_hops)

    def body(state):
        i, dist, tie_c, carr, _ = state
        # ONE gather: [N,K, F*(2+C)]
        packed = jnp.concatenate(
            [dist.astype(jnp.float32), tie_c]
            + [carr[j] for j in range(c)], axis=1)          # [N, F*(2+C)]
        gp = packed[nbr_idx]                                 # [N,K,F*(2+C)]
        nd = gp[:, :, :f].astype(jnp.int32) + 1
        ntie = gp[:, :, f:2 * f]
        ok = (nbr_mask[:, :, None] & gate & (nd <= hops_cap[None, None, :])
              & allow[:, None, :])
        npack = jnp.where(ok, pack_key(nd, ntie), jnp.inf)   # [N,K,F]
        best = jnp.argmin(npack, axis=1)                     # [N,F]
        best_pack = jnp.take_along_axis(npack, best[:, None, :], 1)[:, 0, :]
        adopt = best_pack < pack_key(dist, tie_c)
        take = lambda a: jnp.take_along_axis(a, best[:, None, :], 1)[:, 0, :]
        new_dist = jnp.where(adopt, take(nd), dist)
        new_tie = jnp.where(adopt, take(ntie), tie_c)
        new_carr = jnp.stack(
            [jnp.where(adopt, take(gp[:, :, (2 + j) * f:(3 + j) * f]), carr[j])
             for j in range(c)]) if c else carr
        return i + 1, new_dist, new_tie, new_carr, jnp.any(adopt)

    _, dist, tie_out, carr, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), dist0, tie, carried, jnp.bool_(True))
    )
    dist_f = jnp.where(dist > hops_cap[None, :], jnp.inf,
                       dist.astype(jnp.float32))
    return dist_f, tie_out, carr


def hash01(idx, salt):
    """Deterministic per-cell hash → [0,1) on device (uint32 mix), used to
    randomize BFS fronts like the reference's Knuth-hash priority noise
    (js/terrain-post.js:96-105). ``salt`` may be a python int or a traced
    integer scalar (so seed-dependence stays out of the compiled constant
    pool and fused pipelines don't retrace per seed)."""
    import numpy as _np
    if isinstance(salt, (int, _np.integer)):
        salt_u = jnp.uint32(salt & 0xFFFFFFFF)
    else:
        salt_u = jnp.asarray(salt).astype(jnp.uint32)
    h = (idx.astype(jnp.uint32) + salt_u) * jnp.uint32(2654435761)
    h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
    h = h ^ (h >> 16)
    return (h % jnp.uint32(1 << 24)).astype(jnp.float32) / jnp.float32(1 << 24)


@partial(jax.jit, static_argnames=("max_hops", "num_carry"))
def carry_bfs(seeds, carried, nbr_idx, nbr_mask, max_hops: int,
              allow=None, edge_same=None, tie=None, num_carry: int = 0):
    """Integer-hop BFS from ``seeds`` carrying per-seed values outward.

    Parallel re-design of the reference's carry-propagating queue BFS
    (coast boundary js/elevation.js:462-509, rift :511-538, ridge :542-568,
    fracture :570-596, back-arc :598-631, arcs :1054-1086): per sweep each
    eligible cell adopts (dist+1, carried values) from the neighbor with the
    lexicographically smallest (dist, -tie) — ties resolved toward higher
    ``tie`` exactly like the reference's equal-distance stress override
    (js/elevation.js:502-506).

    - ``carried``: [C, N] stacked float32 values following the BFS tree.
    - ``allow``:   [N] bool — cells permitted to be reached (default all).
    - ``edge_same``: [N, K] bool — extra per-edge constraint (e.g. same
      plate), aligned with nbr_idx slots of the RECEIVING cell.
    - dist is capped at ``max_hops``; unreached cells return +inf.
    """
    n = nbr_idx.shape[0]
    inf_i = jnp.int32(max_hops + 1)
    dist0 = jnp.where(seeds, 0, inf_i).astype(jnp.int32)
    if tie is None:
        tie = jnp.zeros(n, jnp.float32)
    if allow is None:
        allow = jnp.ones(n, bool)
    if edge_same is None:
        edge_same = jnp.ones_like(nbr_mask)
    if carried is None:
        carried = jnp.zeros((max(1, num_carry), n), jnp.float32)

    def pack(d, t):
        return d.astype(jnp.float32) * 2.0 - t

    def cond(state):
        i, _, _, _, changed = state
        return changed & (i < max_hops)

    def body(state):
        i, dist, tie_c, carr, _ = state
        nd = dist[nbr_idx] + 1                     # [N, K]
        ntie = tie_c[nbr_idx]
        ok = nbr_mask & edge_same & (nd <= max_hops) & allow[:, None]
        npack = jnp.where(ok, pack(nd, ntie), jnp.inf)
        best = jnp.argmin(npack, axis=1)
        best_pack = jnp.take_along_axis(npack, best[:, None], 1)[:, 0]
        adopt = best_pack < pack(dist, tie_c)
        src = jnp.take_along_axis(nbr_idx, best[:, None], 1)[:, 0]
        new_dist = jnp.where(adopt, dist[src] + 1, dist)
        new_tie = jnp.where(adopt, tie_c[src], tie_c)
        new_carr = jnp.where(adopt[None, :], carr[:, src], carr)
        changed = jnp.any(adopt)
        return i + 1, new_dist, new_tie, new_carr, changed

    _, dist, tie_out, carr, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), dist0, tie, carried, jnp.bool_(True))
    )
    dist_f = jnp.where(dist > max_hops, jnp.inf, dist.astype(jnp.float32))
    return dist_f, tie_out, carr
