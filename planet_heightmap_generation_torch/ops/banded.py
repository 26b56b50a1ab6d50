"""Banded neighbour sweeps — masked shifts over the Fibonacci spiral
ordering, in torch.

The spiral mesh ordering makes neighbour index offsets (j - i) concentrate
onto ~32 signed Fibonacci numbers (mesh/build.py:build_banded). A
neighbour reduction is then D shifts of the field with per-band masks plus
a small remainder-edge scatter.

Every function takes the graph's ``band_off`` (tuple), ``band_mask
[NP,D]`` and the REAL remainder edges ``rem_src/rem_dst [M]`` (the
DeviceGraph stores them pre-filtered, so no scatter here needs a drop
mode) — normally splatted from ``g.bands``.

The fixpoint loops follow the JAX jnp loops' semantics: iteration caps
bound the number of sweeps, and a loop ends at the first sweep that changes
nothing. The distance BFS, the stress propagation and the components (and
the terrain warp and the ε-fill, in erosion/) run their whole loop in one
launch of their kernel (ops/sweep_cuda.py, plain torch on CPU tensors),
with no host sync. Only the carry BFS and flood_assign, which have no
kernel, run one synchronous sweep per step under :func:`relax`, which
reads the change flag every ``CHECK_EVERY`` sweeps (a host sync); the
extra sweeps past a fixpoint are no-ops and no loop runs past its cap.

The climate's Laplacian smoothing runs all the passes of a call in one
launch of the smoothing kernel; it sums, so it takes the remainder edges
as CSR rows in edge order (:func:`rem_csr`) instead of a scatter, and so
do :func:`banded_sum` and every other remainder-edge sum (:func:`rem_add`,
walked as rows): every neighbour sum keeps the jnp scatter-add's order
and gives the same bits on every run. The pointer-doubling loops, whose
targets change every round, are one launch of the accumulate kernel each
(:func:`pointer_accumulate`), and the one-round bin and deposit sums are
the same kernel's one round (:func:`ordered_index_sum`): each target's
floats add in source order, the CPU's bits on every run.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from . import sweep_cuda
from ..parallel import spmd

CHECK_EVERY = 8
INF = float("inf")


def relax(step, state, cap=None):
    """Iterate ``state = step(state, flag)`` until a sweep changes nothing
    or ``cap`` sweeps ran. ``flag`` is an int32 [1] device tensor passed
    only to the sweep whose change is read (else None). Returns
    (state, sweeps run)."""
    flag = None
    done = 0
    while cap is None or done < cap:
        k = CHECK_EVERY if cap is None else min(CHECK_EVERY, cap - done)
        for s in range(k):
            if s == k - 1:
                if flag is None:
                    flag = torch.zeros(1, dtype=torch.int32,
                                       device=_device_of(state))
                flag.zero_()
                state = step(state, flag)
            else:
                state = step(state, None)
        done += k
        if not spmd.flag_any(flag):
            break
    return state, done


def _device_of(state):
    return (state[0] if isinstance(state, (tuple, list)) else state).device


def _expand(mask, field):
    """Broadcast a [N] or [N,D] mask against field rank ([N] or [N,F])."""
    return mask[:, None] if field.dim() == 2 and mask.dim() == 1 else mask


def band_shift(field, off):
    """field[i + off] along the cell axis (wrap killed by band masks)."""
    return torch.roll(spmd.fresh(field), -int(off), dims=0)


def rem_gather(field, rem_dst):
    """Remainder-edge neighbour values, [M] or [M,F]: ``field[rem_dst]``."""
    return spmd.fresh(field)[rem_dst]


def pack_band_bits(band_mask):
    """[N, D≤32] bool band masks → [N] int32 words (bit d = band d)."""
    d = band_mask.shape[1]
    assert d <= 32, d
    w = (torch.ones(d, dtype=torch.int64, device=band_mask.device)
         << torch.arange(d, device=band_mask.device))
    packed = (band_mask.to(torch.int64) * w).sum(1)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return packed.to(torch.int32).contiguous()


_BAND_OFF_TENSORS: dict = {}


def band_off_tensor(band_off, device):
    """The band offsets as a float32 [D] tensor on ``device``, made once
    per (offsets, device): on the card a tensor made from a Python list
    is a host-to-device copy, which waits for the device's queue."""
    key = (tuple(int(o) for o in band_off), str(device))
    t = _BAND_OFF_TENSORS.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=torch.float32, device=device)
        _BAND_OFF_TENSORS[key] = t
    return t


def band_gate(cell_value, band_off, band_mask):
    """[N,D] per-edge gate: band_mask[i,d] & (value[i+off_d] == value[i])."""
    cols = [band_mask[:, d] & (band_shift(cell_value, off) == cell_value)
            for d, off in enumerate(band_off)]
    return torch.stack(cols, dim=1)


def band_nbr_dist(pos, band_off, band_mask):
    """[N,D] chord distance to each band neighbour, 0 where absent."""
    cols = []
    for d, off in enumerate(band_off):
        delta = band_shift(pos, off) - pos
        cols.append(torch.where(band_mask[:, d],
                                torch.linalg.vector_norm(delta, dim=1), 0.0))
    return torch.stack(cols, dim=1).to(torch.float32)


def _scatter(out, rem_src, vals, reduce: str):
    """out[rem_src] <reduce>= vals (include_self), along the cell axis."""
    idx = rem_src if vals.dim() == 1 else rem_src[:, None].expand_as(vals)
    return out.scatter_reduce(0, idx, vals, reduce)


def banded_min(field, band_off, band_mask, rem_src, rem_dst, fill=INF,
               gate=None):
    out = torch.full_like(field, fill)
    for d, off in enumerate(band_off):
        m = band_mask[:, d] if gate is None else gate[:, d]
        out = torch.minimum(out, torch.where(_expand(m, field),
                                             band_shift(field, off), fill))
    return _scatter(out, rem_src, rem_gather(field, rem_dst), "amin")


def banded_max(field, band_off, band_mask, rem_src, rem_dst, fill=-INF,
               gate=None):
    out = torch.full_like(field, fill)
    for d, off in enumerate(band_off):
        m = band_mask[:, d] if gate is None else gate[:, d]
        out = torch.maximum(out, torch.where(_expand(m, field),
                                             band_shift(field, off), fill))
    return _scatter(out, rem_src, rem_gather(field, rem_dst), "amax")


def banded_sum(field, band_off, band_mask, rem_src, rem_dst, gate=None):
    """Sum over neighbours: the bands in order, then each cell's remainder
    edges in edge order (the order of the jnp scatter-add
    ``.at[rem_src].add``), walked as rows (:func:`rem_add`) with no
    atomics, so a CUDA tensor gives the CPU's bits on every run."""
    out = torch.zeros_like(field)
    for d, off in enumerate(band_off):
        m = band_mask[:, d] if gate is None else gate[:, d]
        out = out + torch.where(_expand(m, field), band_shift(field, off), 0)
    return rem_add(out, rem_gather(field, rem_dst), rem_src, rem_dst)


def rem_add(out, edge_vals, rem_src, rem_dst):
    """``out`` plus, at each cell, the values ``edge_vals`` [M] (or [M,F])
    of the remainder edges it receives (``rem_src``), in edge order: the
    jnp scatter-add ``out.at[rem_src].add(edge_vals)``, walked as rows
    (:func:`rem_walk_edges`) with no atomics, so a CUDA tensor gives the
    CPU's bits on every run."""
    cells, edges = rem_walk_edges(rem_src, rem_dst)
    if not edges:
        return out
    acc = out[cells]
    for e in edges:
        acc[:e.shape[0]] += edge_vals[e]
    return out.index_put((cells,), acc)


def ordered_index_sum(n_out: int, idx, vals):
    """``out[t] = Σ vals[i]`` over the i with ``idx[i] == t``, added in
    ascending i from 0 (the order of the jnp ``.at[idx].add`` and of
    torch's CPU ``index_add``), for t < ``n_out``; entries with
    ``idx >= n_out`` (a virtual sink or overflow slot) are skipped.
    ``vals`` is [K] or [K, F] float32. On a CUDA tensor one launch of the
    accumulate kernel's one-round form (ops/sweep_cuda.py ``ordered_sum``),
    with no sort: the CPU's bits on every run."""
    return spmd.launch("ordered_sum", sweep_cuda.ordered_sum, n_out, idx,
                       vals)


def pointer_accumulate(s, p, rounds: int, stop_at_sink: bool = True):
    """The pointer-doubling sum ``S ← S + scatter_add(S along P), P ←
    P[P]`` over N cells with the sink at N (``p`` in [0, N], int32 or
    int64): at most ``rounds`` rounds, each target's adds in source order
    (int32 ``s``: counts, exact in any order). ``stop_at_sink`` stops
    before a round in which every pointer is at the sink (the JAX
    while_loop's cond); otherwise the loop ends once a round has run and
    every pointer is at the sink, where the JAX scan's further rounds
    change nothing. On a CUDA tensor the whole loop is one launch of the
    accumulate kernel (ops/sweep_cuda.py ``accumulate_relax``) with no host
    sync. Returns the sums."""
    return spmd.launch("accumulate", sweep_cuda.accumulate_relax, s, p,
                       rounds, stop_at_sink)[0]


# The remainder walk of each (rem_src, rem_dst) pair in use, keyed by the
# tensors' identity; weak references check that a key still names them
# and drop the entry with them.
_REM_WALKS: dict = {}


def rem_walk_edges(rem_src, rem_dst, host=None):
    """The remainder edges as rows of their receiving cell, in edge order:
    (cells, edges). ``cells`` [U] int64 are the cells with remainder
    edges, longest row first; ``edges[k]`` [U_k] int64 holds the index
    into the remainder list of the k-th edge of the first U_k of them
    (those with more than k edges). Built once per pair of tensors, from
    ``host`` = (rem_src, rem_dst) numpy arrays where the caller has them
    (mesh/device.py does), else on the tensors' own device (reading back
    only the row-length counts)."""
    key = (id(rem_src), id(rem_dst))
    hit = _REM_WALKS.get(key)
    if hit is not None and hit[0]() is rem_src and hit[1]() is rem_dst:
        return hit[2]
    src = (rem_src if host is None
           else torch.as_tensor(np.asarray(host[0]), dtype=torch.int64))
    order = torch.argsort(src, stable=True)
    cells, count = torch.unique_consecutive(src[order], return_counts=True)
    first = torch.cumsum(count, 0) - count
    rows = torch.argsort(-count, stable=True)
    longest = count[rows[:1]]
    ks = torch.arange(int(longest.sum()), device=src.device)
    widths = (count[:, None] > ks[None, :]).sum(0).tolist()
    dev = rem_src.device
    walk = (cells[rows].to(dev),
            tuple((order[first[rows[:u]] + k]).to(dev)
                  for k, u in enumerate(widths)))

    def drop(_):
        _REM_WALKS.pop(key, None)

    _REM_WALKS[key] = (weakref.ref(rem_src, drop), weakref.ref(rem_dst, drop),
                       walk)
    return walk


def banded_count(band_mask, rem_src, gate=None, dtype=torch.int32):
    """Neighbour degree [N], counted in int32 (exact, in any order) and
    returned as ``dtype``."""
    m = band_mask if gate is None else gate
    out = m.sum(1).to(torch.int32)
    out = _scatter(out, rem_src, torch.ones(rem_src.shape[0],
                                            dtype=torch.int32,
                                            device=out.device), "sum")
    return out.to(dtype)


def rem_gate_eq(cell_value, rem_src, rem_dst):
    """[M] remainder-edge equality gate matching :func:`band_gate`."""
    return cell_value[rem_src] == rem_gather(cell_value, rem_dst)


def banded_select(key_src, payloads, band_off, band_mask, rem_src, rem_dst,
                  minimize=False, edge_payloads=None, rem_edge_payloads=None):
    """Per-cell best-neighbour selection over [N] keys: the neighbour j
    maximising (or minimising) ``key_src[j]``, with its payloads. Bands
    are scanned in order and the FIRST best wins; remainder edges merge
    last and win only on strict improvement, equal-key remainder ties
    resolving toward the maximum payload. Returns
    (best_key, [payloads...], [edge payloads...])."""
    fill = INF if minimize else -INF
    better = (lambda a, b: a < b) if minimize else (lambda a, b: a > b)
    payloads = list(payloads)
    edge_payloads = list(edge_payloads or [])

    best_key = torch.full_like(key_src, fill)
    best_pay = [torch.zeros_like(p) for p in payloads]
    best_epay = [torch.zeros_like(ep[:, 0]) for ep in edge_payloads]
    for d, off in enumerate(band_off):
        k = torch.where(band_mask[:, d], band_shift(key_src, off), fill)
        upd = better(k, best_key)
        best_key = torch.where(upd, k, best_key)
        best_pay = [torch.where(upd, band_shift(p, off), bp)
                    for p, bp in zip(payloads, best_pay)]
        best_epay = [torch.where(upd, ep[:, d], bep)
                     for ep, bep in zip(edge_payloads, best_epay)]

    rk = rem_gather(key_src, rem_dst)
    w = _scatter(torch.full_like(key_src, fill), rem_src, rk,
                 "amin" if minimize else "amax")
    is_win = rk == w[rem_src]
    upd = better(w, best_key)
    best_key = torch.where(upd, w, best_key)

    def pick(cand):
        c = torch.where(is_win, cand, -INF)
        return _scatter(torch.full(w.shape, -INF, dtype=cand.dtype,
                                   device=w.device), rem_src, c, "amax")

    best_pay = [torch.where(upd, pick(rem_gather(p, rem_dst)), bp)
                for p, bp in zip(payloads, best_pay)]
    best_epay = [torch.where(upd, pick(rep), bep)
                 for rep, bep in zip(rem_edge_payloads or [], best_epay)]
    return best_key, best_pay, best_epay


# ── the erosion stencils' graph (ops/sweep_cuda.py section 9) ─────────

# Values derived once from tensors that the erosion loop passes unchanged
# from step to step, keyed by the tensors' identity; weak references check
# that a key still names them and drop the entry with them.
_DERIVED: dict = {}


def _derived(tag: str, keys: tuple, build):
    key = (tag, *(id(t) for t in keys))
    hit = _DERIVED.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], keys)):
        return hit[1]
    value = build()

    def drop(_):
        _DERIVED.pop(key, None)

    _DERIVED[key] = (tuple(weakref.ref(t, drop) for t in keys), value)
    return value


def stencil_graph(band_mask, rem_src, rem_dst, rem_dist=None):
    """The graph form of the one-pass stencil kernels: (band bits int32
    [NP], rem_ptr, rem_nbr, the remainder edge lengths in CSR order, or
    None without ``rem_dist``), built once per set of tensors (no host
    sync), so a step of the erosion loop reuses them."""
    npad = band_mask.shape[0]
    bits = _derived("bits", (band_mask,),
                    lambda: pack_band_bits(band_mask))
    ptr, nbr, order = _derived("csr", (rem_src, rem_dst),
                               lambda: rem_csr_order(rem_src, rem_dst, npad))
    dist = None if rem_dist is None else _derived(
        "dist", (rem_src, rem_dst, rem_dist),
        lambda: rem_dist[order].to(torch.float32).contiguous())
    return bits, ptr, nbr, dist


def host_f32(x) -> float:
    """A slider constant as the float32 value a kernel argument takes:
    ``float(x)`` of a float32 tensor (a host read on the card: pass a
    float there), a Python number rounded to float32."""
    if torch.is_tensor(x):
        return float(x.to(torch.float32))
    return float(np.float32(x))


def f32_mul(a: float, b: float) -> float:
    """``a * b`` rounded to float32 after each factor is, as torch takes a
    Python number times a float32 scalar tensor."""
    return float(np.float32(a) * np.float32(b))


# ── distance BFS (kernel 1) ──────────────────────────────────────────

def bfs_hops_multi_banded(seeds, barrier, band_off, band_mask, rem_src,
                          rem_dst, max_hops: int = 0, rand_cost=None):
    """F independent min-plus distance fields relaxed together.

    seeds/barrier [N,F] bool, rand_cost [N,F] f32 or None (unit costs).
    Seeds and barriers are baked in (dist0 = 0 at seeds, cost = +inf at
    non-seed barriers), which makes each sweep equal one iteration of the
    JAX jnp loop ``_bfs_hops_multi_jnp``. The whole loop is one relax
    launch (ops/sweep_cuda.py ``bfs_relax``), the remainder edges walked as
    CSR rows inside it, with no host sync. ``max_hops`` > 0 caps the
    number of sweeps (values beyond may be path-order overestimates,
    unreached = +inf). Returns [N,F] f32."""
    seeds_t = seeds.T
    dist = torch.where(seeds_t, 0.0, INF).to(torch.float32).contiguous()
    cost = (torch.ones_like(dist) if rand_cost is None
            else rand_cost.T.to(torch.float32))
    cost = torch.where(barrier.T & ~seeds_t, INF, cost).contiguous()
    bits = pack_band_bits(band_mask)
    ptr, nbr = rem_csr(rem_src, rem_dst, band_mask.shape[0])
    dist, _ = spmd.launch("bfs_relax", sweep_cuda.bfs_relax, dist, cost,
                          bits, band_off, ptr, nbr, int(max_hops))
    return dist.T


# ── stress propagation (kernel 2) ────────────────────────────────────

def propagate_stress_banded(stress, subduct, gate_stack, rem_gate,
                            ocean_cell, band_off, band_mask, rem_src,
                            rem_dst, decay, subduct_decay, num_passes):
    """G stress layers ([N,G] stress / subduct / ocean_cell, G [N,D] gates,
    [M,G] remainder gates) relaxed together until no layer changes or
    ``num_passes`` sweeps ran — the loop of ``_propagate_stress_jnp``. Per
    sweep each cell adopts the strongest propagated stress among gated
    (same-plate) neighbours, the subduct factor riding along: the band
    argmax (strict ``>`` in band order), then the remainder edges' max
    (ties to the largest subduct factor) on strict improvement. The whole
    loop is one relax launch (ops/sweep_cuda.py ``stress_relax``), the
    remainder edges walked as CSR rows inside it, with no host sync.
    Returns (stress, subduct) [N,G] f32."""
    state, ocean, bits, ptr, nbr, rgate = stress_planes(
        stress, subduct, gate_stack, rem_gate, ocean_cell, band_mask,
        rem_src, rem_dst)
    state, _ = spmd.launch(
        "stress_relax", sweep_cuda.stress_relax, state, ocean, bits,
        band_off, ptr, nbr, rgate, float(decay), float(subduct_decay),
        int(num_passes))
    return state[:, 0].T, state[:, 1].T


def stress_planes(stress, subduct, gate_stack, rem_gate, ocean_cell,
                  band_mask, rem_src, rem_dst):
    """The inputs of ``sweep_cuda.stress_relax`` for the layers of
    :func:`propagate_stress_banded`: (state [G,3,NP] = st, sf, act = st >
    0.01; ocean [G,NP] f32; bits [G,NP] of gate & band_mask; rem_ptr,
    rem_nbr; remainder gates [G,M] uint8 in CSR order)."""
    st0 = stress.T.to(torch.float32)
    state = torch.stack([st0, subduct.T.to(torch.float32),
                         (st0 > 0.01).to(torch.float32)], 1).contiguous()
    bits = torch.stack([pack_band_bits(gs & band_mask)
                        for gs in gate_stack]).contiguous()
    ptr, nbr, order = rem_csr_order(rem_src, rem_dst, band_mask.shape[0])
    return (state, ocean_cell.T.to(torch.float32).contiguous(), bits, ptr,
            nbr, rem_gate.T[:, order].to(torch.uint8).contiguous())


# ── carry BFS (plain torch; it has no kernel) ────────────────────────

def band_bfs_banded(seeds, carried, band_off, band_mask, rem_src, rem_dst,
                    max_hops: int, hops_cap=None, allow=None, rem_gate=None,
                    tie=None, num_carry: int = 0, gate_mix=None):
    """F carry-propagating BFS bands in one sweep loop (the JAX
    ``band_bfs_banded``).

    - seeds [N,F] bool; carried [C,N,F] f32; tie [N,F] (higher wins among
      equal distances); hops_cap [F] ints; allow [N,F] receiver mask.
    - gate_mix = (eq_gate [N,D], use [F] bools): field f is gated by
      eq_gate where use[f], by the plain band mask otherwise; rem_gate
      [M,F] gates the remainder edges.

    The (dist, tie) pair packs into one float key (dist·2 - tie) and is
    re-derived from the winning key. State rows are fields ([F,N]).
    Returns (dist [N,F] f32 with +inf unreached, tie [N,F], carr [C,N,F])."""
    n, f = seeds.shape
    dev = seeds.device
    c = max(num_carry, 0)
    dist = torch.where(seeds.T, 0, max_hops + 1).to(torch.int32)
    if hops_cap is None:
        cap = torch.full((f, 1), max_hops, dtype=torch.int32, device=dev)
    else:
        cap = torch.as_tensor(list(hops_cap), dtype=torch.int32,
                              device=dev)[:, None]
    allow_t = (torch.ones((f, n), dtype=torch.bool, device=dev)
               if allow is None else allow.T)
    tie_c = (torch.zeros((f, n), dtype=torch.float32, device=dev)
             if tie is None else tie.T.to(torch.float32))
    carr = [carried[j].T.to(torch.float32) for j in range(c)]

    if gate_mix is not None:
        eq, use = gate_mix
        use = [bool(u) for u in use]
        gates = [torch.stack([eq[:, d] if use[g] else band_mask[:, d]
                              for g in range(f)])
                 for d in range(len(band_off))]
    else:
        gates = [band_mask[:, d][None, :].expand(f, n)
                 for d in range(len(band_off))]
    rg = (torch.ones((f, rem_src.shape[0]), dtype=torch.bool, device=dev)
          if rem_gate is None else rem_gate.T)
    ridx = rem_src[None, :].expand(f, -1)

    def pack(d, t):
        return d.to(torch.float32) * 2.0 - t

    def step(state, flag):
        dist, tie_c, carr = state
        nd_src = dist + 1
        key_src = spmd.fresh(torch.where(nd_src <= cap, pack(nd_src, tie_c),
                                         INF), 1)
        carr = [spmd.fresh(p, 1) for p in carr]
        best_key = torch.full((f, n), INF, device=dev)
        best_pay = [torch.zeros((f, n), device=dev) for _ in range(c)]
        for d, off in enumerate(band_off):
            k = torch.where(gates[d], torch.roll(key_src, -int(off), 1), INF)
            u = k < best_key
            best_key = torch.where(u, k, best_key)
            best_pay = [torch.where(u, torch.roll(p, -int(off), 1), bp)
                        for p, bp in zip(carr, best_pay)]
        rk = torch.where(rg, key_src[:, rem_dst], INF)
        w = torch.full((f, n), INF, device=dev).scatter_reduce(
            1, ridx, rk, "amin")
        is_win = rg & (rk == w[:, rem_src])
        u = w < best_key
        best_key = torch.where(u, w, best_key)

        def pick(p):
            cand = torch.where(is_win, p[:, rem_dst], -INF)
            return torch.full((f, n), -INF, device=dev).scatter_reduce(
                1, ridx, cand, "amax")

        best_pay = [torch.where(u, pick(p), bp)
                    for p, bp in zip(carr, best_pay)]
        adopt = (best_key < pack(dist, tie_c)) & allow_t
        new_dist = torch.where(
            adopt, torch.ceil(best_key / 2.0).to(torch.int32), dist)
        new_tie = torch.where(
            adopt, new_dist.to(torch.float32) * 2.0 - best_key, tie_c)
        new_carr = [torch.where(adopt, bp, p) for p, bp in zip(carr, best_pay)]
        if flag is not None:
            flag |= adopt.any().to(torch.int32)
        return new_dist, new_tie, new_carr

    (dist, tie_c, carr), _ = relax(step, (dist, tie_c, carr), cap=max_hops)
    dist_out = torch.where(dist > cap, INF, dist.to(torch.float32))
    if c:
        carr_out = torch.stack([p.T for p in carr])
    else:
        carr_out = (torch.zeros((1, n, f), device=dev) if carried is None
                    else carried)
    return dist_out.T, tie_c.T, carr_out


# ── connected components (kernel 1 with zero cost) ───────────────────

def components_core(init_lab, member, gate_bits, rem_ok, band_off, rem_src,
                    rem_dst):
    """Min-label components: per step one gated min-label sweep over f32
    cell-index labels (exact below 2^24), the gated remainder edges, root
    hooking (each member scatter-mins its new label into its previous
    parent's slot) and two pointer jumps — one iteration of the JAX jnp
    components loops — until a step changes nothing. ``init_lab`` [N] f32
    (N at non-members); ``member`` [N] bool, or None when every cell is a
    member. The whole loop is one launch of the components kernel
    (ops/sweep_cuda.py ``components_relax``), the gated remainder edges as
    CSR rows (the ungated ones keyed past the last row), with no host
    sync. Returns [N] int32."""
    n = init_lab.shape[0]
    ptr, nbr = rem_csr(torch.where(rem_ok, rem_src, n), rem_dst, n)
    mem = None if member is None else member.to(torch.uint8).contiguous()
    lab, _ = spmd.launch(
        "components_relax", sweep_cuda.components_relax,
        init_lab.to(torch.float32).contiguous(), mem, gate_bits, band_off,
        ptr, nbr)
    return lab.to(torch.int32)


def connected_components_gated(labels_eq, band_off, band_mask, rem_src,
                               rem_dst):
    """Min-label connected components over edges whose endpoints share
    the same ``labels_eq`` value. Returns [N] int32."""
    n = band_mask.shape[0]
    gate = band_gate(labels_eq, band_off, band_mask)
    return components_core(
        spmd.arange(n, torch.float32, band_mask.device), None,
        pack_band_bits(gate), rem_gate_eq(labels_eq, rem_src, rem_dst),
        band_off, rem_src, rem_dst)


def flood_assign_banded(value, frontier, band_off, band_mask, rem_src,
                        rem_dst):
    """Propagate ``value`` outward from ``frontier`` cells to all
    reachable unassigned cells, breadth-first, ties toward the min value.
    Returns (value, reached)."""
    big = torch.iinfo(value.dtype).max

    def step(state, flag):
        val, reached = state
        masked = torch.where(reached, val, big)
        best = banded_min(masked, band_off, band_mask, rem_src, rem_dst,
                          fill=big)
        newly = (~reached) & (best < big)
        if flag is not None:
            flag |= newly.any().to(torch.int32)
        return torch.where(newly, best, val), reached | newly

    (val, reached), _ = relax(step, (value, frontier))
    return val, reached


# ── Laplacian smoothing (kernel 5) ───────────────────────────────────

def rem_csr(rem_src, rem_dst, npad: int):
    """The remainder edges as CSR rows of their destination cell, each row
    in edge order (a stable sort): (rem_ptr int32 [NP+1], rem_nbr int32
    [M]). The summing kernels walk a cell's row after its bands, which
    reproduces the order in which the jnp scatter-add ``.at[rem_src].add``
    accumulates, with no atomics. Row starts come from a sorted search, so
    building the CSR issues no host sync."""
    return rem_csr_order(rem_src, rem_dst, npad)[:2]


def rem_csr_order(rem_src, rem_dst, npad: int):
    """:func:`rem_csr` and the stable sort's ``order`` [M] int64: edge
    ``order[k]`` of the remainder list is CSR entry k, so a per-edge array
    ``a`` lines up with ``rem_nbr`` as ``a[order]``."""
    key, order = torch.sort(rem_src, stable=True)
    ptr = torch.searchsorted(key, torch.arange(
        npad + 1, dtype=key.dtype, device=rem_src.device))
    return (ptr.to(torch.int32).contiguous(),
            rem_dst[order].to(torch.int32).contiguous(), order)


def smooth_passes(field, c, band_off, band_mask, rem_src, rem_dst,
                  passes: int, gate=None, upd=None):
    """``passes`` smoothing passes, all in one launch of the smoothing
    kernel of ops/sweep_cuda.py (``smooth_relax``), over a [N] or [N,F]
    field (see ``smooth_relax`` for ``c``, ``gate`` and ``upd``). Returns
    f32 of the field's shape."""
    one_d = field.dim() == 1
    planes = (field[None] if one_d else field.T).to(torch.float32)
    planes = planes.contiguous()
    bits = pack_band_bits(band_mask)
    ptr, nbr = rem_csr(rem_src, rem_dst, band_mask.shape[0])
    c = c.to(torch.float32).contiguous()
    gate = None if gate is None else gate.to(torch.float32).contiguous()
    upd = None if upd is None else upd.to(torch.float32).contiguous()
    planes = spmd.launch("smooth_relax", sweep_cuda.smooth_relax, planes,
                         c, bits, band_off, ptr, nbr, passes, gate, upd)
    return planes[0] if one_d else planes.T


def smooth_field_banded(field, band_off, band_mask, rem_src, rem_dst,
                        passes: int):
    """Laplacian smoothing including the cell itself, ``passes`` times:
    ``f ← (f + Σ_nbr f) / (deg + 1)`` — the JAX ``_smooth_field_jnp``
    (which divides; its Pallas path multiplies by 1/(deg+1))."""
    c = banded_count(band_mask, rem_src, dtype=torch.float32) + 1
    return smooth_passes(field, c, band_off, band_mask, rem_src, rem_dst,
                         passes)


def smooth_masked_banded(field, mask, band_off, band_mask, rem_src, rem_dst,
                         passes: int):
    """Smoothing restricted to ``mask`` cells: non-mask cells neither
    contribute nor update (the JAX ``_smooth_masked_jnp``)."""
    mf = mask.to(torch.float32)
    c = 1 + banded_sum(mf, band_off, band_mask, rem_src, rem_dst)
    return smooth_passes(field, c, band_off, band_mask, rem_src, rem_dst,
                         passes, gate=mf, upd=mf)


# ── least-squares tangent gradients (plain torch) ────────────────────

def dot3(a, b):
    """Σ_c a[..., c]·b[..., c] over a last axis of 3, summed x, y, z in
    that order (the order of the JAX package's 3-term einsums)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def compute_gradients_banded(pos, field, east, north, band_off, band_mask,
                             rem_src, rem_dst):
    """Least-squares tangent gradients (js/wind.js:306-339) as quadratic
    forms of ONE stacked neighbour sum, the JAX ``compute_gradients_banded``
    term for term: Σ de² = vᵀMv with M = Σp_jp_jᵀ − p_iΣp_jᵀ − (Σp_j)p_iᵀ +
    deg·p_ip_iᵀ, evaluated as ``vpp − 2·vp·vsp + deg·vp·vp``, and
    Σ de·df = v·(Σf_jp_j − f_iΣp_j − p_iΣf_j + deg·f_ip_i). The terms
    cancel in f32, so their order is kept. Returns (ge, gn) of the field's
    shape."""
    n = pos.shape[0]
    f2 = field if field.dim() == 2 else field[:, None]
    nf = f2.shape[1]
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    pp = torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], 1)
    fp = (f2[:, :, None] * pos[:, None, :]).reshape(n, 3 * nf)
    s = banded_sum(torch.cat([pp, pos, f2, fp], 1), band_off, band_mask,
                   rem_src, rem_dst)
    deg = banded_count(band_mask, rem_src, dtype=torch.float32)
    s_pp, s_p = s[:, :6], s[:, 6:9]
    s_f, s_fp = s[:, 9:9 + nf], s[:, 9 + nf:].reshape(n, nf, 3)

    def quad(v):
        vpp = (v[:, 0] * v[:, 0] * s_pp[:, 0]
               + 2 * v[:, 0] * v[:, 1] * s_pp[:, 1]
               + 2 * v[:, 0] * v[:, 2] * s_pp[:, 2]
               + v[:, 1] * v[:, 1] * s_pp[:, 3]
               + 2 * v[:, 1] * v[:, 2] * s_pp[:, 4]
               + v[:, 2] * v[:, 2] * s_pp[:, 5])
        vp, vsp = dot3(v, pos), dot3(v, s_p)
        return vpp - 2 * vp * vsp + deg * vp * vp

    def cross(v):
        vfp = dot3(s_fp, v[:, None, :])
        vp, vsp = dot3(v, pos), dot3(v, s_p)
        return (vfp - f2 * vsp[:, None] - vp[:, None] * s_f
                + deg[:, None] * f2 * vp[:, None])

    sum_ee, sum_nn = quad(east), quad(north)
    sum_ep, sum_np = cross(east), cross(north)
    ge = torch.where(sum_ee[:, None] > 1e-12,
                     sum_ep / torch.clamp(sum_ee, min=1e-20)[:, None], 0.0)
    gn = torch.where(sum_nn[:, None] > 1e-12,
                     sum_np / torch.clamp(sum_nn, min=1e-20)[:, None], 0.0)
    if field.dim() == 1:
        ge, gn = ge[:, 0], gn[:, 0]
    return ge.to(torch.float32), gn.to(torch.float32)
