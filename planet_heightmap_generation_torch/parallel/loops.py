"""The kernel loops of ops/sweep_cuda.py run split over a row of windows
(parallel/windows.py), each equal to its one-launch form bit for bit.

Every split loop takes the same inputs as its one-launch form, with each
``[..., NP]`` plane a :class:`~.windows.CellShards` (cell axis last) and
the band bits and remainder CSR a :class:`~.windows.WindowGraph`
(``layout.graph(bits, band_off, rem_ptr, rem_nbr)``). Each shard's launch
is the one-launch wrapper itself on its window: on CUDA windows it
launches the CUDA kernel, on CPU windows it runs the plain version; the
split adds no other branch. A loop returns ``(CellShards, count)`` with
the count on the host; every window's halo and slots are exchanged at
the end.

Two loop modes, chosen per loop by what makes it equal the one-launch
loop:

- **per sweep**: one sweep (pass, hop) a launch on every window, then an
  exchange; a fixpoint loop stops after the first sweep in which no chunk
  changed, or at its cap. Every chunk row reads exact neighbour values in
  every sweep, so this is the one-launch Jacobi loop, cap and sweep count
  included: the distance BFS (capped or not), stress, warp, smoothing and
  the rain shadow.
- **stale-halo rounds**: a launch runs the loop to its fixpoint on the
  window with the halo and slot rows frozen, then an exchange; the rounds
  repeat until no chunk changed in one. Only for loops whose fixpoint is
  unique: the ε-fill, and the components as min-label sweeps. Their
  counts are rounds, not the one-launch form's sweeps or steps.

The pointer-doubling sums (``accumulate_relax``, ``ordered_sum``) read
pointers that reach any cell: the *gather* route all-gathers the chunks
and runs the one launch once, on the layout's first device, and splits
the result back (as XLA all-gathers the operands of a split dynamic
gather). Once, not once per device: the loop's work is the whole array
either way, and on one card W launches would only repeat it.
"""

from __future__ import annotations

import torch

from ..ops import sweep_cuda
from .windows import CellShards, WindowGraph


def chunks_changed(layout, old, new) -> bool:
    """Whether any shard's chunk rows differ between windows ``old`` and
    ``new`` (cell axis last): one host read."""
    dev = layout.devices[0]
    flags = [(layout.chunk(n, c, -1) != layout.chunk(o, c, -1)).any().to(dev)
             for c, (o, n) in enumerate(zip(old, new))]
    return bool(torch.stack(flags).any())


def _per_sweep(layout, state, step, cap: int, fixpoint: bool = True):
    """Per-sweep mode: ``step(windows, i)`` (sweep i on every shard), then
    an exchange, until a sweep changes no chunk (``fixpoint``) or ``cap``
    sweeps ran (<= 0: no cap). Returns (windows, sweeps)."""
    state, n = list(state), 0
    while cap <= 0 or n < cap:
        new = step(state, n)
        changed = not fixpoint or chunks_changed(layout, state, new)
        layout.exchange(new, -1)
        state, n = new, n + 1
        if not changed:
            break
    return state, n


def _stale_rounds(layout, state, run):
    """Stale-halo mode: ``run(c, window)`` (a loop to the window's fixpoint
    with frozen halo and slots) on every shard, then an exchange, until a
    round changes no chunk. Returns (windows, rounds)."""
    state, n = list(state), 0
    while True:
        new = [run(c, w) for c, w in enumerate(state)]
        changed = chunks_changed(layout, state, new)
        layout.exchange(new, -1)
        state, n = new, n + 1
        if not changed:
            return state, n


def _each(launch):
    """A per-sweep step that runs ``launch(c, window, i)`` on every
    shard."""
    return lambda ws, i: [launch(c, x, i) for c, x in enumerate(ws)]


def _out(x: CellShards, windows) -> CellShards:
    return CellShards(x.layout, windows, -1)


def sharded_bfs_relax(cur, cost, wg, cap: int = 0):
    """:func:`sweep_cuda.bfs_relax` per sweep: the cap (which binds before
    the fixpoint on the path) and the sweep count are the one launch's."""
    step = _each(lambda c, x, _: sweep_cuda.bfs_relax(
        x, cost.windows[c], wg.bits(c), wg.band_off, *wg.csr(c), 1)[0])
    out, n = _per_sweep(cur.layout, cur.windows, step, int(cap))
    return _out(cur, out), n


def sharded_stress_relax(state, ocean, wg, rem_gate, decay: float,
                         sub_decay: float, cap: int):
    """:func:`sweep_cuda.stress_relax` per sweep (a capped argmax with
    payload ties: no schedule but the Jacobi one gives its values).
    ``rem_gate`` [G, M] is the global gate in CSR order, or a list of each
    window's [G, M_c] gates in its own CSR order."""
    gates = (list(rem_gate) if isinstance(rem_gate, (list, tuple))
             else [wg.edge_rows(rem_gate, c) for c in range(len(wg.shards))])
    step = _each(lambda c, x, _: sweep_cuda.stress_relax(
        x, ocean.windows[c], wg.bits(c), wg.band_off, *wg.csr(c), gates[c],
        decay, sub_decay, 1)[0])
    out, n = _per_sweep(state.layout, state.windows, step, int(cap))
    return _out(state, out), n


def sharded_warp_relax(state, w, wg, cap: int):
    """:func:`sweep_cuda.warp_relax` per sweep: it stops at its first sweep
    that changes nothing, and a sweep changed something exactly where a
    chunk's state changed (a pick is strictly nearer, so its coordinates
    differ). A sweep's remainder phase reads its neighbours' band-phase
    output, so each sweep is two launches of the kernel with an exchange
    between: the band phase (an empty remainder CSR), then the remainder
    phase (no band bits). The source index stays a global value: it rides
    along and is never dereferenced."""
    lay = state.layout
    if int(cap) < 1:
        return _out(state, [x.clone() for x in state.windows]), 0
    no_rows = [(torch.zeros(lay.length(c) + 1, dtype=torch.int32, device=d),
                torch.zeros(0, dtype=torch.int32, device=d))
               for c, d in enumerate(lay.devices)]
    no_bits = [torch.zeros(lay.length(c), dtype=torch.int32, device=d)
               for c, d in enumerate(lay.devices)]
    bands = _each(lambda c, x, _: sweep_cuda.warp_relax(
        x, w.windows[c], wg.bits(c), wg.band_off, *no_rows[c], 1)[0])
    rows = _each(lambda c, x, _: sweep_cuda.warp_relax(
        x, w.windows[c], no_bits[c], wg.band_off, *wg.csr(c), 1)[0])

    def step(ws, i):
        new = bands(ws, i)
        lay.exchange(new, -1)
        return rows(new, i)

    out, n = _per_sweep(lay, state.windows, step, int(cap))
    return _out(state, out), n


def sharded_flood_relax(surf, inland, elev_baked, wg, big: float,
                        eps: float):
    """:func:`sweep_cuda.flood_relax` in stale-halo rounds: the ε-fill's
    fixpoint is unique, so the rounds reach its surface. The count is
    rounds."""
    def run(c, x):
        return sweep_cuda.flood_relax(x, inland.windows[c],
                                      elev_baked.windows[c], wg.bits(c),
                                      wg.band_off, *wg.csr(c), big, eps)[0]

    out, n = _stale_rounds(surf.layout, surf.windows, run)
    return _out(surf, out), n


def sharded_smooth_relax(field, c_norm, wg, passes: int, gate=None,
                         upd=None):
    """:func:`sweep_cuda.smooth_relax` one pass a launch (a fixed pass
    count; every pass reads exact neighbours)."""
    if int(passes) < 1:
        raise ValueError(f"smoothing takes at least one pass, got {passes}")
    step = _each(lambda c, x, _: sweep_cuda.smooth_relax(
        x, c_norm.windows[c], wg.bits(c), wg.band_off, *wg.csr(c), 1,
        None if gate is None else gate.windows[c],
        None if upd is None else upd.windows[c]))
    out, _ = _per_sweep(field.layout, field.windows, step, int(passes),
                        fixpoint=False)
    return _out(field, out)


def sharded_shadow_relax(state, aux, land, wg, retain_s: float,
                         retain_w: float, shadow_hops: int,
                         windward_hops: int):
    """:func:`sweep_cuda.shadow_relax` one hop a launch: hop i updates the
    shadow columns while i < ``shadow_hops`` and the windward columns while
    i < ``windward_hops`` (a launch of one hop with 0 for a column that has
    stopped). The count is the hops, ``max(shadow_hops, windward_hops)``."""
    hops = max(int(shadow_hops), int(windward_hops), 0)
    if hops == 0:
        return _out(state, [x.clone() for x in state.windows]), 0
    step = _each(lambda c, x, i: sweep_cuda.shadow_relax(
        x, aux.windows[c], land.windows[c], wg.bits(c), wg.band_off,
        *wg.csr(c), retain_s, retain_w, int(i < int(shadow_hops)),
        int(i < int(windward_hops)))[0])
    out, n = _per_sweep(state.layout, state.windows, step, hops,
                        fixpoint=False)
    return _out(state, out), n


def sharded_components_relax(lab, wg):
    """:func:`sweep_cuda.components_relax` as min-label sweeps
    (``bfs_relax`` at zero cost over the gated bits and rows) in stale-halo
    rounds. The one-launch loop's hook and jumps dereference labels, which
    are global cell indices, so they cannot run on a window; they only
    hasten the loop to the same labels, the unique least min-label fixpoint
    from the initial labels over symmetric gates (each component's least
    initial label; non-members without a gated edge keep theirs), so the
    member mask is not needed. The count is rounds, not steps."""
    zeros = [torch.zeros((1, x.shape[-1]), dtype=torch.float32,
                         device=x.device) for x in lab.windows]

    def run(c, x):
        return sweep_cuda.bfs_relax(x[None], zeros[c], wg.bits(c),
                                    wg.band_off, *wg.csr(c), 0)[0][0]

    out, n = _stale_rounds(lab.layout, lab.windows, run)
    return _out(lab, out), n


def sharded_accumulate_relax(s, p, rounds: int, stop_at_sink: bool = True):
    """:func:`sweep_cuda.accumulate_relax` by the gather route: ``s``
    ([N] or [N, F]) and ``p`` ([N], global indices, the sink at N) split
    with cell axis 0, all-gathered to the first device, one launch there,
    the sums split back. Returns (CellShards, rounds)."""
    lay = s.layout
    out, ran = sweep_cuda.accumulate_relax(s.gather(), p.gather(), rounds,
                                           stop_at_sink)
    return CellShards(lay, lay.split(out, 0), 0), int(ran)


def sharded_ordered_sum(n_out: int, idx, vals):
    """:func:`sweep_cuda.ordered_sum` by the gather route over ``idx`` and
    ``vals`` split with cell axis 0: the sum on the first device, split
    back when it is cell-indexed (``n_out`` = NP), else that one tensor
    (bins: replicated, as a psum leaves it)."""
    lay = vals.layout
    out = sweep_cuda.ordered_sum(n_out, idx.gather(), vals.gather())
    if int(n_out) == lay.n_padded:
        return CellShards(lay, lay.split(out, 0), 0)
    return out


# ── the split generate's kernel routes (parallel/spmd.py ``launch``) ───────
# Each takes the layout and, per shard, the arguments its window passed to
# the one-launch wrapper (its own band bits and remainder CSR, built by the
# unchanged caller on the window graph), exchanges the cell planes the
# caller built on its window, runs the split loop and returns per shard
# what the wrapper returns.

def _graph(layout, vals, bits: int, ptr: int, band_off: int = 3):
    return WindowGraph(layout, tuple(int(o) for o in vals[0][band_off]),
                       tuple((v[bits], v[ptr], v[ptr + 1], None)
                             for v in vals))


def _planes(layout, vals, i: int) -> CellShards:
    wins = [v[i] for v in vals]
    layout.exchange(wins, -1)
    return CellShards(layout, wins, -1)


def _with_count(out: CellShards, n: int) -> list:
    return [(w, torch.tensor([int(n)], dtype=torch.int32, device=w.device))
            for w in out.windows]


def _route_bfs(layout, vals):
    # cur, cost, bits, band_off, rem_ptr, rem_nbr, cap
    out, n = sharded_bfs_relax(_planes(layout, vals, 0),
                               _planes(layout, vals, 1),
                               _graph(layout, vals, 2, 4), vals[0][6])
    return _with_count(out, n)


def _route_stress(layout, vals):
    # state, ocean, bits, band_off, rem_ptr, rem_nbr, rem_gate, decay,
    # sub_decay, cap
    v0 = vals[0]
    out, n = sharded_stress_relax(
        _planes(layout, vals, 0), _planes(layout, vals, 1),
        _graph(layout, vals, 2, 4), [v[6] for v in vals], v0[7], v0[8],
        v0[9])
    return _with_count(out, n)


def _route_warp(layout, vals):
    # state, w, bits, band_off, rem_ptr, rem_nbr, cap
    out, n = sharded_warp_relax(_planes(layout, vals, 0),
                                _planes(layout, vals, 1),
                                _graph(layout, vals, 2, 4), vals[0][6])
    return _with_count(out, n)


def _route_flood(layout, vals):
    # surf, inland, elev_baked, bits, band_off, rem_ptr, rem_nbr, big, eps
    out, n = sharded_flood_relax(
        _planes(layout, vals, 0), _planes(layout, vals, 1),
        _planes(layout, vals, 2), _graph(layout, vals, 3, 5, 4),
        vals[0][7], vals[0][8])
    return _with_count(out, n)


def _route_smooth(layout, vals):
    # field, c, bits, band_off, rem_ptr, rem_nbr, passes, gate, upd
    opt = [None if vals[0][i] is None else _planes(layout, vals, i)
           for i in (7, 8)]
    return sharded_smooth_relax(_planes(layout, vals, 0),
                                _planes(layout, vals, 1),
                                _graph(layout, vals, 2, 4), vals[0][6],
                                *opt).windows


def _route_shadow(layout, vals):
    # state, aux, land, bits, band_off, rem_ptr, rem_nbr, retain_s,
    # retain_w, shadow_hops, windward_hops
    v0 = vals[0]
    out, n = sharded_shadow_relax(
        _planes(layout, vals, 0), _planes(layout, vals, 1),
        _planes(layout, vals, 2), _graph(layout, vals, 3, 5, 4), v0[7],
        v0[8], v0[9], v0[10])
    return _with_count(out, n)


def _route_components(layout, vals):
    # lab, member, bits, band_off, rem_ptr, rem_nbr
    out, n = sharded_components_relax(_planes(layout, vals, 0),
                                      _graph(layout, vals, 2, 4))
    return _with_count(out, n)


def _route_accumulate(layout, vals):
    # s, p, rounds, stop_at_sink: the gather route
    out, n = sharded_accumulate_relax(
        CellShards(layout, [v[0] for v in vals], 0),
        CellShards(layout, [v[1] for v in vals], 0), vals[0][2], vals[0][3])
    return _with_count(out, n)


def _route_ordered_sum(layout, vals):
    # n_out, idx, vals: the gather route; bins come back whole to every
    # shard, cell-indexed sums as windows
    out = sharded_ordered_sum(
        vals[0][0], CellShards(layout, [v[1] for v in vals], 0),
        CellShards(layout, [v[2] for v in vals], 0))
    if isinstance(out, CellShards):
        return out.windows
    return [out.to(d) for d in layout.devices]


ROUTES = {
    "bfs_relax": _route_bfs, "stress_relax": _route_stress,
    "warp_relax": _route_warp, "flood_relax": _route_flood,
    "smooth_relax": _route_smooth, "shadow_relax": _route_shadow,
    "components_relax": _route_components, "accumulate": _route_accumulate,
    "ordered_sum": _route_ordered_sum,
}
