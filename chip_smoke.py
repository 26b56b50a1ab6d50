"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero with its traceback):

1. report the card and build the CUDA kernels from csrc/sweeps.cu;
2. hold every kernel against its plain-torch version on the card, on the
   204K-cell mesh (seed 42) with inputs made from numpy seeds at the main
   path's shapes: one launch runs a whole loop and must equal the plain
   loop bit for bit, in its sweep count too; time the launch (CUDA events
   over many launches, and its device time from a ``torch.profiler``
   trace), the plain loop, the least time the card could take (bytes or
   operations) and, where one PyTorch call computes the same function,
   that call. The relax launches (``bfs_relax``, ``stress``, ``warp``,
   ``flood``, ``smooth``, ``shadow``) run: the distance BFS at the path's
   three shapes (F=4 at the generate's cap of 119 sweeps, which must bind;
   the climate's F=5 coast fields at cap 70; F=1 at cap 28); stress at the
   path's two layers and cap of 68 sweeps, where the cap must bind, and at
   a decay that reaches its fixpoint before it; warp toward the path's
   targets at its cap of 17 sweeps and at a cap that binds; the ε-fill at
   1, 4 and 8 inner sweeps per barrier round; smoothing at every (fields,
   gate, update mask, passes) shape of the climate stack; the rain shadow
   at the path's 56 / 34 hops, with the windward columns running longer,
   and over clustered land. The lines report sweeps (ε-fill: rounds;
   smoothing: passes; rain shadow: hops), device µs per launch and per
   sweep, and the bound per sweep and per launch. The warp and rain-shadow
   callers (``warp_sources``, ``_rain_shadow2``) must equal themselves with
   the plain loop in the wrapper's place, in one launch and with no host
   sync. ``banded_sum`` on the card must equal the same call on CPU tensors
   bit for bit. After the default generate's first (cold) run, which
   records their arguments, the two launches of the pointer-doubling and
   components loops: ``accumulate`` on the generate's flow receivers (int32
   counts), its ``downstream_accumulate`` forest, the ice flow of a glacial
   step over a noise terrain (22 rounds, no stop at the sink), its deposit
   sum and the wind stage's geo bins (F=3; both one round), each equal to
   the plain loop on CPU copies bit for bit, twice, in its rounds too, with
   one atomic ``index_add_`` per round timed as the yardstick; and
   ``components`` at the generate's four call sites (all cells under the
   same-plate gate, the ocean subsets, the land subset), equal to the plain
   loop on the card in labels and steps; every caller of either launch
   runs with no host sync. Then every staged launch past 204K: synthetic
   meshes (the 204K band set with its widest pair replaced by ±5760, about
   the 2.56M mesh's half-width, on the 2.56M mesh's 2,561,024 cells, and by
   ±7200, ~4M cells, on 1,048,576 cells; bits and remainder edges from
   numpy seeds) whose plans the shared-memory window cap binds, so that
   chunks are no multiple of 4: smoothing F = 1..4 with and without gate
   and update mask, warp, stress with 2 layers, the BFS at F=1 and F=4,
   and the ε-fill, rain shadow and components at F=1, each equal to its
   plain loop on CPU copies bit for bit, in sweeps too (or refused, only
   where its windows no longer fit), timed, with its plan (T, H, windows,
   grid, shared bytes, capped or not) read back from the library;
3. drive the port's main path: the default ``PlanetEngine.generate``
   (``GenerationParams(seed=42)``: 204K cells, 80 plates, climate on),
   cold then warm, with every kernel's launch count (and the launches'
   sweeps, read from the device) taken around the warm run, which must
   hold one components launch per components loop and one accumulate
   launch per pointer-doubling loop or one-round sum, and no one-sweep BFS;
   then one more warm run under ``torch.profiler`` for the device's busy
   time and each kernel's device time per launch, and one under CUDA sync
   debug mode that counts the generate's host syncs; then one warm
   terrain-only run (``skip_climate=True``), timed and profiled the same
   way, so the terrain numbers stay comparable;
4. check the 4K planet (seed 123) with climate against the reference's
   pinned c4k_s123 snapshot: terrain distribution and Köppen shares;
5. the glacial generate (``glacial_erosion=0.2``, 204K, climate on): a
   first run records the arguments of every float-sum site (thermal,
   smoothing, ``dep_sum``, the flow counts, ``downstream_accumulate``, the
   wind bins, the moisture advection's ``wsum``, the ice flow, the glacial
   step's remainder sums), each replayed on the card twice and on the CPU
   (bit for bit), beside the cells in which the atomic form the site used
   before differs from the CPU; then a warm run, counted (``accumulate``
   must launch), timed, profiled and held to the same gates as the default
   generate;
6. the retained-state commands on the default planet: a no-change
   ``reapply`` equals the generate's elevation bit for bit; a sculpted
   ``reapply`` keeps the pre-post elevation; ``edit_recompute([0])``
   flips plate 0 and passes the gates; ``compute_climate`` runs its
   second call without wind or ocean stages; ``save_session`` →
   ``load_session`` → no-change ``reapply`` equals the live engine's
   retained elevation bit for bit; ``import_heightmap`` of a 1024×512
   band image passes the band checks; one ``WorkerProtocol.dispatch`` of
   each command returns its done type. Each command must launch the
   kernels of its path, and its wall time is printed;
7. sizes past 204K: ``GenerationParams(seed=42, n_cells=1_000_000,
   skip_climate=False)`` (the JAX bench config 4) and
   ``GenerationParams(seed=42, n_cells=2_560_000)`` (the detail ceiling,
   terrain-only by the 300K rule), each cold, then warm (stage table,
   launches and sweeps of every kernel, peak device memory, and one line
   per staged launch with its plan, read back from the library), then
   warm under the profiler (device busy time, events); each passes the
   gates of the default generate, and at 1M the climate's;
8. the product surfaces on the default planet of phase 3: every
   ``available_layers`` colour on the card equal to the same call on CPU
   copies (atol 1e-6); ``nearest_region`` and ``cell_info`` at 8 points,
   the CPU's cells; the wind and current arrows, the ITCZ and the plate
   borders; ``rasterize_cell_ids`` at 2048×1024 (timed; where its ids
   differ from the CPU's, the two candidates' scores differ by at most
   1e-6) and ``export_map`` of the six types; ``export_map_tiled`` of the
   heightmap at 8192×4096 (timed; >= 97 % of its pixels match the
   in-memory export); ``export_globe``; ``cli.main`` for ``generate`` →
   ``export`` (the npz's elevation the generate's, bit for bit) and a
   ``sweep`` of three terrain-only seeds with 2048-px exports.

Before the last line come JSON objects of the commands' wall times, the
sizes past 204K, the plans past 204K and the product surfaces' wall
times, a JSON object with one entry per kernel and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``. Without CUDA the
script exits with code 1 before printing any result.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_CELLS = 204_000
SEED = 42
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
# csrc kMaxWindowFloats: the dynamic shared memory a staged block may take
KMAX_WINDOW_FLOATS = (232448 - 1024) // 4
SOURCE = "planet_heightmap_generation_torch/csrc/sweeps.cu"
TPU_KERNELS = "planet_heightmap_generation_tpu/ops/sweep_pallas.py"
REPLACES = {"bfs_relax": f"{TPU_KERNELS}:171",
            "flood": f"{TPU_KERNELS}:230",
            "stress": f"{TPU_KERNELS}:388", "warp": f"{TPU_KERNELS}:480",
            "smooth": f"{TPU_KERNELS}:564", "shadow": f"{TPU_KERNELS}:619",
            # the components loop of the JAX _cc_core_pallas runs the BFS
            # kernel (BfsSweeper)
            "components": f"{TPU_KERNELS}:171",
            # port-only: no Pallas kernel; it replaces the XLA scatter-adds
            # of the pointer-doubling sums, first of them the ice flow's
            "accumulate":
                "planet_heightmap_generation_tpu/erosion/glacial.py:72"}
# the float sums routed through the accumulate launch (a whole loop:
# pointer_accumulate; one round: ordered_index_sum) or the remainder row
# walk (rem_add), and the int32 flow counts: (module, name it calls) →
# calls kept when recorded (the glacial step's valley widening and moraines
# are its two remainder sums)
SUM_SITES = {
    ("erosion.thermal", "rem_add"): 2,
    ("erosion.smooth", "rem_add"): 2,
    ("erosion.fluvial", "ordered_index_sum"): 1,
    ("erosion.fluvial", "pointer_accumulate"): 1,
    ("erosion.flood", "pointer_accumulate"): 1,
    ("climate.wind", "ordered_index_sum"): 1,
    ("climate.precipitation", "rem_add"): 1,
    ("erosion.glacial", "pointer_accumulate"): 1,
    ("erosion.glacial", "rem_add"): 2,
}
# the loops that launch the accumulate and components kernels, and the
# modules that call them: (module, name) → calls kept when recorded
LOOP_SITES = {
    ("erosion.fluvial", "pointer_accumulate"): 1,
    ("erosion.fluvial", "ordered_index_sum"): 1,
    ("erosion.flood", "pointer_accumulate"): 1,
    ("climate.wind", "ordered_index_sum"): 1,
    ("erosion.glacial", "pointer_accumulate"): 1,
    ("ops.banded", "components_core"): 4,
    ("erosion.flood", "components_core"): 4,
}
# the default generate with one launch per float sum and per components
# sweep, before both became one launch per loop (PERF.md §6 keeps the runs;
# the host syncs counted by tools/torch_compare_trees.py on that tree)
BEFORE_LOOP_LAUNCHES = dict(busy_ms=212.167, events=91024, host_syncs=749)
# smoothing calls of the default generate's climate stack, one launch each:
# wind 2, ocean currents 2, precipitation 6 (west coast included),
# temperature 2
SMOOTH_CALLS = 12
# c4k_s123 (tests/test_reference_parity.py:45-55)
SNAPSHOT_C4K = dict(
    land_fraction=0.31042,
    elevation_hist=[0.0, 0.0, 0.0, 0.0055, 0.02424, 0.03274, 0.06048,
                    0.12297, 0.24494, 0.1987, 0.02899, 0.02649, 0.04699,
                    0.09198, 0.04574, 0.03024, 0.019, 0.00625, 0.00525,
                    0.0095],
    koppen_top={0: 0.6896, 29: 0.045, 6: 0.0422, 19: 0.0362,
                3: 0.0307, 1: 0.0272, 30: 0.0247, 9: 0.0195},
    plate_count=12)


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls after
    ``warm`` warm-up calls, between two CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool((torch.isfinite(a) == torch.isfinite(b)).all()):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def with_plain(wrapper: str, fn):
    """Run ``fn()`` with the ``wrapper`` of ops/sweep_cuda replaced by its
    plain-torch version (``<wrapper>_plain``), so the same caller runs on
    the card without the kernel."""
    from planet_heightmap_generation_torch.ops import sweep_cuda

    kern = getattr(sweep_cuda, wrapper)
    setattr(sweep_cuda, wrapper, getattr(sweep_cuda, f"{wrapper}_plain"))
    try:
        return fn()
    finally:
        setattr(sweep_cuda, wrapper, kern)


def popcount(bits) -> int:
    b = bits.to(torch.int64) & 0xFFFFFFFF
    total = 0
    for d in range(32):
        total += int(((b >> d) & 1).sum())
    return total


def noise_plates(g):
    """Noise-blob plate labels [NP] int32 over the mesh."""
    from planet_heightmap_generation_torch.ops.noise import tables, fbm

    pos = g.pos
    blob = fbm(tables(7.0, g.device), pos[:, 0] * 2, pos[:, 1] * 2,
               pos[:, 2] * 2, 3)
    return torch.floor(blob * 6).to(torch.int32)


def noise_terrain(g):
    """A noise elevation [NP] with oceans, inland seas and polar land."""
    from planet_heightmap_generation_torch.ops.noise import tables, fbm

    pos = g.pos
    e = fbm(tables(3.0, g.device), pos[:, 0] * 2, pos[:, 1] * 2,
            pos[:, 2] * 2)
    return torch.where(g.valid, e * 0.6 + 0.25 * pos[:, 2], 0.0)


def bound_ms(nbytes: float, nops: float):
    """(least ms, what bounds it) for a launch moving ``nbytes`` and doing
    ``nops`` f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ── phase 2: kernels against their plain versions ────────────────────

def kernel_checks(g, g_cpu, dev, reps: int = 200, plain_reps: int = 10):
    """One record per kernel: loop bit-identity, launches the loop took,
    per-launch times and bound at each of the path's shapes."""
    from planet_heightmap_generation_torch.ops import banded, sweep_cuda
    from planet_heightmap_generation_torch.ops.noise import tables
    from planet_heightmap_generation_torch.elevation.assemble import (
        distance_bfs_caps)
    from planet_heightmap_generation_torch.erosion import flood, warp
    from planet_heightmap_generation_torch.climate import wind

    npad = g.n_padded
    rng = np.random.default_rng(SEED)
    rng2 = np.random.default_rng(SEED + 1)
    valid = g.valid.cpu().numpy()
    bits = g.band_bits
    edges = popcount(bits)
    sf_res = math.sqrt(g.n_cells / 10000.0)
    records = {}

    def bfs_planes(seeds, barrier, cost=None):
        """A distance BFS's [F, NP] start and cost planes, with seeds and
        barriers baked in as ops/banded.py bfs_hops_multi_banded does."""
        s, b = seeds.T, barrier.T
        cur = torch.where(s, 0.0, float("inf")).contiguous()
        c = torch.ones_like(cur) if cost is None else cost.T
        return cur, torch.where(b & ~s, float("inf"), c).contiguous()

    ptr, nbr = banded.rem_csr(g.rem_src, g.rem_dst, npad)
    m = nbr.shape[0]
    csr_bytes = (npad + 1 + m) * 4

    def relax_bytes_ops(f):
        return (3 * f + 1) * npad * 4 + csr_bytes, f * (edges + m + 2 * npad)

    # four-field distance BFS with random costs, the bfs5 loop's shape, at
    # the generate's cap; three seeds a field, so that the cap binds as it
    # does on the path
    f = 4
    seeds = np.zeros((npad, f), bool)
    for k in range(f):
        seeds[rng.choice(np.flatnonzero(valid), 3, replace=False), k] = True
    barrier = torch.as_tensor(rng.random((npad, f)) < 0.05, device=dev)
    cost = torch.as_tensor(rng.random((npad, f)).astype(np.float32) + 0.5,
                           device=dev)
    hops = distance_bfs_caps(sf_res)[3]
    cur, cost_t = bfs_planes(torch.as_tensor(seeds, device=dev), barrier,
                             cost)

    # noise-blob plates (the same-plate gates of stress) and a noise
    # terrain with inland seas (coast seeds, ε-fill)
    pos = g.pos
    plate = noise_plates(g)
    elev = noise_terrain(g)

    # 1. the distance-BFS relax launch at the path's three shapes: F=4 at
    # cap 119 (the cap must bind), the climate's five coast fields at its
    # cap 70 (coast seeds and barriers of the noise terrain over the
    # noise-blob plates, unit cost), and F=1 at cap 28 (the land coast,
    # random cost)
    plate_ix = (plate - plate.min()).long()
    plate_is_ocean = torch.as_tensor(
        rng2.random(int(plate_ix.max()) + 1) < 0.5, device=dev)
    seeds5, barriers5, _ = wind.coast_bfs_seeds(g, elev, plate_is_ocean,
                                                plate_ix)
    cur5, cost5 = bfs_planes(seeds5, barriers5)
    cost1 = torch.as_tensor(rng2.random((npad, 1)).astype(np.float32) + 0.5,
                            device=dev)
    cur1, cost1 = bfs_planes(seeds5[:, :1], torch.zeros_like(seeds5[:, :1]),
                             cost1)

    def bfs_config(label, c, k, cap, must_bind):
        def run():
            return sweep_cuda.bfs_relax(c, k, bits, g.band_off, ptr, nbr, cap)
        ref = plain_loop(lambda: sweep_cuda.bfs_relax_plain(
            c, k, bits, g.band_off, ptr, nbr, cap))
        return dict(label=label, run=run, ref=ref,
                    cost=relax_bytes_ops(c.shape[0]), cap=cap,
                    binds=True if must_bind else None)

    records["bfs_relax"] = relax_record("bfs_relax", [
        bfs_config(f"F=4 cap {hops}", cur, cost_t, hops, True),
        bfs_config(f"F=5 cap {wind.climate_coast_cap(g.n_cells)}", cur5,
                   cost5, wind.climate_coast_cap(g.n_cells), False),
        bfs_config(f"F=1 cap {min(hops, 28)}", cur1, cost1, min(hops, 28),
                   False)])

    # 2. stress: the default generate's joint loop of two layers (the
    # noise-blob plates, and super plates that join them in pairs; whole
    # plates ocean at random, as on the path) at its cap of 68 sweeps,
    # with start stress up to 2 so that the cap binds; and at a fast decay
    # that reaches its fixpoint before the cap
    rng3 = np.random.default_rng(SEED + 2)
    base_decay = 0.5 + 5.0 * 0.04
    decay = base_decay ** (1 / sf_res)
    sub_decay = (base_decay * 0.45) ** (1 / sf_res)
    passes = max(1, round(5.0 * 3 * sf_res))
    layers = (plate - plate.min(), torch.div(plate - plate.min(), 2,
                                             rounding_mode="floor"))
    ocean2 = torch.stack([torch.as_tensor(
        rng3.random(int(p.max()) + 1) < 0.3, device=dev)[p.long()]
        for p in layers], 1)
    st2 = torch.as_tensor(np.where(
        rng3.random((npad, 2)) < 0.01, rng3.random((npad, 2)) * 2.0,
        0.0).astype(np.float32), device=dev)
    sf2 = torch.as_tensor(rng3.random((npad, 2)).astype(np.float32),
                          device=dev)
    sgates = [banded.band_gate(p, g.band_off, g.band_mask) for p in layers]
    srgates = torch.stack([banded.rem_gate_eq(p, g.rem_src, g.rem_dst)
                           for p in layers], 1)
    sins = banded.stress_planes(st2, sf2, sgates, srgates, ocean2,
                                *g.bands[1:])
    layer_edges = sum(popcount(b) for b in sins[2])
    stress_cost = ((8 * 2) * npad * 4 + csr_bytes + 2 * m,
                   4 * (layer_edges + 2 * m) + 2 * 4 * npad)

    def stress_config(label, dk, sdk, binds):
        def run():
            return sweep_cuda.stress_relax(*sins[:3], g.band_off, *sins[3:],
                                           dk, sdk, passes)
        return dict(label=label, run=run, cost=stress_cost, cap=passes,
                    binds=binds, ref=plain_loop(
                        lambda: sweep_cuda.stress_relax_plain(
                            *sins[:3], g.band_off, *sins[3:], dk, sdk,
                            passes)))

    records["stress"] = relax_record("stress", [
        stress_config(f"G=2 cap {passes}", decay, sub_decay, True),
        stress_config(f"G=2 cap {passes}, decay 0.6", 0.6, 0.5, False)])

    # 3. warp candidate propagation toward the default-slider targets, at
    # the path's cap (17 sweeps at 204K) and at a cap that binds
    w = warp.warp_targets(pos, tables(SEED + 9999.0, dev),
                          torch.tensor(0.5, device=dev))
    wt = w.T.contiguous()
    steps = int(math.ceil(0.06 / (math.pi / math.sqrt(g.n_cells)))) + 8
    wstate = torch.cat([torch.arange(npad, dtype=torch.float32,
                                     device=dev)[None], pos.T]).contiguous()
    warp_cost = (12 * npad * 4 + csr_bytes, 9 * (edges + m) + 9 * npad)

    def warp_config(cap, binds):
        args = (wstate, wt, bits, g.band_off, ptr, nbr, cap)
        return dict(label=f"cap {cap}", cap=cap, binds=binds,
                    cost=warp_cost,
                    run=lambda: sweep_cuda.warp_relax(*args),
                    ref=plain_loop(lambda: sweep_cuda.warp_relax_plain(*args)))

    records["warp"] = relax_record("warp", [warp_config(steps, None),
                                            warp_config(3, True)])
    caller_check("warp", "warp_relax", lambda: warp.warp_sources(
        pos, w, *g.bands, max_steps=steps))

    # 4. ε-fill of the noise terrain with its inland seas, to its fixpoint,
    # at k = 1, 4 and 8 inner sweeps per barrier round
    is_ocean = (elev <= 0) & g.valid
    oo = flood.open_ocean_mask(is_ocean, g.valid, *g.bands)
    inland, _, surf0, frozen = flood._fill_common(
        elev, is_ocean, oo, g.valid, *g.bands)
    fill_in = (surf0.contiguous(), inland.float().contiguous(),
               torch.where(frozen, surf0, elev).contiguous(), bits,
               g.band_off, ptr, nbr, flood.BIG, flood.EPS)
    fill_ref = plain_loop(lambda: sweep_cuda.flood_relax_plain(*fill_in))
    fill_cost = (5 * npad * 4 + csr_bytes, 2 * (edges + m) + 3 * npad)

    def fill(k):
        return lambda: sweep_cuda._flood_relax(*fill_in, k)

    records["flood"] = relax_record("flood", [
        dict(label=f"k={k}", run=fill(k), ref=fill_ref, cost=fill_cost)
        for k in (1, 4, 8)],
        primary=(1, 4, 8).index(sweep_cuda.FLOOD_INNER))

    # 5. smoothing: one launch per call at every (fields, gate, update
    # mask, passes) shape of the default generate's climate stack (pass
    # counts from the climate modules' formulas at 204K cells): ocean
    # warmth (F=2, frozen interiors pass through), ocean currents and
    # their warmth (F=4 and F=2, masked), the west-coast signal (F=1,
    # masked), plain F=2 passes (temperature: 1; convergence) and F=1
    # (elevation). The row's numbers are those of the 1-pass launch, the
    # shape one torch.sparse.mm call also computes.
    avg_edge_km = math.pi * 6371 / math.sqrt(g.n_cells)
    deg = banded.banded_count(g.band_mask, g.rem_src, dtype=torch.float32)
    c_all = (deg + 1).contiguous()
    ocean_m = (torch.as_tensor(rng.random(npad) < 0.7, device=dev)
               & g.valid).float().contiguous()
    land_m = ((1 - ocean_m) * g.valid).contiguous()
    thaw = torch.as_tensor(rng.random(npad) < 0.9, device=dev).float()

    def masked_c(mf):
        return (1 + banded.banded_sum(mf, *g.bands)).contiguous()

    def smooth_config(label, f, passes, c, gate=None, upd=None):
        x = torch.as_tensor(rng.standard_normal((f, npad)).astype(np.float32),
                            device=dev)
        args = (x, c, bits, g.band_off, ptr, nbr, passes, gate, upd)
        planes = (2 * f + 2 + (gate is not None) + (upd is not None))
        ref = plain_loop(lambda: (sweep_cuda.smooth_relax_plain(*args),
                                  passes))
        return dict(label=label, ref=ref, field=x,
                    run=lambda: (sweep_cuda.smooth_relax(*args), passes),
                    cost=(planes * npad * 4 + csr_bytes,
                          f * (edges + m + 2 * npad)))

    smooth_cfgs = [
        smooth_config("F=2, 1 pass", 2, 1, c_all),
        smooth_config(f"F=2 upd, {max(4, round(1400 / avg_edge_km))} passes",
                      2, max(4, round(1400 / avg_edge_km)), c_all, upd=thaw),
        smooth_config(f"F=4 masked, {max(2, round(125 / avg_edge_km))} passes",
                      4, max(2, round(125 / avg_edge_km)), masked_c(ocean_m),
                      ocean_m, ocean_m),
        smooth_config(f"F=2 masked, {max(3, round(900 / avg_edge_km))} passes",
                      2, max(3, round(900 / avg_edge_km)), masked_c(ocean_m),
                      ocean_m, ocean_m),
        smooth_config(f"F=1 masked, {max(2, round(300 / avg_edge_km))} passes",
                      1, max(2, round(300 / avg_edge_km)), masked_c(land_m),
                      land_m, land_m),
        smooth_config(f"F=2, {max(3, round(400 / avg_edge_km))} passes", 2,
                      max(3, round(400 / avg_edge_km)), c_all),
        smooth_config(f"F=1, {max(2, round(200 / avg_edge_km))} passes", 1,
                      max(2, round(200 / avg_edge_km)), c_all)]
    records["smooth"] = relax_record("smooth", smooth_cfgs)
    f2 = smooth_cfgs[0]["field"].T.contiguous()
    lib_ms = time_ms(smooth_library(g, c_all, f2), 200)
    records["smooth"]["library_ms"] = lib_ms
    print(f"kernel smooth library call (one pass, F=2) {lib_ms * 1e3:.2f} us",
          flush=True)

    # 6. rain shadow: 56 hops (34 windward) of the default generate's
    # [4, NP] state over winds and slopes made from numpy seeds; with the
    # windward columns running longer; and over the noise terrain's land,
    # clustered as the path's is
    from planet_heightmap_generation_torch.climate import precipitation
    elev6 = torch.as_tensor((rng.standard_normal(npad) * 0.4)
                            .astype(np.float32), device=dev) * g.valid
    height_km = torch.clamp(elev6, min=0.0) * 6.0
    land = (elev6 > 0) & g.valid
    wind3d2 = torch.as_tensor(rng.standard_normal((npad, 2, 3))
                              .astype(np.float32) * 0.3, device=dev)
    wdg2 = torch.as_tensor(rng.standard_normal((npad, 2))
                           .astype(np.float32) * 0.1, device=dev)
    s_hops = max(8, round(2500 / avg_edge_km))
    w_hops = max(6, round(1500 / avg_edge_km))
    aux = torch.cat([g.pos.T, wind3d2[:, 0].T, wind3d2[:, 1].T]).contiguous()

    def shadow_config(label, sh, wh, terrain=elev6):
        is_land = (terrain > 0) & g.valid
        seed2 = precipitation._shadow_seeds2(
            terrain, torch.clamp(terrain, min=0.0) * 6.0, is_land, wdg2)
        args = (torch.cat([seed2, seed2], 1).T.contiguous(), aux,
                is_land.float().contiguous(), bits, g.band_off, ptr, nbr,
                *precipitation.shadow_retain(sh, wh), sh, wh)
        n_land = int(is_land.sum())
        land_edges = popcount(bits[is_land]) + int(is_land[g.rem_src].sum())
        # a column a hop updates: ~3 flops per land edge (w > 0 and a sign
        # test gate wsum += w, wacc += w * v) and ~2 per land cell (divide,
        # scale, min / max); the weights, ~23 flops per land edge (d, then
        # four 3-term dots), once on the first hop
        col_ops = 3 * land_edges + 2 * n_land
        return dict(label=label, cap=max(sh, wh), binds=True,
                    cost=((4 + 9 + 1 + 1 + 4) * npad * 4 + csr_bytes,
                          4 * col_ops),
                    launch_ops=23 * land_edges + 2 * (sh + wh) * col_ops,
                    run=lambda: sweep_cuda.shadow_relax(*args),
                    ref=plain_loop(
                        lambda: sweep_cuda.shadow_relax_plain(*args)))

    records["shadow"] = relax_record("shadow", [
        shadow_config(f"{s_hops}/{w_hops} hops", s_hops, w_hops),
        shadow_config(f"{w_hops}/{s_hops} hops", w_hops, s_hops),
        shadow_config(f"{s_hops}/{w_hops} hops, noise-terrain land", s_hops,
                      w_hops, terrain=elev)])
    caller_check("shadow", "shadow_relax", lambda: precipitation._rain_shadow2(
        g.pos, elev6, height_km, land, wind3d2, wdg2, *g.bands, s_hops,
        w_hops))

    # 7. the drivers of the stress and smoothing launches, and banded_sum,
    # issue no host sync (the relax launches and the warp and rain-shadow
    # callers are checked above)
    no_host_sync("propagate_stress_banded",
                 lambda: banded.propagate_stress_banded(
                     st2, sf2, sgates, srgates, ocean2, *g.bands, decay,
                     sub_decay, passes))
    no_host_sync("smooth_masked_banded", lambda: banded.smooth_masked_banded(
        smooth_cfgs[2]["field"].T, ocean_m > 0, *g.bands, 3))
    no_host_sync("banded_sum", lambda: banded.banded_sum(
        smooth_cfgs[2]["field"].T, *g.bands))
    print("host syncs: none in propagate_stress_banded, "
          "smooth_masked_banded, banded_sum, warp_sources, _rain_shadow2 or "
          "any relax launch", flush=True)

    # 8. banded_sum's remainder rows: the same bits on the card as on CPU
    # tensors, on the climate's coast-seed stack (wind.coast_bfs_seeds:
    # main ocean, plate ocean, land, land·xyz) and on five standard-normal
    # fields
    main_ocean = flood.open_ocean_mask((elev <= 0) & g.valid, g.valid,
                                       *g.bands)
    land_f = ((elev > 0) & g.valid).float()
    banded_sum_check(g, g_cpu, [
        ("coast-seed stack", torch.cat([
            main_ocean.float()[:, None],
            plate_is_ocean[plate_ix].float()[:, None], land_f[:, None],
            land_f[:, None] * g.pos], 1)),
        ("5 normal fields", torch.as_tensor(
            rng.standard_normal((npad, 5)).astype(np.float32), device=dev))])
    return records


# ── phase 2: the staged launches' plans past 204K ────────────────────

def synthetic_mesh(band_off, half_width: int, npad: int, seed: int):
    """A banded mesh of ``npad`` cells made from a numpy seed, as CPU
    tensors: the mesh's band set with its widest pair replaced by
    ±``half_width`` (set in half the cells, every other band in a fifth),
    and one random remainder edge per 100 cells. Returns (band_off, bits,
    rem_ptr, rem_nbr)."""
    from planet_heightmap_generation_torch.ops import banded

    offs = sorted(band_off, key=abs)[:-2] + [-half_width, half_width]
    offs = tuple(sorted(int(o) for o in offs))
    rng = np.random.default_rng(seed)
    wide = np.abs(np.asarray(offs)) == half_width
    mask = rng.random((npad, len(offs))) < np.where(wide, 0.5, 0.2)
    bits = banded.pack_band_bits(torch.as_tensor(mask))
    m = npad // 100
    ptr, nbr = banded.rem_csr(torch.as_tensor(rng.integers(0, npad, m)),
                              torch.as_tensor(rng.integers(0, npad, m)),
                              npad)
    return offs, bits, ptr, nbr


def plan_configs(mesh, npad: int, seed: int):
    """Every staged launch at its real windows per item, on ``mesh``
    (:func:`synthetic_mesh`), with inputs made from a numpy seed as CPU
    tensors and short loops (caps of 2-3 sweeps; the ε-fill and the
    components run to their fixpoints): smoothing with F = 1..4 fields
    without and with gate and update mask (and F=2 with the update mask
    alone), warp, stress with 2 layers, the BFS at F=1 and F=4, and F=1
    for the ε-fill, rain shadow and components. Returns (label, kernel, wrapper, args, bytes
    per sweep) tuples: ``wrapper(*args)`` on CPU tensors runs the plain
    loop."""
    from planet_heightmap_generation_torch.ops import sweep_cuda as sc

    offs, bits, ptr, nbr = mesh
    rng = np.random.default_rng(seed)
    csr = (npad + 1 + nbr.shape[0]) * 4

    def f32(*shape, lo=0.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32))

    def mask(p):
        return torch.as_tensor((rng.random(npad) < p).astype(np.float32))

    def unit(n):
        v = rng.standard_normal((3, n))
        return torch.as_tensor((v / np.linalg.norm(v, axis=0))
                               .astype(np.float32))

    def plane_bytes(planes):
        return planes * npad * 4 + npad * 4 + csr

    out = []
    c = f32(npad, lo=1.0, hi=8.0)
    for f in range(1, sc.SMOOTH_MAX_FIELDS + 1):
        masks = [(None, None), (mask(0.8), mask(0.9))]
        if f == 2:
            masks.append((None, mask(0.9)))
        for gate, upd in masks:
            name = ("" if gate is None else "gate ") + (
                "" if upd is None else "upd")
            out.append((f"smooth F={f}" + (f" {name.strip()}" if name.strip()
                                           else ""), "smooth",
                        sc.smooth_relax,
                        (f32(f, npad, lo=-1.0), c, bits, offs, ptr, nbr, 2,
                         gate, upd),
                        plane_bytes(2 * f + 1 + (gate is not None)
                                    + (upd is not None))))
    pos = unit(npad)
    state = torch.cat([torch.arange(npad, dtype=torch.float32)[None], pos])
    target = pos + 0.05 * unit(npad)
    out.append(("warp", "warp", sc.warp_relax,
                (state.contiguous(), target.contiguous(), bits, offs, ptr,
                 nbr, 3), plane_bytes(8 + 3)))
    g = 2
    st = torch.where(torch.as_tensor(rng.random((g, npad)) < 0.05),
                     f32(g, npad, hi=2.0), 0.0)
    layers = torch.stack([st, f32(g, npad), mask(0.5).expand(g, -1)], 1)
    lbits = torch.stack([bits & torch.as_tensor(
        rng.integers(-2 ** 31, 2 ** 31, npad).astype(np.int32))
        for _ in range(g)])
    out.append(("stress G=2", "stress", sc.stress_relax,
                (layers.contiguous(), mask(0.3).expand(g, -1).contiguous(),
                 lbits.contiguous(), offs, ptr, nbr,
                 torch.as_tensor(rng.random((g, nbr.shape[0])) < 0.7)
                 .to(torch.uint8), 0.9, 0.5, 3),
                plane_bytes(g * (3 * 2 + 2))))
    for f in (1, 4):   # F=4 (four groups) is capped at 2.56M cells
        seeds = torch.as_tensor(rng.random((f, npad)) < 0.01)
        out.append((f"bfs F={f}", "bfs_relax", sc.bfs_relax,
                    (torch.where(seeds, 0.0, float("inf")).contiguous(),
                     f32(f, npad, lo=0.5, hi=1.5), bits, offs, ptr, nbr, 3),
                    plane_bytes(3 * f)))
    elev = f32(npad, lo=-1.0)
    ocean = torch.as_tensor(rng.random(npad) < 0.3)
    big = 1e9
    out.append(("flood F=1", "flood", sc.flood_relax,
                (torch.where(ocean, elev, big).contiguous(), mask(0.02),
                 elev, bits, offs, ptr, nbr, big, 1e-4),
                plane_bytes(4)))
    aux = torch.cat([pos, 0.3 * unit(npad), 0.3 * unit(npad)])
    out.append(("shadow F=1", "shadow", sc.shadow_relax,
                (f32(4, npad, lo=-1.0), aux.contiguous(), mask(0.4), bits,
                 offs, ptr, nbr, 0.9, 0.8, 3, 2),
                plane_bytes(4 * 2 + 9 + 1)))
    out.append(("components F=1", "components", sc.components_relax,
                (torch.arange(npad, dtype=torch.float32),
                 None, bits & torch.as_tensor(rng.integers(
                     -2 ** 31, 2 ** 31, npad).astype(np.int32)),
                 offs, ptr, nbr), plane_bytes(2)))
    return out


# windows per item of each staged kernel (csrc make_geo's nw; smoothing:
# one per field)
PLAN_WINDOWS = {"bfs_relax": 1, "flood": 1, "stress": 2, "warp": 3,
                "shadow": 1, "components": 1}


def window_fits(nw: int, half_width: int) -> bool:
    """Whether csrc get_plan finds a chunk T >= 1 for ``nw`` windows of
    half-width ``half_width`` (kMaxWindowFloats / nw - 2H - 11 >= 1)."""
    return KMAX_WINDOW_FLOATS // nw - 2 * half_width - 11 >= 1


def plan_checks(dev, band_off, sizes, seed: int = SEED, reps: int = 3,
                plain=None):
    """Every staged launch (:func:`plan_configs`) on a synthetic mesh of
    NP cells at band half-width H, for each (H, NP) of ``sizes``, on
    ``dev`` and, as its plain loop, on CPU copies (``plain(fn, *args)``,
    default ``fn(*args)``): the two must agree bit for bit, in sweeps too;
    a launch whose windows no longer fit shared memory
    (:func:`window_fits`) must raise instead, and only then. Each launch's
    plan is read back from the library, and on the card the launch is
    timed. Returns one record per launch."""
    from planet_heightmap_generation_torch.ops import sweep_cuda as sc

    plain = plain or (lambda fn, *a: fn(*a))
    records = []
    for hw, npad in sizes:
        mesh = synthetic_mesh(band_off, hw, npad, seed)
        for label, kernel, fn, args, nbytes in plan_configs(mesh, npad,
                                                            seed + hw):
            nw = PLAN_WINDOWS.get(kernel) or args[0].shape[0]
            groups = args[0].shape[0] if kernel in ("bfs_relax",
                                                    "stress") else 1
            ref = plain(fn, *args)
            on_dev = [a.to(dev) if torch.is_tensor(a) else a for a in args]
            try:
                got = fn(*on_dev)
            except RuntimeError as e:
                if window_fits(nw, hw) or "launch failed" not in str(e):
                    raise
                print(f"plan [{label}, H {hw}]: refused ({e}), as its "
                      f"{nw} windows no longer fit", flush=True)
                records.append(dict(config=label, H=hw, NP=npad,
                                    refused=True))
                continue
            ref = ref if isinstance(ref, tuple) else (ref, None)
            got = got if isinstance(got, tuple) else (got, None)
            same = torch.equal(got[0].cpu(), ref[0])
            # the ε-fill counts barrier rounds, its plain loop sweeps
            sweeps = (None if ref[1] is None or kernel == "flood"
                      else int(ref[1][0]))
            if not same or (sweeps is not None and int(got[1][0]) != sweeps):
                raise AssertionError(
                    f"plan [{label}, H {hw}]: the launch differs from the "
                    f"plain loop on the CPU (max abs err "
                    f"{max_abs_err(got[0].cpu(), ref[0])}, sweeps "
                    f"{None if got[1] is None else int(got[1][0])} / "
                    f"{sweeps})")
            # smoothing: its pass count; the ε-fill: the rounds it ran
            sweeps = (int(got[1][0]) if kernel == "flood"
                      else sweeps or args[6])
            rec = dict(config=label, H=hw, NP=npad, sweeps=sweeps,
                       refused=False, fits=window_fits(nw, hw))
            plan = [p for p in sc.relax_plans()
                    if p["kernel"] == kernel and p["np"] == npad
                    and p["H"] == hw and p["windows"] == nw
                    and p["groups"] == groups]
            rec.update(plan[-1])
            unit = "rounds" if kernel == "flood" else "sweeps"
            text = (f"T {rec['T']} (before the cap {rec['T_free']}), {nw} "
                    f"windows, grid {rec['grid']}, {rec['smem_bytes']} B "
                    f"shared, {'capped' if rec['capped'] else 'not capped'}")
            if dev.type == "cuda":
                ms = time_ms(lambda: fn(*on_dev), reps, warm=1)
                rec.update(ms=ms, us_per_sweep=ms * 1e3 / sweeps,
                           bound_us_per_sweep=nbytes / HBM_BYTES_PER_S * 1e6)
                text += (f"; {rec['us_per_sweep']:.2f} us a {unit[:-1]}, "
                         f"bound {rec['bound_us_per_sweep']:.2f} a sweep "
                         "(bytes)")
            records.append(rec)
            print(f"plan [{label}, H {hw}, NP {npad}]: bit-identical to the "
                  f"plain loop on the CPU ({sweeps} {unit}); {text}",
                  flush=True)
    return records


def banded_sum_check(g, g_cpu, stacks):
    """Fail unless ``banded_sum`` on the card gives the bits of the same
    call on CPU tensors, twice. The atomic scatter-add it replaced is run
    beside it for the record: the cells where it differs from the CPU."""
    from planet_heightmap_generation_torch.ops import banded

    none = torch.zeros(0, dtype=torch.int64, device=g.rem_src.device)
    for label, x in stacks:
        on_card = banded.banded_sum(x, *g.bands)
        again = banded.banded_sum(x, *g.bands)
        on_cpu = banded.banded_sum(x.cpu(), *g_cpu.bands)
        if not (torch.equal(on_card.cpu(), on_cpu)
                and torch.equal(on_card, again)):
            raise AssertionError(f"banded_sum ({label}): the card's sum "
                                 "differs from the CPU's")
        band = banded.banded_sum(x, g.band_off, g.band_mask, none, none)
        scatter = band.scatter_reduce(
            0, g.rem_src[:, None].expand(-1, x.shape[1]), x[g.rem_dst], "sum")
        off = int((scatter.cpu() != on_cpu).any(1).sum())
        print(f"banded_sum [{label}, {tuple(x.shape)}]: bit-identical to the "
              f"CPU, twice; the atomic scatter-add it replaced differs from "
              f"the CPU in {off} cells", flush=True)


def caller_check(name: str, wrapper: str, fn):
    """``fn()``, a caller of one relax launch, must launch its kernel once
    with no host sync and give the bits it gives with the plain loop in
    the wrapper's place."""
    from planet_heightmap_generation_torch.ops import sweep_cuda

    sweep_cuda.reset_launches()
    out_k = no_host_sync(name, fn)
    torch.cuda.synchronize()
    launches = sweep_cuda.LAUNCHES[name]
    out_p = with_plain(wrapper, fn)
    if launches != 1 or not torch.equal(out_k, out_p):
        raise AssertionError(f"{name} caller: {launches} launches, max abs "
                             f"err {max_abs_err(out_k, out_p)} against the "
                             "plain loop")
    print(f"caller of {name}: one launch, no host sync, bit-identical to the "
          "plain loop", flush=True)


def no_host_sync(label: str, fn):
    """``fn()``, failing if it makes the host wait for the device (CUDA
    sync debug mode: a synchronizing torch call inside raises)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        raise AssertionError(f"{label}: host sync: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")


def plain_loop(plain):
    """(state, sweeps, ms) of one run of a plain relax loop on the card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref, sweeps = plain()
    end.record()
    torch.cuda.synchronize()
    return ref, int(sweeps), start.elapsed_time(end)


def relax_record(name: str, configs, primary: int = 0, reps: int = 20):
    """Check and time a relax kernel. Each config's ``run()`` is one relax
    launch of the whole loop and must equal its plain loop (``ref``, from
    :func:`plain_loop`) bit for bit, BFS, stress, warp and the rain shadow
    also in their sweep count; ``binds`` True says the plain loop must
    have run ``cap`` sweeps (the cap binds), False fewer (a fixpoint before
    the cap). ``cost`` is one sweep's (bytes, operations): the per-sweep
    bound counts them once, the per-launch bound counts each byte once and
    the operations of every sweep the plain loop needed, or
    ``launch_bytes`` / ``launch_ops`` where the config gives the launch's
    own (a loop whose every round must read and write its state).
    The row's numbers are those of ``configs[primary]``."""
    from planet_heightmap_generation_torch.ops import sweep_cuda

    unit, one = {"flood": ("rounds", "round"), "smooth": ("passes", "pass"),
                 "shadow": ("hops", "hop"), "accumulate": ("rounds", "round"),
                 "components": ("steps", "step")}.get(name,
                                                      ("sweeps", "sweep"))
    out = []
    for cfg in configs:
        ref, ref_sweeps, plain_ms = cfg["ref"]
        binds = cfg.get("binds")
        if binds is not None and (ref_sweeps == cfg["cap"]) != binds:
            raise AssertionError(
                f"{name} ({cfg['label']}): the plain loop ran {ref_sweeps} "
                f"sweeps at cap {cfg['cap']}; the config needs the cap "
                f"{'to bind' if binds else 'not to bind'}")
        run = cfg["run"]
        sweep_cuda.reset_launches()
        state, swept = no_host_sync(f"{name} ({cfg['label']})", run)
        torch.cuda.synchronize()
        launches, swept = sweep_cuda.LAUNCHES[name], int(swept)
        err = max_abs_err(state, ref)
        if not torch.equal(state, ref):
            raise AssertionError(f"{name} ({cfg['label']}): relax launch "
                                 f"differs from the plain loop (max abs err "
                                 f"{err})")
        if (name in ("bfs_relax", "stress", "warp", "shadow", "components",
                     "accumulate") and swept != ref_sweeps):
            raise AssertionError(f"{name} ({cfg['label']}): relax launch ran "
                                 f"{swept} sweeps, the plain loop "
                                 f"{ref_sweeps}")
        ms = time_ms(run, reps)
        dev_ms = mean_device_ms(device_events(
            lambda: [run() for _ in range(5)]), KERNEL_FNS[name])
        s_ms, s_by = bound_ms(*cfg["cost"])
        b_ms, b_by = bound_ms(cfg.get("launch_bytes", cfg["cost"][0]),
                              cfg.get("launch_ops",
                                      cfg["cost"][1] * ref_sweeps))
        share = None if dev_ms is None else b_ms / dev_ms
        out.append(dict(
            config=cfg["label"], loop_launches=launches, sweeps=swept,
            plain_sweeps=ref_sweeps, max_abs_err=err, ms=ms,
            device_ms=dev_ms, share_of_bound=share,
            device_ms_per_sweep=None if dev_ms is None else dev_ms / swept,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_ms_per_sweep=s_ms, bound_by_per_sweep=s_by))
        dev_txt = ("not measured" if dev_ms is None else
                   f"{dev_ms * 1e3:.2f} us ({dev_ms * 1e3 / swept:.3f} us "
                   f"per {one})")
        print(f"kernel {name} [{cfg['label']}]: bit-identical to the plain "
              f"loop ({ref_sweeps} {unit}, {plain_ms:.1f} ms) in {launches} "
              f"launch of {swept} {unit}; {ms * 1e3:9.2f} us/launch (device "
              f"{dev_txt}); bound {s_ms * 1e3:.2f} us per {one} ({s_by}), "
              f"{b_ms * 1e3:.2f} us per launch ({b_by})"
              + ("" if share is None else
                 f", {share:.1%} of the device time"), flush=True)
    row = dict(out[primary])
    row.update(library_ms=None, configs=out,
               max_abs_err=max(x["max_abs_err"] for x in out))
    return row


def smooth_library(g, c, field):
    """One PyTorch call computing a smoothing pass: the CSR adjacency with
    self-loops, rows scaled by 1/c, times the [NP, F] field
    (``torch.sparse.mm``). It multiplies by 1/c where the kernel divides,
    so it is a yardstick of speed, not of bits; the port never calls it."""
    npad = g.n_padded
    rows = torch.arange(npad, device=g.device)
    src = torch.cat([rows[:, None].expand_as(g.nbr_idx)[g.nbr_mask], rows])
    dst = torch.cat([g.nbr_idx[g.nbr_mask], rows])
    adj = torch.sparse_coo_tensor(
        torch.stack([src, dst]), (1.0 / c)[src], (npad, npad),
        check_invariants=True).coalesce()
    adj = adj.to_sparse_csr()
    return lambda: torch.sparse.mm(adj, field)


# ── the accumulate and components launches (phase 2 rows) ───────────

def loop_args(a, kw):
    """(s, p, rounds, stop_at_sink) of a recorded pointer_accumulate call."""
    return (*a[:3], a[3] if len(a) > 3 else kw.get("stop_at_sink", True))


def row_lengths(s, p, rounds: int, stop_at_sink: bool):
    """The longest row (entries of one target) of each round the plain
    loop runs, on the CPU: the longest run of ordered adds."""
    n = s.shape[0]
    p = p.cpu().long()
    out = []
    for r in range(rounds):
        keep = p[p < n]
        if keep.numel() == 0 and (stop_at_sink or r > 0):
            break
        out.append(int(torch.bincount(keep).max()) if keep.numel() else 0)
        p = torch.cat([p, p.new_tensor([n])])[p]
    return out


def accumulate_record(g, dev, calls, reps: int = 50):
    """Phase-2 row of the accumulate launch, at the path's shapes recorded
    from the default generate (``calls``: its flow counts, its
    ``downstream_accumulate`` forest, its deposit sum and wind bins) and the
    ice flow of a glacial step over the noise terrain: each launch must
    equal the plain loop on CPU copies bit for bit, twice, in its rounds
    too; its callers issue no host sync. Times the launch, the plain loop
    on the card (``index_add``, atomic there) and one atomic ``index_add_``
    per round; the bound counts each round's bytes once (s and p read, s
    and p written)."""
    from planet_heightmap_generation_torch.erosion import (flood, fluvial,
                                                            glacial)
    from planet_heightmap_generation_torch.ops import banded, sweep_cuda

    elev = noise_terrain(g)
    land = (elev > 0) & g.valid
    glac = glacial.glaciation_index(g.pos, elev, ~land & g.valid, g.valid,
                                    torch.tensor(0.2, device=dev))
    _, ice = record_calls(lambda: glacial.ice_flow(elev, land, glac,
                                                   *g.bands),
                          {("erosion.glacial", "pointer_accumulate"): 1})
    loops = [
        ("flow counts (int32)", calls[("erosion.fluvial",
                                       "pointer_accumulate")][0]),
        ("downstream_accumulate", calls[("erosion.flood",
                                         "pointer_accumulate")][0]),
        ("ice flow, 22 rounds", ice[("erosion.glacial",
                                     "pointer_accumulate")][0])]
    sums = [("deposit sum, one round", calls[("erosion.fluvial",
                                              "ordered_index_sum")][0]),
            ("geo bins F=3, one round", calls[("climate.wind",
                                               "ordered_index_sum")][0])]
    one = torch.ones(1, dtype=torch.int32, device=dev)
    configs = []
    for label, (a, kw) in loops:
        s, ptr, rounds, stop = loop_args(a, kw)
        cpu, cpu_rounds = sweep_cuda.accumulate_relax_plain(
            s.cpu(), ptr.cpu(), rounds, stop)
        rows = row_lengths(s, ptr, rounds, stop)
        f = 1 if s.dim() == 1 else s.shape[1]
        pb = ptr.element_size()
        per_round = s.shape[0] * (2 * 4 * f + 4 + 4)
        launch_bytes = per_round * len(rows) + s.shape[0] * (pb - 4)
        run = (lambda s=s, ptr=ptr, rounds=rounds, stop=stop:
               sweep_cuda.accumulate_relax(s, ptr, rounds, stop))
        acc = torch.zeros((s.shape[0] + 1, *s.shape[1:]), dtype=s.dtype,
                          device=dev)
        configs.append(dict(
            label=f"{label}: longest row {max(rows, default=0)}",
            run=run, cost=(per_round, s.shape[0] * f),
            launch_bytes=launch_bytes,
            ref=(cpu.to(dev), int(cpu_rounds), plain_loop(
                lambda s=s, ptr=ptr, rounds=rounds, stop=stop:
                sweep_cuda.accumulate_relax_plain(s, ptr, rounds,
                                                  stop))[2]),
            library=lambda acc=acc, ptr=ptr, s=s, r=len(rows): [
                acc.index_add_(0, ptr, s) for _ in range(r)]))
    for label, (a, kw) in sums:
        n_out, idx, vals = a
        cpu = sweep_cuda.ordered_sum_plain(n_out, idx.cpu(), vals.cpu())
        f = 1 if vals.dim() == 1 else vals.shape[1]
        nbytes = idx.shape[0] * (idx.element_size() + 4 * f) + n_out * 4 * f
        acc = torch.zeros((n_out + 1, *vals.shape[1:]), device=dev)
        configs.append(dict(
            label=f"{label}: longest row {longest_run(idx, n_out)}",
            run=lambda a=a: (sweep_cuda.ordered_sum(*a), one),
            cost=(nbytes, idx.shape[0] * f),
            ref=(cpu.to(dev), 1, plain_loop(
                lambda a=a: (sweep_cuda.ordered_sum_plain(*a), 1))[2]),
            library=lambda acc=acc, idx=idx, vals=vals: acc.index_add_(
                0, idx, vals)))
    for cfg in configs:
        first, again = cfg["run"](), cfg["run"]()
        if not torch.equal(first[0], again[0]):
            raise AssertionError(f"accumulate ({cfg['label']}): two launches "
                                 "differ")
    row = relax_record("accumulate", configs, reps=reps)
    for cfg, out in zip(configs, row["configs"]):
        out["library_ms"] = time_ms(cfg["library"], reps)
        print(f"kernel accumulate [{cfg['label']}]: yardstick, one atomic "
              f"index_add_ a round: {out['library_ms'] * 1e3:.2f} us",
              flush=True)
    row["library_ms"] = row["configs"][0]["library_ms"]

    # the callers, with no host sync: the flow counts and the downstream
    # forest from the recorded pointers, the ice flow on the noise terrain
    n = g.n_padded
    s0, p0 = loops[0][1][0][:2]
    rcv = torch.where(p0 < n, p0, -1)
    no_host_sync("flow_accumulation", lambda: fluvial.flow_accumulation(
        s0 > 0, rcv, torch.zeros_like(s0, dtype=torch.bool)))
    v1, p1 = loops[1][1][0][:2]
    no_host_sync("downstream_accumulate", lambda: flood.downstream_accumulate(
        v1, torch.where(p1 < n, p1, -1), torch.zeros_like(p1,
                                                          dtype=torch.bool)))
    no_host_sync("ice_flow", lambda: glacial.ice_flow(elev, land, glac,
                                                      *g.bands))
    no_host_sync("ordered_index_sum", lambda: banded.ordered_index_sum(
        *sums[1][1][0]))
    print("host syncs: none in flow_accumulation, downstream_accumulate, "
          "ice_flow or ordered_index_sum", flush=True)
    return row


def components_record(g, dev, calls, reps: int = 50):
    """Phase-2 row of the components launch at the default generate's
    call sites (``calls``: ``components_core``'s arguments, from
    ops/banded.py (every cell a member, the same-plate gate) and
    erosion/flood.py (the ocean and land subsets)): one launch must equal
    the plain loop on the card (mins and gathers: order-free) in labels and
    steps, and its callers issue no host sync. The bound counts each step's
    bytes once (labels read and written, bits, members and the CSR)."""
    from planet_heightmap_generation_torch.erosion import flood
    from planet_heightmap_generation_torch.ops import banded, sweep_cuda

    kept = (calls[("ops.banded", "components_core")]
            + calls[("erosion.flood", "components_core")])
    if len(kept) < 3:
        raise AssertionError(f"components: {len(kept)} call sites recorded")
    configs = []
    for i, (a, _) in enumerate(kept):
        init, member, gbits, rem_ok, band_off, rem_src, rem_dst = a
        n = init.shape[0]
        ptr, nbr = banded.rem_csr(torch.where(rem_ok, rem_src, n), rem_dst,
                                  n)
        mem = None if member is None else member.to(torch.uint8).contiguous()
        share = 1.0 if member is None else float(member.float().mean())
        args = (init.contiguous(), mem, gbits, band_off, ptr, nbr)
        ref = plain_loop(lambda args=args:
                         sweep_cuda.components_relax_plain(*args))
        step_bytes = (3 * 4 + (mem is not None)) * n + (n + 1 + nbr.shape[0]) * 4
        configs.append(dict(
            label=(f"call {i}: " + ("every cell, same-plate gate"
                                    if member is None else
                                    f"{share:.1%} of cells members")),
            run=lambda args=args: sweep_cuda.components_relax(*args),
            ref=ref, cost=(step_bytes, popcount(gbits) + int(rem_ok.sum())
                           + 4 * n),
            launch_bytes=step_bytes * ref[1]))
    row = relax_record("components", configs, reps=reps)
    plate = noise_plates(g)
    ocean = (noise_terrain(g) <= 0) & g.valid
    no_host_sync("connected_components_gated",
                 lambda: banded.connected_components_gated(plate, *g.bands))
    no_host_sync("connected_components_banded",
                 lambda: flood.connected_components_banded(ocean, *g.bands))
    print("host syncs: none in connected_components_gated or "
          "connected_components_banded", flush=True)
    return row


def longest_run(idx, n_out: int) -> int:
    """The most entries any one target below ``n_out`` holds."""
    keep = idx[idx < n_out]
    return int(torch.bincount(keep).max()) if keep.numel() else 0


def record_calls(fn, sites):
    """``fn()`` with each (module, name) of ``sites`` wrapped to keep
    copies of the arguments of its first ``sites[site]`` calls and to
    count its calls. Returns (fn(), {site: kept calls}); the counts are
    under ``(module, name, "calls")``."""
    import importlib

    calls = {site: [] for site in sites}
    counts = {site: [0] for site in sites}
    saved = []
    for site, keep in sites.items():
        mod_name, name = site
        mod = importlib.import_module(
            f"planet_heightmap_generation_torch.{mod_name}")
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _kept=calls[site], _keep=keep,
                    _n=counts[site], **k):
            _n[0] += 1
            if len(_kept) < _keep:
                _kept.append(([x.clone() if torch.is_tensor(x) else x
                               for x in a], dict(k)))
            return _orig(*a, **k)

        saved.append((mod, name, orig))
        setattr(mod, name, wrapped)
    try:
        out = fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    calls.update({(*site, "calls"): n[0] for site, n in counts.items()})
    return out, calls



def sum_site_checks(calls):
    """Each recorded call of each site of ``SUM_SITES`` (``calls`` from
    :func:`record_calls`), replayed: the card's result must
    equal the same call on CPU copies bit for bit, twice. Beside it, the
    cells in which the atomic form the site used before (``index_add``;
    for a pointer-doubling loop, one a round) differs from the CPU. The ice
    flow's loop is also timed, with its rounds and longest rows."""
    from planet_heightmap_generation_torch.ops import banded, sweep_cuda

    out = {}
    ice_flow = ("erosion.glacial", "pointer_accumulate")
    for site in SUM_SITES:
        kept, name = calls[site], site[1]
        if not kept:
            raise AssertionError(f"sum site {site}: no call recorded")
        for i, (args, kw) in enumerate(kept):
            fn = getattr(banded, name)
            first, second = fn(*args, **kw), fn(*args, **kw)
            cpu = fn(*[x.cpu() if torch.is_tensor(x) else x for x in args],
                     **kw)
            if not (torch.equal(first.cpu(), cpu)
                    and torch.equal(first, second)):
                raise AssertionError(
                    f"sum site {site} (call {i}): the card's sum differs "
                    f"from the CPU's (max abs err "
                    f"{max_abs_err(first.cpu().float(), cpu.float())})")
            if name == "rem_add":
                old = args[0].index_add(0, args[2], args[1])
            elif name == "pointer_accumulate":
                old = sweep_cuda.accumulate_relax_plain(
                    *loop_args(args, kw))[0]
            else:
                old = sweep_cuda.ordered_sum_plain(*args, **kw)
            off = int((old.cpu() != cpu).reshape(cpu.shape[0], -1)
                      .any(1).sum())
            extra = ""
            if site == ice_flow:
                rows = row_lengths(*loop_args(args, kw))
                ms = time_ms(lambda: fn(*args, **kw), 50)
                out["ice_flow"] = dict(rounds=len(rows), longest_rows=rows,
                                       ms=ms)
                extra = (f"; {len(rows)} rounds, longest row per round "
                         f"{rows}, {ms * 1e3:.2f} us a loop")
            print(f"sum site {site[0]} [{name}, call {i}, "
                  f"{tuple(first.shape)}]: bit-identical to the CPU, twice; "
                  f"the atomic form it replaced differs from the CPU in "
                  f"{off} cells{extra}", flush=True)
            out[f"{site[0]}.{name}:{i}"] = off
    return out


# ── phase 5: the engine's retained-state commands ────────────────────

def timed(fn):
    """(fn(), wall seconds to a device synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def launched(fn, expect, label: str):
    """``fn()`` with the kernel launches it made; fail unless every kernel
    of ``expect`` was launched."""
    from planet_heightmap_generation_torch.ops import sweep_cuda

    sweep_cuda.reset_launches()
    out, secs = timed(fn)
    counts = dict(sweep_cuda.LAUNCHES)
    missing = [k for k in expect if counts[k] == 0]
    assert not missing, f"{label}: kernels not launched: {missing}"
    print(f"{label}: {secs:.3f} s; launches "
          + " ".join(f"{k}={v}" for k, v in counts.items() if v), flush=True)
    return out, secs


def command_checks(dev, params, n_plates: int):
    """The commands on the default planet: a no-change reapply equals the
    generate's elevation bit for bit, a sculpted reapply keeps the pre-post
    elevation, an edit flips plate 0 and passes the gates, compute_climate
    reuses the cached wind and ocean on its second call, a session saved
    and loaded reapplies to the live engine's retained elevation bit for
    bit, an imported equirect band image passes the band checks, and one
    WorkerProtocol dispatch of each command returns its done type. Returns
    each command's wall seconds."""
    import tempfile

    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.pipeline import (PlanetEngine,
                                                            WorkerProtocol)

    walls = {}
    eng = PlanetEngine(device=dev)
    gen, walls["generate"] = timed(lambda: eng.generate(params))
    assert gen.error is None, gen.error
    post = ("warp", "flood", "components", "accumulate")
    climate = ("bfs_relax", "components", "smooth", "shadow", "accumulate")

    r, walls["reapply"] = launched(lambda: eng.reapply(skip_climate=True),
                                   post, "reapply (no change, no climate)")
    if not torch.equal(r.elevation, gen.elevation):
        raise AssertionError(
            "no-change reapply differs from the generate in "
            f"{int((r.elevation != gen.elevation).sum())} cells (max abs "
            f"err {max_abs_err(r.elevation, gen.elevation)})")
    print("reapply (no change): bit-identical to the generate's elevation",
          flush=True)
    r2, walls["reapply_sculpted"] = launched(
        lambda: eng.reapply(sculpt=dict(smoothing=1.0)),
        post + climate, "reapply (smoothing 1.0, climate on)")
    assert r2.error is None, r2.error
    assert torch.equal(r2.pre_post_elevation, gen.pre_post_elevation)
    assert not torch.equal(r2.elevation, gen.elevation)
    print("climate: " + check_climate(r2), flush=True)

    e, walls["edit_recompute"] = launched(
        lambda: eng.edit_recompute([0]),
        ("bfs_relax", "stress", "warp", "flood", "components", "smooth",
         "shadow", "accumulate"), "edit_recompute([0])")
    assert e.error is None
    assert bool(e.plate_is_ocean[0]) != bool(eng._w["original_is_ocean"][0])
    diag, plates = check_planet(e, n_plates)
    print(f"edit_recompute: plate 0 flipped; diagnostics {diag}, plates "
          f"{plates}; climate: {check_climate(e)}", flush=True)

    # a terrain-only reapply drops the cached wind and ocean, as in the
    # reference worker; the first compute_climate recomputes them
    eng.reapply(skip_climate=True)
    c0, walls["compute_climate"] = launched(
        lambda: eng.compute_climate(), climate, "compute_climate()")
    assert any("wind" in s for s, _ in c0["timing"].stages)
    c1, walls["compute_climate_offset"] = launched(
        lambda: eng.compute_climate(temperature_offset=5.0),
        ("smooth", "shadow"), "compute_climate(temperature_offset=5.0)")
    stages = [s for s, _ in c1["timing"].stages]
    assert not any("wind" in s.lower() or "ocean" in s.lower()
                   for s in stages), stages
    assert c1["wind"] is c0["wind"]
    print(f"compute_climate: the second call ran {stages} (no wind or "
          "ocean stage)", flush=True)

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/session.npz"
        _, walls["save_session"] = timed(lambda: eng.save_session(path))
        eng2, walls["load_session"] = timed(
            lambda: PlanetEngine.load_session(path, device=dev))
    r3, walls["reapply_loaded"] = timed(
        lambda: eng2.reapply(skip_climate=True))
    if not torch.equal(r3.elevation, eng._w["elevation_final"]):
        raise AssertionError(
            "session reapply differs from the live engine in "
            f"{int((r3.elevation != eng._w['elevation_final']).sum())} "
            "cells")
    print("session: save → load → no-change reapply bit-identical to the "
          "live engine's retained elevation", flush=True)

    h, w = 512, 1024
    img = np.zeros((h, w), np.float32)
    img[192:320, :] = 200.0     # an equatorial land band
    imp, walls["import_heightmap"] = launched(
        lambda: PlanetEngine(device=dev).import_heightmap(
            img.ravel(), w, h, GenerationParams(seed=5, n_cells=N_CELLS,
                                                skip_climate=True)),
        ("warp", "flood", "components", "accumulate"),
        "import_heightmap 1024x512")
    n = imp.graph.n_cells
    e_np = imp.elevation[:n].cpu().numpy()
    lat = np.degrees(np.arcsin(np.clip(imp.graph.pos[:n, 1], -1, 1)))
    band = float((e_np[np.abs(lat) < 20] > 0).mean())
    poles = float((e_np[np.abs(lat) > 60] <= 0).mean())
    assert band > 0.8 and poles > 0.9, (band, poles)
    assert imp.plate_is_ocean.size >= 2 and np.isfinite(e_np).all()
    print(f"import_heightmap: land within 20 deg of the equator {band:.4f}, "
          f"ocean beyond 60 deg {poles:.4f}, "
          f"{imp.plate_is_ocean.size} synthetic plates", flush=True)

    log = []
    proto = WorkerProtocol(engine=PlanetEngine(device=dev),
                           on_message=log.append)
    for cmd, msg, want in [
            ("generate", dict(params=params), "done"),
            ("reapply", dict(sculpt=dict(smoothing=0.6), skipClimate=True),
             "reapplyDone"),
            ("editRecompute", dict(toggledIndices=(0,)), "editDone"),
            ("computeClimate", dict(temperatureOffset=3.0), "climateDone"),
            ("importHeightmap", dict(grayscale=img, width=w, height=h,
                                     params=dict(seed=5, n_cells=N_CELLS,
                                                 skip_climate=True)),
             "done")]:
        resp, secs = timed(lambda: proto.dispatch(dict(cmd=cmd, **msg)))
        assert resp["type"] == want, (cmd, resp.get("message"),
                                      resp.get("stack"))
        assert "error" not in resp, resp["error"]
        walls[f"protocol {cmd}"] = secs
        print(f"protocol {cmd}: {want} in {secs:.3f} s", flush=True)
    assert any(m.get("type") == "progress" for m in log)
    return walls


# ── phases 3 and 4 ───────────────────────────────────────────────────

def device_events(fn):
    """The device events of a ``torch.profiler`` trace around ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# the device function of each kernel, as a trace names it
KERNEL_FNS = dict(bfs_relax="bfs_relax_kernel",
                  stress="stress_relax_kernel", warp="warp_relax_kernel",
                  flood="flood_relax_kernel", smooth="smooth_relax_kernel",
                  shadow="shadow_relax_kernel",
                  components="components_relax_kernel",
                  accumulate="accumulate_relax")
# the one-sweep BFS launch the components loop made before it became one
# launch; a trace of the path must hold none
ONE_SWEEP_BFS = "bfs_sweep_kernel"


def mean_device_ms(events, fn: str):
    """Mean device ms per launch of the device function ``fn``; None when
    the trace holds none of its launches."""
    t = [e.time_range.elapsed_us() for e in events if fn in e.name]
    return sum(t) / len(t) / 1e3 if t else None


def profile_generate(dev, params, top: int = 8):
    """One more warm generate under ``torch.profiler``: the device's busy
    time (union of its event intervals), each sweep kernel's mean device
    time per launch on the path, and the kernels that took the most
    device time. None when the trace holds no device events."""
    events = device_events(lambda: run_generate(dev, params))
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for e in events:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(busy_ms=busy_us / 1e3, n_events=len(events),
                one_sweep_bfs=sum(ONE_SWEEP_BFS in e.name for e in events),
                device_ms={k: mean_device_ms(events, fn)
                           for k, fn in KERNEL_FNS.items()},
                seen={k: sum(fn in e.name for e in events)
                      for k, fn in KERNEL_FNS.items()},
                top=[(n[:90], t / 1e3, c) for n, (t, c) in ranked])


def count_host_syncs(fn):
    """(fn(), host syncs): the synchronizing torch calls inside ``fn()``,
    counted as the warnings of CUDA sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def run_generate(dev, params):
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    engine = PlanetEngine(device=dev)
    t0 = time.perf_counter()
    res = engine.generate(params)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_planet(res, n_plates: int):
    d = res.diagnostics()
    n = res.graph.n_cells
    plates = len(torch.unique(res.r_plate[:n]))
    assert d["nan_count"] == 0, d
    assert 0.15 < d["land_fraction"] < 0.5, d
    assert plates == n_plates, (plates, n_plates)
    return d, plates


def check_climate(res) -> str:
    """Fail unless the result carries the whole climate: every field
    finite on the real cells, Köppen codes valid."""
    from planet_heightmap_generation_torch.climate import KOPPEN_CODES

    n, npad = res.graph.n_cells, res.graph.n_padded
    assert res.climate is not None
    assert set(res.climate) == {"wind", "ocean", "precip", "temp", "koppen"}
    kop = res.climate["koppen"][:n]
    assert int(kop.min()) >= 0 and int(kop.max()) < len(KOPPEN_CODES)
    fields = 0
    for part in ("wind", "ocean", "precip", "temp"):
        for k, v in res.climate[part].items():
            if torch.is_tensor(v) and v.is_floating_point():
                rows = v[:n] if v.shape[0] == npad else v
                assert bool(torch.isfinite(rows).all()), (part, k)
                fields += 1
    counts = torch.bincount(kop.long(), minlength=len(KOPPEN_CODES))
    top = sorted(((int(c), KOPPEN_CODES[i]) for i, c in enumerate(counts)),
                 reverse=True)[:4]
    return (f"{fields} fields finite, Koppen codes valid, most common "
            + ", ".join(f"{name} {c / n:.4f}" for c, name in top))


def report_profile(prof, warm_s: float):
    if prof is None:
        print("profile: no device events in the trace (device time not "
              "measured)")
        return
    print(f"profile: device busy {prof['busy_ms']:.3f} ms of the warm "
          f"{warm_s * 1e3:.1f} ms generate (idle share "
          f"{1 - prof['busy_ms'] / (warm_s * 1e3):.4f}), "
          f"{prof['n_events']} device events in the trace")
    for k, v in prof["device_ms"].items():
        print(f"  {KERNEL_FNS[k]:18s} mean device time per launch on the "
              "path: "
              + ("not measured" if v is None else f"{v * 1e3:.2f} us")
              + f" ({prof['seen'][k]} launches in the trace)")
    for n, t, c in prof["top"]:
        print(f"  {t:9.3f} ms {c:6d}x {n}")


def snapshot_check(res):
    n = res.graph.n_cells
    e = res.elevation[:n].cpu().numpy()
    hist = np.histogram(np.clip(e, -1, 1 - 1e-6), bins=20,
                        range=(-1, 1))[0] / n
    land = float((e > 0).mean())
    l1 = float(np.abs(hist - np.asarray(SNAPSHOT_C4K["elevation_hist"])).sum())
    plates = len(torch.unique(res.r_plate[:n]))
    kop = res.climate["koppen"][:n].cpu().numpy()
    shares = {c: float((kop == c).mean()) for c in SNAPSHOT_C4K["koppen_top"]}
    worst = max(abs(shares[c] - f)
                for c, f in SNAPSHOT_C4K["koppen_top"].items())
    print(f"c4k_s123: land {land:.5f} (snapshot "
          f"{SNAPSHOT_C4K['land_fraction']}), histogram L1 {l1:.5f}, "
          f"plates {plates}, Koppen top-8 shares {shares}, largest "
          f"difference from the snapshot {worst:.5f}", flush=True)
    assert abs(land - SNAPSHOT_C4K["land_fraction"]) < 0.02
    assert l1 < 0.05
    assert plates == SNAPSHOT_C4K["plate_count"]
    assert worst < 0.03, shares


# ── phase 7: sizes past 204K ─────────────────────────────────────────

# (label, GenerationParams keywords): the JAX package's bench config 4
# (bench.py:93-95, 1M cells with climate) and the reference's detail
# ceiling (config.py:17, 2.56M cells; the 300K rule skips climate)
BIG_SIZES = (("1M with climate", dict(n_cells=1_000_000, skip_climate=False)),
             ("2.56M terrain-only", dict(n_cells=2_560_000)))
# the synthetic plan shapes of phase 2: (band half-width H, NP). ±5760 is
# about the 2.56M mesh's half-width (its largest |offset| is 5778), at its
# padded size, so its plans are within a few cells of the 2.56M
# generate's; ±7200 (~4M cells, near where four windows stop fitting) on
# 1M cells, where the warp and stress plans cap too
PLAN_SIZES = ((5760, 2_561_024), (7200, 1_048_576))
# phase 8: the in-memory export's (height, width), the tiled export's width
EXPORT_HW = (1024, 2048)
TILED_WIDTH = 8192


def plan_lines(npad: int):
    """Print and return the staged launches' plans at ``npad`` cells, as
    the library cached them."""
    from planet_heightmap_generation_torch.ops import sweep_cuda

    plans = [p for p in sweep_cuda.relax_plans() if p["np"] == npad]
    for p in plans:
        print(f"  plan {p['kernel']:10s} NP {p['np']} groups {p['groups']} "
              f"windows {p['windows']} H {p['H']} T {p['T']} (before the "
              f"cap {p['T_free']}) grid {p['grid']} shared "
              f"{p['smem_bytes']} B "
              f"{'capped' if p['capped'] else 'not capped'}", flush=True)
    return plans


def size_checks(dev):
    """The 1M-with-climate and 2.56M terrain-only generates, each cold
    then warm (counted, timed, its plans read back), then once warm under
    the profiler, held to PERF.md §2's gates. Returns one record per
    size."""
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.ops import sweep_cuda

    out = {}
    for label, kw in BIG_SIZES:
        params = GenerationParams(seed=SEED, **kw)
        torch.cuda.reset_peak_memory_stats()
        _, cold_s = run_generate(dev, params)
        sweep_cuda.reset_launches()
        res, warm_s = run_generate(dev, params)
        launches = dict(sweep_cuda.LAUNCHES)
        swept = sweep_cuda.sweeps_run()
        peak = torch.cuda.max_memory_allocated()
        print(res.timing.table())
        n, npad = res.graph.n_cells, res.graph.n_padded
        print(f"generate {label} ({n} cells, NP {npad}, "
              f"{len(res.graph.banded_packed[0])} bands, H "
              f"{max(abs(o) for o in res.graph.banded_packed[0])}): cold "
              f"{cold_s:.2f} s, warm {warm_s:.3f} s, peak device memory "
              f"{peak / 2 ** 30:.2f} GiB", flush=True)
        assert res.error is None, res.error
        diag, plates = check_planet(res, params.n_plates)
        print(f"diagnostics: {diag}, plates {plates}", flush=True)
        climate = params.skip_climate is False
        if climate:
            print("climate: " + check_climate(res), flush=True)
        else:
            assert res.climate is None
        path = [k for k in launches
                if climate or k not in ("smooth", "shadow")]
        missing = [k for k in path if launches[k] == 0]
        assert not missing, f"{label}: kernels not launched: {missing}"
        print("kernels " + " ".join(f"{k}={v}" for k, v in launches.items())
              + " | sweeps " + " ".join(f"{k}={v}" for k, v in swept.items()),
              flush=True)
        plans = plan_lines(npad)
        staged = {p["kernel"] for p in plans}
        assert staged >= {"bfs_relax", "stress", "warp", "flood",
                          "components"} | ({"smooth", "shadow"} if climate
                                           else set()), staged
        prof = profile_generate(dev, params)
        report_profile(prof, warm_s)
        out[label] = dict(
            n_cells=n, np=npad, cold_s=cold_s, warm_s=warm_s,
            peak_bytes=peak, launches=launches, sweeps=swept,
            stages=res.timing.stages, plans=plans,
            busy_ms=None if prof is None else prof["busy_ms"],
            events=None if prof is None else prof["n_events"],
            device_ms=None if prof is None else prof["device_ms"])
    return out


# ── phase 8: the product surfaces on the default planet ──────────────

def to_cpu(x):
    """A result's tensors (in dicts too) as CPU copies."""
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x.cpu() if torch.is_tensor(x) else x


def api_checks(dev, res, tmp: str):
    """api/, the CLI and the batch sweep at 204K on the card, timed, with
    the layers, picks, overlays and raster held against the same calls on
    CPU copies. Returns {check: seconds}."""
    import dataclasses
    import os

    from planet_heightmap_generation_torch import cli
    from planet_heightmap_generation_torch.api import (export, globe, layers,
                                                       overlays, picking)
    from planet_heightmap_generation_torch.api.imageio import load_png
    from planet_heightmap_generation_torch.mesh.device import to_device

    walls = {}
    cpu = dataclasses.replace(
        res, r_plate=res.r_plate.cpu(), elevation=res.elevation.cpu(),
        t_elevation=res.t_elevation.cpu(), stress=res.stress.cpu(),
        climate=to_cpu(res.climate), debug=to_cpu(res.debug))

    names = layers.available_layers(res)
    assert names == layers.available_layers(cpu)
    assert len(names) == len(layers.LAYERS), names
    worst, secs = 0.0, 0.0
    for name in names:
        t0 = time.perf_counter()
        got = layers.layer_color(res, name)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        assert got.device == res.elevation.device
        err = max_abs_err(got.cpu(), layers.layer_color(cpu, name))
        assert err <= 1e-6, (name, err)
        worst = max(worst, err)
    walls["layers"] = secs
    print(f"layers: {len(names)} on the card in {secs:.3f} s, each within "
          f"{worst:.2e} of the CPU (atol 1e-6)", flush=True)

    rng = np.random.default_rng(SEED)
    picks = []
    for lat, lon in zip(rng.uniform(-90, 90, 8), rng.uniform(-180, 180, 8)):
        cell = picking.nearest_region(res, lat, lon)
        assert cell == picking.nearest_region(cpu, lat, lon), (lat, lon)
        assert picking.cell_info(res, cell) == picking.cell_info(cpu, cell)
        picks.append(cell)
    print(f"picking: 8 lat/lon points, the CPU's cells {picks}", flush=True)

    for label, fn in (("wind arrows", overlays.wind_arrows),
                      ("current arrows", overlays.ocean_current_arrows)):
        t0 = time.perf_counter()
        got = fn(res)
        walls[label] = time.perf_counter() - t0
        want = fn(cpu)
        assert np.isfinite(got["direction"]).all()
        common = np.intersect1d(got["cells"], want["cells"])
        print(f"{label}: {len(got['cells'])} arrows in "
              f"{walls[label]:.3f} s; {len(common)} of the CPU's "
              f"{len(want['cells'])} cells in common", flush=True)
        assert len(common) >= 0.999 * len(want["cells"])
    for sp in (False, True):
        assert np.array_equal(overlays.plate_border_edges(res, sp),
                              overlays.plate_border_edges(cpu, sp))
    assert np.array_equal(overlays.itcz_polyline(res),
                          overlays.itcz_polyline(cpu))

    g = to_device(res.graph, dev)
    h, w = EXPORT_HW
    t0 = time.perf_counter()
    ids = export.rasterize_cell_ids(g, h, w)
    torch.cuda.synchronize()
    walls[f"raster {w}x{h}"] = time.perf_counter() - t0
    ids_cpu = export.rasterize_cell_ids(to_device(res.graph, "cpu"), h, w)
    diff = (ids.cpu() != ids_cpu).numpy()
    pos = res.graph.pos.astype(np.float64)
    plat = (0.5 - (np.arange(h) + 0.5) / h) * np.pi
    plon = ((np.arange(w) + 0.5) / w * 2 - 1) * np.pi
    yy, xx = np.nonzero(diff)
    pp = np.stack([np.cos(plat[yy]) * np.sin(plon[xx]), np.sin(plat[yy]),
                   np.cos(plat[yy]) * np.cos(plon[xx])], -1)
    gap = np.abs(np.einsum("nc,nc->n", pos[ids.cpu().numpy()[diff]], pp)
                 - np.einsum("nc,nc->n", pos[ids_cpu.numpy()[diff]], pp))
    assert (gap <= 1e-6).all(), gap.max()
    t0 = time.perf_counter()
    imgs = {t: export.export_map(g, res.elevation, t, h, w,
                                 koppen=res.climate["koppen"], cell_ids=ids)
            for t in export.EXPORT_TYPES}
    walls[f"export 6 types {w}x{h}"] = time.perf_counter() - t0
    assert all(v.shape == (h, w, 3) and np.isfinite(v).all()
               for v in imgs.values())
    print(f"export: raster {w}x{h} in {walls[f'raster {w}x{h}']:.3f} s "
          f"({int(diff.sum())} pixels differ from the CPU's, each a score "
          f"tie within {gap.max() if gap.size else 0.0:.1e}); six types in "
          f"{walls[f'export 6 types {w}x{h}']:.3f} s", flush=True)

    big_w = TILED_WIDTH
    path = os.path.join(tmp, "tiled.png")
    t0 = time.perf_counter()
    export.export_map_tiled(res.graph, res.elevation, "heightmap", path,
                            width=big_w)
    key = f"tiled heightmap {big_w}x{big_w // 2}"
    walls[key] = time.perf_counter() - t0
    tiled = load_png(path)
    mem = export.export_map(g, res.elevation, "heightmap", big_w // 2, big_w)
    mem8 = np.clip(mem * 255 + 0.5, 0, 255).astype(np.uint8)
    match = float((np.abs(tiled.astype(int) - mem8).max(axis=2) <= 2).mean())
    print(f"{key}: {walls[key]:.3f} s, {os.path.getsize(path)} bytes, "
          f"{match:.4%} of its pixels match the in-memory export",
          flush=True)
    assert match >= 0.97, match

    t0 = time.perf_counter()
    html = globe.export_globe(res, os.path.join(tmp, "globe"),
                              layer=["terrain", "biome", "plates"])
    walls["globe"] = time.perf_counter() - t0
    manifest = json.load(open(os.path.join(tmp, "globe", "globe.json")))
    assert manifest["num_cells"] == res.graph.n_cells and os.path.exists(html)
    print(f"globe: {manifest['vertices']} vertices, "
          f"{manifest['total_bytes']} bytes in {walls['globe']:.3f} s",
          flush=True)

    npz, png = os.path.join(tmp, "p.npz"), os.path.join(tmp, "m.png")
    p = res.params
    gen = ["--cells", str(p.n_cells), "--plates", str(p.n_plates),
           "--continents", str(p.num_continents), "--device", str(dev)]
    for label, argv in (
            ("cli generate", ["generate", "--seed", str(p.seed), *gen,
                              "--out", npz]),
            ("cli export", ["export", "--in", npz, "--type", "biome",
                            "--width", str(w), "--device", str(dev),
                            "--out", png])):
        t0 = time.perf_counter()
        cli.main(argv)
        walls[label] = time.perf_counter() - t0
    assert load_png(png).shape == (h, w, 3)
    data = np.load(npz)
    assert np.array_equal(data["elevation"],
                          res.elevation[:res.graph.n_cells].cpu().numpy())
    here = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        cli.main(["sweep", "--seeds", "1-3", *gen, "--skip-climate",
                  "--export-width", str(w)])
        walls["cli sweep 3 seeds"] = time.perf_counter() - t0
        for s in (1, 2, 3):
            assert load_png(f"heightmap_seed{s}.png").shape == (h, w, 3)
    finally:
        os.chdir(here)
    print(f"cli: generate {{:.2f}} s, export {{:.2f}} s, sweep of 3 seeds "
          f"with {w}-px exports {{:.2f}} s".format(
              walls["cli generate"], walls["cli export"],
              walls["cli sweep 3 seeds"]), flush=True)
    return walls


def phase(t_run: float, n) -> None:
    print(f"[phase {n} at {time.perf_counter() - t_run:.1f} s]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.mesh.build import build_sphere
    from planet_heightmap_generation_torch.mesh.device import to_device
    from planet_heightmap_generation_torch.ops import sweep_cuda
    from planet_heightmap_generation_torch.ops.rng import ParkMiller

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # 1. build
    t_run = t0 = time.perf_counter()
    report = sweep_cuda.build()
    sweep_cuda._kernel("accumulate")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    kernel = "?"
    for line in report.splitlines():
        named = re.search(r"Function properties for \S*?\d+([a-z_]+_kernel)"
                          r"(?:ILi(\d+)E)?", line)
        if named:
            kernel = named.group(1) + (f"<{named.group(2)}>"
                                       if named.group(2) else "")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas [{kernel}]:", line.strip())

    # 2. kernels against their plain versions on the 204K mesh
    graph = build_sphere(N_CELLS, 0.75, rng=ParkMiller(SEED))
    g = to_device(graph, dev)
    print(f"mesh: {g.n_cells} cells, NP {g.n_padded}, {len(g.band_off)} "
          f"bands, {g.rem_src.shape[0]} remainder edges", flush=True)
    records = kernel_checks(g, to_device(graph, "cpu"), dev)
    # the staged launches past 204K: synthetic meshes whose plans the
    # window cap binds, each launch against its plain loop on CPU copies
    phase(t_run, "2, plans past 204K")
    plan_records = plan_checks(dev, g.band_off, PLAN_SIZES)

    phase(t_run, 3)
    # 3. the main path: the default generate (204K, climate on), cold
    # (recording the arguments of its components and pointer-doubling
    # loops for the last two phase-2 rows) then warm; then one warm
    # terrain-only run
    params = GenerationParams(seed=SEED)
    assert params.n_cells == N_CELLS and params.skip_climate is None
    (_, cold_s), loop_calls = record_calls(lambda: run_generate(dev, params),
                                           LOOP_SITES)
    print(f"generate 204K (default, climate on) cold: {cold_s:.2f} s",
          flush=True)
    records["components"] = components_record(g, dev, loop_calls)
    records["accumulate"] = accumulate_record(g, dev, loop_calls)
    sweep_cuda.reset_launches()
    (res, warm_s), counted = record_calls(lambda: run_generate(dev, params),
                                          dict.fromkeys(LOOP_SITES, 0))
    launches = dict(sweep_cuda.LAUNCHES)
    swept = sweep_cuda.sweeps_run()
    print(res.timing.table())
    print(f"generate 204K (default, climate on) warm: {warm_s:.3f} s",
          flush=True)
    diag, plates = check_planet(res, params.n_plates)
    print(f"diagnostics: {diag}, plates {plates}", flush=True)
    print("climate: " + check_climate(res), flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    print("kernels " + " ".join(f"{k}={v}" for k, v in launches.items())
          + f" | relax sweeps bfs_relax={swept['bfs_relax']} "
          f"stress={swept['stress']} warp={swept['warp']} "
          f"flood={swept['flood']} (rounds) shadow={swept['shadow']} (hops)")
    assert launches["components"] + launches["bfs_relax"] <= 40, launches
    n_calls = {name: sum(v for k, v in counted.items()
                         if len(k) == 3 and k[1] == name)
               for name in ("components_core", "pointer_accumulate",
                            "ordered_index_sum")}
    assert launches["components"] == n_calls["components_core"], (
        launches, n_calls)
    assert launches["accumulate"] == (n_calls["pointer_accumulate"]
                                      + n_calls["ordered_index_sum"]), (
        launches, n_calls)
    print(f"loops: {n_calls['components_core']} components loops in "
          f"{launches['components']} launches ({swept['components']} steps), "
          f"{n_calls['pointer_accumulate']} pointer-doubling loops and "
          f"{n_calls['ordered_index_sum']} one-round sums in "
          f"{launches['accumulate']} launches ({swept['accumulate']} rounds)",
          flush=True)
    assert launches["stress"] == 1, launches
    assert launches["warp"] == 1, launches
    assert launches["shadow"] == 1, launches
    # one rain-shadow call: max(shadow_hops, windward_hops) hops
    avg_edge_km = math.pi * 6371 / math.sqrt(N_CELLS)
    assert swept["shadow"] == max(8, round(2500 / avg_edge_km),
                                  round(1500 / avg_edge_km)), swept
    assert launches["smooth"] == SMOOTH_CALLS, launches
    assert res.error is None, res.error
    prof = profile_generate(dev, params)
    report_profile(prof, warm_s)
    assert prof is None or prof["one_sweep_bfs"] == 0, prof["one_sweep_bfs"]
    _, syncs = count_host_syncs(lambda: run_generate(dev, params))
    if prof is not None:
        print(f"default generate: device busy {prof['busy_ms']:.3f} ms, "
              f"{prof['n_events']} device events, {syncs} host syncs; with "
              f"one launch per sum and per components sweep: "
              f"{BEFORE_LOOP_LAUNCHES['busy_ms']} ms, "
              f"{BEFORE_LOOP_LAUNCHES['events']} events, "
              f"{BEFORE_LOOP_LAUNCHES['host_syncs']} host syncs (PERF.md §6)",
              flush=True)
    print(f"host syncs in the default generate (CUDA sync debug mode): "
          f"{syncs}", flush=True)

    terrain = GenerationParams(seed=SEED, skip_climate=True)
    res_t, warm_t = run_generate(dev, terrain)
    assert res_t.climate is None
    print(res_t.timing.table())
    print(f"generate 204K terrain-only warm: {warm_t:.3f} s", flush=True)
    check_planet(res_t, terrain.n_plates)
    report_profile(profile_generate(dev, terrain), warm_t)

    phase(t_run, 4)
    # 4. pinned distribution at 4K, climate on
    small, _ = run_generate(dev, GenerationParams(
        seed=123, n_cells=4000, n_plates=12, num_continents=2))
    snapshot_check(small)

    phase(t_run, 5)
    # 5. the glacial generate (204K, glacial 0.2, climate on): a first run
    # records the arguments of every float-sum site (thermal, smoothing,
    # dep_sum, downstream_accumulate, the wind bins, wsum, the ice flow and
    # the glacial step's remainder sums),
    # which are then replayed against the CPU; a warm run is counted,
    # timed and profiled
    glacial = GenerationParams(seed=SEED, glacial_erosion=0.2)
    (res_g, cold_g), calls = record_calls(
        lambda: run_generate(dev, glacial), SUM_SITES)
    print(f"generate 204K glacial 0.2 (climate on) cold, sums recorded: "
          f"{cold_g:.2f} s", flush=True)
    sites = sum_site_checks(calls)
    sweep_cuda.reset_launches()
    res_g, warm_g = run_generate(dev, glacial)
    launches_g = dict(sweep_cuda.LAUNCHES)
    print(res_g.timing.table())
    print(f"generate 204K glacial 0.2 (climate on) warm: {warm_g:.3f} s; "
          "kernels " + " ".join(f"{k}={v}" for k, v in launches_g.items()),
          flush=True)
    assert launches_g["accumulate"] > 0, launches_g
    assert res_g.error is None, res_g.error
    diag_g, plates_g = check_planet(res_g, glacial.n_plates)
    print(f"glacial diagnostics: {diag_g}, plates {plates_g}; climate: "
          + check_climate(res_g), flush=True)
    changed = int((res_g.elevation != res.elevation).sum())
    assert changed > 0
    print(f"glacial erosion moved {changed} cells against the default "
          "generate", flush=True)
    report_profile(profile_generate(dev, glacial), warm_g)

    phase(t_run, 6)
    # 6. the retained-state commands on the default planet
    walls = command_checks(dev, params, params.n_plates)

    phase(t_run, 7)
    # 7. sizes past 204K: 1M with climate, 2.56M terrain-only
    sizes = size_checks(dev)

    phase(t_run, 8)
    # 8. api/, the CLI and the batch sweep on the default planet
    with tempfile.TemporaryDirectory() as tmp:
        api_walls = api_checks(dev, res, tmp)
    phase(t_run, "end")

    # the row's times and bound are those of its phase-2 shape (configs /
    # shapes list the others); path_device_ms is the mean device time per
    # launch over the default generate's launches of the kernel
    top = {"name", "route", "source", "replaces", "launches", "max_abs_err",
           "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    records["accumulate"]["ice_flow"] = sites.get("ice_flow")
    records["accumulate"]["glacial_launches"] = launches_g["accumulate"]
    records["accumulate"]["port_only"] = True
    records["accumulate"]["host_syncs_default_generate"] = syncs
    kernels = [dict(
        name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
        launches=launches[k], max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        path_device_ms=None if prof is None else prof["device_ms"][k],
        **({"path_sweeps": swept[k]} if k in swept else {}),
        **{x: v for x, v in r.items() if x not in top})
        for k, r in records.items()]
    print(json.dumps({"commands_wall_s": walls,
                      "glacial_generate_wall_s": warm_g}))
    print(json.dumps({"sizes": sizes}, default=str))
    print(json.dumps({"plans_past_204K": plan_records}))
    print(json.dumps({"api_wall_s": api_walls}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
