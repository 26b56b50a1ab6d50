"""Tectonic plate generation — host side (runs on the fixed 20K coarse mesh).

Re-design of reference ``js/plates.js``: farthest-point seed placement with
top-3 jitter pick, per-plate growth rate / tangent direction / direction
strength, round-robin weighted flood fill with compactness penalty and area
governor, orphan adoption, majority-vote smoothing and largest-component
reconnection, and per-plate Euler poles.

This stage always runs on the fixed-size coarse grid (N_COARSE=20_000,
reference js/coarse-plates.js:11) so its cost is constant regardless of the
detail level — it stays on host (vectorized numpy + a frontier loop), and its
[P]-sized outputs ship to device as dense plate-slot arrays. Plates are
indexed by SLOT (0..P-1, insertion order) rather than by seed region id as in
the reference — slot indexing makes every downstream device gather a dense
[P] lookup.

RNG streams mirror the reference (rng = seed+0.5, randInt = seed,
js/plates.js:9-10) with identical per-event draw counts; bitwise equality
with the JS is not expected because frontier memory layout differs (SURVEY.md
§7 hard part 5 — structural parity is the contract).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import sparse
from scipy.sparse import csgraph

from ..mesh.build import SphereGraph
from ..ops.rng import ParkMiller


class BufferedStream:
    """Park-Miller stream with block-buffered vectorized draws.

    Tracks the LOGICAL position (draws actually consumed) so the state can
    be handed to / resumed from the native fill kernel, which advances the
    raw recurrence itself."""

    _M = 2147483647
    _A = 16807

    def __init__(self, seed: float, block: int = 16384):
        self._rng = ParkMiller(seed)
        self._s0 = self._rng.s
        self._consumed = 0
        self._block = block
        self._buf = np.empty(0)
        self._i = 0

    def next(self) -> float:
        if self._i >= len(self._buf):
            self._buf = self._rng.sequence(self._block)
            self._i = 0
        v = self._buf[self._i]
        self._i += 1
        self._consumed += 1
        return v

    def take(self, k: int) -> np.ndarray:
        if self._i + k > len(self._buf):
            rest = self._buf[self._i:]
            need = k - len(rest)
            self._buf = self._rng.sequence(max(self._block, need))
            self._i = 0
            out = np.concatenate([rest, self._buf[:need]])
            self._i = need
        else:
            out = self._buf[self._i:self._i + k]
            self._i += k
        self._consumed += k
        return out

    def logical_state(self) -> int:
        """Park-Miller state at the consumed position (ignores buffering)."""
        return (self._s0 * pow(self._A, self._consumed, self._M)) % self._M

    def set_logical_state(self, s: int) -> None:
        """Resume the stream from an externally-advanced state."""
        self._rng.s = int(s)
        self._s0 = int(s)
        self._consumed = 0
        self._buf = np.empty(0)
        self._i = 0


@dataclasses.dataclass
class PlateSet:
    """Dense per-plate-slot arrays (insertion order = planet-code order)."""

    seeds: np.ndarray        # [P] i32 coarse region id of each plate seed
    pole: np.ndarray         # [P, 3] f64 Euler pole
    omega: np.ndarray        # [P] f64 angular velocity (signed)
    is_ocean: np.ndarray     # [P] bool (filled by assign_ocean_land)
    density: np.ndarray      # [P] f64
    density_land: np.ndarray
    density_ocean: np.ndarray

    @property
    def num_plates(self) -> int:
        return len(self.seeds)


def _low_plate_t(num_plates: int) -> float:
    return max(0.0, min(1.0, (80 - num_plates) / 60.0))


def generate_plates(graph: SphereGraph, num_plates: int, seed: int):
    """Generate plates on the (coarse) mesh. Returns (r_plate_slot, PlateSet)
    with r_plate_slot an int32 [n_cells] array of slot ids."""
    n = graph.n_cells
    pos = graph.pos[:n].astype(np.float64)
    rng = BufferedStream(seed + 0.5)
    randint = BufferedStream(seed)

    def rand_int(k: int) -> int:
        return int(randint.next() * k)

    # --- farthest-point seeding with top-3 jitter (js/plates.js:12-87) ---
    seeds: list[int] = []
    is_seed = np.zeros(n, dtype=bool)
    first = rand_int(n)
    seeds.append(first)
    is_seed[first] = True
    min_dist = 1.0 - pos @ pos[first]
    min_dist[first] = 0.0

    while len(seeds) < min(num_plates, n):
        d = np.where(is_seed, -1.0, min_dist)
        top = np.argpartition(d, -3)[-3:]
        top = top[np.argsort(-d[top], kind="stable")]
        valid = top[d[top] > -1.0]
        if len(valid) == 0:
            break
        pick = rand_int(len(valid))
        s = int(valid[pick])
        seeds.append(s)
        is_seed[s] = True
        min_dist = np.minimum(min_dist, 1.0 - pos @ pos[s])

    p = len(seeds)
    seeds_arr = np.asarray(seeds, dtype=np.int32)
    low_t = _low_plate_t(num_plates)

    # --- per-plate growth properties (js/plates.js:93-115) ---
    rate_min = 0.7 - 0.4 * low_t
    rate_range = 2.3 + 2.4 * low_t
    dir_base = 0.15 + 0.25 * low_t
    dir_scale = 0.25 + 0.25 * low_t

    growth_rate = np.empty(p)
    growth_dir = np.empty((p, 3))
    dir_strength = np.empty(p)
    for i, center in enumerate(seeds):
        growth_rate[i] = rate_min + rng.next() * rng.next() * rate_range
        nvec = pos[center]
        rv = np.array([rng.next() - 0.5, rng.next() - 0.5, rng.next() - 0.5])
        t = rv - (rv @ nvec) * nvec
        tlen = np.linalg.norm(t) or 1.0
        growth_dir[i] = t / tlen
        dir_strength[i] = min(0.85, rng.next() * (dir_base + dir_scale / growth_rate[i]))

    # --- round-robin weighted flood fill (js/plates.js:117-196) ---
    r_plate = np.full(n, -1, dtype=np.int32)
    r_plate[seeds_arr] = np.arange(p, dtype=np.int32)

    compact_weight = 0.3 - 0.22 * low_t
    expected_area = max(1.0, (n - p) / num_plates)
    governor_mult = 2.0 + 2.0 * low_t

    from ..native import get_coarse_fill
    native_fill = get_coarse_fill()
    if native_fill is not None:
        import ctypes
        rng_state = ctypes.c_int64(rng.logical_state())
        randint_state = ctypes.c_int64(randint.logical_state())
        native_fill(
            n, p, graph.nbr_idx.shape[1], num_plates,
            np.ascontiguousarray(graph.nbr_idx[:n]),
            np.ascontiguousarray(graph.nbr_mask[:n].astype(np.uint8)),
            np.ascontiguousarray(pos),
            seeds_arr,
            np.ascontiguousarray(growth_rate),
            np.ascontiguousarray(growth_dir),
            np.ascontiguousarray(dir_strength),
            expected_area, governor_mult, compact_weight,
            ctypes.byref(rng_state), ctypes.byref(randint_state),
            r_plate,
        )
        rng.set_logical_state(rng_state.value)
        randint.set_logical_state(randint_state.value)
    else:
        _python_fill(graph, pos, r_plate, seeds_arr,
                     growth_rate, growth_dir, dir_strength,
                     expected_area, governor_mult, compact_weight,
                     rng, randint)

    num_passes = round(3 - 2 * low_t)
    protect = np.zeros(n, dtype=bool)
    protect[seeds_arr] = True
    smooth_and_reconnect_host(graph, r_plate, protect, num_passes)

    # --- Euler poles (js/plates.js:219-229) ---
    pole = np.empty((p, 3))
    omega = np.empty(p)
    for i in range(p):
        theta = rng.next() * 2 * math.pi
        cos_p = 2 * rng.next() - 1
        sin_p = math.sqrt(max(0.0, 1 - cos_p * cos_p))
        pole[i] = [sin_p * math.cos(theta), sin_p * math.sin(theta), cos_p]
        omega[i] = (0.5 + rng.next() * 1.5) * (-1.0 if rng.next() < 0.5 else 1.0)

    plates = PlateSet(
        seeds=seeds_arr,
        pole=pole,
        omega=omega,
        is_ocean=np.zeros(p, dtype=bool),
        density=np.full(p, 2.7),
        density_land=np.full(p, 2.7),
        density_ocean=np.full(p, 3.2),
    )
    return r_plate, plates


def _python_fill(graph, pos, r_plate, seeds_arr,
                 growth_rate, growth_dir, dir_strength,
                 expected_area, governor_mult, compact_weight,
                 rng, randint):
    """Pure-Python fallback for the round-robin fill (same algorithm and
    per-stream RNG consumption as native/coarse_fill.cpp)."""
    n = graph.n_cells
    p = len(seeds_arr)
    frontier = np.empty((p, n), dtype=np.int32)
    f_len = np.zeros(p, dtype=np.int64)
    for i, s in enumerate(seeds_arr):
        frontier[i, 0] = s
        f_len[i] = 1
    area = np.ones(p, dtype=np.int64)

    nbr_idx = graph.nbr_idx[:n]
    nbr_mask = graph.nbr_mask[:n]

    remaining = n - p
    inv_n = 1.0 / n
    seed_pos = pos[seeds_arr]

    while remaining > 0:
        any_progress = False
        for pid in range(p):
            fl = f_len[pid]
            if fl == 0:
                continue
            rate = growth_rate[pid]
            dvec = growth_dir[pid]
            dstr = dir_strength[pid]
            steps = max(1, math.ceil(rate * (0.5 + rng.next())))
            if area[pid] > expected_area * governor_mult:
                steps = max(1, math.ceil(steps * 0.5))
            expected_chord = math.sqrt(area[pid] * inv_n / math.pi) * 2
            compact_threshold = expected_chord * 1.8
            sp = seed_pos[pid]

            for _ in range(steps):
                fl = f_len[pid]
                if fl == 0:
                    break
                samples = int(min(fl, 3 + int(dstr * 5)))
                idxs = (randint.take(samples) * fl).astype(np.int64)
                cells = frontier[pid, idxs]
                dv = pos[cells] - sp
                # explicit left-to-right sums (NOT einsum/@): BLAS kernels
                # use FMA/reordered accumulation, which diverges from the
                # plain C arithmetic of the native fill at near-ties
                dlen_sq = (dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                           + dv[:, 2] * dv[:, 2])
                dlen = np.sqrt(dlen_sq)
                dlen[dlen == 0] = 1.0
                alignment = (dv[:, 0] * dvec[0] + dv[:, 1] * dvec[1]
                             + dv[:, 2] * dvec[2]) / dlen
                excess = np.maximum(0.0, dlen_sq * 0.5 - compact_threshold)
                penalty = excess * (compact_weight * 4)
                scores = alignment * dstr + rng.take(samples) * (1 - dstr * 0.5) - penalty
                best = int(np.argmax(scores))
                bidx = idxs[best]
                cell = frontier[pid, bidx]
                # swap-pop
                f_len[pid] -= 1
                frontier[pid, bidx] = frontier[pid, f_len[pid]]

                nbs = nbr_idx[cell][nbr_mask[cell]]
                free = nbs[r_plate[nbs] == -1]  # adjacency order, already unique
                if len(free):
                    r_plate[free] = pid
                    nf = len(free)
                    frontier[pid, f_len[pid]:f_len[pid] + nf] = free
                    f_len[pid] += nf
                    area[pid] += nf
                    remaining -= nf
                    any_progress = True
        if not any_progress:
            break

    # --- orphan adoption (js/plates.js:199-214) ---
    while True:
        orphans = np.flatnonzero(r_plate == -1)
        if len(orphans) == 0:
            break
        np_plates = np.where(nbr_mask[orphans], r_plate[nbr_idx[orphans]], -1)
        has = (np_plates >= 0)
        pickable = has.any(axis=1)
        if not pickable.any():
            break
        first_slot = np.argmax(has, axis=1)
        adopted = np_plates[np.arange(len(orphans)), first_slot]
        sel = orphans[pickable]
        r_plate[sel] = adopted[pickable]


def smooth_and_reconnect_host(graph: SphereGraph, r_plate: np.ndarray,
                              protect: np.ndarray, num_passes: int) -> None:
    """Majority-vote smoothing + largest-component reconnection, host numpy.

    Mirrors reference smoothAndReconnectPlates (js/plates.js:241-348) with
    synchronous (Jacobi) majority passes. Mutates ``r_plate`` in place.
    The device equivalent for hi-res meshes lives in ops/graph.py.
    """
    n = graph.n_cells
    nbr_idx = graph.nbr_idx[:n]
    nbr_mask = graph.nbr_mask[:n]
    deg = nbr_mask.sum(axis=1)

    for pass_i in range(num_passes):
        threshold = 0.4 if pass_i == 0 else 0.5
        nl = r_plate[nbr_idx]                                     # [n, K]
        same = (nl[:, :, None] == nl[:, None, :])
        same &= nbr_mask[:, None, :] & nbr_mask[:, :, None]
        counts = same.sum(axis=2)
        counts[~nbr_mask] = -1
        best_slot = counts.argmax(axis=1)
        rows = np.arange(n)
        best_count = counts[rows, best_slot]
        best_label = nl[rows, best_slot]
        adopt = (best_count > deg * threshold) & (~protect[:n]) & (deg > 0)
        r_plate[:n][adopt] = best_label[adopt]

    # largest connected component per plate via scipy csgraph
    src = np.repeat(np.arange(n, dtype=np.int32), nbr_idx.shape[1])
    dst = nbr_idx.ravel()
    ok = nbr_mask.ravel() & (r_plate[src] == r_plate[dst])
    g = sparse.coo_matrix(
        (np.ones(ok.sum(), dtype=np.int8), (src[ok], dst[ok])), shape=(n, n)
    )
    _, labels = csgraph.connected_components(g, directed=False)
    comp_size = np.bincount(labels)

    # per plate: component with max size (tie → smaller label)
    order = np.lexsort((labels, -comp_size[labels], r_plate[:n]))
    plate_sorted = r_plate[:n][order]
    first_of_plate = np.ones(n, dtype=bool)
    first_of_plate[1:] = plate_sorted[1:] != plate_sorted[:-1]
    main_label_of_plate = {}
    for i in np.flatnonzero(first_of_plate):
        main_label_of_plate[int(plate_sorted[i])] = int(labels[order[i]])
    main_label = np.array(
        [main_label_of_plate[int(pl)] for pl in r_plate[:n]], dtype=np.int64
    )
    in_main = labels == main_label

    # BFS reassignment from the main-component boundary (js/plates.js:322-347)
    while not in_main.all():
        out = np.flatnonzero(~in_main)
        nb = nbr_idx[out]
        good = nbr_mask[out] & in_main[nb]
        has = good.any(axis=1)
        if not has.any():
            break
        first_slot = np.argmax(good, axis=1)
        adopted = r_plate[nb[np.arange(len(out)), first_slot]]
        sel = out[has]
        r_plate[sel] = adopted[has]
        in_main[sel] = True
