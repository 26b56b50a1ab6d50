"""Super plates — grouping same-type plates into broad tectonic units.

Re-design of reference ``js/super-plates.js``: connected components of
same-type (ocean/land) adjacent plates, farthest-point + multi-source
Dijkstra splitting of large components with edge weight sqrt(destination
plate area), area-weighted angular-momentum Euler poles, majority-area ocean
flag, area-weighted density. All [P]-sized host graph work (P ≤ 120).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..mesh.build import SphereGraph
from .plates import PlateSet
from .ocean_land import plate_geometry


# Fixed padded length for the [S] arrays (worst case: every plate its own
# component, P ≤ 121). Keeps jit shapes seed-stable.
S_MAX = 128


@dataclasses.dataclass
class SuperPlates:
    plate_to_super: np.ndarray    # [P] i32
    num_super: int
    pole: np.ndarray              # [S, 3]
    omega: np.ndarray             # [S]
    is_ocean: np.ndarray          # [S] bool
    density: np.ndarray           # [S]


def build_super_plates(graph: SphereGraph, r_plate: np.ndarray,
                       plates: PlateSet) -> SuperPlates:
    p = plates.num_plates
    area, _, adj, _ = plate_geometry(graph, r_plate, p)
    is_ocean = plates.is_ocean

    # --- connected components of same-type plates (js/super-plates.js:41-62)
    visited = np.zeros(p, dtype=bool)
    components: list[list[int]] = []
    for pid in range(p):
        if visited[pid]:
            continue
        t = is_ocean[pid]
        comp = [pid]
        visited[pid] = True
        qi = 0
        while qi < len(comp):
            for nb in adj[comp[qi]]:
                if not visited[nb] and is_ocean[nb] == t:
                    visited[nb] = True
                    comp.append(nb)
            qi += 1
        components.append(comp)

    target = max(2, min(20, round(p / 4)))
    plate_to_super = np.full(p, -1, dtype=np.int32)
    next_sp = 0

    for comp in components:
        k = max(1, round(target * len(comp) / p))
        if k <= 1:
            for pid in comp:
                plate_to_super[pid] = next_sp
            next_sp += 1
            continue

        comp_set = set(comp)
        local_adj = {pid: [nb for nb in adj[pid] if nb in comp_set] for pid in comp}
        weight = {pid: math.sqrt(max(area[pid], 1.0)) for pid in comp}

        def dijkstra(sources):
            dist = {pid: math.inf for pid in comp}
            seen = set()
            for s in sources:
                dist[s] = 0.0
            for _ in range(len(comp)):
                cur, best = -1, math.inf
                for pid in comp:
                    if pid not in seen and dist[pid] < best:
                        best, cur = dist[pid], pid
                if cur == -1:
                    break
                seen.add(cur)
                for nb in local_adj[cur]:
                    nd = dist[cur] + weight[nb]
                    if nd < dist[nb]:
                        dist[nb] = nd
            return dist

        # farthest-point seeding on the weighted plate graph
        sp_seeds = [comp[0]]
        dist = dijkstra(sp_seeds)
        for _ in range(1, k):
            far = max(comp, key=lambda pid: dist[pid])
            sp_seeds.append(far)
            dist = dijkstra(sp_seeds)

        # multi-source Dijkstra assignment (js/super-plates.js:138-165)
        assign = {pid: -1 for pid in comp}
        d = {pid: math.inf for pid in comp}
        for si, s in enumerate(sp_seeds):
            assign[s] = next_sp + si
            d[s] = 0.0
        seen = set()
        for _ in range(len(comp)):
            cur, best = -1, math.inf
            for pid in comp:
                if pid not in seen and d[pid] < best:
                    best, cur = d[pid], pid
            if cur == -1:
                break
            seen.add(cur)
            for nb in local_adj[cur]:
                nd = d[cur] + weight[nb]
                if nd < d[nb]:
                    d[nb] = nd
                    assign[nb] = assign[cur]
        for pid in comp:
            plate_to_super[pid] = assign[pid]
        next_sp += len(sp_seeds)

    num_super = next_sp

    # --- Euler poles: area-weighted angular momentum (js/super-plates.js:184-235)
    lvec = np.zeros((num_super, 3))
    omega_sum = np.zeros(num_super)
    area_sum = np.zeros(num_super)
    largest = np.full(num_super, -1, dtype=np.int64)
    largest_area = np.zeros(num_super)
    for pid in range(p):
        sp = plate_to_super[pid]
        a = area[pid]
        lvec[sp] += a * plates.omega[pid] * plates.pole[pid]
        omega_sum[sp] += a * abs(plates.omega[pid])
        area_sum[sp] += a
        if a > largest_area[sp]:
            largest_area[sp] = a
            largest[sp] = pid

    sp_pole = np.zeros((num_super, 3))
    sp_omega = np.zeros(num_super)
    for sp in range(num_super):
        llen = np.linalg.norm(lvec[sp])
        if llen < 1e-8 or area_sum[sp] < 1:
            if largest[sp] >= 0:
                sp_pole[sp] = plates.pole[largest[sp]]
                sp_omega[sp] = plates.omega[largest[sp]]
            else:
                sp_pole[sp] = [0.0, 1.0, 0.0]
        else:
            sp_pole[sp] = lvec[sp] / llen
            sp_omega[sp] = omega_sum[sp] / area_sum[sp]

    # --- ocean flag by majority area; density area-weighted ---
    ocean_area = np.zeros(num_super)
    dens_sum = np.zeros(num_super)
    for pid in range(p):
        sp = plate_to_super[pid]
        if is_ocean[pid]:
            ocean_area[sp] += area[pid]
        dens_sum[sp] += area[pid] * plates.density[pid]
    sp_ocean = ocean_area > area_sum * 0.5
    sp_density = np.where(area_sum > 0, dens_sum / np.maximum(area_sum, 1e-9), 2.7)

    # Pad the [S] arrays to a fixed S_MAX so downstream jit kernels
    # (find_collisions on the super layer) keep one shape across seeds and
    # plate edits — variable S would recompile per planet. Padded entries
    # are never referenced: plate_to_super only maps to real ids.
    pad = S_MAX - num_super
    if pad > 0:
        sp_pole = np.concatenate([sp_pole, np.tile([[0.0, 1.0, 0.0]], (pad, 1))])
        sp_omega = np.concatenate([sp_omega, np.zeros(pad)])
        sp_ocean = np.concatenate([sp_ocean, np.ones(pad, bool)])
        sp_density = np.concatenate([sp_density, np.full(pad, 3.0)])

    return SuperPlates(
        plate_to_super=plate_to_super,
        num_super=num_super,
        pole=sp_pole,
        omega=sp_omega,
        is_ocean=sp_ocean,
        density=sp_density,
    )
