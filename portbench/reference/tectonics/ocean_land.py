"""Ocean/land assignment at the plate level — host side.

Re-design of reference ``js/ocean-land.js``: plate areas/centroids, plate
adjacency graph, compactness, farthest-point continent seeding with top-3
pick, seed-budget trim, round-robin continent growth to per-continent
targets (log-normal-skewed under continentSizeVariety), trapped-sea
absorption. Operates entirely on [P]-sized plate arrays (P ≤ 120), so it is
sub-millisecond host work; RNG stream is seed+42 (js/ocean-land.js:8) with
matching draw structure.
"""

from __future__ import annotations

import math

import numpy as np

from ..mesh.build import SphereGraph
from .plates import BufferedStream, PlateSet


def plate_geometry(graph: SphereGraph, r_plate: np.ndarray, num_plates: int):
    """Areas, centroids, adjacency sets and perimeter per plate slot."""
    n = graph.n_cells
    rp = r_plate[:n]
    area = np.bincount(rp, minlength=num_plates).astype(np.float64)
    pos = graph.pos[:n].astype(np.float64)
    centroid = np.zeros((num_plates, 3))
    for c in range(3):
        centroid[:, c] = np.bincount(rp, weights=pos[:, c], minlength=num_plates)
    centroid /= np.maximum(area, 1.0)[:, None]

    nbr_idx = graph.nbr_idx[:n]
    nbr_mask = graph.nbr_mask[:n]
    np_plate = rp[nbr_idx]
    diff = nbr_mask & (np_plate != rp[:, None])
    is_boundary = diff.any(axis=1)
    perim = np.bincount(rp[is_boundary], minlength=num_plates).astype(np.float64)

    src = np.repeat(rp, nbr_idx.shape[1])[diff.ravel()]
    dst = np_plate.ravel()[diff.ravel()]
    pairs = np.unique(src.astype(np.int64) * num_plates + dst)
    adj = [[] for _ in range(num_plates)]
    for pr in pairs:
        adj[int(pr // num_plates)].append(int(pr % num_plates))

    return area, centroid, adj, perim


def assign_ocean_land(graph: SphereGraph, r_plate: np.ndarray,
                      plates: PlateSet, seed: int, num_continents: int,
                      continent_size_variety: float = 0.0,
                      land_coverage: float = 0.3) -> np.ndarray:
    """Returns is_ocean [P] bool (True = ocean plate)."""
    rng = BufferedStream(seed + 42)
    p = plates.num_plates
    n = graph.n_cells

    area, centroid, adj, perim = plate_geometry(graph, r_plate, p)

    compact = np.sqrt(np.maximum(area, 1.0)) / np.maximum(perim, 1.0)
    mx = compact.max()
    if mx > 0:
        compact = compact / mx

    target_land = land_coverage * n

    # --- continent seeds via farthest-point sampling (js/ocean-land.js:67-99)
    effective = min(num_continents, p)
    continent_seeds: list[int] = []
    chosen = np.zeros(p, dtype=bool)
    first = int(rng.next() * p)
    continent_seeds.append(first)
    chosen[first] = True

    for _ in range(1, effective):
        cands = []
        for pid in range(p):
            if chosen[pid]:
                continue
            d = min(
                float(((centroid[pid] - centroid[e]) ** 2).sum())
                for e in continent_seeds
            )
            raw_af = math.sqrt(n / p) / math.sqrt(max(area[pid], 1.0))
            af = 1 + (raw_af - 1) * (1 - continent_size_variety * 0.5)
            comp = 0.3 + 0.7 * compact[pid]
            cands.append((pid, d * af * comp))
        if not cands:
            break
        cands.sort(key=lambda t: -t[1])
        top_k = min(len(cands), 3)
        pick = cands[int(rng.next() * top_k)]
        continent_seeds.append(pick[0])
        chosen[pick[0]] = True

    # trim seeds that alone exceed the budget (js/ocean-land.js:102-112)
    seed_area = sum(area[pid] for pid in continent_seeds)
    while len(continent_seeds) > 1 and seed_area > target_land:
        max_i = max(range(len(continent_seeds)),
                    key=lambda i: area[continent_seeds[i]])
        seed_area -= area[continent_seeds[max_i]]
        chosen[continent_seeds[max_i]] = False
        continent_seeds.pop(max_i)

    continent_of = np.full(p, -1, dtype=np.int64)
    for c, pid in enumerate(continent_seeds):
        continent_of[pid] = c
    land_area = seed_area

    # --- round-robin growth (js/ocean-land.js:121-180) ---
    grow_target = target_land * 0.9
    num_c = len(continent_seeds)
    cont_area = np.array([area[pid] for pid in continent_seeds], dtype=np.float64)

    if continent_size_variety > 0 and num_c > 1:
        weights = np.array(
            [math.exp((rng.next() - 0.5) * continent_size_variety * 2.5)
             for _ in range(num_c)]
        )
        cont_target = grow_target * weights / weights.sum()
    else:
        cont_target = np.full(num_c, grow_target / max(num_c, 1))

    progress = True
    while progress and land_area < grow_target:
        progress = False
        for c in range(num_c):
            if land_area >= grow_target:
                break
            if cont_area[c] >= cont_target[c]:
                continue
            cands = []
            for pid in range(p):
                if continent_of[pid] != -1:
                    continue
                touches_self = touches_other = False
                same = 0
                for a in adj[pid]:
                    ac = continent_of[a]
                    if ac == c:
                        touches_self = True
                        same += 1
                    elif ac != -1:
                        touches_other = True
                        break
                if touches_self and not touches_other:
                    cands.append((pid, same + compact[pid] * 3 + rng.next() * 0.5))
            if not cands:
                continue
            cands.sort(key=lambda t: -t[1])
            top_k = min(len(cands), 3)
            pick = cands[int(rng.next() * top_k)]
            continent_of[pick[0]] = c
            cont_area[c] += area[pick[0]]
            land_area += area[pick[0]]
            progress = True

    # --- absorb trapped interior seas (js/ocean-land.js:182-230) ---
    visited = np.zeros(p, dtype=bool)
    components = []
    for pid in range(p):
        if continent_of[pid] != -1 or visited[pid]:
            continue
        comp = [pid]
        visited[pid] = True
        qi = 0
        while qi < len(comp):
            for a in adj[comp[qi]]:
                if continent_of[a] == -1 and not visited[a]:
                    visited[a] = True
                    comp.append(a)
            qi += 1
        components.append(comp)

    if components:
        main_idx = max(range(len(components)),
                       key=lambda i: sum(area[pid] for pid in components[i]))
        absorb_cap = target_land * 1.1
        for i, comp in enumerate(components):
            if i == main_idx:
                continue
            bordering = set()
            for op in comp:
                for a in adj[op]:
                    if continent_of[a] != -1:
                        bordering.add(int(continent_of[a]))
                if len(bordering) > 1:
                    break
            if len(bordering) == 1:
                comp_area = sum(area[pid] for pid in comp)
                if land_area + comp_area <= absorb_cap:
                    c = next(iter(bordering))
                    for op in comp:
                        continent_of[op] = c
                    land_area += comp_area

    return continent_of == -1
