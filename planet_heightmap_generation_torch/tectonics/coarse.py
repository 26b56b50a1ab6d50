"""Coarse reference grid and the projection of its plates onto the hi-res
mesh.

The reference generates plates on a fixed 20K mesh with isolated RNG
(seed+137) and fixed jitter (js/coarse-plates.js:11-21), then projects to
the hi-res mesh by FBM-warping each point and greedy-walking the coarse mesh
to the nearest cell (js/coarse-plates.js:51-117). Here the projection runs
on device: the FBM warp is a vectorized noise evaluation and the greedy
walk becomes a covering lat/lon-bin candidate gather + dot-product argmax
(mesh/geobins.py), which is exact rather than warm-start-approximate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import N_COARSE, COARSE_JITTER
from ..mesh.build import SphereGraph, build_sphere
from ..mesh.geobins import GeoBins, build_geobins, nearest_cell
from ..ops.rng import ParkMiller
from ..ops.noise import _noise3, make_perm_tables
from ..pipeline import timing
from .plates import PlateSet, generate_plates, _low_plate_t
from .ocean_land import assign_ocean_land

PROJECT_CHUNK = 65536


@dataclasses.dataclass
class CoarsePlates:
    graph: SphereGraph           # the 20K coarse mesh
    r_plate: np.ndarray          # [NC] plate slot per coarse cell
    plates: PlateSet
    bins: GeoBins                # nearest-coarse-cell index for projection


def generate_coarse_plates(seed: int, num_plates: int, num_continents: int,
                           continent_size_variety: float = 0.0,
                           land_coverage: float = 0.3,
                           n_coarse: int = N_COARSE) -> CoarsePlates:
    """Full coarse stage: mesh (isolated rng seed+137), plates, ocean/land."""
    coarse_rng = ParkMiller(seed + 137)
    # no "Mesh: …" spans: those label the planet's mesh
    with timing.current(None):
        graph = build_sphere(n_coarse, COARSE_JITTER, rng=coarse_rng)
    r_plate, plates = generate_plates(graph, num_plates, seed)
    plates.is_ocean = assign_ocean_land(
        graph, r_plate, plates, seed, num_continents,
        continent_size_variety, land_coverage,
    )
    bins = build_geobins(graph.pos[: graph.n_cells])
    return CoarsePlates(graph=graph, r_plate=r_plate, plates=plates, bins=bins)


def assign_plate_densities(plates: PlateSet) -> None:
    """Per-plate density from per-seed RNG r+777 (js/planet-worker.js:193-201):
    ocean = 3.0 + rng()*0.5 (first draw), land = 2.4 + rng()*0.5 (second)."""
    p = plates.num_plates
    for i in range(p):
        rng = ParkMiller(int(plates.seeds[i]) + 777)
        plates.density_ocean[i] = 3.0 + rng() * 0.5
        plates.density_land[i] = 2.4 + rng() * 0.5
    plates.density = np.where(
        plates.is_ocean, plates.density_ocean, plates.density_land
    )


def project_kernel(pos, perm, pm12, perturb_amp: float, bins_idx,
                   bins_mask, bins_points, coarse_plate_of_cell, n_lat: int,
                   n_lon: int):
    """FBM-warp positions, then nearest-coarse-cell plate lookup. [N]→[N].
    The candidate lookup runs in 65,536-row chunks: its [chunk, K_c, 3]
    gather is the largest transient of the terrain path."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(x)
    dz = torch.zeros_like(x)
    amp = torch.tensor(perturb_amp, dtype=torch.float32, device=pos.device)
    freq = 8.0  # js/coarse-plates.js:61
    for _ in range(4):
        dx = dx + _noise3(perm, pm12, x * freq, y * freq, z * freq) * amp
        dy = dy + _noise3(perm, pm12, x * freq + 100, y * freq + 100,
                          z * freq + 100) * amp
        dz = dz + _noise3(perm, pm12, x * freq + 200, y * freq + 200,
                          z * freq + 200) * amp
        amp = amp * 0.5
        freq = freq * 2.0
    px = x + dx
    py = y + dy
    pz = z + dz
    norm = torch.sqrt(px * px + py * py + pz * pz)
    norm = torch.where(norm == 0, 1.0, norm)
    q = torch.stack([px / norm, py / norm, pz / norm], dim=1)

    nearest = torch.cat([
        nearest_cell(bins_idx, bins_mask, bins_points, n_lat, n_lon,
                     q[lo:lo + PROJECT_CHUNK])
        for lo in range(0, q.shape[0], PROJECT_CHUNK)])
    return coarse_plate_of_cell[nearest]


def project_points_host(coarse: CoarsePlates, seed: int, num_plates: int,
                        pts: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`_project_kernel` for a handful of points
    (hotspot centers): FBM-warp each point with the same seed+999 tables,
    then brute-force nearest coarse cell. Keeps the device pipeline free of
    mid-pipeline [N] device→host reads. Differs from the device map only by
    f64-vs-f32 noise rounding and the hi-res majority smoothing — both at
    plate boundaries only."""
    from ..ops.noise import make_perm_tables, noise3_np

    perm, pm12 = make_perm_tables(seed + 999)
    coarse_edge_rad = np.pi / np.sqrt(coarse.graph.n_cells)
    low_t = _low_plate_t(num_plates)
    amp = coarse_edge_rad * (1.5 + 1.0 * low_t)

    pts = np.asarray(pts, np.float64).reshape(-1, 3)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    dx = np.zeros_like(x)
    dy = np.zeros_like(x)
    dz = np.zeros_like(x)
    freq = 8.0
    a = amp
    for _ in range(4):
        dx = dx + noise3_np(perm, pm12, x * freq, y * freq, z * freq) * a
        dy = dy + noise3_np(perm, pm12, x * freq + 100, y * freq + 100,
                            z * freq + 100) * a
        dz = dz + noise3_np(perm, pm12, x * freq + 200, y * freq + 200,
                            z * freq + 200) * a
        a *= 0.5
        freq *= 2.0
    q = np.stack([x + dx, y + dy, z + dz], axis=1)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)

    coarse_pts = coarse.graph.pos[: coarse.graph.n_cells]
    nearest = np.argmax(q @ coarse_pts.T, axis=1)
    return coarse.r_plate[nearest].astype(np.int32)


def projection_host(coarse: CoarsePlates, seed: int, num_plates: int):
    """The seed/coarse-derived inputs of :func:`project_kernel` (noise
    tables, warp amplitude, geobins, coarse plate map) as numpy arrays, in
    :func:`projection_from_numpy`'s argument order."""
    perm, pm12 = make_perm_tables(seed + 999)
    coarse_edge_rad = np.pi / np.sqrt(coarse.graph.n_cells)
    low_t = _low_plate_t(num_plates)
    perturb_amp = float(np.float32(coarse_edge_rad * (1.5 + 1.0 * low_t)))
    return (perm, pm12, perturb_amp, coarse.bins.cand_idx,
            coarse.bins.cand_mask, coarse.bins.points, coarse.r_plate)


def projection_inputs(coarse: CoarsePlates, seed: int, num_plates: int,
                      device="cpu"):
    """:func:`projection_host`'s inputs as tensors on ``device``."""
    return projection_from_numpy(*projection_host(coarse, seed, num_plates),
                                 device)


def project_coarse_plates(graph, coarse: CoarsePlates, seed: int,
                          num_plates: int, device="cpu"):
    """Project the coarse plate slots onto the hi-res mesh ``graph`` (a
    ``SphereGraph``): :func:`projection_inputs` and :func:`project_kernel`
    in one call, on ``device``. Returns [NP] int32 plate ids."""
    perm, pm12, amp, bi, bm, bp, cp = projection_inputs(coarse, seed,
                                                        num_plates, device)
    pos = torch.as_tensor(np.asarray(graph.pos, np.float32), device=device)
    return project_kernel(pos, perm, pm12, amp, bi, bm, bp, cp,
                          coarse.bins.n_lat, coarse.bins.n_lon)


def projection_from_numpy(perm, pm12, perturb_amp, cand_idx, cand_mask,
                          points, coarse_plate, device="cpu"):
    """Tensors of the projection inputs from their numpy arrays."""
    def t(a, dtype):
        # a copy: the producer's arrays may be read-only views
        return torch.tensor(np.array(a), dtype=dtype, device=device)

    return (t(perm, torch.int64), t(pm12, torch.int64), float(perturb_amp),
            t(cand_idx, torch.int64), t(cand_mask, torch.bool),
            t(points, torch.float32), t(coarse_plate, torch.int32))
