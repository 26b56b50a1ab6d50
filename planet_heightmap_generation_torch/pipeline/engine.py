"""The planet engine — ``generate`` on a CUDA device.

One eager path: host prologue (mesh, coarse tectonics, super plates,
hotspot domes, noise tables) in numpy and native C++, then plate
projection → smoothing and reconnection → elevation → erosion → climate
(coast fields, wind, ocean currents, precipitation, temperature, Köppen)
in torch, with the banded sweep loops in the CUDA kernels of
ops/sweep_cuda.py. Climate runs when ``skip_climate`` is False, or None
at ≤ ``AUTO_CLIMATE_THRESHOLD`` cells, as in the reference. A climate
failure propagates: the JAX engine's seam that turns it into
``PlanetResult.error`` belongs with ``compute_climate``, which is not
ported yet. Glacial erosion is not ported and raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import GenerationParams, AUTO_CLIMATE_THRESHOLD
from ..mesh.build import SphereGraph, build_sphere
from ..mesh.device import DeviceGraph, to_device
from ..ops.rng import ParkMiller
from ..ops.noise import tables
from ..ops.graph import majority_smooth
from ..ops.banded import connected_components_gated, flood_assign_banded
from ..tectonics.coarse import (CoarsePlates, generate_coarse_plates,
                                assign_plate_densities, project_kernel,
                                project_points_host, projection_inputs)
from ..tectonics.super_plates import build_super_plates
from ..elevation.assemble import assign_elevation, elevation_tables
from ..elevation.hotspots import build_domes
from ..erosion.composite import run_post_processing
from ..climate import (compute_wind, compute_ocean_currents,
                       compute_precipitation, compute_temperature,
                       classify_koppen)
from ..climate.wind import climate_coast_fields
from .timing import StageTimer

MAX_SUPER = 32


@dataclasses.dataclass
class PlanetResult:
    """The 'done' message equivalent (js/planet-worker.js:299-325)."""

    graph: SphereGraph
    params: GenerationParams
    r_plate: torch.Tensor
    plate_seeds: np.ndarray
    plate_is_ocean: np.ndarray
    plate_density: np.ndarray
    pre_post_elevation: torch.Tensor
    elevation: torch.Tensor
    t_elevation: torch.Tensor
    stress: torch.Tensor
    mountain_mask: torch.Tensor
    coastline_mask: torch.Tensor
    ocean_seed_mask: torch.Tensor
    climate: Optional[Dict]
    debug: Dict
    timing: StageTimer

    def _elev_np(self) -> np.ndarray:
        return self.elevation[: self.graph.n_cells].cpu().numpy()

    @property
    def land_fraction(self) -> float:
        return float((self._elev_np() > 0).mean())

    def diagnostics(self) -> Dict:
        """NaN / land-fraction checks (js/generate.js:317-330)."""
        e = self._elev_np()
        return dict(
            nan_count=int(np.isnan(e).sum()),
            land_fraction=float((e > 0).mean()),
            min=float(np.nanmin(e)), max=float(np.nanmax(e)),
        )


def smooth_and_reconnect(g: DeviceGraph, r_plate, num_p: int,
                         num_passes: int = 3):
    """Hi-res plate smoothing + reconnection (the reference runs
    smoothAndReconnectPlates on the projected map, js/planet-worker.js:173):
    majority smoothing, then every plate keeps its largest connected piece
    (ties toward the smallest component label) and the other pieces are
    flood-assigned from their neighbours."""
    n = g.n_padded
    protect = torch.zeros(n, dtype=torch.bool, device=g.device)
    r_plate = majority_smooth(r_plate, g.nbr_idx, g.nbr_mask, protect,
                              num_passes=num_passes)

    labels = connected_components_gated(r_plate, *g.bands).long()
    rp = r_plate.long()
    sizes = torch.zeros(n, dtype=torch.int64, device=g.device).index_add(
        0, labels, g.valid.to(torch.int64))
    comp_size = sizes[labels]
    imin = torch.iinfo(torch.int64).min
    max_per_plate = torch.full((num_p,), imin, dtype=torch.int64,
                               device=g.device).scatter_reduce(
        0, rp, torch.where(g.valid, comp_size, 0), "amax")
    is_max = comp_size == max_per_plate[rp]
    min_tied = torch.full((num_p,), torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=g.device).scatter_reduce(
        0, rp, torch.where(is_max & g.valid, labels, n), "amin")
    in_main = is_max & (labels == min_tied[rp]) & g.valid
    val, _ = flood_assign_banded(r_plate.to(torch.int32), in_main, *g.bands)
    return torch.where(g.valid, val, r_plate).to(torch.int32)


@dataclasses.dataclass
class PlanetSetup:
    """Everything the device pipeline needs, built on host for one seed."""

    params: GenerationParams
    graph: SphereGraph
    g: DeviceGraph
    coarse: CoarsePlates
    plates: object
    super_sp: object
    domes: Dict[str, torch.Tensor]
    noise_pack: Dict
    warp_t: object
    climate_t: object
    projection: tuple
    plate_arrays: tuple
    super_arrays: Optional[tuple]


def plate_arrays(plates, device):
    """(is_ocean, pole, omega, density) of the plates as tensors."""
    return (torch.as_tensor(plates.is_ocean, device=device),
            torch.as_tensor(plates.pole.astype(np.float32), device=device),
            torch.as_tensor(plates.omega.astype(np.float32), device=device),
            torch.as_tensor(plates.density.astype(np.float32), device=device))


def super_arrays(super_sp, device, max_super: int = MAX_SUPER):
    """(plate_to_super, is_ocean, pole, omega, density) of the super
    plates, padded to ``max_super`` inert rows (zero angular velocity,
    mapped to by no plate); None without super plates."""
    if super_sp is None:
        return None
    so = super_sp.is_ocean
    spo = super_sp.pole.astype(np.float32)
    som = super_sp.omega.astype(np.float32)
    sd = super_sp.density.astype(np.float32)
    pad = max_super - len(so)
    if pad > 0:
        so = np.concatenate([so, np.zeros(pad, bool)])
        spo = np.concatenate(
            [spo, np.tile([[0.0, 1.0, 0.0]], (pad, 1))]).astype(np.float32)
        som = np.concatenate([som, np.zeros(pad, np.float32)])
        sd = np.concatenate([sd, np.full(pad, 2.7, np.float32)])
    return tuple(torch.as_tensor(a, device=device) for a in (
        super_sp.plate_to_super.astype(np.int32), so, spo, som, sd))


def host_setup(params: GenerationParams, device, timer: StageTimer,
               prog: Callable) -> PlanetSetup:
    """The host prologue: mesh, coarse tectonics, super plates, hotspot
    domes, noise tables — and their upload to ``device``."""
    seed = params.seed
    prog(0, "Shaping the world…")
    with timer.stage("Sphere mesh + upload", sync=True):
        graph = build_sphere(params.n_cells, params.jitter,
                             rng=ParkMiller(seed))
        g = to_device(graph, device)

    prog(10, "Generating coarse plates…")
    with timer.stage("Coarse plates"):
        coarse = generate_coarse_plates(
            seed, params.n_plates, params.num_continents,
            params.continent_size_variety, params.land_coverage)
    plates = coarse.plates
    for i in params.toggled_indices:
        if i < plates.num_plates:
            plates.is_ocean[i] = not plates.is_ocean[i]
    assign_plate_densities(plates)

    super_sp = None
    if params.n_plates >= 8:
        with timer.stage("Super plates"):
            super_sp = build_super_plates(coarse.graph, coarse.r_plate,
                                          plates)

    with timer.stage("Hotspot domes + noise tables", sync=True):
        def plate_of(center: int) -> int:
            return int(project_points_host(
                coarse, seed, params.n_plates, graph.pos[center])[0])

        domes_np = build_domes(seed, graph.pos, plate_of, plates.pole,
                               plates.omega, plates.is_ocean, graph.n_cells)
        domes = {k: torch.as_tensor(v, device=device)
                 for k, v in domes_np.items()}
        noise_pack = elevation_tables(seed, device)
        warp_t = tables(seed + 9999, device)
        climate_t = tables(seed, device)
        projection = projection_inputs(coarse, seed, params.n_plates, device)

    return PlanetSetup(
        params=params, graph=graph, g=g, coarse=coarse, plates=plates,
        super_sp=super_sp, domes=domes, noise_pack=noise_pack, warp_t=warp_t,
        climate_t=climate_t, projection=projection,
        plate_arrays=plate_arrays(plates, device),
        super_arrays=super_arrays(super_sp, device))


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "PlanetEngine runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain-torch path explicitly")
    return dev


class PlanetEngine:
    """Generates planets on ``device`` (default ``"cuda"``; there is no
    silent fallback to the CPU — pass ``device="cpu"`` to ask for it)."""

    def __init__(self, device=None):
        self.device = _resolve_device(device)

    def generate(self, params: GenerationParams,
                 on_progress: Optional[Callable] = None) -> PlanetResult:
        """The reference generate (js/planet-worker.js:136-339)."""
        skip_climate = params.skip_climate
        if skip_climate is None:
            skip_climate = params.n_cells > AUTO_CLIMATE_THRESHOLD
        if params.glacial_erosion > 0:
            raise NotImplementedError(
                "glacial erosion is not ported yet (ROADMAP queue 1, item 6)")

        timer = StageTimer(sync_enabled=self.device.type == "cuda")
        prog = on_progress or (lambda pct, label: None)
        s = host_setup(params, self.device, timer, prog)
        g = s.g
        p_ocean, p_pole, p_omega, p_dens = s.plate_arrays

        prog(20, "Projecting plates…")
        with timer.stage("Project plates", sync=True):
            perm, pm12, amp, bins_idx, bins_mask, bins_pts, cplate = \
                s.projection
            r_plate = project_kernel(
                g.pos, perm, pm12, amp, bins_idx, bins_mask, bins_pts,
                cplate, s.coarse.bins.n_lat, s.coarse.bins.n_lon)

        prog(25, "Smoothing boundaries…")
        with timer.stage("Smooth + reconnect plates", sync=True):
            r_plate = smooth_and_reconnect(g, r_plate, s.plates.num_plates)

        prog(35, "Raising mountains…")
        with timer.stage("Elevation", sync=True):
            kw = {}
            if s.super_arrays is not None:
                pts, so, spo, som, sd = s.super_arrays
                kw = dict(r_super_plate=pts[r_plate.long()],
                          super_is_ocean=so, super_pole=spo,
                          super_omega=som, super_density=sd)
            elev_res = assign_elevation(
                g, r_plate, p_ocean, p_pole, p_omega, p_dens,
                seed=params.seed, noise_mag=params.roughness,
                spread=params.spread, noise_pack=s.noise_pack,
                domes=s.domes, **kw)

        prog(60, "Eroding terrain…")
        with timer.stage("Terrain post-processing", sync=True):
            elevation, erosion_delta = run_post_processing(
                g, elev_res.elevation, params.seed,
                dataclasses.asdict(params),
                hotspot=elev_res.debug.get("hotspot"),
                avg_edge=math.pi / math.sqrt(g.n_cells), warp_t=s.warp_t)

        with timer.stage("Triangle elevations", sync=True):
            tris = torch.as_tensor(s.graph.triangles.astype(np.int64),
                                   device=self.device)
            t_elev = elevation[tris].mean(dim=1)

        debug = dict(elev_res.debug)
        debug["erosionDelta"] = erosion_delta
        climate = None
        if not skip_climate:
            prog(80, "Simulating climate…")
            climate = climate_stack(g, elevation, p_ocean, r_plate,
                                    s.climate_t, params, timer, debug)
        return PlanetResult(
            graph=s.graph, params=params, r_plate=r_plate,
            plate_seeds=s.plates.seeds, plate_is_ocean=s.plates.is_ocean,
            plate_density=s.plates.density,
            pre_post_elevation=elev_res.elevation, elevation=elevation,
            t_elevation=t_elev, stress=elev_res.stress,
            mountain_mask=elev_res.mountain,
            coastline_mask=elev_res.coastline,
            ocean_seed_mask=elev_res.ocean_seeds,
            climate=climate, debug=debug, timing=timer)


def climate_stack(g: DeviceGraph, elevation, plate_is_ocean, r_plate,
                  climate_t, params: GenerationParams, timer: StageTimer,
                  debug: Dict) -> Dict:
    """Wind → ocean → precipitation → temperature → Köppen on the final
    elevation, after the merged 5-field coast BFS (the JAX package's
    pipeline/fused.py ``_climate_stack``). Returns the climate dict and
    adds the climate debug layers to ``debug``."""
    with timer.stage("Climate: coast fields", sync=True):
        d5, aux = climate_coast_fields(g, elevation, plate_is_ocean, r_plate)
    with timer.stage("Climate: wind", sync=True):
        wind = compute_wind(g, elevation, plate_is_ocean, r_plate, climate_t,
                            coast_d=d5[:, :2], gf=aux["gf"],
                            is_land=aux["is_land"],
                            plate_land=aux["plate_land"], timer=timer)
    with timer.stage("Climate: ocean currents", sync=True):
        ocean = compute_ocean_currents(g, elevation, wind, coast_d=d5[:, 2:])
    with timer.stage("Climate: precipitation", sync=True):
        precip = compute_precipitation(g, elevation, wind, ocean,
                                       params.precipitation_offset,
                                       params.land_coverage)
    with timer.stage("Climate: temperature", sync=True):
        temp = compute_temperature(g, elevation, wind, ocean, precip,
                                   params.temperature_offset)
    with timer.stage("Climate: Köppen", sync=True):
        koppen = classify_koppen(
            elevation, temp["r_temperature_summer"],
            temp["r_temperature_winter"], precip["r_precip_summer"],
            precip["r_precip_winter"])
    debug.update(
        pressureSummer=wind["r_pressure_summer"],
        pressureWinter=wind["r_pressure_winter"],
        windSpeedSummer=wind["r_wind_speed_summer"],
        windSpeedWinter=wind["r_wind_speed_winter"],
        continentality=wind["r_continentality"],
        precipSummer=precip["r_precip_summer"],
        precipWinter=precip["r_precip_winter"],
        rainShadowSummer=precip["r_rainshadow_summer"],
        rainShadowWinter=precip["r_rainshadow_winter"],
        tempSummer=temp["r_temperature_summer"],
        tempWinter=temp["r_temperature_winter"],
        koppen=koppen,
    )
    return dict(wind=wind, ocean=ocean, precip=precip, temp=temp,
                koppen=koppen)
