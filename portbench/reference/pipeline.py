"""The reference engine: ``generate`` and ``reapply`` as the JAX
package's engine runs them on its staged path (``PlanetEngine._generate``
and ``reapply`` with ``timing=True``, ``pipeline/engine.py``), with the
retained state that ``reapply`` reads.

``lowp=True`` is the benchmark's lower-precision control: the float32
fields the stages hand on (the cell positions the plate projection
reads, the elevation after the elevation stage and after
post-processing, the precipitation and temperature fields) are stored
in bfloat16, as a program that kept them in bfloat16 would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from .config import GenerationParams, AUTO_CLIMATE_THRESHOLD
from .backend import bfloat16, jax, jnp
from .mesh.build import build_sphere
from .mesh.device import to_device
from .ops.rng import ParkMiller
from .ops.noise import tables
from .ops.graph import majority_smooth
from .ops.banded import connected_components_gated, flood_assign_banded
from .tectonics import (generate_coarse_plates, project_coarse_plates,
                        build_super_plates)
from .tectonics.coarse import assign_plate_densities
from .elevation import assign_elevation
from .erosion import run_post_processing
from .climate import (compute_wind, compute_ocean_currents,
                      compute_precipitation, compute_temperature,
                      classify_koppen)

MAX_SUPER = 32


def smooth_and_reconnect(g, r_plate, num_p: int, num_passes: int = 3):
    """The JAX engine's ``_smooth_and_reconnect_device``: majority
    smoothing, then every plate keeps its largest connected piece (ties
    toward the smallest label) and the other pieces are flood-assigned."""
    protect = jnp.zeros(g.n_padded, bool)
    r_plate = majority_smooth(r_plate, g.nbr_idx, g.nbr_mask, protect,
                              num_passes=num_passes)
    labels = connected_components_gated(r_plate, *g.bands)
    n = g.n_padded
    sizes = jax.ops.segment_sum(
        g.valid.astype(jnp.int32), labels, num_segments=n)
    comp_size = sizes[labels]
    max_per_plate = jax.ops.segment_max(
        jnp.where(g.valid, comp_size, 0), r_plate, num_segments=num_p)
    is_max = comp_size == max_per_plate[r_plate]
    min_tied = jax.ops.segment_min(
        jnp.where(is_max & g.valid, labels, n), r_plate, num_segments=num_p)
    in_main = is_max & (labels == min_tied[r_plate]) & g.valid
    val, _ = flood_assign_banded(r_plate, in_main, *g.bands)
    return jnp.where(g.valid, val, r_plate).astype(jnp.int32)


def _host_prologue(graph, coarse, plates, seed: int, num_plates: int):
    """The JAX engine's ``_host_prologue``: hotspot domes, the elevation
    noise tables and the warp tables."""
    from .elevation.assemble import elevation_tables
    from .elevation.hotspots import build_domes
    from .tectonics.coarse import project_points_host

    def plate_of(center: int) -> int:
        return int(project_points_host(
            coarse, seed, num_plates, graph.pos[center])[0])

    domes_np = build_domes(seed, graph.pos, plate_of, plates.pole,
                           plates.omega, plates.is_ocean, graph.n_cells)
    domes = {k: jnp.asarray(v) for k, v in domes_np.items()}
    return domes, elevation_tables(seed), tables(seed + 9999)


def _super_arrays(super_sp):
    """The JAX engine's ``_super_device_arrays``, padded to ``MAX_SUPER``."""
    if super_sp is None:
        return None
    so = super_sp.is_ocean
    spo = super_sp.pole.astype(np.float32)
    som = super_sp.omega.astype(np.float32)
    sd = super_sp.density.astype(np.float32)
    if len(so) < MAX_SUPER:
        pad = MAX_SUPER - len(so)
        so = np.concatenate([so, np.zeros(pad, bool)])
        spo = np.concatenate(
            [spo, np.tile([[0.0, 1.0, 0.0]], (pad, 1))]).astype(np.float32)
        som = np.concatenate([som, np.zeros(pad, np.float32)])
        sd = np.concatenate([sd, np.full(pad, 2.7, np.float32)])
    return (jnp.asarray(super_sp.plate_to_super.astype(np.int32)),
            jnp.asarray(so), jnp.asarray(spo), jnp.asarray(som),
            jnp.asarray(sd))


def _skip_climate(params: GenerationParams) -> bool:
    if params.skip_climate is None:
        return params.n_cells > AUTO_CLIMATE_THRESHOLD
    return params.skip_climate


class ReferenceEngine:
    """The planet of one ``GenerationParams`` stage by stage: ``plates``
    (the projection and smoothing of the coarse plates onto the mesh),
    ``elevation``, ``post`` (post-processing at the params' sliders) and
    ``climate``. Each stage takes its inputs as arguments, so a stage can
    run on another program's products; ``generate`` and ``reapply`` run
    the chain on the reference's own. Arrays are NumPy's."""

    def __init__(self, params: GenerationParams, lowp: bool = False):
        """The host prologue of the JAX engine's ``host_setup``: mesh,
        coarse plates, super plates, hotspot domes and noise tables."""
        self.params, self.lowp = params, bool(lowp)
        seed = params.seed
        self.graph = build_sphere(params.n_cells, params.jitter,
                                  rng=ParkMiller(seed))
        self.g = to_device(self.graph)
        self.coarse = generate_coarse_plates(
            seed, params.n_plates, params.num_continents,
            params.continent_size_variety, params.land_coverage)
        plates = self.plates_set = self.coarse.plates
        for i in params.toggled_indices:
            if i < plates.num_plates:
                plates.is_ocean[i] = not plates.is_ocean[i]
        assign_plate_densities(plates)
        super_sp = None
        if params.n_plates >= 8:
            super_sp = build_super_plates(self.coarse.graph,
                                          self.coarse.r_plate, plates)
        self.sup = _super_arrays(super_sp)
        self.domes, self.noise_pack, self.warp_t = _host_prologue(
            self.graph, self.coarse, plates, seed, params.n_plates)
        self.p_ocean = jnp.asarray(plates.is_ocean)
        self._w: Optional[dict] = None

    def _round(self, x):
        """``x`` stored in bfloat16 where the engine is the control."""
        if self.lowp and np.asarray(x).dtype == np.float32:
            return jnp.asarray(bfloat16(np.asarray(x)))
        return x

    def plates(self):
        """The plate of each cell: the coarse plates projected onto the
        mesh, smoothed and reconnected."""
        graph = self.graph
        if self.lowp:
            graph = dataclasses.replace(graph, pos=bfloat16(graph.pos))
        r_plate = project_coarse_plates(graph, self.coarse, self.params.seed,
                                        self.params.n_plates)
        return smooth_and_reconnect(self.g, r_plate,
                                    self.plates_set.num_plates, 3)

    def elevation(self, r_plate):
        """(elevation before post-processing, hotspot uplift) from the
        plate of each cell."""
        plates, sup = self.plates_set, self.sup
        r_plate = jnp.asarray(r_plate, jnp.int32)
        kw = {}
        if sup is not None:
            kw = dict(r_super_plate=sup[0][r_plate], super_is_ocean=sup[1],
                      super_pole=sup[2], super_omega=sup[3],
                      super_density=sup[4])
        res = assign_elevation(
            self.g, r_plate, self.p_ocean,
            jnp.asarray(plates.pole.astype(np.float32)),
            jnp.asarray(plates.omega.astype(np.float32)),
            jnp.asarray(plates.density.astype(np.float32)),
            seed=self.params.seed, noise_mag=self.params.roughness,
            spread=self.params.spread, noise_pack=self.noise_pack,
            domes=self.domes, **kw)
        return self._round(res.elevation), res.debug.get("hotspot")

    def hotspot(self):
        """The hotspot uplift the elevation stage adds (it reads the
        positions and the domes only): post-processing's warp damps it."""
        from .elevation.hotspots import hotspot_uplift

        if not self.domes:
            return jnp.zeros(self.g.n_padded, jnp.float32)
        return hotspot_uplift(self.g.pos, self.domes, self.noise_pack["hs1"],
                              self.noise_pack["hs2"])

    def post(self, sliders: Optional[dict], pre_post, hotspot):
        """The elevation after post-processing at the params' sliders
        changed by ``sliders``."""
        params = self.params.replace(**(sliders or {}))
        elevation, _ = run_post_processing(
            self.g, jnp.asarray(pre_post, jnp.float32), params.seed,
            dataclasses.asdict(params), hotspot=hotspot,
            avg_edge=math.pi / math.sqrt(self.graph.n_cells),
            warp_t=self.warp_t)
        return self._round(elevation)

    def climate(self, elevation, r_plate) -> Optional[Dict]:
        """The JAX engine's ``_run_climate`` on the final elevation, or
        None where the params skip climate."""
        params = self.params
        if _skip_climate(params):
            return None
        g, elevation = self.g, jnp.asarray(elevation, jnp.float32)
        r_plate = jnp.asarray(r_plate, jnp.int32)
        wind = compute_wind(g, elevation, self.p_ocean, r_plate,
                            tables(params.seed))
        ocean = compute_ocean_currents(g, elevation, wind)
        precip = compute_precipitation(g, elevation, wind, ocean,
                                       params.precipitation_offset,
                                       params.land_coverage)
        precip = {k: self._round(v) for k, v in precip.items()}
        temp = compute_temperature(g, elevation, wind, ocean, precip,
                                   params.temperature_offset)
        temp = {k: self._round(v) for k, v in temp.items()}
        koppen = classify_koppen(
            elevation, temp["r_temperature_summer"],
            temp["r_temperature_winter"], precip["r_precip_summer"],
            precip["r_precip_winter"])
        return dict(precip=precip, temp=temp, koppen=koppen)

    def _answer(self, sliders):
        w = self._w
        elevation = self.post(sliders, w["pre_post"], w["hotspot"])
        return dict(n_cells=self.graph.n_cells, nbr_idx=self.graph.nbr_idx,
                    r_plate=w["r_plate"], pre_post=w["pre_post"],
                    elevation=elevation,
                    climate=self.climate(elevation, w["r_plate"]))

    def generate(self) -> Dict:
        """The whole chain on the reference's own products: a dict of
        ``n_cells`` (the real cells), ``nbr_idx``, ``r_plate``,
        ``pre_post``, ``elevation`` and ``climate`` (None, or ``precip``,
        ``temp`` and ``koppen``)."""
        r_plate = self.plates()
        pre_post, hotspot = self.elevation(r_plate)
        self._w = dict(r_plate=r_plate, pre_post=pre_post, hotspot=hotspot)
        return self._answer(None)

    def reapply(self, sliders: Optional[dict] = None) -> Dict:
        """Post-processing and climate again from the retained elevation,
        with the params' sliders changed by ``sliders``."""
        if self._w is None:
            raise RuntimeError("No retained state for reapply")
        return self._answer(sliders)
