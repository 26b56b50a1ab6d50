"""Composite erosion loop and the full terrain post-processing stage.

Re-design of reference erodeComposite (js/terrain-post.js:369-707) and
runPostProcessing (js/planet-worker.js:40-102): glacial → hydraulic →
thermal per iteration, with an initial priority-flood carve (0.5) before
the loop, a mid-loop re-flood (0.85) at 75% of the iterations and the
glacial Laplacian blend after it. Slider → parameter mapping matches
js/planet-worker.js:58-93.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..mesh.device import DeviceGraph
from ..ops.banded import band_nbr_dist, rem_gather
from ..parallel import spmd
from ..pipeline.timing import span
from .flood import priority_flood_carve, open_ocean_mask
from .fluvial import steepest_receivers, flow_accumulation, stream_power_solve
from .thermal import thermal_step
from .glacial import glaciation_index, glacial_step, glacial_post_smooth
from .smooth import smooth_elevation, sharpen_ridges, apply_soil_creep
from .warp import warp_terrain


def _f32(x: float, g: DeviceGraph):
    """A float32 scalar tensor: slider-derived constants are float32 in
    every product they enter, as in the JAX stage."""
    return torch.tensor(x, dtype=torch.float32, device=g.device)


def _edge_lengths(g: DeviceGraph):
    """([N,D] banded edge lengths, [M] remainder edge lengths)."""
    band_dist = band_nbr_dist(g.pos, g.band_off, g.band_mask)
    rem_dist = torch.linalg.vector_norm(
        g.pos[g.rem_src] - rem_gather(g.pos, g.rem_dst),
        dim=1).to(torch.float32)
    return band_dist, rem_dist


def mean_edge(g: DeviceGraph) -> float:
    """The mean neighbour distance of the padded gather form, in float32:
    Σ|p_j - p_i| over the masked slots / max(1, their count), as the JAX
    ``run_post_processing`` takes it (one host read)."""
    delta = g.pos[g.nbr_idx] - g.pos[:, None, :]
    dist = torch.where(g.nbr_mask, torch.sqrt(torch.sum(delta * delta, -1)),
                       0.0).to(torch.float32)
    return float(dist.sum() / torch.clamp(g.nbr_mask.sum(), min=1))


def erode_composite(g: DeviceGraph, elev, is_ocean,
                    h_iters: int, k_coeff: float, m_exp: float, dt: float,
                    t_iters: int, talus_slope: float, k_thermal: float,
                    g_iters: int = 0, glacial_strength: float = 0.0):
    """The composite loop: per iteration a glacial step while
    ``it < g_iters``, a hydraulic step while ``it < h_iters`` and a
    thermal step while ``it < t_iters``; the glacial blend after it."""
    total = max(h_iters, t_iters, g_iters)
    if total <= 0:
        return elev

    valid = g.valid
    with span("Post: edge lengths"):
        band_dist, rem_dist = _edge_lengths(g)
        land = (~is_ocean) & valid

    # the ocean mask is frozen for the whole loop → one components call
    # serves both the initial flood and the 75% re-flood
    open_ocean = None
    if h_iters > 0:
        with span("Post: open-ocean mask"):
            open_ocean = open_ocean_mask(is_ocean, valid, *g.bands)
        with span("Post: flood carve"):
            elev, _, _ = priority_flood_carve(
                elev, is_ocean, valid, *g.bands, _f32(0.5, g),
                open_ocean=open_ocean)

    # the glaciation index of the carved elevation, fixed for the loop
    glac_idx = None
    if g_iters > 0 and glacial_strength > 0:
        with span("Post: glaciation index"):
            glac_idx = glaciation_index(g.pos, elev, is_ocean, valid,
                                        _f32(glacial_strength, g))
    g_scale = 1.0 / g_iters if g_iters > 0 else 0.0

    # the slider constants, each made once per call: a float32 tensor on
    # the card is an upload, which waits for the device; the glacial and
    # thermal steps take Python numbers (kernel arguments on the card)
    if h_iters > 0:
        k_coeff_t, m_exp_t, dt_t = (_f32(x, g) for x in (k_coeff, m_exp, dt))

    def step(elev, it: int):
        if glac_idx is not None and it < g_iters:
            with span("Post: glacial step"):
                elev = glacial_step(
                    elev, is_ocean, valid, g.band_off, g.band_mask,
                    band_dist, g.rem_src, g.rem_dst, rem_dist, glac_idx,
                    glacial_strength, g_scale)
        if it < h_iters:
            with span("Post: hydraulic receivers"):
                rcv, dist, is_pit = steepest_receivers(
                    elev, is_ocean, valid, g.band_off, g.band_mask,
                    band_dist, g.rem_src, g.rem_dst, rem_dist)
            with span("Post: flow accumulation"):
                flow = flow_accumulation(land, rcv, is_pit)
            with span("Post: stream power"):
                elev = spmd.gathered(
                    stream_power_solve, elev, is_ocean, valid, rcv, dist,
                    is_pit, flow, k_coeff=k_coeff_t, m_exp=m_exp_t, dt=dt_t)
        if it < t_iters:
            with span("Post: thermal step"):
                elev = thermal_step(
                    elev, is_ocean, valid, g.band_off, g.band_mask,
                    band_dist, g.rem_src, g.rem_dst, rem_dist,
                    talus_slope, k_thermal)
        return elev

    # the mid-loop re-flood at 75% of iterations (js/terrain-post.js:444-462)
    mid = min(round(total * 0.75), total)
    for it in range(mid):
        elev = step(elev, it)
    if mid < total:
        with span("Post: re-flood"):
            elev, _, _ = priority_flood_carve(elev, is_ocean, valid,
                                              *g.bands, _f32(0.85, g),
                                              open_ocean=open_ocean)
        for it in range(mid, total):
            elev = step(elev, it)
    if glac_idx is not None:
        with span("Post: glacial post-smooth"):
            elev = glacial_post_smooth(elev, is_ocean, valid, *g.bands,
                                       glac_idx)
    return elev


def run_post_processing(g: DeviceGraph, elev, seed: int, params: dict,
                        hotspot: Optional[torch.Tensor] = None,
                        avg_edge: Optional[float] = None, warp_t=None):
    """Full post stage with the worker's slider mapping
    (js/planet-worker.js:40-102). ``params`` keys: smoothing,
    glacial_erosion, hydraulic_erosion, thermal_erosion, ridge_sharpening,
    terrain_warp. ``avg_edge`` defaults to the mesh's mean neighbour
    distance (:func:`mean_edge`; the engines pass π/√N); ``warp_t`` are
    the seed+9999 noise tables. Returns (elevation, erosion_delta)."""
    smoothing = params.get("smoothing", 0.0)
    glacial = params.get("glacial_erosion", 0.0)
    hydraulic = params.get("hydraulic_erosion", 0.0)
    thermal = params.get("thermal_erosion", 0.0)
    ridge = params.get("ridge_sharpening", 0.0)
    tw = params.get("terrain_warp", 0.0)

    if tw > 0:
        from ..ops.noise import tables
        with span("Post: warp"):
            max_amp = 0.12 * tw
            if avg_edge is None:
                avg_edge = mean_edge(g)
            max_steps = int(math.ceil(max_amp / max(avg_edge, 1e-6))) + 8
            hot = hotspot if hotspot is not None else torch.zeros_like(elev)
            elev = warp_terrain(elev, g.pos, g.valid, *g.bands,
                                noise_t=warp_t if warp_t is not None
                                else tables(seed + 9999, g.device),
                                strength=_f32(tw, g), hotspot=hot,
                                max_steps=max_steps)

    # ocean mask frozen BEFORE smoothing/erosion (js/planet-worker.js:51-54)
    is_ocean = (elev <= 0) & g.valid
    pre = elev

    if smoothing > 0:
        with span("Post: smoothing"):
            elev = smooth_elevation(elev, is_ocean, g.valid, *g.bands,
                                    round(1 + smoothing * 4),
                                    _f32(0.2 + smoothing * 0.5, g))

    if glacial > 0 or hydraulic > 0 or thermal > 0:
        elev = erode_composite(
            g, elev, is_ocean,
            h_iters=round(hydraulic * 20), k_coeff=hydraulic * 0.0006,
            m_exp=0.5, dt=1.0,
            t_iters=round(thermal * 10), talus_slope=1.2 - thermal * 0.4,
            k_thermal=thermal * 0.15,
            g_iters=round(glacial * 10), glacial_strength=glacial)

    if ridge > 0:
        with span("Post: ridge sharpening"):
            elev = sharpen_ridges(elev, is_ocean, g.valid, *g.bands,
                                  round(1 + ridge * 3), _f32(ridge * 0.08, g))

    # soil creep always applied (js/planet-worker.js:92)
    with span("Post: soil creep"):
        elev = apply_soil_creep(elev, is_ocean, g.valid, *g.bands,
                                3, _f32(0.1125, g))
    return elev, elev - pre
