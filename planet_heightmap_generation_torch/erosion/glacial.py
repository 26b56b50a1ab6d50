"""Glacial erosion — latitude/elevation glaciation, ice flow, U-valley
carving, moraines, fjords.

The glacial block of erodeComposite (js/terrain-post.js:404-557,
689-706), as the JAX package re-designs it: the sequential
descending-order ice flow becomes 22 steps of pointer doubling, each
target's adds in source order, the whole loop one launch
(ops.banded.pointer_accumulate, so the card gives the CPU's bits); valley
widening and moraine deposition are taken from the receiving cell's side.

:func:`ice_flow` and :func:`glacial_step` read their neighbours through
two one-pass stencils of ops/sweep_cuda.py, ``ice_argmin`` (the lowest
neighbour) and ``glacial_stencil`` (everything after the flow), each
walking a cell's set band bits in band order, then its remainder row in
edge order, the order of the JAX package's band loop and scatter-add. On
CUDA tensors each is one kernel launch; on CPU tensors its plain version,
the same walk in torch. ``strength`` and ``g_scale`` are float32 scalar
tensors or Python numbers; on the card numbers, which the kernel takes as
arguments (a tensor there is a host read). :func:`glacial_post_smooth`
runs after the loop over the bands (ops.banded.banded_sum).
"""

from __future__ import annotations

import math

import torch

from ..ops import sweep_cuda
from ..ops.banded import (banded_sum, f32_mul, host_f32, pointer_accumulate,
                          stencil_graph)
from ..parallel import spmd

# pointer-doubling steps of the ice flow (a fixed count, as in the JAX
# package: ice paths are short, and the sink absorbs every finished path;
# the rounds after every path has ended change nothing and are not run)
ICE_FLOW_STEPS = 22


def _smoothstep(x, e0, e1):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def glaciation_index(pos, elev, is_ocean, valid, strength):
    """Latitude/elevation glaciation index (js/terrain-post.js:416-427).
    The reference reads r_xyz[3r+1] (its y axis) as the pole axis.
    ``strength`` is a float32 scalar tensor."""
    y = pos[:, 1]
    polar = torch.abs(torch.asin(torch.clamp(y, -1.0, 1.0)))
    threshold_lat = math.pi / 2 - strength * math.pi / 4.5
    lat_factor = _smoothstep(polar, threshold_lat, math.pi / 2)
    elev_factor = _smoothstep(elev, 0.5, 0.9)
    lat_scale = _smoothstep(polar, math.pi / 8, math.pi / 3)
    g = torch.maximum(lat_factor,
                      elev_factor * 0.3 * (0.3 + 0.7 * lat_scale))
    return torch.where((~is_ocean) & valid, g * strength,
                       0.0).to(torch.float32)


def ice_flow(elev, land, glac_idx, band_off, band_mask, rem_src, rem_dst):
    """(ice_target [N] int32, -1 where none; ice flow [N] f32): each
    glaciated land cell drains to its lowest neighbour when that is
    strictly lower (banded argmin, ties by band order), and the flow is
    ``glac_idx`` accumulated downstream by ``ICE_FLOW_STEPS`` pointer
    doublings into a virtual sink that is never summed."""
    return _ice_flow(elev, ~land, None, glac_idx, band_off, band_mask,
                     rem_src, rem_dst)[:2]


def _ice_flow(elev, ocean, valid, glac_idx, band_off, band_mask, rem_src,
              rem_dst):
    """:func:`ice_flow` over the land ``valid & ~ocean`` (``valid`` None:
    every cell) with one argmin stencil; also returns the window's global
    indices (None off a split)."""
    npad = band_mask.shape[0]
    bits, ptr, nbr, _ = stencil_graph(band_mask, rem_src, rem_dst)
    gidx = spmd.window_index(npad, elev.device)
    ice_target, p = sweep_cuda.ice_argmin(
        spmd.fresh(elev), ocean, valid, glac_idx, gidx, bits, band_off, ptr,
        nbr, spmd.total(npad))
    s = pointer_accumulate(glac_idx.to(torch.float32).contiguous(), p,
                           ICE_FLOW_STEPS, stop_at_sink=False)
    return ice_target, s, gidx


def glacial_step(elev, is_ocean, valid, band_off, band_mask, band_dist,
                 rem_src, rem_dst, rem_dist, glac_idx, strength, g_scale):
    """One glacial iteration (the JAX ``glacial_step``), ``strength`` and
    ``g_scale`` = 1/gIters float32 values: the argmin stencil, the
    pointer-doubling flow, torch's four ``pow`` terms of the flow, then one
    stencil pass for the widening, moraines, tributary count, ocean
    neighbours, delta, fjord carve and clamp."""
    elev, is_ocean, valid, glac_idx = (
        spmd.fresh(x) for x in (elev, is_ocean, valid, glac_idx))
    ice_target, flow, gidx = _ice_flow(elev, is_ocean, valid, glac_idx,
                                       band_off, band_mask, rem_src, rem_dst)
    bits, ptr, nbr, rd = stencil_graph(band_mask, rem_src, rem_dst, rem_dist)
    # the 0.6 and 0.3 terms are read at the neighbours
    p06, p03 = (spmd.fresh(torch.pow(flow, e)) for e in (0.6, 0.3))
    p04, p05 = (torch.pow(flow, e) for e in (0.4, 0.5))
    g = host_f32(g_scale)
    return sweep_cuda.glacial_stencil(
        elev, is_ocean, valid, glac_idx, spmd.fresh(flow),
        spmd.fresh(ice_target), gidx, p06, p03, p04, p05, bits, band_off,
        band_dist, ptr, nbr, rd, f32_mul(0.02, g), f32_mul(0.005, g),
        f32_mul(0.01, g), f32_mul(0.015, g), host_f32(strength))


def glacial_post_smooth(elev, is_ocean, valid, band_off, band_mask,
                        rem_src, rem_dst, glac_idx):
    """Post-loop Laplacian blend on glaciated land
    (js/terrain-post.js:689-706)."""
    land = (~is_ocean) & valid
    c = banded_sum(land.to(torch.float32), band_off, band_mask, rem_src,
                   rem_dst)
    s = banded_sum(torch.where(land, elev, 0.0), band_off, band_mask,
                   rem_src, rem_dst)
    avg = s / torch.clamp(c, min=1)
    blended = elev + (avg - elev) * 0.3
    return torch.where(land & (glac_idx > 0) & (c > 0), blended,
                       elev).to(torch.float32)
