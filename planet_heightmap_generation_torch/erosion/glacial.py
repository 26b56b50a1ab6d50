"""Glacial erosion — latitude/elevation glaciation, ice flow, U-valley
carving, moraines, fjords.

The glacial block of erodeComposite (js/terrain-post.js:404-557,
689-706), as the JAX package re-designs it: the sequential
descending-order ice flow becomes 22 steps of pointer doubling, each
target's adds in source order, the whole loop one launch
(ops.banded.pointer_accumulate, so the card gives the CPU's bits); valley
widening and moraine deposition are taken from the receiving cell's side
over the Fibonacci roll bands, the remainder edges added in edge order
(ops.banded.rem_add).

:func:`ice_flow` and :func:`glacial_step` have two forms, with the same
bits: on CPU tensors the band loop (``*_bands``); on CUDA tensors the
stencil form (``*_stencil``), whose neighbour passes are one launch each
of ops/sweep_cuda.py ``ice_argmin`` and ``glacial_stencil``, with the ice
flow's pointer-doubling launch and the four ``pow`` terms between them.
``strength`` and ``g_scale`` are float32 scalar tensors or Python numbers;
on the card numbers, which the kernel takes as arguments (a tensor there
is a host read).
"""

from __future__ import annotations

import math

import torch

from ..ops import sweep_cuda
from ..ops.banded import (banded_sum, band_shift, banded_select,
                          band_off_tensor, f32_mul, host_f32,
                          pointer_accumulate, rem_add, rem_gather,
                          stencil_graph)
from ..parallel import spmd

G_FLOW_THRESHOLD = 0.1
G_FJORD_THRESHOLD = 0.5
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
    if sweep_cuda.on_card(elev):
        return _ice_flow_stencil(elev, ~land, None, glac_idx, band_off,
                                 band_mask, rem_src, rem_dst)[:2]
    return ice_flow_bands(elev, land, glac_idx, band_off, band_mask,
                          rem_src, rem_dst)


def _ice_flow_stencil(elev, ocean, valid, glac_idx, band_off, band_mask,
                      rem_src, rem_dst):
    """:func:`ice_flow` over the land ``valid & ~ocean`` (``valid`` None:
    every cell) with one argmin launch; also returns the window's global
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


def ice_flow_bands(elev, land, glac_idx, band_off, band_mask, rem_src,
                   rem_dst):
    """:func:`ice_flow` as the band loop."""
    n = spmd.total(band_mask.shape[0])
    dev = elev.device
    idx_f = spmd.arange(band_mask.shape[0], torch.float32, dev)
    band_idx = idx_f[:, None] + band_off_tensor(band_off, dev)[None, :]
    min_elev, _, (tgt_f,) = banded_select(
        elev, [], band_off, band_mask, rem_src, rem_dst, minimize=True,
        edge_payloads=[band_idx],
        rem_edge_payloads=[spmd.global_index(rem_dst).to(torch.float32)])
    best_drop = elev - min_elev
    has_target = (land & (glac_idx > 0) & (best_drop > 0)
                  & torch.isfinite(min_elev))
    ice_target = torch.where(has_target, tgt_f, -1.0).to(torch.int32)

    p = torch.where(has_target, torch.clamp(ice_target, 0, n - 1),
                    n).to(torch.int64)
    s = pointer_accumulate(glac_idx.to(torch.float32).contiguous(), p,
                           ICE_FLOW_STEPS, stop_at_sink=False)
    return ice_target, s


def glacial_step(elev, is_ocean, valid, band_off, band_mask, band_dist,
                 rem_src, rem_dst, rem_dist, glac_idx, strength, g_scale):
    """One glacial iteration (the JAX ``glacial_step``). ``strength`` and
    ``g_scale`` = 1/gIters are float32 values."""
    form = (glacial_step_stencil if sweep_cuda.on_card(elev)
            else glacial_step_bands)
    return form(elev, is_ocean, valid, band_off, band_mask, band_dist,
                rem_src, rem_dst, rem_dist, glac_idx, strength, g_scale)


def glacial_step_stencil(elev, is_ocean, valid, band_off, band_mask,
                         band_dist, rem_src, rem_dst, rem_dist, glac_idx,
                         strength, g_scale):
    """:func:`glacial_step` as two stencil launches around the ice flow
    (their plain versions on CPU tensors): the argmin, the pointer-doubling
    flow, torch's four ``pow`` terms of the flow, then one pass for the
    widening, moraines, tributary count, ocean neighbours, delta, fjord
    carve and clamp."""
    elev, is_ocean, valid, glac_idx = (
        spmd.fresh(x) for x in (elev, is_ocean, valid, glac_idx))
    ice_target, flow, gidx = _ice_flow_stencil(
        elev, is_ocean, valid, glac_idx, band_off, band_mask, rem_src,
        rem_dst)
    bits, ptr, nbr, rd = stencil_graph(band_mask, rem_src, rem_dst, rem_dist)
    # the pow terms of the band loop, torch's own (the 0.6 and 0.3 terms
    # are read at the neighbours)
    p06, p03 = (spmd.fresh(torch.pow(flow, e)) for e in (0.6, 0.3))
    p04, p05 = (torch.pow(flow, e) for e in (0.4, 0.5))
    g = host_f32(g_scale)
    return sweep_cuda.glacial_stencil(
        elev, is_ocean, valid, glac_idx, spmd.fresh(flow),
        spmd.fresh(ice_target), gidx, p06, p03, p04, p05, bits, band_off,
        band_dist, ptr, nbr, rd, f32_mul(0.02, g), f32_mul(0.005, g),
        f32_mul(0.01, g), f32_mul(0.015, g), host_f32(strength))


def glacial_step_bands(elev, is_ocean, valid, band_off, band_mask,
                       band_dist, rem_src, rem_dst, rem_dist, glac_idx,
                       strength, g_scale):
    """:func:`glacial_step` as the band loop."""
    n = band_mask.shape[0]
    dev = elev.device
    strength, g_scale = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                         for x in (strength, g_scale))
    land = (~is_ocean) & valid
    src = rem_src
    ice_target, flow = ice_flow_bands(elev, land, glac_idx, band_off,
                                      band_mask, rem_src, rem_dst)

    carving = land & (flow > G_FLOW_THRESHOLD)
    deepening = torch.where(
        carving, 0.02 * g_scale * torch.pow(flow, 0.6) * strength, 0.0)
    delta = -deepening

    # valley widening + moraines + tributary count, one banded sweep set.
    # points_at_me[edge j→i]: ice_target[j] == i.
    cells = spmd.arange(n, torch.int32, dev)
    num_upstream = torch.zeros(n, dtype=torch.int32, device=dev)
    widen = torch.zeros(n, dtype=torch.float32, device=dev)
    deposit = torch.zeros(n, dtype=torch.float32, device=dev)
    moraine_amt = 0.005 * g_scale * torch.pow(flow, 0.3)
    flow_ok = flow > G_FLOW_THRESHOLD
    for d, off in enumerate(band_off):
        ok = band_mask[:, d]
        nb_land = band_shift(land, off)
        points_at_me = ok & (band_shift(ice_target, off) == cells)
        num_upstream = num_upstream + points_at_me.to(torch.int32)
        # widening: I receive from each carving neighbour
        slope = torch.abs(elev - band_shift(elev, off)) / torch.clamp(
            band_dist[:, d], min=1e-6)
        widen = widen + torch.where(
            ok & band_shift(carving, off) & land & nb_land,
            band_shift(deepening, off) * 0.4
            * torch.clamp(1 - slope, min=0.0), 0.0)
        # moraine deposition at termini
        dep_ok = (points_at_me & land & band_shift(flow_ok, off)
                  & (glac_idx < band_shift(glac_idx, off) * 0.3))
        deposit = deposit + torch.where(dep_ok, band_shift(moraine_amt, off),
                                        0.0)
    # remainder edges (receiver = rem_src, sender = rem_dst), in edge order
    points_r = rem_gather(ice_target, rem_dst) == spmd.global_index(src)
    num_upstream = num_upstream.index_add(0, src,
                                          points_r.to(torch.int32))
    slope_r = torch.abs(elev[src] - rem_gather(elev, rem_dst)) / torch.clamp(
        rem_dist, min=1e-6)
    widen = rem_add(widen, torch.where(
        rem_gather(carving, rem_dst) & land[src] & rem_gather(land, rem_dst),
        rem_gather(deepening, rem_dst) * 0.4
        * torch.clamp(1 - slope_r, min=0.0), 0.0),
        rem_src, rem_dst)
    dep_ok_r = (points_r & land[src] & rem_gather(flow_ok, rem_dst)
                & (glac_idx[src] < rem_gather(glac_idx, rem_dst) * 0.3))
    deposit = rem_add(deposit, torch.where(
        dep_ok_r, rem_gather(moraine_amt, rem_dst), 0.0), rem_src, rem_dst)

    delta = delta - widen
    delta = delta - torch.where(
        carving & (num_upstream >= 2),
        0.01 * g_scale * torch.pow(flow, 0.4), 0.0)
    delta = delta + deposit

    new = elev + torch.where(land, delta, 0.0)

    # fjord carve on glaciated coastal cells
    ocean_nb = banded_sum(is_ocean.to(torch.float32), band_off, band_mask,
                          rem_src, rem_dst)
    fjord = (land & (ocean_nb > 0) & (glac_idx > 0.2)
             & (flow > G_FJORD_THRESHOLD))
    new = torch.where(
        fjord,
        torch.clamp(new - 0.015 * g_scale * torch.pow(flow, 0.5), min=0.0),
        new)

    # clamp: land stays land
    new = torch.where(land, torch.clamp(new, min=0.0), new)
    return new.to(torch.float32)


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
