"""Thermal (talus-angle) erosion over the roll bands.

The reference (js/terrain-post.js:644-686) scatters slope-excess material
from each cell to its lower neighbours through a delta buffer. Here the
symmetric-edge form (shed = per-edge excess above the talus slope;
received = the higher neighbour's transfer times this edge's share of its
total excess) runs over the Fibonacci roll bands; the remainder edges add
in edge order (ops.banded.rem_add), as the jnp scatter-add does.
``band_dist`` is the [N,D] banded edge length (ops.banded.band_nbr_dist),
computed once by the composite loop.

Each pass has two forms, with the same bits: on CPU tensors the band loop
(``*_bands``: a few torch ops per band); on CUDA tensors one launch of
its stencil kernel (``*_stencil``: ops/sweep_cuda.py ``thermal_shed`` /
``thermal_receive``, every band and remainder edge of a cell in one
thread). ``talus_slope`` and ``k_thermal`` are float32 scalar tensors or
Python numbers; on the card a number, which the kernel takes as an
argument (a tensor there is a host read).
"""

from __future__ import annotations

import torch

from ..ops import sweep_cuda
from ..ops.banded import (band_shift, host_f32, rem_add, rem_gather,
                          stencil_graph)
from ..parallel import spmd


def _edge_excess(h_me, h_nb, d, ok, talus_slope):
    """Per-edge slope excess above the talus slope (land→land edges)."""
    dd = torch.clamp(d, min=1e-6)
    slope = (h_me - h_nb) / dd
    return torch.where(ok & (slope > talus_slope),
                       (slope - talus_slope) * dd, 0.0)


def _scalar(x, like):
    """A slider constant as a float32 scalar tensor on ``like``'s device
    (a tensor passes as it is)."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def thermal_shed(elev, is_ocean, valid, band_off, band_mask, band_dist,
                 rem_src, rem_dst, rem_dist, talus_slope, k_thermal):
    """Pass 1: each cell's total slope excess over its land neighbours →
    (shed, nb_share), ``nb_share`` the share of the excess it sends across
    each edge, which pass 2 reads at the neighbours. A cells split
    exchanges ``nb_share`` between the passes (parallel/sharding.py)."""
    form = (thermal_shed_stencil if sweep_cuda.on_card(elev)
            else thermal_shed_bands)
    return form(elev, is_ocean, valid, band_off, band_mask, band_dist,
                rem_src, rem_dst, rem_dist, talus_slope, k_thermal)


def thermal_shed_stencil(elev, is_ocean, valid, band_off, band_mask,
                         band_dist, rem_src, rem_dst, rem_dist, talus_slope,
                         k_thermal):
    """:func:`thermal_shed` in one launch of its stencil kernel (its plain
    version on CPU tensors)."""
    bits, ptr, nbr, rd = stencil_graph(band_mask, rem_src, rem_dst, rem_dist)
    return sweep_cuda.thermal_shed(
        spmd.fresh(elev), spmd.fresh(is_ocean), spmd.fresh(valid), bits,
        band_off, band_dist, ptr, nbr, rd, host_f32(talus_slope),
        host_f32(k_thermal))


def thermal_shed_bands(elev, is_ocean, valid, band_off, band_mask,
                       band_dist, rem_src, rem_dst, rem_dist, talus_slope,
                       k_thermal):
    """:func:`thermal_shed` as the band loop."""
    talus_slope = _scalar(talus_slope, elev)
    k_thermal = _scalar(k_thermal, elev)
    n = band_mask.shape[0]
    land = (~is_ocean) & valid
    total_excess = torch.zeros(n, device=elev.device)
    for d, off in enumerate(band_off):
        ok = band_mask[:, d] & land & band_shift(land, off)
        total_excess = total_excess + _edge_excess(
            elev, band_shift(elev, off), band_dist[:, d], ok, talus_slope)
    ok_r = land[rem_src] & rem_gather(land, rem_dst)
    total_excess = rem_add(
        total_excess, _edge_excess(elev[rem_src], rem_gather(elev, rem_dst),
                                   rem_dist, ok_r, talus_slope),
        rem_src, rem_dst)

    transfer = k_thermal * total_excess * 0.5
    shed = torch.where(total_excess > 0, transfer, 0.0)
    nb_share = torch.where(
        total_excess > 0,
        transfer / torch.clamp(total_excess, min=1e-20), 0.0)
    return shed, nb_share


def thermal_receive(elev, is_ocean, valid, band_off, band_mask, band_dist,
                    rem_src, rem_dst, rem_dist, talus_slope, shed, nb_share):
    """Pass 2: received from each higher neighbour — the neighbour's
    transfer share across this edge — less what the cell sheds."""
    form = (thermal_receive_stencil if sweep_cuda.on_card(elev)
            else thermal_receive_bands)
    return form(elev, is_ocean, valid, band_off, band_mask, band_dist,
                rem_src, rem_dst, rem_dist, talus_slope, shed, nb_share)


def thermal_receive_stencil(elev, is_ocean, valid, band_off, band_mask,
                            band_dist, rem_src, rem_dst, rem_dist,
                            talus_slope, shed, nb_share):
    """:func:`thermal_receive` in one launch of its stencil kernel (its
    plain version on CPU tensors)."""
    bits, ptr, nbr, rd = stencil_graph(band_mask, rem_src, rem_dst, rem_dist)
    return sweep_cuda.thermal_receive(
        spmd.fresh(elev), spmd.fresh(is_ocean), spmd.fresh(valid), bits,
        band_off, band_dist, ptr, nbr, rd, host_f32(talus_slope),
        shed.contiguous(), spmd.fresh(nb_share).contiguous())


def thermal_receive_bands(elev, is_ocean, valid, band_off, band_mask,
                          band_dist, rem_src, rem_dst, rem_dist, talus_slope,
                          shed, nb_share):
    """:func:`thermal_receive` as the band loop."""
    talus_slope = _scalar(talus_slope, elev)
    n = band_mask.shape[0]
    land = (~is_ocean) & valid
    recv = torch.zeros(n, device=elev.device)
    for d, off in enumerate(band_off):
        ok = band_mask[:, d] & land & band_shift(land, off)
        excess_in = _edge_excess(band_shift(elev, off), elev,
                                 band_dist[:, d], ok, talus_slope)
        recv = recv + excess_in * band_shift(nb_share, off)
    # remainder: every directed edge appears exactly once across bands +
    # remainder, so one (src ← dst) pass covers all remaining flow
    ok_r = land[rem_src] & rem_gather(land, rem_dst)
    excess_in_r = _edge_excess(rem_gather(elev, rem_dst), elev[rem_src],
                               rem_dist, ok_r, talus_slope)
    recv = rem_add(recv, excess_in_r * rem_gather(nb_share, rem_dst),
                   rem_src, rem_dst)

    out = elev + torch.where(land, recv - shed, 0.0)
    return out.to(torch.float32)


def thermal_step(elev, is_ocean, valid, band_off, band_mask, band_dist,
                 rem_src, rem_dst, rem_dist, talus_slope, k_thermal):
    """One talus step: :func:`thermal_shed`, then :func:`thermal_receive`."""
    shed, nb_share = thermal_shed(elev, is_ocean, valid, band_off, band_mask,
                                  band_dist, rem_src, rem_dst, rem_dist,
                                  talus_slope, k_thermal)
    return thermal_receive(elev, is_ocean, valid, band_off, band_mask,
                           band_dist, rem_src, rem_dst, rem_dist, talus_slope,
                           shed, nb_share)
