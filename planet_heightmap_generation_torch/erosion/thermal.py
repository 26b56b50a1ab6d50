"""Thermal (talus-angle) erosion as two one-pass stencils.

The reference (js/terrain-post.js:644-686) scatters slope-excess material
from each cell to its lower neighbours through a delta buffer. Here the
symmetric-edge form (shed = per-edge excess above the talus slope;
received = the higher neighbour's transfer times this edge's share of its
total excess) runs as two passes, each one call of its stencil in
ops/sweep_cuda.py (``thermal_shed`` / ``thermal_receive``): per cell the
set band bits in band order, then the remainder row in edge order, the
order of the JAX package's band loop and scatter-add. On CUDA tensors a
pass is one kernel launch; on CPU tensors it is the stencil's plain
version, the same walk in torch. ``band_dist`` is the [N,D] banded edge
length (ops.banded.band_nbr_dist), computed once by the composite loop.
``talus_slope`` and ``k_thermal`` are float32 scalar tensors or Python
numbers; on the card numbers, which the kernel takes as arguments (a
tensor there is a host read).
"""

from __future__ import annotations

from ..ops import sweep_cuda
from ..ops.banded import host_f32, stencil_graph
from ..parallel import spmd


def thermal_shed(elev, is_ocean, valid, band_off, band_mask, band_dist,
                 rem_src, rem_dst, rem_dist, talus_slope, k_thermal):
    """Pass 1: each cell's total slope excess over its land neighbours →
    (shed, nb_share), ``nb_share`` the share of the excess it sends across
    each edge, which pass 2 reads at the neighbours (exchanged first on a
    cells split)."""
    bits, ptr, nbr, rd = stencil_graph(band_mask, rem_src, rem_dst, rem_dist)
    return sweep_cuda.thermal_shed(
        spmd.fresh(elev), spmd.fresh(is_ocean), spmd.fresh(valid), bits,
        band_off, band_dist, ptr, nbr, rd, host_f32(talus_slope),
        host_f32(k_thermal))


def thermal_receive(elev, is_ocean, valid, band_off, band_mask, band_dist,
                    rem_src, rem_dst, rem_dist, talus_slope, shed, nb_share):
    """Pass 2: received from each higher neighbour — the neighbour's
    transfer share across this edge — less what the cell sheds."""
    bits, ptr, nbr, rd = stencil_graph(band_mask, rem_src, rem_dst, rem_dist)
    return sweep_cuda.thermal_receive(
        spmd.fresh(elev), spmd.fresh(is_ocean), spmd.fresh(valid), bits,
        band_off, band_dist, ptr, nbr, rd, host_f32(talus_slope),
        shed.contiguous(), spmd.fresh(nb_share).contiguous())


def thermal_step(elev, is_ocean, valid, band_off, band_mask, band_dist,
                 rem_src, rem_dst, rem_dist, talus_slope, k_thermal):
    """One talus step: :func:`thermal_shed`, then :func:`thermal_receive`."""
    shed, nb_share = thermal_shed(elev, is_ocean, valid, band_off, band_mask,
                                  band_dist, rem_src, rem_dst, rem_dist,
                                  talus_slope, k_thermal)
    return thermal_receive(elev, is_ocean, valid, band_off, band_mask,
                           band_dist, rem_src, rem_dst, rem_dist, talus_slope,
                           shed, nb_share)
