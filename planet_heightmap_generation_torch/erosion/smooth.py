"""Bilateral smoothing, ridge sharpening, soil creep — banded roll sweeps.

Re-designs of reference smoothElevation (js/terrain-post.js:317-354),
sharpenRidges (:713-751) and applySoilCreep (:758-794). Each pass is D
masked shifts over the Fibonacci spiral ordering plus the remainder edges,
added in edge order (ops/banded).
"""

from __future__ import annotations

import torch

from ..ops.banded import (banded_sum, banded_count, band_shift, rem_add,
                          rem_gather)


def smooth_elevation(elev, is_ocean, valid, band_off, band_mask,
                     rem_src, rem_dst, iterations: int, strength):
    """Bilateral-weighted Laplacian: weight 1/(1+8|Δh|) preserves ridges;
    coastline cells (land with an ocean neighbour) are locked."""
    n = band_mask.shape[0]
    land = (~is_ocean) & valid
    ocean_nb = banded_sum(is_ocean.to(torch.float32), band_off, band_mask,
                          rem_src, rem_dst)
    movable = valid & (~(land & (ocean_nb > 0)))

    for _ in range(iterations):
        w_sum = torch.zeros(n, device=elev.device)
        hw = torch.zeros(n, device=elev.device)
        for d, off in enumerate(band_off):
            nh = band_shift(elev, off)
            w = torch.where(band_mask[:, d],
                            1.0 / (1.0 + torch.abs(nh - elev) * 8.0), 0.0)
            w_sum = w_sum + w
            hw = hw + nh * w
        nh_r = rem_gather(elev, rem_dst)
        w_r = 1.0 / (1.0 + torch.abs(nh_r - elev[rem_src]) * 8.0)
        w_sum = rem_add(w_sum, w_r, rem_src, rem_dst)
        hw = rem_add(hw, nh_r * w_r, rem_src, rem_dst)
        h_avg = hw / torch.clamp(w_sum, min=1e-20)
        new = elev + (h_avg - elev) * strength
        elev = torch.where(movable & (w_sum > 0), new, elev)
    return elev.to(torch.float32)


def sharpen_ridges(elev, is_ocean, valid, band_off, band_mask,
                   rem_src, rem_dst, iterations: int, strength):
    """h += (h - avgNbr)·strength when above the neighbourhood mean,
    capped at 1.5× the pre-sharpening elevation."""
    land = (~is_ocean) & valid
    original = elev
    c = banded_count(band_mask, rem_src)
    for _ in range(iterations):
        s = banded_sum(elev, band_off, band_mask, rem_src, rem_dst)
        avg = s / torch.clamp(c, min=1)
        new = elev + (elev - avg) * strength
        new = torch.minimum(new, original * 1.5)
        elev = torch.where(land & (elev > avg) & (c > 0), new, elev)
    return elev.to(torch.float32)


def apply_soil_creep(elev, is_ocean, valid, band_off, band_mask,
                     rem_src, rem_dst, iterations: int, strength):
    """Plain Laplacian diffusion on interior land (coastline locked)."""
    land = (~is_ocean) & valid
    ocean_nb = banded_sum(is_ocean.to(torch.float32), band_off, band_mask,
                          rem_src, rem_dst)
    interior = land & (ocean_nb == 0)
    c = banded_sum(land.to(torch.float32), band_off, band_mask, rem_src,
                   rem_dst)
    for _ in range(iterations):
        contrib = torch.where(land, elev, 0.0)
        s = banded_sum(contrib, band_off, band_mask, rem_src, rem_dst)
        avg = s / torch.clamp(c, min=1)
        new = elev + (avg - elev) * strength
        elev = torch.where(interior & (c > 0), new, elev)
    return elev.to(torch.float32)
