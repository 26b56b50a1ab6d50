"""Terrain domain warp — tangent-frame FBM displacement with a banded
nearest-cell search.

Re-design of reference warpTerrain (js/terrain-post.js:233-309). Every
cell carries its best "source cell" candidate (index + position); each
sweep it adopts any neighbour's candidate that lies strictly closer to its
own warped target point, then the remainder edges' two-phase pick. After
k sweeps cell i has considered every cell within k hops, so ``max_steps``
sweeps find the nearest cell in the displacement ball; one final gather
fetches the warped elevation. The whole loop is one launch of the warp
relax kernel (ops/sweep_cuda.py ``warp_relax``), which stops at the first
sweep that changes nothing, with no host sync.

The sweeps are synchronous. The JAX jnp loop (``_warp_terrain_jnp``)
updates band by band within a step, so a later band sees the earlier
bands' adoptions; the two reach the same nearest candidates except where
two candidates sit at nearly equal distance, the ties the JAX package
itself resolves by schedule on its TPU path.
"""

from __future__ import annotations

import torch

from ..ops import sweep_cuda
from ..ops.banded import pack_band_bits, rem_csr
from ..ops.noise import Tables, fbm
from ..parallel import spmd


def warp_targets(pos, noise_t: Tables, strength):
    """Tangent-frame FBM displacement targets w [N,3]
    (js/terrain-post.js:249-289)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    freq, octaves = 4.0, 5
    max_amp = 0.12 * strength

    # tangent frame (east/north), poles fall back to x
    ex, ez = -z, x
    elen = torch.sqrt(ex * ex + ez * ez)
    ok = elen > 1e-10
    ex = torch.where(ok, ex / torch.clamp(elen, min=1e-20), 1.0)
    ez = torch.where(ok, ez / torch.clamp(elen, min=1e-20), 0.0)
    nx = y * ez
    ny = z * ex - x * ez
    nz = -y * ex
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    nlen = torch.where(nlen == 0, 1.0, nlen)
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen

    d1 = fbm(noise_t, x * freq, y * freq, z * freq, octaves) * max_amp
    d2 = fbm(noise_t, x * freq + 31.7, y * freq + 47.3, z * freq + 19.1,
             octaves) * max_amp

    wx = x + ex * d1 + nx * d2
    wy = y * 1.0 + ny * d2        # ey = 0
    wz = z + ez * d1 + nz * d2
    wl = torch.sqrt(wx * wx + wy * wy + wz * wz)
    wl = torch.where(wl == 0, 1.0, wl)
    return torch.stack([wx / wl, wy / wl, wz / wl], dim=1)


def warp_merge(elev, warped, valid, strength, hotspot):
    """Weighted-max merge, damped near hotspots (js/terrain-post.js:291-308)."""
    warp_bias = 0.25 + 0.5 * strength
    hot_frac = torch.clamp(
        torch.abs(hotspot) / torch.clamp(torch.abs(elev), min=1e-20), max=1.0)
    bias = warp_bias * (1.0 - 0.8 * hot_frac)
    merged = torch.where(
        warped > elev,
        elev + (warped - elev) * bias,
        warped + (elev - warped) * (1.0 - bias))
    return torch.where(valid, merged, elev).to(torch.float32)


def warp_sources(pos, w, band_off, band_mask, rem_src, rem_dst,
                 max_steps: int):
    """Nearest-candidate propagation: [N] f32 index of each cell's source
    cell after at most ``max_steps`` sweeps (fewer when a sweep changes
    nothing)."""
    n = pos.shape[0]
    state = torch.cat([spmd.arange(n, torch.float32, pos.device)[None],
                       pos.T]).contiguous()                      # [4, N]
    wt = w.T.contiguous()                                        # [3, N]
    bits = pack_band_bits(band_mask)
    ptr, nbr = rem_csr(rem_src, rem_dst, n)
    state, _ = spmd.launch("warp_relax", sweep_cuda.warp_relax, state, wt,
                           bits, band_off, ptr, nbr, max_steps)
    return state[0]


def source_elevation(elev, src_idx):
    """``elev`` at each cell's source cell (a global index that may lie
    anywhere: a cells split runs this on gathered arrays)."""
    n = elev.shape[0]
    return elev[torch.clamp(src_idx, 0, n - 1).to(torch.int64)]


def warp_terrain(elev, pos, valid, band_off, band_mask, rem_src, rem_dst,
                 noise_t: Tables, strength, hotspot, max_steps: int):
    w = warp_targets(pos, noise_t, strength)
    src_idx = warp_sources(pos, w, band_off, band_mask, rem_src, rem_dst,
                           max_steps)
    return warp_merge(elev, spmd.gathered(source_elevation, elev, src_idx),
                      valid, strength, hotspot)
