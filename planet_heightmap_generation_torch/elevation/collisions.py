"""Plate-boundary collision detection.

Re-design of reference findCollisions (js/elevation.js:27-122): for each
boundary cell, the best-compressing foreign neighbour is found by moving
both cells along their Euler-pole velocities for dt and comparing
distances — an argmax over the roll bands plus the remainder edges, with
boundary typing, deterministic per-plate-pair intensity hashing, and the
density-driven subduction factor (tanh ramp + FBM undulation).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..mesh.device import DeviceGraph
from ..ops.banded import band_shift, rem_gather
from ..ops.graph import gather_nbrs, mul_u32
from ..ops.noise import Tables, fbm

COLLISION_THRESHOLD = 0.75  # js/elevation.js:25
INF = float("inf")


class CollisionResult(NamedTuple):
    mountain: torch.Tensor     # [N] bool seed masks
    coastline: torch.Tensor
    ocean: torch.Tensor
    stress: torch.Tensor       # [N] f32
    subduct: torch.Tensor      # [N] f32 (0.5 default)
    btype: torch.Tensor        # [N] i32: 0 none / 1 conv. / 2 div. / 3 transform
    both_ocean: torch.Tensor   # [N] bool
    has_ocean: torch.Tensor    # [N] bool


def pair_intensity(a, b):
    """Deterministic per-plate-pair intensity 0.5–1.5 (js/elevation.js:44-53),
    uint32 arithmetic emulated in int64."""
    lo = torch.minimum(a, b).to(torch.int64)
    hi = torch.maximum(a, b).to(torch.int64)
    h = mul_u32(lo, 16807) ^ mul_u32(hi, 48271)
    h = mul_u32((h >> 16) ^ h, 0x45D9F3B)
    return 0.5 + (h % 10001).to(torch.float32) / 10000.0


def find_collisions(g: DeviceGraph, r_plate, plate_is_ocean, plate_pole,
                    plate_omega, plate_density, noise_t: Tables, dt: float,
                    undul_octaves: int = 3) -> CollisionResult:
    pos = g.pos
    n = pos.shape[0]
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    # dt is an f32 scalar, so every product with it rounds in f32
    dt = torch.tensor(dt, dtype=torch.float32, device=pos.device)
    rp = r_plate.long()

    # per-cell plate velocity v = omega * (pole x r)  (js/elevation.js:10-20)
    ox, oy, oz = (plate_pole[:, 0][rp], plate_pole[:, 1][rp],
                  plate_pole[:, 2][rp])
    omega = plate_omega[rp]
    vx = omega * (oy * pz - oz * py)
    vy = omega * (oz * px - ox * pz)
    vz = omega * (ox * py - oy * px)

    def edge_metrics(a, b):
        """comp/normal for edges a→b; a, b are (px, py, pz, vx, vy, vz)."""
        dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
        d_before = torch.sqrt(dx * dx + dy * dy + dz * dz)
        rvx, rvy, rvz = a[3] - b[3], a[4] - b[4], a[5] - b[5]
        ax, ay, az = dx + rvx * dt, dy + rvy * dt, dz + rvz * dt
        d_after = torch.sqrt(ax * ax + ay * ay + az * az)
        comp = d_before - d_after
        normal = (-(rvx * dx + rvy * dy + rvz * dz)
                  / torch.where(d_before == 0, 1.0, d_before))
        return comp, normal

    me = (px, py, pz, vx, vy, vz)
    best_comp = torch.full((n,), -INF, device=pos.device)
    best_normal = torch.zeros(n, device=pos.device)
    best_plate = r_plate
    for bd, off in enumerate(g.band_off):
        plate_j = band_shift(r_plate, off)
        foreign = g.band_mask[:, bd] & (plate_j != r_plate)
        comp, normal = edge_metrics(me, tuple(band_shift(c, off) for c in me))
        comp = torch.where(foreign, comp, -INF)
        upd = comp > best_comp
        best_comp = torch.where(upd, comp, best_comp)
        best_normal = torch.where(upd, normal, best_normal)
        best_plate = torch.where(upd, plate_j, best_plate)

    # remainder edges (pole fan, jitter outliers): two-phase scatter-max
    src, dst = g.rem_src, g.rem_dst
    plate_r = rem_gather(r_plate, dst)
    foreign_r = plate_r != r_plate[src]
    comp_r, normal_r = edge_metrics(tuple(c[src] for c in me),
                                    tuple(rem_gather(c, dst) for c in me))
    comp_r = torch.where(foreign_r, comp_r, -INF)
    w = torch.full((n,), -INF, device=pos.device).scatter_reduce(
        0, src, comp_r, "amax")
    is_win = foreign_r & (comp_r == w[src]) & torch.isfinite(comp_r)
    pick_n = torch.full((n,), -INF, device=pos.device).scatter_reduce(
        0, src, torch.where(is_win, normal_r, -INF), "amax")
    pick_p = torch.full((n,), -1.0, device=pos.device).scatter_reduce(
        0, src, torch.where(is_win, plate_r.to(torch.float32), -1.0), "amax")
    upd = w > best_comp
    best_comp = torch.where(upd, w, best_comp)
    best_normal = torch.where(upd, pick_n, best_normal)
    best_plate = torch.where(upd, pick_p.to(r_plate.dtype), best_plate)

    has = torch.isfinite(best_comp)
    best_comp = torch.where(has, best_comp, 0.0)
    collided = has & (best_comp > COLLISION_THRESHOLD * dt)

    thresh = 0.3 * dt
    btype = torch.where(best_normal > thresh, 1,
                        torch.where(best_normal < -thresh, 2, 3))
    btype = torch.where(has, btype, 0).to(torch.int32)

    bp = best_plate.long()
    stress = torch.where(
        collided, best_comp / dt * pair_intensity(r_plate, best_plate), 0.0
    ).to(torch.float32)

    dd = plate_density[rp] - plate_density[bp]
    base = 0.5 + 0.5 * torch.tanh(dd * 8.0)
    undul_strength = torch.exp(-torch.abs(dd) * 12.0)
    undul = fbm(noise_t, px * 6, py * 6, pz * 6,
                octaves=undul_octaves) * 0.4 * undul_strength
    subduct = torch.where(has, torch.clamp(base + undul, 0.0, 1.0),
                          0.5).to(torch.float32)

    r_oc = plate_is_ocean[rp]
    n_oc = plate_is_ocean[bp]
    both_ocean = has & r_oc & n_oc
    has_ocean = has & (r_oc | n_oc)

    # seed routing (js/elevation.js:109-118)
    oo = r_oc & n_oc
    cc = (~r_oc) & (~n_oc)
    mountain = has & ((cc & collided & (subduct < 0.55))
                      | ((~oo) & (~cc) & collided))
    coastline = has & ((oo & collided)
                       | (cc & collided & (subduct >= 0.55))
                       | ((~oo) & (~cc) & (~collided)))
    ocean = has & oo & (~collided)
    return CollisionResult(
        mountain=mountain, coastline=coastline, ocean=ocean,
        stress=stress, subduct=subduct, btype=btype,
        both_ocean=both_ocean, has_ocean=has_ocean)


def propagate_stress_multi(stress, subduct, same, ocean_cell, nbr_idx,
                           decay, subduct_decay, num_passes: int):
    """G independent gather-form stress propagations in one sweep loop
    (the JAX ``propagate_stress_multi``, the oracle of the banded stress
    loop): per sweep every layer packs its propagated stress, sendability
    and subduct factor into one [N, 3G] neighbour gather; each cell takes
    its first strongest sendable same-plate neighbour and adopts it where
    it beats its own stress, the subduct factor riding along; until no
    layer changed or ``num_passes`` sweeps ran. stress / subduct /
    ocean_cell [N, G]; same [N, K, G] same-plate edge masks. Returns
    (stress, subduct) [N, G] f32."""
    active = stress > 0.01
    st = stress.to(torch.float32)
    sf = subduct.to(torch.float32)
    g = st.shape[1]
    i, changed = 0, True
    while changed and i < int(num_passes):
        prop = st * torch.where(sf > 0.5, subduct_decay, decay)
        sendable = active & (~ocean_cell) & (prop >= 0.005)
        gp = gather_nbrs(torch.cat([prop, sendable.to(torch.float32), sf], 1),
                         nbr_idx)                                # [N,K,3G]
        cand = torch.where(same & (gp[:, :, g:2 * g] > 0.5), gp[:, :, :g],
                           -INF)
        best = torch.argmax(cand, dim=1, keepdim=True)            # [N,1,G]
        best_val = torch.gather(cand, 1, best)[:, 0, :]
        src_sf = torch.gather(gp[:, :, 2 * g:], 1, best)[:, 0, :]
        upd = best_val > st
        st = torch.where(upd, best_val, st)
        sf = torch.where(upd, src_sf, sf)
        active = active | upd
        i += 1
        changed = bool(upd.any())
    return st, sf


def propagate_stress(stress, subduct, r_plate, plate_is_ocean, nbr_idx,
                     nbr_mask, decay, subduct_decay, num_passes: int):
    """Frontier stress diffusion inward through the same plate
    (js/elevation.js:127-159) as synchronous gather-form max-relaxation
    sweeps (the JAX ``propagate_stress``): each cell takes the strongest
    propagated stress among its same-plate neighbours (a source decays by
    ``subduct_decay`` when its subduct factor > 0.5, else by ``decay``;
    nothing below 0.005 and nothing from ocean-plate cells propagates),
    the subduct factor riding along, until a sweep changes nothing or
    ``num_passes`` sweeps ran. Returns (stress, subduct) [N] f32."""
    rp = r_plate.long()
    ocean_cell = plate_is_ocean[rp]
    same = (gather_nbrs(r_plate, nbr_idx) == r_plate[:, None]) & nbr_mask
    active = stress > 0.01
    st = stress.to(torch.float32)
    sf = subduct.to(torch.float32)
    i, changed = 0, True
    while changed and i < int(num_passes):
        prop = st * torch.where(sf > 0.5, subduct_decay, decay)
        sendable = active & (~ocean_cell) & (prop >= 0.005)
        cand = torch.where(same & gather_nbrs(sendable, nbr_idx),
                           gather_nbrs(prop, nbr_idx), -INF)
        best = torch.argmax(cand, dim=1, keepdim=True)
        best_val = torch.gather(cand, 1, best)[:, 0]
        src = torch.gather(nbr_idx, 1, best)[:, 0]
        upd = best_val > st
        st = torch.where(upd, best_val, st)
        sf = torch.where(upd, sf[src], sf)
        active = active | upd
        i += 1
        changed = bool(upd.any())
    return st, sf
