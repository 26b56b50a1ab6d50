"""Plate-boundary collision detection — fused device kernel.

Re-design of reference findCollisions (js/elevation.js:27-122): for each
boundary cell, the best-compressing foreign neighbor is found by moving both
cells along their Euler-pole velocities for dt and comparing distances. Here
the per-cell neighbor scan is one masked [N, K] reduction; boundary typing,
deterministic per-plate-pair intensity hashing, and the density-driven
subduction factor (tanh ramp + FBM undulation) are all fused into the same
pass.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

from ..backend import jax
from ..backend import jnp

from ..mesh.device import DeviceGraph
from ..ops.noise import Tables, fbm

COLLISION_THRESHOLD = 0.75  # js/elevation.js:25


class CollisionResult(NamedTuple):
    mountain: jax.Array        # [N] bool seed masks
    coastline: jax.Array
    ocean: jax.Array
    stress: jax.Array          # [N] f32
    subduct: jax.Array         # [N] f32 (0.5 default)
    btype: jax.Array           # [N] i32: 0 none / 1 convergent / 2 divergent / 3 transform
    both_ocean: jax.Array      # [N] bool
    has_ocean: jax.Array       # [N] bool


def _pair_intensity(a, b):
    """Deterministic per-plate-pair intensity 0.5–1.5 (js/elevation.js:44-53).

    Hash inputs are plate SLOTS (dense ids) rather than the reference's seed
    region ids — same distribution, different per-pair values."""
    lo = jnp.minimum(a, b).astype(jnp.uint32)
    hi = jnp.maximum(a, b).astype(jnp.uint32)
    h = (lo * jnp.uint32(16807)) ^ (hi * jnp.uint32(48271))
    h = ((h >> 16) ^ h) * jnp.uint32(0x45D9F3B)
    return 0.5 + (h % jnp.uint32(10001)).astype(jnp.float32) / 10000.0


@partial(jax.jit, static_argnames=("undul_octaves",))
def find_collisions(g: DeviceGraph, r_plate, plate_is_ocean, plate_pole,
                    plate_omega, plate_density, noise_t: Tables,
                    dt: float, undul_octaves: int = 3) -> CollisionResult:
    """Banded + component-wise: the best-compressing foreign neighbor is an
    argmax over the roll bands with [N] scalar arrays only. The former
    [N,K(,3)] intermediates tile-padded 16x on TPU (minor dim 8 -> 128
    lanes), and even a [N,3] gather result can land in a {1,0} layout that
    pads 40x — every vector here lives as three [N] components."""
    from ..ops.banded import band_shift, _rem_real

    pos = g.pos
    n = pos.shape[0]
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]

    # per-cell plate velocity v = omega * (pole x r)  (js/elevation.js:10-20)
    ox = plate_pole[:, 0][r_plate]
    oy = plate_pole[:, 1][r_plate]
    oz = plate_pole[:, 2][r_plate]
    omega = plate_omega[r_plate]
    vx = omega * (oy * pz - oz * py)
    vy = omega * (oz * px - ox * pz)
    vz = omega * (ox * py - oy * px)

    def edge_metrics(idx_a, idx_b, shift_off):
        """comp/normal for edges a→b given either a roll offset (banded,
        idx_* None) or index arrays (remainder)."""
        if shift_off is not None:
            bpx, bpy, bpz = (band_shift(px, shift_off),
                             band_shift(py, shift_off),
                             band_shift(pz, shift_off))
            bvx, bvy, bvz = (band_shift(vx, shift_off),
                             band_shift(vy, shift_off),
                             band_shift(vz, shift_off))
            apx, apy, apz, avx, avy, avz = px, py, pz, vx, vy, vz
        else:
            apx, apy, apz = px[idx_a], py[idx_a], pz[idx_a]
            avx, avy, avz = vx[idx_a], vy[idx_a], vz[idx_a]
            bpx, bpy, bpz = px[idx_b], py[idx_b], pz[idx_b]
            bvx, bvy, bvz = vx[idx_b], vy[idx_b], vz[idx_b]
        dx, dy, dz = apx - bpx, apy - bpy, apz - bpz
        d_before = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        rvx, rvy, rvz = avx - bvx, avy - bvy, avz - bvz
        ax, ay, az = dx + rvx * dt, dy + rvy * dt, dz + rvz * dt
        d_after = jnp.sqrt(ax * ax + ay * ay + az * az)
        comp = d_before - d_after
        normal = (-(rvx * dx + rvy * dy + rvz * dz)
                  / jnp.where(d_before == 0, 1.0, d_before))
        return comp, normal

    neg_inf = -jnp.inf
    best_comp = jnp.full(n, neg_inf)
    best_normal = jnp.zeros(n, jnp.float32)
    best_plate = r_plate
    for bd, off in enumerate(g.band_off):
        plate_j = band_shift(r_plate, off)
        foreign_d = g.band_mask[:, bd] & (plate_j != r_plate)
        comp, normal = edge_metrics(None, None, off)
        comp = jnp.where(foreign_d, comp, neg_inf)
        upd = comp > best_comp
        best_comp = jnp.where(upd, comp, best_comp)
        best_normal = jnp.where(upd, normal, best_normal)
        best_plate = jnp.where(upd, plate_j, best_plate)
    # remainder edges (pole fan, jitter outliers): two-phase scatter-max
    rem_src, rem_dst = g.rem_src, g.rem_dst
    src = jnp.clip(rem_src, 0, n - 1)
    real = _rem_real(rem_src, n)
    plate_r = r_plate[rem_dst]
    foreign_r = real & (plate_r != r_plate[src])
    comp_r, normal_r = edge_metrics(src, rem_dst, None)
    comp_r = jnp.where(foreign_r, comp_r, neg_inf)
    w = jnp.full(n, neg_inf).at[rem_src].max(comp_r, mode="drop")
    is_win = foreign_r & (comp_r == w[src]) & jnp.isfinite(comp_r)
    pick_n = jnp.full(n, neg_inf).at[rem_src].max(
        jnp.where(is_win, normal_r, neg_inf), mode="drop")
    pick_p = jnp.full(n, -1.0).at[rem_src].max(
        jnp.where(is_win, plate_r.astype(jnp.float32), -1.0), mode="drop")
    upd = w > best_comp
    best_comp = jnp.where(upd, w, best_comp)
    best_normal = jnp.where(upd, pick_n, best_normal)
    best_plate = jnp.where(upd, pick_p.astype(jnp.int32), best_plate)

    has = jnp.isfinite(best_comp)
    best_comp = jnp.where(has, best_comp, 0.0)
    collided = has & (best_comp > COLLISION_THRESHOLD * dt)

    thresh = 0.3 * dt
    btype = jnp.where(
        best_normal > thresh, 1, jnp.where(best_normal < -thresh, 2, 3)
    )
    btype = jnp.where(has, btype, 0).astype(jnp.int32)

    stress = jnp.where(
        collided, best_comp / dt * _pair_intensity(r_plate, best_plate), 0.0
    ).astype(jnp.float32)

    my_dens = plate_density[r_plate]
    nb_dens = plate_density[best_plate]
    dd = my_dens - nb_dens
    base = 0.5 + 0.5 * jnp.tanh(dd * 8.0)
    undul_strength = jnp.exp(-jnp.abs(dd) * 12.0)
    undul = fbm(noise_t, pos[:, 0] * 6, pos[:, 1] * 6, pos[:, 2] * 6,
                octaves=undul_octaves) * 0.4 * undul_strength
    subduct = jnp.where(
        has, jnp.clip(base + undul, 0.0, 1.0), 0.5
    ).astype(jnp.float32)

    r_oc = plate_is_ocean[r_plate]
    n_oc = plate_is_ocean[best_plate]
    both_ocean = has & r_oc & n_oc
    has_ocean = has & (r_oc | n_oc)

    # seed routing (js/elevation.js:109-118)
    oo = r_oc & n_oc
    cc = (~r_oc) & (~n_oc)
    mountain = has & (
        (cc & collided & (subduct < 0.55)) | ((~oo) & (~cc) & collided)
    )
    coastline = has & (
        (oo & collided)
        | (cc & collided & (subduct >= 0.55))
        | ((~oo) & (~cc) & (~collided))
    )
    ocean = has & oo & (~collided)

    return CollisionResult(
        mountain=mountain, coastline=coastline, ocean=ocean,
        stress=stress, subduct=subduct, btype=btype,
        both_ocean=both_ocean, has_ocean=has_ocean,
    )


@jax.jit
def propagate_stress_multi(stress, subduct, same, ocean_cell, nbr_idx,
                           decay, subduct_decay, num_passes):
    """G independent stress propagations (e.g. small + super plate layers)
    in one sweep loop. All neighbor state (propagated stress, sendability,
    subduct factor) packs into a single [N, 3G] gather per sweep — TPU
    gathers are index-bound, so this costs ~1/3G of the per-field loops.

    stress/subduct/ocean_cell: [N,G]; same: [N,K,G] same-plate edge masks.
    """
    active0 = stress > 0.01

    def cond(state):
        i, _, _, _, changed = state
        return changed & (i < num_passes)

    def body(state):
        i, stress, sf, active, _ = state
        g = stress.shape[1]
        eff = jnp.where(sf > 0.5, subduct_decay, decay)
        prop = stress * eff
        sendable = active & (~ocean_cell) & (prop >= 0.005)
        packed = jnp.concatenate(
            [prop, sendable.astype(jnp.float32), sf], axis=1)   # [N,3G]
        gp = packed[nbr_idx]                                     # [N,K,3G]
        cand = jnp.where(same & (gp[:, :, g:2 * g] > 0.5),
                         gp[:, :, :g], -jnp.inf)                 # [N,K,G]
        best = jnp.argmax(cand, axis=1)                          # [N,G]
        take = lambda a: jnp.take_along_axis(a, best[:, None, :], 1)[:, 0, :]
        best_val = take(cand)
        src_sf = take(gp[:, :, 2 * g:3 * g])
        upd = best_val > stress
        stress2 = jnp.where(upd, best_val, stress)
        sf2 = jnp.where(upd, src_sf, sf)
        return i + 1, stress2, sf2, active | upd, jnp.any(upd)

    _, stress, subduct, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), stress.astype(jnp.float32),
         subduct.astype(jnp.float32), active0, jnp.bool_(True)),
    )
    return stress, subduct


@jax.jit
def propagate_stress(stress, subduct, r_plate, plate_is_ocean,
                     nbr_idx, nbr_mask, decay, subduct_decay, num_passes):
    """Frontier BFS stress diffusion inward through the same plate
    (js/elevation.js:127-159), as synchronous max-relaxation sweeps.

    Per sweep: each cell takes the strongest propagated stress among
    same-plate neighbors (source decays by ``subduct_decay`` when its
    subduct factor > 0.5, else ``decay``; propagation stops below 0.005 and
    never starts from ocean-plate cells). The subduct factor rides along.
    """
    ocean_cell = plate_is_ocean[r_plate]
    same = (r_plate[nbr_idx] == r_plate[:, None]) & nbr_mask
    active0 = stress > 0.01

    def cond(state):
        i, _, _, _, changed = state
        return changed & (i < num_passes)

    def body(state):
        i, stress, sf, active, _ = state
        eff = jnp.where(sf > 0.5, subduct_decay, decay)
        prop = stress * eff
        sendable = active & (~ocean_cell) & (prop >= 0.005)
        cand = jnp.where(same & sendable[nbr_idx], prop[nbr_idx], -jnp.inf)
        best = jnp.argmax(cand, axis=1)
        best_val = jnp.take_along_axis(cand, best[:, None], 1)[:, 0]
        src = jnp.take_along_axis(nbr_idx, best[:, None], 1)[:, 0]
        upd = best_val > stress
        stress2 = jnp.where(upd, best_val, stress)
        sf2 = jnp.where(upd, sf[src], sf)
        return i + 1, stress2, sf2, active | upd, jnp.any(upd)

    _, stress, subduct, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), stress.astype(jnp.float32),
         subduct.astype(jnp.float32), active0, jnp.bool_(True)),
    )
    return stress, subduct
