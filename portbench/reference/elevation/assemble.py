"""Elevation synthesis — distance fields, dual-layer orogeny, the fused
per-cell land/ocean assembly kernel, coastal roughening, island arcs,
hotspots, peak compression.

Re-design of reference assignElevation (js/elevation.js:216-1391). Every
queue-based BFS becomes a masked propagation sweep (ops/graph.py); the huge
sequential per-cell loop becomes ONE fused XLA map over [N] arrays — all
branches turned into ``jnp.where`` masks so the whole land+ocean stack
compiles to a handful of VPU passes; hotspots run as a lax.scan over the
dome list (hotspots.py).

Randomized BFS fronts (js/elevation.js:176-180) are emulated with per-cell
hash-noise hop costs — the same trick the reference itself uses for
priority-flood meander (js/terrain-post.js:96-105).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, NamedTuple, Optional

import numpy as np
from ..backend import jax
from ..backend import jnp

from ..mesh.device import DeviceGraph
from ..ops.noise import Tables, tables, noise3, fbm, ridged_fbm
from ..ops.graph import bfs_hops_multi, band_bfs, hash01
from ..ops.banded import (bfs_hops_multi_banded, band_gate, rem_gate_eq,
                          propagate_stress_banded, band_bfs_banded,
                          banded_sum)
from .collisions import (CollisionResult, find_collisions,
                         propagate_stress_multi)
from .hotspots import build_domes, hotspot_uplift

SMALL_W = 0.05   # js/elevation.js:254-255
SUPER_W = 0.95
BASE_SCALE = 0.6


def distance_bfs_caps(sf_res: float):
    """(interior_band, tectonic_reach, h_far, bfs_hops) for the 5-field
    distance BFS. The saturation cap ``h_far`` must dominate EVERY consumer's
    branch point: ``tectonic_reach = 20·sf_res`` (raw_prox/tec_activity,
    js/elevation.js:757-765) exceeds ``interior_band = 16·sf_res``
    (js/elevation.js:866-887), so it sets h_far at large N. If it didn't,
    saturated far-field cells would read d_mtn = h_far < tectonic_reach and
    carry a spurious raw_prox floor of 1 − h_far/tectonic_reach across
    entire continental interiors (the upstream reference decays to 0
    there). Invariant tested in tests/test_elevation.py."""
    interior_band = max(4, round(16 * sf_res))
    tectonic_reach = max(6, round(20 * sf_res))
    h_far = float(max(interior_band, tectonic_reach, 48))
    bfs_hops = int(math.ceil(1.3 * h_far)) + 2
    return interior_band, tectonic_reach, h_far, bfs_hops


def elevation_tables(seed: int) -> Dict[str, Tables]:
    """All seed-derived noise tables the elevation stage consumes, built on
    host once per seed. Passing this pack (plus prebuilt ``domes``) into
    :func:`assign_elevation` makes the stage fully traceable — no host work
    inside, so it can live under one fused jit without retracing per seed."""
    return dict(
        base=tables(seed), rift=tables(seed + 419), fold=tables(seed + 557),
        c1=tables(seed + 77), c2=tables(seed + 133), c3=tables(seed + 211),
        arc=tables(seed + 307), hs1=tables(seed + 501), hs2=tables(seed + 502),
    )


class ElevationResult(NamedTuple):
    elevation: jax.Array        # [N] f32
    mountain: jax.Array         # [N] bool (seed masks, post-blend)
    coastline: jax.Array
    ocean_seeds: jax.Array
    stress: jax.Array
    subduct: jax.Array
    r_is_ocean: jax.Array       # [N] bool plate-level ocean flag
    dist_coast_land: jax.Array  # [N] f32 (reused by climate)
    debug: Dict[str, jax.Array]


@jax.jit
def _blend_collisions(small: CollisionResult, sup: CollisionResult):
    """Dual-layer orogeny blend, SMALL_W/SUPER_W (js/elevation.js:249-327)."""
    mountain = sup.mountain | small.mountain
    ocean = sup.ocean | small.ocean
    coastline = (sup.coastline | small.coastline) & (~mountain)

    max_super = jnp.max(sup.stress)
    inv_max = jnp.where(max_super > 1e-6, 1.0 / max_super, 0.0)
    proximity = jnp.minimum(1.0, sup.stress * inv_max * 3.0)
    eff_small = SMALL_W * (SMALL_W + (1.0 - SMALL_W) * proximity)
    stress = eff_small * small.stress + SUPER_W * sup.stress

    w_s = SMALL_W * small.stress
    w_p = SUPER_W * sup.stress
    total = w_s + w_p
    subduct = jnp.where(
        total > 1e-6,
        (w_s * small.subduct + w_p * sup.subduct) / jnp.maximum(total, 1e-20),
        SMALL_W * small.subduct + SUPER_W * sup.subduct,
    )
    btype = jnp.where(w_s > w_p, small.btype, sup.btype)
    return CollisionResult(
        mountain=mountain, coastline=coastline, ocean=ocean,
        stress=stress, subduct=subduct, btype=btype,
        both_ocean=small.both_ocean | sup.both_ocean,
        has_ocean=small.has_ocean | sup.has_ocean,
    )


@jax.jit
def _blend_propagated(small_stress, small_sf, super_stress, super_sf, subduct):
    stress = SMALL_W * small_stress + SUPER_W * super_stress
    w_s = SMALL_W * small_stress
    w_p = SUPER_W * super_stress
    total = w_s + w_p
    sf = jnp.where(
        total > 1e-6,
        (w_s * small_sf + w_p * super_sf) / jnp.maximum(total, 1e-20),
        subduct,
    )
    return stress, sf


@partial(jax.jit, static_argnames=("num_plates",))
def _plate_reps(r_plate, in_any_seed, valid, plate_is_ocean, coastline, ocean,
                num_plates: int):
    """Each plate's interior gets a representative seed cell (min index not
    already in a seed set), added to ocean_r/coastline_r by plate type
    (js/elevation.js:365-382)."""
    n = r_plate.shape[0]
    cand = valid & (~in_any_seed)
    idx = jnp.where(cand, jnp.arange(n, dtype=jnp.int32), n)
    rep = jax.ops.segment_min(idx, r_plate, num_segments=num_plates)
    exists = rep < n
    rep_c = jnp.clip(rep, 0, n - 1)
    add_ocean = jnp.zeros(n, bool).at[rep_c].max(exists & plate_is_ocean)
    add_coast = jnp.zeros(n, bool).at[rep_c].max(exists & (~plate_is_ocean))
    return ocean | add_ocean, coastline | add_coast


@jax.jit
def _stress_p97(stress, valid):
    """97th percentile of stress values > 0.01 (js/elevation.js:443-453)."""
    mask = (stress > 0.01) & valid
    cnt = jnp.sum(mask)
    vals = jnp.where(mask, stress, jnp.inf)
    vals = jnp.sort(vals)
    idx = jnp.minimum(cnt - 1, jnp.floor(cnt * 0.97).astype(jnp.int32))
    p97 = vals[jnp.clip(idx, 0, stress.shape[0] - 1)]
    raw_max = jnp.max(jnp.where(valid, stress, 0.0))
    out = jnp.where(cnt > 0, p97, raw_max)
    return jnp.where(out < 0.01, 1.0, out)


def base_blend(dist_mountain, dist_ocean, dist_coastline, sf, eps=1e-3):
    """Harmonic-mean base-elevation blend (js/elevation.js:638-655):
    ``(1/a − 1/b) / (1/a + 1/b + 1/c) · BASE_SCALE`` with the mountain
    distance stretched by the subduction asymmetry
    ``a = d_mtn · (1 + (sf − 0.5)·0.8)``; cells with neither a mountain
    nor an ocean field default to 0.1·BASE_SCALE. Extracted so the
    reference-golden tests can pin the curve (tests/test_reference_goldens
    tranche 3)."""
    asym = 1.0 + (sf - 0.5) * 0.8
    a = dist_mountain * asym + eps
    b = dist_ocean + eps
    c = dist_coastline + eps
    inv_a = jnp.where(jnp.isinf(a), 0.0, 1.0 / a)
    inv_b = jnp.where(jnp.isinf(b), 0.0, 1.0 / b)
    inv_c = jnp.where(jnp.isinf(c), 0.0, 1.0 / c)
    no_field = jnp.isinf(dist_mountain) & jnp.isinf(dist_ocean)
    denom = inv_a + inv_b + inv_c
    return jnp.where(
        no_field, 0.1 * BASE_SCALE,
        jnp.where(denom > 0,
                  (inv_a - inv_b) / jnp.maximum(denom, 1e-20) * BASE_SCALE,
                  0.1 * BASE_SCALE),
    )


def ocean_floor_profile(dist_coast, abyss_noise):
    """Fixed-breakpoint ocean depth profile (js/elevation.js:896-909):
    shelf −0.04→−0.10 over hops 0-5, slope −0.10→−0.35 over hops 5-12,
    abyssal plain −0.35 + fbm·0.03 beyond (``abyss_noise`` is the
    already-scaled noise term). Extracted for the golden tests."""
    dc = dist_coast
    return jnp.where(
        dc < 5, -0.04 - 0.06 * (dc / 5),
        jnp.where(dc < 12, -0.10 - 0.25 * ((dc - 5) / 7),
                  -0.35 + abyss_noise))


@partial(jax.jit, static_argnames=(
    "warp_octaves", "interior_band", "tectonic_reach", "plateau_start",
    "rift_half", "floor_end", "shoulder_end", "ridge_half", "fracture_half",
    "ba_start", "ba_peak", "ba_end"))
def _main_assembly(pos, r_is_ocean, stress, sf, btype,
                   dist_mountain, dist_ocean, dist_coastline, dist_coast,
                   dist_coast_land, rift_dist, ridge_dist, fracture_dist,
                   backarc_dist, backarc_stress, max_stress,
                   plate_pole_of_cell,
                   noise_t: Tables, rift_t: Tables, fold_t: Tables,
                   noise_mag,
                   warp_octaves: int, interior_band: int, tectonic_reach: int,
                   plateau_start: int, rift_half: int, floor_end: int,
                   shoulder_end: int, ridge_half: int, fracture_half: int,
                   ba_start: int, ba_peak: int, ba_end: int):
    """The fused land+ocean per-cell stack (js/elevation.js:638-973)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    eps = 1e-3
    warp_scale = 0.4

    # --- base elevation: harmonic-mean distance blend (:638-655) ---
    base = base_blend(dist_mountain, dist_ocean, dist_coastline, sf, eps)
    elev = base
    dl_base = base

    stress_norm = jnp.minimum(1.0, stress / max_stress)

    # domain warp coordinates (:662-664)
    wx = x + warp_scale * fbm(noise_t, x + 5.3, y + 1.7, z + 3.1, warp_octaves)
    wy = y + warp_scale * fbm(noise_t, x + 8.1, y + 2.9, z + 7.3, warp_octaves)
    wz = z + warp_scale * fbm(noise_t, x + 1.4, y + 6.2, z + 4.8, warp_octaves)

    # orogenic power (:669-672)
    raw_oro = noise3(noise_t, x * 1.5 + 33.7, y * 1.5 + 11.2, z * 1.5 + 22.9)
    shaped = jnp.sign(raw_oro) * jnp.sqrt(jnp.abs(raw_oro))
    orogenic = jnp.clip(0.5 + 0.5 * shaped, 0.0, 1.0)

    land = ~r_is_ocean

    # ================= LAND STACK =================
    # subduction suppression (:678-681)
    suppression = jnp.maximum(0.0, (sf - 0.5) * 2.0)
    elev_l = jnp.where((sf > 0.5) & (elev > 0), elev * (1 - suppression * 0.42), elev)

    # stress uplift/depress with height variation (:683-689)
    stress_mag = stress_norm * stress_norm * 0.55 * orogenic
    uplift = stress_mag * (1 - sf)
    depress = stress_mag * 0.4 * sf
    height_var = 0.60 + 0.8 * fbm(noise_t, x * 8 + 13.7, y * 8 + 9.2, z * 8 + 4.5, 3)
    elev_l = elev_l + jnp.where(stress_norm > 0.01, (uplift - depress) * height_var, 0.0)

    # foreland basin dip (:691-694)
    foreland_t = stress_norm / 0.10
    elev_l = elev_l - jnp.where(
        (stress_norm > 0) & (stress_norm < 0.10), 0.06 * (1 - foreland_t), 0.0)

    # rift valley graben profile (:696-727)
    rd = rift_dist
    rift_ridged = ridged_fbm(rift_t, x * 8, y * 8, z * 8, 3)
    t_floor = rd / floor_end
    t_shoulder = (rd - floor_end) / max(1e-6, shoulder_end - floor_end)
    t_fade = jnp.minimum(1.0, (rd - shoulder_end) / max(1e-6, rift_half - shoulder_end))
    fade = t_fade * t_fade * (3 - 2 * t_fade)
    rift_effect = jnp.where(
        rd <= 0.5, -0.15 + rift_ridged * 0.04,
        jnp.where(
            rd <= floor_end, -0.12 * (1 - t_floor * 0.3) + rift_ridged * 0.03 * (1 - t_floor),
            jnp.where(
                rd <= shoulder_end, 0.03 * (1 - t_shoulder),
                (0.03 * (1 - fade) * 0.2) if rift_half > shoulder_end else 0.0,
            ),
        ),
    )
    elev_l = elev_l + jnp.where(jnp.isinf(rd), 0.0, rift_effect)

    # back-arc basin depression (:729-753) — shared with ocean stack
    bad = backarc_dist
    d_mtn = dist_mountain
    orogeny_factor = jnp.where(
        (~jnp.isinf(d_mtn)) & (d_mtn < bad),
        jnp.maximum(0.0, d_mtn / jnp.maximum(bad, 1e-20)), 1.0)
    t_ba1 = (bad - ba_start) / max(1, ba_peak - ba_start)
    s_ba1 = t_ba1 * t_ba1 * (3 - 2 * t_ba1)
    t_ba2 = (bad - ba_peak) / max(1, ba_end - ba_peak)
    s_ba2 = t_ba2 * t_ba2 * (3 - 2 * t_ba2)
    ba_effect = jnp.where(
        jnp.isinf(bad) | (bad < ba_start), 0.0,
        jnp.where(bad <= ba_peak, -0.10 * backarc_stress * s_ba1 * orogeny_factor,
                  jnp.where(bad <= ba_end,
                            -0.10 * backarc_stress * (1 - s_ba2) * orogeny_factor,
                            0.0)))
    elev_l = elev_l + ba_effect
    dl_tectonic_land = elev_l - base

    # tectonic activity (:757-765)
    raw_prox = jnp.where(
        jnp.isinf(d_mtn) | (d_mtn >= tectonic_reach), 0.0, 1 - d_mtn / tectonic_reach)
    tec_activity = jnp.maximum(stress_norm, raw_prox * raw_prox)

    # fold ridges (:767-799)
    fold_activity = tec_activity * tec_activity
    pp = plate_pole_of_cell
    u_fold = x * pp[:, 0] + y * pp[:, 1] + z * pp[:, 2]
    phase_warp = fbm(fold_t, x * 3 + 55.3, y * 3 + 33.7, z * 3 + 17.2, 2) * 0.08
    FOLD_FREQ = 30.0
    phase = (u_fold + phase_warp) * FOLD_FREQ * jnp.pi
    ridge_f = 1 - jnp.abs(jnp.sin(phase))
    fold_centered = ridge_f - 0.36
    amp_mod = 0.6 + 0.4 * fbm(fold_t, x * 4 + 88.1, y * 4 + 62.3, z * 4 + 41.7, 2)
    elev_boost = 1 + 4 * jnp.maximum(0.0, elev_l)
    fold_amp = fold_activity * jnp.maximum(0.0, 1 - sf * 1.5) * noise_mag * 0.8 * elev_boost
    fold_contrib = jnp.where(fold_activity > 0.01, fold_centered * fold_amp * amp_mod, 0.0)
    elev_l = elev_l + fold_contrib

    # plateau zone flag (:801-802)
    is_plateau = (sf < 0.45) & (~jnp.isinf(d_mtn)) & (d_mtn > plateau_start)

    # tectonic-activity-scaled noise stack (:804-823)
    blend = jnp.minimum(1.0, stress_norm * 3)
    smooth_noise = fbm(noise_t, wx, wy, wz) * noise_mag
    ridged_noise = ridged_fbm(noise_t, wx, wy, wz) * noise_mag * 1.5
    noise_val = smooth_noise * (1 - blend) + ridged_noise * blend
    detail = fbm(noise_t, wx * 4 + 22.1, wy * 4 + 6.8, wz * 4 + 15.4, 4, 0.5) * noise_mag * 0.5
    noise_activity = jnp.minimum(1.0, stress_norm * 4)
    plateau_suppress = jnp.where(
        is_plateau, jnp.maximum(0.30, 1 - tec_activity * 0.60), 1.0)
    noise_scale = (0.25 + 0.75 * noise_activity) * plateau_suppress
    fine = fbm(noise_t, wx * 8 + 41.7, wy * 8 + 13.2, wz * 8 + 27.9, 3, 0.5) * noise_mag * 0.25
    fine_scale = jnp.sqrt(noise_scale)
    total_noise = (noise_val + detail) * noise_scale + fine * fine_scale
    elev_l = elev_l + total_noise
    dl_noise_land = total_noise

    # mountain dissection (:829-842)
    DISSECT_THRESHOLD = 0.12
    excess_d = elev_l - DISSECT_THRESHOLD
    dissect_val = fbm(noise_t, wx * 16 + 71.3, wy * 16 + 44.8, wz * 16 + 29.1, 3, 0.5)
    dissect = jnp.where(
        elev_l > DISSECT_THRESHOLD,
        dissect_val * jnp.sqrt(jnp.maximum(0.0, excess_d)) * stress_norm * noise_mag * 0.4,
        0.0)
    elev_l = elev_l + dissect
    dl_noise_land = dl_noise_land + dissect

    # summit peaks (:844-863)
    SUMMIT_THRESHOLD = 0.65
    peak_noise = ridged_fbm(noise_t, wx * 24 + 91.3, wy * 24 + 55.7, wz * 24 + 38.2, 3, 0.5)
    spike = jnp.maximum(0.0, peak_noise - 0.45)
    peak_contrib = jnp.where(
        (elev_l > SUMMIT_THRESHOLD) & (stress_norm > 0.2),
        spike * (elev_l - SUMMIT_THRESHOLD) * stress_norm * 1.2, 0.0)
    elev_l = elev_l + peak_contrib
    dl_noise_land = dl_noise_land + peak_contrib

    # continental interior uplift (:866-887)
    lcd = dist_coast_land
    t_down = jnp.minimum(lcd / interior_band, 1.0)
    s_down = t_down * t_down * (3 - 2 * t_down)
    t_up = jnp.minimum(lcd / (interior_band * 0.4), 1.0)
    s_up = t_up * t_up * (3 - 2 * t_up)
    interior_uplift = 0.06 + tec_activity * 0.16
    base_bias = -0.08 * (1 - s_down) + interior_uplift * s_up
    mod = 1.0 + 0.2 * fbm(noise_t, x * 2 + 19.3, y * 2 + 7.6, z * 2 + 13.1, 2)
    bias = jnp.where(jnp.isinf(lcd), 0.0, base_bias * mod)
    elev_l = elev_l + bias
    dl_interior = bias

    # plateau boost (:889-894)
    plateau_boost = jnp.where(
        is_plateau & (tec_activity > 0.1), 0.025 * tec_activity * (1 - sf), 0.0)
    elev_l = elev_l + plateau_boost
    dl_interior = dl_interior + plateau_boost

    # ================= OCEAN STACK =================
    dc = dist_coast
    abyss_noise = fbm(noise_t, x * 2, y * 2, z * 2, 3) * 0.03
    ocean_base = ocean_floor_profile(dc, abyss_noise)
    elev_o = jnp.minimum(base, ocean_base)
    dl_ocean = elev_o
    elev_before_oc = elev_o

    # mid-ocean ridge (:921-929)
    rdg = ridge_dist
    t_r = rdg / ridge_half
    ridge_fade = (1 - t_r) * (1 - t_r)
    ridge_n = ridged_fbm(noise_t, x * 3, y * 3, z * 3, 4)
    elev_o = elev_o + jnp.where(
        (~jnp.isinf(rdg)) & (rdg <= ridge_half),
        (0.12 * ridge_n + 0.06) * ridge_fade, 0.0)

    # fracture zones (:931-937)
    fd = fracture_dist
    elev_o = elev_o - jnp.where(
        (~jnp.isinf(fd)) & (fd <= fracture_half),
        0.03 * (1 - fd / fracture_half), 0.0)

    # trenches (:939-942)
    elev_o = elev_o - jnp.where(btype == 1, 0.15 + 0.15 * stress_norm, 0.0)

    # back-arc deepening (:944-965) — same profile as land
    elev_o = elev_o + ba_effect
    dl_tectonic_ocean = elev_o - elev_before_oc

    ocean_noise = fbm(noise_t, wx, wy, wz) * noise_mag * 0.3
    elev_o = elev_o + ocean_noise

    # ================= merge =================
    elev_out = jnp.where(land, elev_l, elev_o)
    debug = dict(
        base=dl_base,
        tectonic=jnp.where(land, dl_tectonic_land, dl_tectonic_ocean),
        noise=jnp.where(land, dl_noise_land, ocean_noise),
        interior=jnp.where(land, dl_interior, 0.0),
        ocean=jnp.where(land, 0.0, dl_ocean),
        tecActivity=jnp.where(land, tec_activity, 0.0),
        backArc=ba_effect,
        foldRidge=jnp.where(land, fold_contrib, 0.0),
        orogenicPower=orogenic - 0.5,
    )
    return elev_out, debug


@partial(jax.jit, static_argnames=("coast_roughen_dist", "island_band"))
def _coastal_roughening(pos, elev, r_is_ocean, stress, max_stress,
                        d_bdry, coast_stress, coast_subduct, coast_convergent,
                        c1_t: Tables, c2_t: Tables, c3_t: Tables,
                        noise_t: Tables, noise_mag,
                        coast_roughen_dist: int, island_band: int):
    """Coastal fractal noise + coastline-aware warp + island scattering
    (js/elevation.js:977-1050)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    in_range = d_bdry <= coast_roughen_dist
    t = d_bdry / coast_roughen_dist
    sn = jnp.minimum(1.0, jnp.maximum(coast_stress, stress / max_stress))

    is_sub_ocean = r_is_ocean & (coast_convergent > 0) & (coast_subduct > 0.45)
    sub_sup = jnp.where(
        is_sub_ocean, jnp.minimum(1.0, (coast_subduct - 0.45) / 0.55), 0.0)
    passive = coast_convergent == 0

    # layer 1: coastal fractal noise
    falloff1 = (1 - t) * (1 - t)
    stress_amp = 1 + sn * 5
    freq = jnp.where(passive, 12.0, 18.0)
    amp = jnp.where(passive, 0.08, 0.12)
    n1 = fbm(c1_t, x * freq + 3.7, y * freq + 7.1, z * freq + 2.3, 5, 0.55)
    cn1 = n1 * amp * falloff1 * stress_amp
    cn1 = jnp.where((sub_sup > 0) & (cn1 > 0), cn1 * (1 - sub_sup), cn1)
    delta = jnp.where(in_range, cn1, 0.0)

    # layer 3: coastline-aware domain warping
    warp_reach = jnp.where(passive, 1.2, 1.5)
    falloff_w = jnp.maximum(0.0, 1 - t * warp_reach)
    warp_amt = 0.35 * falloff_w * (1 + sn * 2)
    dwx = fbm(c3_t, x * 6 + 11.3, y * 6 + 4.7, z * 6 + 8.2, 3, 0.6) * warp_amt
    dwy = fbm(c3_t, x * 6 + 2.9, y * 6 + 9.4, z * 6 + 1.6, 3, 0.6) * warp_amt
    dwz = fbm(c3_t, x * 6 + 7.5, y * 6 + 0.3, z * 6 + 5.9, 3, 0.6) * warp_amt
    orig_n = fbm(noise_t, x, y, z) * noise_mag
    warp_n = fbm(noise_t, x + dwx, y + dwy, z + dwz) * noise_mag
    wd = (warp_n - orig_n) * falloff_w
    wd = jnp.where((sub_sup > 0) & (wd > 0), wd * (1 - sub_sup), wd)
    delta = delta + jnp.where(in_range & (falloff_w > 0), wd, 0.0)

    # layer 2: island scattering
    island_n = fbm(c2_t, x * 35 + 5.1, y * 35 + 9.3, z * 35 + 2.7, 4, 0.5)
    thr = 0.25 - sn * 0.2
    excess = (island_n - thr) / (1 - thr)
    dist_fade = 1 - d_bdry / island_band
    bump = excess * excess * 0.18 * (1 + sn * 2) * dist_fade * (1 - sub_sup / 0.3)
    island_ok = (
        in_range & r_is_ocean & (d_bdry > 0) & (d_bdry <= island_band)
        & (sub_sup < 0.3) & (island_n > thr))
    delta = delta + jnp.where(island_ok, bump, 0.0)

    return elev + delta, delta


@partial(jax.jit, static_argnames=("max_arc_dist",))
def _island_arcs(pos, elev, arc_dist, arc_stress, arc_t: Tables,
                 peak_dist: float, sigma: float, max_arc_dist: int):
    """O-O convergent overriding-side island arcs (js/elevation.js:1054-1107)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    d = arc_dist
    ok = (d >= 1) & (d <= max_arc_dist)
    dist_w = jnp.exp(-0.5 * ((d - peak_dist) / sigma) ** 2)
    n = ridged_fbm(arc_t, x * 4, y * 4, z * 4, 4, 2.0, 0.5, 1.0)
    thr = 0.30
    excess = (n - thr) / (1 - thr)
    uplift = jnp.where(
        ok & (n > thr), excess * excess * 0.55 * dist_w * (0.5 + arc_stress), 0.0)
    return elev + uplift, uplift



def _probe_result(g, probe, col, stress, subduct):
    """Truncated-trace result for assign_elevation(trunc=...) — elevation
    is a cheap reduction over the phase outputs so the prefix stays live."""
    z = jnp.zeros(g.n_padded, jnp.float32)
    return ElevationResult(
        elevation=probe.astype(jnp.float32),
        mountain=col.mountain, coastline=col.coastline,
        ocean_seeds=col.ocean, stress=stress, subduct=subduct,
        r_is_ocean=jnp.zeros(g.n_padded, bool),
        dist_coast_land=z, debug={"hotspot": z},
    )

def assign_elevation(
    g: DeviceGraph,
    r_plate: jax.Array,
    plate_is_ocean: jax.Array, plate_pole: jax.Array, plate_omega: jax.Array,
    plate_density: jax.Array,
    seed: int, noise_mag: float, spread: float = 5.0,
    r_super_plate: Optional[jax.Array] = None,
    super_is_ocean=None, super_pole=None, super_omega=None, super_density=None,
    noise_pack: Optional[Dict[str, Tables]] = None,
    domes: Optional[Dict[str, jax.Array]] = None,
    trunc: Optional[str] = None,
) -> ElevationResult:
    """Full elevation synthesis orchestration (js/elevation.js:216-1391).

    ``noise_pack`` / ``domes``: prebuilt host prologue products (see
    :func:`elevation_tables`, hotspots.build_domes). When both are given the
    function is pure-traceable (``seed`` may be a traced uint32 scalar, used
    only for hash salts); when omitted they are built here on host —
    convenient for tests, but forces device→host syncs mid-stage. An empty
    ``domes`` dict means "no hotspots".

    ``trunc`` (debug/bisect only — tools/bisect_profile.py): stop after the
    named phase ('stress' | 'bfs5' | 'carry' | 'assembly' | 'coastal') and
    return a probe ElevationResult whose elevation consumes that phase's
    outputs (so nothing is dead-code-eliminated from the truncated trace)."""
    n = g.n_cells
    npad = g.n_padded
    dt = 1e-2 / max(1.0, math.sqrt(n / 10000.0))
    undul_oct = 2 if n > 200000 else 3
    warp_oct = 2 if n > 200000 else 3
    sf_res = math.sqrt(n / 10000.0)

    nt = noise_pack if noise_pack is not None else elevation_tables(seed)
    noise_t = nt["base"]

    small = find_collisions(g, r_plate, plate_is_ocean, plate_pole,
                            plate_omega, plate_density, noise_t, dt, undul_oct)
    has_super = r_super_plate is not None
    if has_super:
        sup = find_collisions(g, r_super_plate, super_is_ocean, super_pole,
                              super_omega, super_density, noise_t, dt, undul_oct)
        col = _blend_collisions(small, sup)
    else:
        col = small

    # stress propagation (js/elevation.js:329-362) — small + super layers
    # batched into one packed-gather sweep loop (TPU gathers are index-bound)
    base_decay = 0.5 + spread * 0.04
    decay = base_decay ** (1 / sf_res)
    sub_decay = (base_decay * 0.45) ** (1 / sf_res)
    num_passes = max(1, round(spread * 3 * sf_res))

    gate_small = band_gate(r_plate, g.band_off, g.band_mask)
    rgate_small = rem_gate_eq(r_plate, g.rem_src, g.rem_dst)
    if has_super:
        gate_sup = band_gate(r_super_plate, g.band_off, g.band_mask)
        rgate_sup = rem_gate_eq(r_super_plate, g.rem_src, g.rem_dst)
        st2, sf2 = propagate_stress_banded(
            jnp.stack([small.stress, sup.stress], 1),
            jnp.stack([small.subduct, sup.subduct], 1),
            (gate_small, gate_sup),
            jnp.stack([rgate_small, rgate_sup], 1),
            jnp.stack([plate_is_ocean[r_plate],
                       super_is_ocean[r_super_plate]], 1),
            *g.bands, decay, sub_decay, num_passes)
        stress, subduct = _blend_propagated(
            st2[:, 0], sf2[:, 0], st2[:, 1], sf2[:, 1], col.subduct)
    else:
        st2, sf2 = propagate_stress_banded(
            col.stress[:, None], col.subduct[:, None],
            (gate_small,), rgate_small[:, None],
            plate_is_ocean[r_plate][:, None],
            *g.bands, decay, sub_decay, num_passes)
        stress, subduct = st2[:, 0], sf2[:, 0]

    if trunc == "stress":
        return _probe_result(g, stress + subduct, col, stress, subduct)

    mountain, coastline, ocean_seeds = col.mountain, col.coastline, col.ocean

    # plate interior representatives
    in_any = mountain | coastline | ocean_seeds
    ocean_seeds, coastline = _plate_reps(
        r_plate, in_any, g.valid, plate_is_ocean, coastline,
        ocean_seeds, num_plates=int(plate_is_ocean.shape[0]))

    stress_mountain = mountain & (subduct < 0.55)
    stop_r = stress_mountain | coastline | ocean_seeds

    idx = jnp.arange(npad, dtype=jnp.int32)

    def rand_cost(k):
        return 0.5 + hash01(idx, seed + k)

    r_is_ocean = plate_is_ocean[r_plate] & g.valid
    land_mask = (~r_is_ocean) & g.valid
    land_nb_cnt = banded_sum(land_mask.astype(jnp.float32), *g.bands)
    ocean_nb_cnt = banded_sum(r_is_ocean.astype(jnp.float32), *g.bands)
    coast_seeds = r_is_ocean & (land_nb_cnt > 0)
    no_barrier = jnp.zeros(npad, bool)
    land_coast_seeds = land_mask & (ocean_nb_cnt > 0)

    # the five distance fields (js/elevation.js:365-427) relax together in
    # one [N,5] loop — a single index-bound gather per sweep instead of five.
    #
    # Hop-capped: relaxing to a fixed point costs O(mesh diameter) sweeps
    # (O(N^1.5) total work at 1M cells), but every consumer saturates —
    # dist_coast at the raw 12-hop shelf break (js/elevation.js:896-909),
    # dist_coast_land at interior_band (:866-887), raw_prox/tec_activity at
    # tectonic_reach (:757-765), and the harmonic 1/d base blend (:638-655)
    # flattens once all three long-range fields exceed h_far. The cap must
    # dominate EVERY consumer's branch point — tectonic_reach = 20·sf_res
    # exceeds interior_band = 16·sf_res, so it sets h_far at large N; if it
    # didn't, saturated far-field cells would read d_mtn = h_far <
    # tectonic_reach and carry a spurious raw_prox floor of
    # 1 − h_far/tectonic_reach across entire continental interiors. The
    # loop runs ceil(1.3·h_far) sweeps
    # (rand_cost ≥ 0.5 makes values ≤ 0.65·h_far final by then) and the
    # fields saturate at their caps beyond that — far cells plateau smoothly
    # instead of carrying exact distances nothing downstream can see.
    interior_band, tectonic_reach, h_far, bfs_hops = distance_bfs_caps(sf_res)
    # dist_coast (the ocean-floor field) is split out of the multi-field
    # loop: its only consumers branch at 5/12 raw hops (ocean_floor_profile
    # and the margins layer), so a 13.0 value cap makes it converge in a
    # handful of sweeps while the long-range fields run to h_far — the
    # remaining 4-field loop does 4/5 of the select work per sweep over
    # the same dispatch count (per-field results are independent, so the
    # split is bit-identical on the jnp path). Salt k=4 stays with the
    # coast field to keep every rand-cost stream unchanged.
    dists = bfs_hops_multi_banded(
        jnp.stack([stress_mountain, ocean_seeds, coastline,
                   land_coast_seeds], 1),
        jnp.stack([ocean_seeds, coastline, stop_r, r_is_ocean], 1),
        *g.bands, max_hops=bfs_hops,
        rand_cost=jnp.stack([rand_cost(k) for k in (1, 2, 3, 5)], 1),
        # pallas path: VALUE cap at the consumer saturation point — exact
        # min(true_dist, h_far), no (0.65·h_far, h_far) overestimate band
        value_cap=h_far)
    dists_dc = bfs_hops_multi_banded(
        coast_seeds[:, None], no_barrier[:, None],
        *g.bands, max_hops=min(bfs_hops, 28),
        rand_cost=rand_cost(4)[:, None],
        value_cap=13.0)

    def _saturate(d, seed_col, barrier, cap):
        # finite → clamp at cap; capped-out → cap (unless a barrier cell,
        # which the reference also never visits, or the field has no seeds
        # at all — the degenerate no-collision planet keeps its 0.06
        # no_field fallback, assemble line ~169)
        far = jnp.where(barrier | ~jnp.any(seed_col), jnp.inf,
                        jnp.float32(cap))
        return jnp.where(jnp.isfinite(d), jnp.minimum(d, cap), far)

    dist_mountain = _saturate(dists[:, 0], stress_mountain, ocean_seeds,
                              h_far)
    dist_ocean = _saturate(dists[:, 1], ocean_seeds, coastline, h_far)
    dist_coastline = _saturate(dists[:, 2], coastline, stop_r, h_far)
    dist_coast = dists_dc[:, 0]  # branches at 5/12 hops; ≥13 and inf = abyss
    dist_coast_land = _saturate(dists[:, 3], land_coast_seeds, r_is_ocean,
                                float(interior_band + 1))

    if trunc == "bfs5":
        probe = sum(jnp.where(jnp.isfinite(dists[:, i]), dists[:, i], 0.0)
                    for i in range(4))
        probe = probe + jnp.where(jnp.isfinite(dists_dc[:, 0]),
                                  dists_dc[:, 0], 0.0)
        return _probe_result(g, probe, col, stress, subduct)

    max_stress = _stress_p97(stress, g.valid)

    # structural band widths (js/elevation.js:429-438, 460, 475, 512, 543,
    # 571, 601-603, 1057); interior_band + tectonic_reach hoisted above the
    # distance BFS (they set its saturation cap)
    plateau_start = max(2, round(3 * sf_res))
    rift_half = max(2, round(4 * sf_res))
    floor_end = max(1, round(1.5 * sf_res))
    shoulder_end = max(2, round(2.5 * sf_res))
    ridge_half = max(2, round(4 * sf_res))
    fracture_half = max(2, round(3 * sf_res))
    ba_start = max(1, round(2 * sf_res))
    ba_peak = max(2, round(3 * sf_res))
    ba_end = max(3, round(5 * sf_res))
    max_cd = max(8, round(8 * sf_res))
    max_arc = max(5, round(5 * sf_res))

    # coast-boundary carry BFS (dBdry + stress/subduct/convergent carries)
    # boundary: any neighbor with a different ocean/land state — for a
    # VALID cell that's exactly "land with an ocean neighbor or vice versa"
    coast_bdry = jnp.where(r_is_ocean, land_nb_cnt > 0,
                           ocean_nb_cnt > 0) & g.valid
    stress_n = jnp.minimum(1.0, stress / max_stress)
    carried0 = jnp.stack([
        jnp.where(coast_bdry, stress_n, 0.0),
        jnp.where(coast_bdry, subduct, 0.0),
        jnp.where(coast_bdry, (col.btype == 1).astype(jnp.float32), 0.0),
    ])
    d_bdry2, _, carried = band_bfs_banded(
        coast_bdry[:, None], carried0[:, :, None], *g.bands,
        max_hops=max_cd, tie=carried0[0][:, None], num_carry=3)
    d_bdry = jnp.where(jnp.isinf(d_bdry2[:, 0]), max_cd + 1.0, d_bdry2[:, 0])
    coast_stress, coast_subduct, coast_convergent = (
        carried[0, :, 0], carried[1, :, 0], carried[2, :, 0])

    # rift / ridge / fracture / back-arc / island-arc carry BFS — five
    # structural bands batched into one packed-gather loop
    rift_seeds = (col.btype == 2) & (~col.has_ocean) & g.valid
    ridge_seeds = (col.btype == 2) & col.both_ocean & g.valid
    frac_seeds = (col.btype == 3) & col.both_ocean & g.valid
    ba_seeds = (col.btype == 1) & col.has_ocean & (subduct < 0.50) & g.valid
    arc_seeds = (col.btype == 1) & col.both_ocean & (subduct < 0.45) & g.valid
    all_cells = jnp.ones(npad, bool)
    zero = jnp.zeros(npad, jnp.float32)
    band_hops = max(rift_half, ridge_half, fracture_half, ba_end, max_arc)
    use_gate5 = np.asarray([True, False, False, True, True])
    rgate5 = jnp.where(use_gate5[None, :], rgate_small[:, None], True)
    band_dist, _, band_carry = band_bfs_banded(
        jnp.stack([rift_seeds, ridge_seeds, frac_seeds, ba_seeds,
                   arc_seeds], 1),
        jnp.stack([zero, zero, zero,
                   jnp.where(ba_seeds, stress_n, 0.0),
                   jnp.where(arc_seeds, stress_n, 0.0)], 1)[None],
        *g.bands, max_hops=band_hops,
        hops_cap=np.asarray([rift_half, ridge_half, fracture_half,
                             ba_end, max_arc], np.int32),
        allow=jnp.stack([land_mask, r_is_ocean, r_is_ocean, all_cells,
                         r_is_ocean], 1),
        gate_mix=(gate_small, use_gate5), rem_gate=rgate5,
        num_carry=1)
    rift_dist = band_dist[:, 0]
    ridge_dist = band_dist[:, 1]
    fracture_dist = band_dist[:, 2]
    backarc_dist = band_dist[:, 3]
    backarc_stress = band_carry[0, :, 3]
    arc_dist = band_dist[:, 4]
    arc_stress = band_carry[0, :, 4]

    if trunc == "carry":
        probe = (d_bdry + coast_stress + coast_subduct + coast_convergent
                 + sum(jnp.where(jnp.isfinite(band_dist[:, i]),
                                 band_dist[:, i], 0.0) for i in range(5))
                 + backarc_stress + arc_stress)
        return _probe_result(g, probe, col, stress, subduct)

    # -------- fused assembly --------
    rift_t = nt["rift"]
    fold_t = nt["fold"]
    elev, debug = _main_assembly(
        g.pos, r_is_ocean, stress, subduct, col.btype,
        dist_mountain, dist_ocean, dist_coastline, dist_coast, dist_coast_land,
        rift_dist, ridge_dist, fracture_dist, backarc_dist, backarc_stress,
        max_stress, plate_pole[r_plate],
        noise_t, rift_t, fold_t, jnp.float32(noise_mag),
        warp_oct, interior_band, tectonic_reach, plateau_start,
        rift_half, floor_end, shoulder_end, ridge_half, fracture_half,
        ba_start, ba_peak, ba_end)

    if trunc == "assembly":
        return _probe_result(g, elev, col, stress, subduct)

    # margins debug layer (js/elevation.js:912-917)
    margins = jnp.where(coast_convergent > 0, 0.8, 0.2)
    margins = jnp.where((~jnp.isinf(ridge_dist)) & (ridge_dist <= ridge_half), 1.0, margins)
    margins = jnp.where((~jnp.isinf(fracture_dist)) & (fracture_dist <= fracture_half), -0.5, margins)
    debug["margins"] = jnp.where(r_is_ocean, margins, 0.0)

    # -------- coastal roughening --------
    elev, dl_coastal = _coastal_roughening(
        g.pos, elev, r_is_ocean, stress, max_stress,
        d_bdry, coast_stress, coast_subduct, coast_convergent,
        nt["c1"], nt["c2"], nt["c3"],
        noise_t, jnp.float32(noise_mag),
        coast_roughen_dist=max_cd, island_band=max(4, round(4 * sf_res)))

    # -------- island arcs (band computed above) --------
    elev, dl_arc = _island_arcs(
        g.pos, elev, arc_dist, arc_stress, nt["arc"],
        peak_dist=max(1.5, 1.5 * sf_res), sigma=max(1.5, 1.5 * sf_res),
        max_arc_dist=max_arc)
    debug["coastal"] = dl_coastal + dl_arc

    if trunc == "coastal":
        return _probe_result(g, elev, col, stress, subduct)

    # -------- hotspots --------
    if domes is None:
        centers_plate = np.asarray(r_plate)
        built = build_domes(
            seed, np.asarray(g.pos), centers_plate,
            np.asarray(plate_pole), np.asarray(plate_omega),
            np.asarray(plate_is_ocean), n)
        domes = {k: jnp.asarray(v) for k, v in built.items()}
    if domes:
        hs = hotspot_uplift(g.pos, domes, nt["hs1"], nt["hs2"])
        elev = elev + hs
        debug["hotspot"] = hs
    else:
        debug["hotspot"] = jnp.zeros(npad, jnp.float32)

    # -------- peak compression (js/elevation.js:1377-1382) --------
    elev = jnp.where(elev > 0, jnp.maximum(elev, 1e-20) ** 0.92, elev)
    elev = jnp.where(g.valid, elev, 0.0).astype(jnp.float32)

    if has_super:
        debug["superPlates"] = r_super_plate.astype(jnp.float32)

    return ElevationResult(
        elevation=elev,
        mountain=mountain, coastline=coastline, ocean_seeds=ocean_seeds,
        stress=stress, subduct=subduct, r_is_ocean=r_is_ocean,
        dist_coast_land=dist_coast_land,
        debug=debug,
    )
