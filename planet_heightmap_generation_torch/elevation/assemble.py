"""Elevation synthesis — distance fields, dual-layer orogeny, the per-cell
land/ocean assembly, coastal roughening, island arcs, hotspots, peak
compression.

Re-design of reference assignElevation (js/elevation.js:216-1391). Every
queue-based BFS becomes a masked propagation sweep (ops/banded.py); the
sequential per-cell loop becomes elementwise torch over [N] tensors with
all branches as ``torch.where`` masks; hotspots accumulate over the dome
list (hotspots.py).

Randomized BFS fronts (js/elevation.js:176-180) are emulated with per-cell
hash-noise hop costs — the same trick the reference itself uses for
priority-flood meander (js/terrain-post.js:96-105).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..mesh.device import DeviceGraph
from ..ops.noise import Tables, tables, noise3, fbm, ridged_fbm
from ..ops.graph import hash01
from ..parallel import spmd
from ..pipeline.timing import span
from ..ops.banded import (bfs_hops_multi_banded, band_gate, rem_gate_eq,
                          propagate_stress_banded, band_bfs_banded,
                          banded_sum)
from .collisions import CollisionResult, find_collisions
from .hotspots import hotspot_uplift

SMALL_W = 0.05   # js/elevation.js:254-255
SUPER_W = 0.95
BASE_SCALE = 0.6
INF = float("inf")
PHASES = ("stress", "bfs5", "carry", "assembly", "coastal")


def distance_bfs_caps(sf_res: float):
    """(interior_band, tectonic_reach, h_far, bfs_hops) for the distance
    BFS. The saturation cap ``h_far`` must dominate every consumer's
    branch point (``tectonic_reach = 20·sf_res`` exceeds ``interior_band =
    16·sf_res``, js/elevation.js:757-765, 866-887), or saturated far-field
    cells would carry a spurious raw_prox floor across continental
    interiors."""
    interior_band = max(4, round(16 * sf_res))
    tectonic_reach = max(6, round(20 * sf_res))
    h_far = float(max(interior_band, tectonic_reach, 48))
    bfs_hops = int(math.ceil(1.3 * h_far)) + 2
    return interior_band, tectonic_reach, h_far, bfs_hops


# the seed offset of each noise table the elevation stage consumes
ELEVATION_TABLE_OFFSETS = dict(base=0, rift=419, fold=557, c1=77, c2=133,
                               c3=211, arc=307, hs1=501, hs2=502)


def elevation_tables(seed: int, device="cpu") -> Dict[str, Tables]:
    """All seed-derived noise tables the elevation stage consumes."""
    return {k: tables(seed + o, device)
            for k, o in ELEVATION_TABLE_OFFSETS.items()}


class ElevationResult(NamedTuple):
    elevation: torch.Tensor        # [N] f32
    mountain: torch.Tensor         # [N] bool (seed masks, post-blend)
    coastline: torch.Tensor
    ocean_seeds: torch.Tensor
    stress: torch.Tensor
    subduct: torch.Tensor
    r_is_ocean: torch.Tensor       # [N] bool plate-level ocean flag
    dist_coast_land: torch.Tensor  # [N] f32
    debug: Dict[str, torch.Tensor]


def _blend_collisions(small: CollisionResult, sup: CollisionResult):
    """Dual-layer orogeny blend, SMALL_W/SUPER_W (js/elevation.js:249-327)."""
    mountain = sup.mountain | small.mountain
    ocean = sup.ocean | small.ocean
    coastline = (sup.coastline | small.coastline) & (~mountain)

    max_super = spmd.gathered(torch.max, sup.stress)
    inv_max = torch.where(max_super > 1e-6, 1.0 / max_super, 0.0)
    proximity = torch.clamp(sup.stress * inv_max * 3.0, max=1.0)
    eff_small = SMALL_W * (SMALL_W + (1.0 - SMALL_W) * proximity)
    stress = eff_small * small.stress + SUPER_W * sup.stress

    w_s = SMALL_W * small.stress
    w_p = SUPER_W * sup.stress
    total = w_s + w_p
    subduct = torch.where(
        total > 1e-6,
        (w_s * small.subduct + w_p * sup.subduct)
        / torch.clamp(total, min=1e-20),
        SMALL_W * small.subduct + SUPER_W * sup.subduct)
    btype = torch.where(w_s > w_p, small.btype, sup.btype)
    return CollisionResult(
        mountain=mountain, coastline=coastline, ocean=ocean,
        stress=stress, subduct=subduct, btype=btype,
        both_ocean=small.both_ocean | sup.both_ocean,
        has_ocean=small.has_ocean | sup.has_ocean)


def _blend_propagated(small_stress, small_sf, super_stress, super_sf,
                      subduct):
    stress = SMALL_W * small_stress + SUPER_W * super_stress
    w_s = SMALL_W * small_stress
    w_p = SUPER_W * super_stress
    total = w_s + w_p
    sf = torch.where(
        total > 1e-6,
        (w_s * small_sf + w_p * super_sf) / torch.clamp(total, min=1e-20),
        subduct)
    return stress, sf


def _plate_reps(r_plate, in_any_seed, valid, plate_is_ocean, coastline,
                ocean, num_plates: int):
    """Each plate's interior gets a representative seed cell (min index
    not already in a seed set), added to ocean/coastline by plate type
    (js/elevation.js:365-382)."""
    n = r_plate.shape[0]
    cand = valid & (~in_any_seed)
    idx = torch.where(cand, torch.arange(n, device=r_plate.device), n)
    rep = torch.full((num_plates,), n, dtype=torch.int64,
                     device=r_plate.device).scatter_reduce(
        0, r_plate.long(), idx, "amin")
    exists = rep < n
    ocean, coastline = ocean.clone(), coastline.clone()
    ocean[rep[exists & plate_is_ocean]] = True
    coastline[rep[exists & (~plate_is_ocean)]] = True
    return ocean, coastline


def _stress_p97(stress, valid):
    """97th percentile of stress values > 0.01 (js/elevation.js:443-453)."""
    mask = (stress > 0.01) & valid
    cnt = mask.sum().to(torch.int32)
    vals = torch.sort(torch.where(mask, stress, INF)).values
    idx = torch.minimum(cnt - 1, torch.floor(cnt * 0.97).to(torch.int32))
    p97 = vals[torch.clamp(idx, 0, stress.shape[0] - 1)]
    raw_max = torch.max(torch.where(valid, stress, 0.0))
    out = torch.where(cnt > 0, p97, raw_max)
    return torch.where(out < 0.01, 1.0, out)


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
    inv_a = torch.where(torch.isinf(a), 0.0, 1.0 / a)
    inv_b = torch.where(torch.isinf(b), 0.0, 1.0 / b)
    inv_c = torch.where(torch.isinf(c), 0.0, 1.0 / c)
    no_field = torch.isinf(dist_mountain) & torch.isinf(dist_ocean)
    denom = inv_a + inv_b + inv_c
    return torch.where(
        no_field, 0.1 * BASE_SCALE,
        torch.where(denom > 0,
                  (inv_a - inv_b) / torch.clamp(denom, min=1e-20) * BASE_SCALE,
                  0.1 * BASE_SCALE),
    )


def ocean_floor_profile(dist_coast, abyss_noise):
    """Fixed-breakpoint ocean depth profile (js/elevation.js:896-909):
    shelf −0.04→−0.10 over hops 0-5, slope −0.10→−0.35 over hops 5-12,
    abyssal plain −0.35 + fbm·0.03 beyond (``abyss_noise`` is the
    already-scaled noise term). Extracted for the golden tests."""
    dc = dist_coast
    return torch.where(
        dc < 5, -0.04 - 0.06 * (dc / 5),
        torch.where(dc < 12, -0.10 - 0.25 * ((dc - 5) / 7),
                  -0.35 + abyss_noise))


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

    stress_norm = torch.clamp(stress / max_stress, max=1.0)

    # domain warp coordinates (:662-664)
    wx = x + warp_scale * fbm(noise_t, x + 5.3, y + 1.7, z + 3.1, warp_octaves)
    wy = y + warp_scale * fbm(noise_t, x + 8.1, y + 2.9, z + 7.3, warp_octaves)
    wz = z + warp_scale * fbm(noise_t, x + 1.4, y + 6.2, z + 4.8, warp_octaves)

    # orogenic power (:669-672)
    raw_oro = noise3(noise_t, x * 1.5 + 33.7, y * 1.5 + 11.2, z * 1.5 + 22.9)
    shaped = torch.sign(raw_oro) * torch.sqrt(torch.abs(raw_oro))
    orogenic = torch.clamp(0.5 + 0.5 * shaped, 0.0, 1.0)

    land = ~r_is_ocean

    # ================= LAND STACK =================
    # subduction suppression (:678-681)
    suppression = torch.clamp((sf - 0.5) * 2.0, min=0.0)
    elev_l = torch.where((sf > 0.5) & (elev > 0), elev * (1 - suppression * 0.42), elev)

    # stress uplift/depress with height variation (:683-689)
    stress_mag = stress_norm * stress_norm * 0.55 * orogenic
    uplift = stress_mag * (1 - sf)
    depress = stress_mag * 0.4 * sf
    height_var = 0.60 + 0.8 * fbm(noise_t, x * 8 + 13.7, y * 8 + 9.2, z * 8 + 4.5, 3)
    elev_l = elev_l + torch.where(stress_norm > 0.01, (uplift - depress) * height_var, 0.0)

    # foreland basin dip (:691-694)
    foreland_t = stress_norm / 0.10
    elev_l = elev_l - torch.where(
        (stress_norm > 0) & (stress_norm < 0.10), 0.06 * (1 - foreland_t), 0.0)

    # rift valley graben profile (:696-727)
    rd = rift_dist
    rift_ridged = ridged_fbm(rift_t, x * 8, y * 8, z * 8, 3)
    t_floor = rd / floor_end
    t_shoulder = (rd - floor_end) / max(1e-6, shoulder_end - floor_end)
    t_fade = torch.clamp((rd - shoulder_end) / max(1e-6, rift_half - shoulder_end), max=1.0)
    fade = t_fade * t_fade * (3 - 2 * t_fade)
    rift_effect = torch.where(
        rd <= 0.5, -0.15 + rift_ridged * 0.04,
        torch.where(
            rd <= floor_end, -0.12 * (1 - t_floor * 0.3) + rift_ridged * 0.03 * (1 - t_floor),
            torch.where(
                rd <= shoulder_end, 0.03 * (1 - t_shoulder),
                (0.03 * (1 - fade) * 0.2) if rift_half > shoulder_end else 0.0,
            ),
        ),
    )
    elev_l = elev_l + torch.where(torch.isinf(rd), 0.0, rift_effect)

    # back-arc basin depression (:729-753) — shared with ocean stack
    bad = backarc_dist
    d_mtn = dist_mountain
    orogeny_factor = torch.where(
        (~torch.isinf(d_mtn)) & (d_mtn < bad),
        torch.clamp(d_mtn / torch.clamp(bad, min=1e-20), min=0.0), 1.0)
    t_ba1 = (bad - ba_start) / max(1, ba_peak - ba_start)
    s_ba1 = t_ba1 * t_ba1 * (3 - 2 * t_ba1)
    t_ba2 = (bad - ba_peak) / max(1, ba_end - ba_peak)
    s_ba2 = t_ba2 * t_ba2 * (3 - 2 * t_ba2)
    ba_effect = torch.where(
        torch.isinf(bad) | (bad < ba_start), 0.0,
        torch.where(bad <= ba_peak, -0.10 * backarc_stress * s_ba1 * orogeny_factor,
                  torch.where(bad <= ba_end,
                            -0.10 * backarc_stress * (1 - s_ba2) * orogeny_factor,
                            0.0)))
    elev_l = elev_l + ba_effect
    dl_tectonic_land = elev_l - base

    # tectonic activity (:757-765)
    raw_prox = torch.where(
        torch.isinf(d_mtn) | (d_mtn >= tectonic_reach), 0.0, 1 - d_mtn / tectonic_reach)
    tec_activity = torch.maximum(stress_norm, raw_prox * raw_prox)

    # fold ridges (:767-799)
    fold_activity = tec_activity * tec_activity
    pp = plate_pole_of_cell
    u_fold = x * pp[:, 0] + y * pp[:, 1] + z * pp[:, 2]
    phase_warp = fbm(fold_t, x * 3 + 55.3, y * 3 + 33.7, z * 3 + 17.2, 2) * 0.08
    FOLD_FREQ = 30.0
    phase = (u_fold + phase_warp) * FOLD_FREQ * torch.pi
    ridge_f = 1 - torch.abs(torch.sin(phase))
    fold_centered = ridge_f - 0.36
    amp_mod = 0.6 + 0.4 * fbm(fold_t, x * 4 + 88.1, y * 4 + 62.3, z * 4 + 41.7, 2)
    elev_boost = 1 + 4 * torch.clamp(elev_l, min=0.0)
    fold_amp = fold_activity * torch.clamp(1 - sf * 1.5, min=0.0) * noise_mag * 0.8 * elev_boost
    fold_contrib = torch.where(fold_activity > 0.01, fold_centered * fold_amp * amp_mod, 0.0)
    elev_l = elev_l + fold_contrib

    # plateau zone flag (:801-802)
    is_plateau = (sf < 0.45) & (~torch.isinf(d_mtn)) & (d_mtn > plateau_start)

    # tectonic-activity-scaled noise stack (:804-823)
    blend = torch.clamp(stress_norm * 3, max=1.0)
    smooth_noise = fbm(noise_t, wx, wy, wz) * noise_mag
    ridged_noise = ridged_fbm(noise_t, wx, wy, wz) * noise_mag * 1.5
    noise_val = smooth_noise * (1 - blend) + ridged_noise * blend
    detail = fbm(noise_t, wx * 4 + 22.1, wy * 4 + 6.8, wz * 4 + 15.4, 4, 0.5) * noise_mag * 0.5
    noise_activity = torch.clamp(stress_norm * 4, max=1.0)
    plateau_suppress = torch.where(
        is_plateau, torch.clamp(1 - tec_activity * 0.60, min=0.30), 1.0)
    noise_scale = (0.25 + 0.75 * noise_activity) * plateau_suppress
    fine = fbm(noise_t, wx * 8 + 41.7, wy * 8 + 13.2, wz * 8 + 27.9, 3, 0.5) * noise_mag * 0.25
    fine_scale = torch.sqrt(noise_scale)
    total_noise = (noise_val + detail) * noise_scale + fine * fine_scale
    elev_l = elev_l + total_noise
    dl_noise_land = total_noise

    # mountain dissection (:829-842)
    DISSECT_THRESHOLD = 0.12
    excess_d = elev_l - DISSECT_THRESHOLD
    dissect_val = fbm(noise_t, wx * 16 + 71.3, wy * 16 + 44.8, wz * 16 + 29.1, 3, 0.5)
    dissect = torch.where(
        elev_l > DISSECT_THRESHOLD,
        dissect_val * torch.sqrt(torch.clamp(excess_d, min=0.0)) * stress_norm * noise_mag * 0.4,
        0.0)
    elev_l = elev_l + dissect
    dl_noise_land = dl_noise_land + dissect

    # summit peaks (:844-863)
    SUMMIT_THRESHOLD = 0.65
    peak_noise = ridged_fbm(noise_t, wx * 24 + 91.3, wy * 24 + 55.7, wz * 24 + 38.2, 3, 0.5)
    spike = torch.clamp(peak_noise - 0.45, min=0.0)
    peak_contrib = torch.where(
        (elev_l > SUMMIT_THRESHOLD) & (stress_norm > 0.2),
        spike * (elev_l - SUMMIT_THRESHOLD) * stress_norm * 1.2, 0.0)
    elev_l = elev_l + peak_contrib
    dl_noise_land = dl_noise_land + peak_contrib

    # continental interior uplift (:866-887)
    lcd = dist_coast_land
    t_down = torch.clamp(lcd / interior_band, max=1.0)
    s_down = t_down * t_down * (3 - 2 * t_down)
    t_up = torch.clamp(lcd / (interior_band * 0.4), max=1.0)
    s_up = t_up * t_up * (3 - 2 * t_up)
    interior_uplift = 0.06 + tec_activity * 0.16
    base_bias = -0.08 * (1 - s_down) + interior_uplift * s_up
    mod = 1.0 + 0.2 * fbm(noise_t, x * 2 + 19.3, y * 2 + 7.6, z * 2 + 13.1, 2)
    bias = torch.where(torch.isinf(lcd), 0.0, base_bias * mod)
    elev_l = elev_l + bias
    dl_interior = bias

    # plateau boost (:889-894)
    plateau_boost = torch.where(
        is_plateau & (tec_activity > 0.1), 0.025 * tec_activity * (1 - sf), 0.0)
    elev_l = elev_l + plateau_boost
    dl_interior = dl_interior + plateau_boost

    # ================= OCEAN STACK =================
    dc = dist_coast
    abyss_noise = fbm(noise_t, x * 2, y * 2, z * 2, 3) * 0.03
    ocean_base = ocean_floor_profile(dc, abyss_noise)
    elev_o = torch.minimum(base, ocean_base)
    dl_ocean = elev_o
    elev_before_oc = elev_o

    # mid-ocean ridge (:921-929)
    rdg = ridge_dist
    t_r = rdg / ridge_half
    ridge_fade = (1 - t_r) * (1 - t_r)
    ridge_n = ridged_fbm(noise_t, x * 3, y * 3, z * 3, 4)
    elev_o = elev_o + torch.where(
        (~torch.isinf(rdg)) & (rdg <= ridge_half),
        (0.12 * ridge_n + 0.06) * ridge_fade, 0.0)

    # fracture zones (:931-937)
    fd = fracture_dist
    elev_o = elev_o - torch.where(
        (~torch.isinf(fd)) & (fd <= fracture_half),
        0.03 * (1 - fd / fracture_half), 0.0)

    # trenches (:939-942)
    elev_o = elev_o - torch.where(btype == 1, 0.15 + 0.15 * stress_norm, 0.0)

    # back-arc deepening (:944-965) — same profile as land
    elev_o = elev_o + ba_effect
    dl_tectonic_ocean = elev_o - elev_before_oc

    ocean_noise = fbm(noise_t, wx, wy, wz) * noise_mag * 0.3
    elev_o = elev_o + ocean_noise

    # ================= merge =================
    elev_out = torch.where(land, elev_l, elev_o)
    debug = dict(
        base=dl_base,
        tectonic=torch.where(land, dl_tectonic_land, dl_tectonic_ocean),
        noise=torch.where(land, dl_noise_land, ocean_noise),
        interior=torch.where(land, dl_interior, 0.0),
        ocean=torch.where(land, 0.0, dl_ocean),
        tecActivity=torch.where(land, tec_activity, 0.0),
        backArc=ba_effect,
        foldRidge=torch.where(land, fold_contrib, 0.0),
        orogenicPower=orogenic - 0.5,
    )
    return elev_out, debug


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
    sn = torch.clamp(torch.maximum(coast_stress, stress / max_stress), max=1.0)

    is_sub_ocean = r_is_ocean & (coast_convergent > 0) & (coast_subduct > 0.45)
    sub_sup = torch.where(
        is_sub_ocean, torch.clamp((coast_subduct - 0.45) / 0.55, max=1.0), 0.0)
    passive = coast_convergent == 0

    # layer 1: coastal fractal noise
    falloff1 = (1 - t) * (1 - t)
    stress_amp = 1 + sn * 5
    freq = torch.where(passive, 12.0, 18.0)
    amp = torch.where(passive, 0.08, 0.12)
    n1 = fbm(c1_t, x * freq + 3.7, y * freq + 7.1, z * freq + 2.3, 5, 0.55)
    cn1 = n1 * amp * falloff1 * stress_amp
    cn1 = torch.where((sub_sup > 0) & (cn1 > 0), cn1 * (1 - sub_sup), cn1)
    delta = torch.where(in_range, cn1, 0.0)

    # layer 3: coastline-aware domain warping
    warp_reach = torch.where(passive, 1.2, 1.5)
    falloff_w = torch.clamp(1 - t * warp_reach, min=0.0)
    warp_amt = 0.35 * falloff_w * (1 + sn * 2)
    dwx = fbm(c3_t, x * 6 + 11.3, y * 6 + 4.7, z * 6 + 8.2, 3, 0.6) * warp_amt
    dwy = fbm(c3_t, x * 6 + 2.9, y * 6 + 9.4, z * 6 + 1.6, 3, 0.6) * warp_amt
    dwz = fbm(c3_t, x * 6 + 7.5, y * 6 + 0.3, z * 6 + 5.9, 3, 0.6) * warp_amt
    orig_n = fbm(noise_t, x, y, z) * noise_mag
    warp_n = fbm(noise_t, x + dwx, y + dwy, z + dwz) * noise_mag
    wd = (warp_n - orig_n) * falloff_w
    wd = torch.where((sub_sup > 0) & (wd > 0), wd * (1 - sub_sup), wd)
    delta = delta + torch.where(in_range & (falloff_w > 0), wd, 0.0)

    # layer 2: island scattering
    island_n = fbm(c2_t, x * 35 + 5.1, y * 35 + 9.3, z * 35 + 2.7, 4, 0.5)
    thr = 0.25 - sn * 0.2
    excess = (island_n - thr) / (1 - thr)
    dist_fade = 1 - d_bdry / island_band
    bump = excess * excess * 0.18 * (1 + sn * 2) * dist_fade * (1 - sub_sup / 0.3)
    island_ok = (
        in_range & r_is_ocean & (d_bdry > 0) & (d_bdry <= island_band)
        & (sub_sup < 0.3) & (island_n > thr))
    delta = delta + torch.where(island_ok, bump, 0.0)

    return elev + delta, delta


def _island_arcs(pos, elev, arc_dist, arc_stress, arc_t: Tables,
                 peak_dist: float, sigma: float, max_arc_dist: int):
    """O-O convergent overriding-side island arcs (js/elevation.js:1054-1107)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    d = arc_dist
    ok = (d >= 1) & (d <= max_arc_dist)
    dist_w = torch.exp(-0.5 * ((d - peak_dist) / sigma) ** 2)
    n = ridged_fbm(arc_t, x * 4, y * 4, z * 4, 4, 2.0, 0.5, 1.0)
    thr = 0.30
    excess = (n - thr) / (1 - thr)
    uplift = torch.where(
        ok & (n > thr), excess * excess * 0.55 * dist_w * (0.5 + arc_stress), 0.0)
    return elev + uplift, uplift


def _probe_result(g, probe, col, stress, subduct):
    """Truncated result for assign_elevation(trunc=...): the elevation
    slot carries a cheap reduction over the phase's outputs."""
    z = torch.zeros(g.n_padded, device=g.device)
    return ElevationResult(
        elevation=probe.to(torch.float32),
        mountain=col.mountain, coastline=col.coastline,
        ocean_seeds=col.ocean, stress=stress, subduct=subduct,
        r_is_ocean=torch.zeros(g.n_padded, dtype=torch.bool, device=g.device),
        dist_coast_land=z, debug={"hotspot": z})


def assign_elevation(
    g: DeviceGraph,
    r_plate: torch.Tensor,
    plate_is_ocean, plate_pole, plate_omega, plate_density,
    seed: int, noise_mag: float, spread: float = 5.0,
    r_super_plate: Optional[torch.Tensor] = None,
    super_is_ocean=None, super_pole=None, super_omega=None,
    super_density=None,
    noise_pack: Optional[Dict[str, Tables]] = None,
    domes: Optional[Dict[str, torch.Tensor]] = None,
    trunc: Optional[str] = None,
) -> ElevationResult:
    """Full elevation synthesis (js/elevation.js:216-1391).

    ``noise_pack`` (see :func:`elevation_tables`) and ``domes``
    (hotspots.build_domes as tensors) are host prologue products; an empty
    or missing ``domes`` means no hotspots. ``seed`` only salts the
    per-cell hash costs.

    ``trunc`` stops after the named phase ('stress' | 'bfs5' | 'carry' |
    'assembly' | 'coastal') and returns a probe ElevationResult whose
    elevation is a reduction over that phase's outputs — the same probes
    as the JAX function's, so the two can be compared phase by phase."""
    n = g.n_cells
    npad = g.n_padded
    dev = g.device
    dt = 1e-2 / max(1.0, math.sqrt(n / 10000.0))
    undul_oct = 2 if n > 200000 else 3
    warp_oct = 2 if n > 200000 else 3
    sf_res = math.sqrt(n / 10000.0)
    nt = noise_pack if noise_pack is not None else elevation_tables(seed, dev)
    noise_t = nt["base"]
    noise_mag = torch.tensor(noise_mag, dtype=torch.float32, device=dev)

    with span("Elevation: collisions"):
        small = find_collisions(g, r_plate, plate_is_ocean, plate_pole,
                                plate_omega, plate_density, noise_t, dt,
                                undul_oct)
        has_super = r_super_plate is not None
        if has_super:
            sup = find_collisions(g, r_super_plate, super_is_ocean, super_pole,
                                  super_omega, super_density, noise_t, dt,
                                  undul_oct)
            col = _blend_collisions(small, sup)
        else:
            col = small

    # stress propagation (js/elevation.js:329-362) — small + super layers
    with span("Elevation: stress propagation"):
        base_decay = 0.5 + spread * 0.04
        decay = base_decay ** (1 / sf_res)
        sub_decay = (base_decay * 0.45) ** (1 / sf_res)
        num_passes = max(1, round(spread * 3 * sf_res))

        rp = r_plate.long()
        gate_small = band_gate(r_plate, g.band_off, g.band_mask)
        rgate_small = rem_gate_eq(r_plate, g.rem_src, g.rem_dst)
        if has_super:
            rs = r_super_plate.long()
            st2, sf2 = propagate_stress_banded(
                torch.stack([small.stress, sup.stress], 1),
                torch.stack([small.subduct, sup.subduct], 1),
                (gate_small,
                 band_gate(r_super_plate, g.band_off, g.band_mask)),
                torch.stack([rgate_small,
                             rem_gate_eq(r_super_plate, g.rem_src,
                                         g.rem_dst)], 1),
                torch.stack([plate_is_ocean[rp], super_is_ocean[rs]], 1),
                *g.bands, decay, sub_decay, num_passes)
            stress, subduct = _blend_propagated(
                st2[:, 0], sf2[:, 0], st2[:, 1], sf2[:, 1], col.subduct)
        else:
            st2, sf2 = propagate_stress_banded(
                col.stress[:, None], col.subduct[:, None],
                (gate_small,), rgate_small[:, None],
                plate_is_ocean[rp][:, None],
                *g.bands, decay, sub_decay, num_passes)
            stress, subduct = st2[:, 0], sf2[:, 0]

    if trunc == "stress":
        return _probe_result(g, stress + subduct, col, stress, subduct)

    with span("Elevation: seeds and masks"):
        mountain, coastline, ocean_seeds = (col.mountain, col.coastline,
                                            col.ocean)

        # plate interior representatives
        in_any = mountain | coastline | ocean_seeds
        ocean_seeds, coastline = spmd.gathered(
            lambda rp, seeds, valid, co, oc: _plate_reps(
                rp, seeds, valid, plate_is_ocean, co, oc,
                num_plates=int(plate_is_ocean.shape[0])),
            r_plate, in_any, g.valid, coastline, ocean_seeds)

        stress_mountain = mountain & (subduct < 0.55)
        stop_r = stress_mountain | coastline | ocean_seeds

        idx = spmd.arange(npad, device=dev)

        def rand_cost(k):
            return 0.5 + hash01(idx, seed + k)

        r_is_ocean = plate_is_ocean[rp] & g.valid
        land_mask = (~r_is_ocean) & g.valid
        land_nb_cnt = banded_sum(land_mask.to(torch.float32), *g.bands)
        ocean_nb_cnt = banded_sum(r_is_ocean.to(torch.float32), *g.bands)
        coast_seeds = r_is_ocean & (land_nb_cnt > 0)
        no_barrier = torch.zeros(npad, dtype=torch.bool, device=dev)
        land_coast_seeds = land_mask & (ocean_nb_cnt > 0)

    # the four long-range distance fields (js/elevation.js:365-427) relax
    # together, hop-capped at bfs_hops sweeps (every consumer saturates at
    # h_far); dist_coast (branches at 5/12 hops) runs its own shorter loop
    with span("Elevation: distance BFS"):
        interior_band, tectonic_reach, h_far, bfs_hops = \
            distance_bfs_caps(sf_res)
        dists = bfs_hops_multi_banded(
            torch.stack([stress_mountain, ocean_seeds, coastline,
                         land_coast_seeds], 1),
            torch.stack([ocean_seeds, coastline, stop_r, r_is_ocean], 1),
            *g.bands, max_hops=bfs_hops,
            rand_cost=torch.stack([rand_cost(k) for k in (1, 2, 3, 5)], 1))
    with span("Elevation: coast distance BFS"):
        dists_dc = bfs_hops_multi_banded(
            coast_seeds[:, None], no_barrier[:, None],
            *g.bands, max_hops=min(bfs_hops, 28),
            rand_cost=rand_cost(4)[:, None])

        def _saturate(d, seed_col, barrier, cap):
            # finite → clamp at cap; capped-out → cap (unless a barrier cell or
            # the field has no seeds at all)
            far = torch.where(barrier | ~spmd.gathered(torch.any, seed_col),
                              INF, cap)
            return torch.where(torch.isfinite(d), torch.clamp(d, max=cap),
                               far).to(torch.float32)

        dist_mountain = _saturate(dists[:, 0], stress_mountain, ocean_seeds,
                                  h_far)
        dist_ocean = _saturate(dists[:, 1], ocean_seeds, coastline, h_far)
        dist_coastline = _saturate(dists[:, 2], coastline, stop_r, h_far)
        dist_coast = dists_dc[:, 0]
        dist_coast_land = _saturate(dists[:, 3], land_coast_seeds, r_is_ocean,
                                    float(interior_band + 1))

    if trunc == "bfs5":
        probe = sum(torch.where(torch.isfinite(dists[:, i]), dists[:, i], 0.0)
                    for i in range(4))
        probe = probe + torch.where(torch.isfinite(dists_dc[:, 0]),
                                    dists_dc[:, 0], 0.0)
        return _probe_result(g, probe, col, stress, subduct)

    with span("Elevation: coast carry BFS"):
        max_stress = spmd.gathered(_stress_p97, stress, g.valid)

        # structural band widths (js/elevation.js:429-438, 460, 475, 512, 543,
        # 571, 601-603, 1057)
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
        coast_bdry = torch.where(r_is_ocean, land_nb_cnt > 0,
                                 ocean_nb_cnt > 0) & g.valid
        stress_n = torch.clamp(stress / max_stress, max=1.0)
        carried0 = torch.stack([
            torch.where(coast_bdry, stress_n, 0.0),
            torch.where(coast_bdry, subduct, 0.0),
            torch.where(coast_bdry, (col.btype == 1).to(torch.float32), 0.0),
        ])
        d_bdry2, _, carried = band_bfs_banded(
            coast_bdry[:, None], carried0[:, :, None], *g.bands,
            max_hops=max_cd, tie=carried0[0][:, None], num_carry=3)
        d_bdry = torch.where(torch.isinf(d_bdry2[:, 0]), max_cd + 1.0,
                             d_bdry2[:, 0])
        coast_stress, coast_subduct, coast_convergent = (
            carried[0, :, 0], carried[1, :, 0], carried[2, :, 0])

    # rift / ridge / fracture / back-arc / island-arc carry BFS — five
    # structural bands in one loop
    with span("Elevation: structural carry BFS"):
        rift_seeds = (col.btype == 2) & (~col.has_ocean) & g.valid
        ridge_seeds = (col.btype == 2) & col.both_ocean & g.valid
        frac_seeds = (col.btype == 3) & col.both_ocean & g.valid
        ba_seeds = ((col.btype == 1) & col.has_ocean & (subduct < 0.50)
                    & g.valid)
        arc_seeds = ((col.btype == 1) & col.both_ocean & (subduct < 0.45)
                     & g.valid)
        all_cells = torch.ones(npad, dtype=torch.bool, device=dev)
        zero = torch.zeros(npad, device=dev)
        band_hops = max(rift_half, ridge_half, fracture_half, ba_end, max_arc)
        use_gate5 = (True, False, False, True, True)
        rgate5 = torch.stack([rgate_small if u
                              else torch.ones_like(rgate_small)
                              for u in use_gate5], 1)
        band_dist, _, band_carry = band_bfs_banded(
            torch.stack([rift_seeds, ridge_seeds, frac_seeds, ba_seeds,
                         arc_seeds], 1),
            torch.stack([zero, zero, zero,
                         torch.where(ba_seeds, stress_n, 0.0),
                         torch.where(arc_seeds, stress_n, 0.0)], 1)[None],
            *g.bands, max_hops=band_hops,
            hops_cap=(rift_half, ridge_half, fracture_half, ba_end, max_arc),
            allow=torch.stack([land_mask, r_is_ocean, r_is_ocean, all_cells,
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
                 + sum(torch.where(torch.isfinite(band_dist[:, i]),
                                   band_dist[:, i], 0.0) for i in range(5))
                 + backarc_stress + arc_stress)
        return _probe_result(g, probe, col, stress, subduct)

    # -------- per-cell assembly --------
    with span("Elevation: assembly"):
        elev, debug = _main_assembly(
            g.pos, r_is_ocean, stress, subduct, col.btype,
            dist_mountain, dist_ocean, dist_coastline, dist_coast,
            dist_coast_land,
            rift_dist, ridge_dist, fracture_dist, backarc_dist, backarc_stress,
            max_stress, plate_pole[rp],
            noise_t, nt["rift"], nt["fold"], noise_mag,
            warp_oct, interior_band, tectonic_reach, plateau_start,
            rift_half, floor_end, shoulder_end, ridge_half, fracture_half,
            ba_start, ba_peak, ba_end)

    if trunc == "assembly":
        return _probe_result(g, elev, col, stress, subduct)

    with span("Elevation: coastal roughening and island arcs"):
        # margins debug layer (js/elevation.js:912-917)
        margins = torch.where(coast_convergent > 0, 0.8, 0.2)
        margins = torch.where((~torch.isinf(ridge_dist))
                              & (ridge_dist <= ridge_half), 1.0, margins)
        margins = torch.where((~torch.isinf(fracture_dist))
                              & (fracture_dist <= fracture_half), -0.5,
                              margins)
        debug["margins"] = torch.where(r_is_ocean, margins, 0.0)

        # -------- coastal roughening --------
        elev, dl_coastal = _coastal_roughening(
            g.pos, elev, r_is_ocean, stress, max_stress,
            d_bdry, coast_stress, coast_subduct, coast_convergent,
            nt["c1"], nt["c2"], nt["c3"], noise_t, noise_mag,
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
    with span("Elevation: hotspots and peaks"):
        if domes:
            hs = hotspot_uplift(g.pos, domes, nt["hs1"], nt["hs2"])
            elev = elev + hs
            debug["hotspot"] = hs
        else:
            debug["hotspot"] = torch.zeros(npad, device=dev)

        # -------- peak compression (js/elevation.js:1377-1382) --------
        elev = torch.where(elev > 0, torch.clamp(elev, min=1e-20) ** 0.92,
                           elev)
        elev = torch.where(g.valid, elev, 0.0).to(torch.float32)

        if has_super:
            debug["superPlates"] = r_super_plate.to(torch.float32)

    return ElevationResult(
        elevation=elev,
        mountain=mountain, coastline=coastline, ocean_seeds=ocean_seeds,
        stress=stress, subduct=subduct, r_is_ocean=r_is_ocean,
        dist_coast_land=dist_coast_land,
        debug=debug)
