"""Hotspot volcanism — mantle plumes with drift-trail chains.

Re-design of reference js/elevation.js:1111-1373: the ~35-85 dome list
(5 hotspots × drift chains) is built on host with the same RNG streams
(seed+999 rng, seed+1001 randInt), then the per-cell accumulation runs as a
device ``lax.scan`` over domes — each step is a fused [N] map (dual Gaussian
peak+swell, drift elongation, rift-ridge boosts, calderas), so no [N, D]
intermediate ever materializes. Domain-warped shape distortion and the
age-dependent ridged texture are computed once per cell outside the scan.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from ..backend import jax
from ..backend import jnp

from ..ops.rng import ParkMiller
from ..ops.noise import Tables, fbm, ridged_fbm

NUM_HOTSPOTS = 5
CHAIN_LENGTH = 6
CHAIN_DECAY = 0.75
CHAIN_SPACING = 0.06
DOME_SIGMA = 0.006
DOME_STRENGTH = 0.60
SWELL_SIGMA_MULT = 2
SWELL_STR_MULT = 0.10
MAX_RIFTS = 3
# Fixed dome-array length: 5 hotspots × (1 + max chain 11) = 60 ≤ 64.
# Padding with inert zero-strength domes keeps hotspot_uplift's jit shape
# stable across seeds (variable D would recompile the kernel per planet).
MAX_DOMES = 64


def build_domes(seed: int, pos: np.ndarray, r_plate,
                plate_pole: np.ndarray, plate_omega: np.ndarray,
                plate_is_ocean: np.ndarray, n_cells: int) -> Dict[str, np.ndarray]:
    """Host dome-list builder (js/elevation.js:1149-1261). Sequential RNG,
    ≤ NUM_HOTSPOTS*(1+chain) entries. Returns dict of [D]-shaped arrays.

    ``r_plate`` is either an int array (plate per cell) or a callable
    ``center_index -> plate`` — the engine passes a host-side coarse-grid
    projection lookup so building domes never reads device arrays. All
    noise here is the numpy mirror (:func:`noise3_np`) for the same reason."""
    from ..ops.noise import make_perm_tables, noise3_np

    hs_rng = ParkMiller(seed + 999)
    hs_randint = ParkMiller(seed + 1001)
    perm503, pm503 = make_perm_tables(seed + 503)
    plate_of = r_plate if callable(r_plate) else (
        lambda c: int(np.asarray(r_plate)[c]))

    def tangent_frame(p, d):
        u = d - (d @ p) * p
        ul = np.linalg.norm(u) or 1.0
        u = u / ul
        v = np.cross(p, u)
        return u, v

    domes = []
    for _ in range(NUM_HOTSPOTS):
        h_strength = DOME_STRENGTH * (0.4 + hs_rng() * 1.2)
        h_sigma = DOME_SIGMA * (0.4 + hs_rng() * 1.2)
        h_decay = CHAIN_DECAY + (hs_rng() - 0.5) * 0.35
        h_length = max(3, CHAIN_LENGTH + round((hs_rng() - 0.5) * 10))

        center = hs_randint.rand_int(n_cells)
        p = pos[center].astype(np.float64)
        plate = int(plate_of(center))
        pole = plate_pole[plate]
        omega = plate_omega[plate]
        drift = omega * np.cross(pole, p)
        dl = np.linalg.norm(drift)
        if dl < 1e-6:
            continue
        drift = drift / dl
        ocean_boost = 1.8 if plate_is_ocean[plate] else 1.0

        base_rift = float(noise3_np(
            perm503, pm503, p[0] * 10, p[1] * 10, p[2] * 10)) * np.pi

        def rift_angles(ci, cl):
            if ci == 0:
                return [base_rift, base_rift + np.pi * 0.6, base_rift - np.pi * 0.6]
            if ci == 1:
                return [base_rift, base_rift + np.pi]
            if ci <= int(cl * 0.4):
                return [base_rift]
            return []

        def push(c, strength, base_strength, sigma, ci):
            u, v = tangent_frame(c, drift)
            ra = rift_angles(ci, h_length)
            domes.append(dict(
                pos=c.copy(), strength=strength, base_strength=base_strength,
                sigma=sigma, chain_index=ci, chain_length=h_length,
                u=u, v=v,
                rift=np.pad(np.asarray(ra, dtype=np.float64),
                            (0, MAX_RIFTS - len(ra))),
                n_rift=len(ra),
            ))

        push(p, h_strength * ocean_boost, h_strength, h_sigma, 0)

        perp = np.cross(drift, p)
        pl = np.linalg.norm(perp) or 1.0
        perp = perp / pl
        c = p.copy()
        s = h_strength * ocean_boost
        bs = h_strength
        for ci in range(1, h_length + 1):
            decay_jitter = h_decay * (0.7 + hs_rng() * 0.6)
            s *= decay_jitter
            bs *= decay_jitter
            step = CHAIN_SPACING * (0.3 + hs_rng() * 1.4)
            age_broadening = 1.0 + ci * 0.06
            step_sigma = h_sigma * (0.5 + hs_rng() * 1.0) * age_broadening
            wobble = (hs_rng() - 0.5) * 0.8
            dd = -drift + perp * wobble
            t = dd - (dd @ c) * c
            tl = np.linalg.norm(t)
            if tl < 1e-6:
                break
            t = t / tl
            c = c * np.cos(step) + t * np.sin(step)
            c = c / np.linalg.norm(c)
            push(c, s, bs, step_sigma, ci)

    if not domes:
        return {}

    # pad with inert domes: strength 0, cos thresholds 2.0 (dot ≤ 1 < 2 so
    # `near` is always False), zero rifts — shape-stable across seeds.
    for _ in range(MAX_DOMES - len(domes)):
        domes.append(dict(
            pos=np.array([0.0, 0.0, 1.0]), strength=0.0, base_strength=0.0,
            sigma=1.0, chain_index=0, chain_length=1,
            u=np.array([1.0, 0.0, 0.0]), v=np.array([0.0, 1.0, 0.0]),
            rift=np.zeros(MAX_RIFTS), n_rift=0, inert=True,
        ))

    def stack(key):
        return np.asarray([d[key] for d in domes])

    inert = np.asarray([bool(d.get("inert")) for d in domes])

    sigma = stack("sigma")
    strength = stack("strength")
    base_strength = stack("base_strength")
    ci = stack("chain_index").astype(np.float64)
    cl = stack("chain_length").astype(np.float64)
    sw_sigma = sigma * SWELL_SIGMA_MULT
    out = dict(
        pos=stack("pos").astype(np.float32),
        u=stack("u").astype(np.float32),
        v=stack("v").astype(np.float32),
        strength=strength.astype(np.float32),
        cos_peak=np.where(inert, 2.0, np.cos(sigma * 5.5)).astype(np.float32),
        inv_s2=(-0.5 / (sigma * sigma)).astype(np.float32),
        swell_strength=(base_strength * SWELL_STR_MULT).astype(np.float32),
        cos_swell=np.where(inert, 2.0, np.cos(sw_sigma * 3)).astype(np.float32),
        inv_s2_swell=(-0.5 / (sw_sigma * sw_sigma)).astype(np.float32),
        caldera_depth=np.where(
            (ci <= 1) & (strength > 0.15), strength * 0.20, 0.0
        ).astype(np.float32),
        inv_s2_caldera=(-0.5 / ((sigma * 0.25) ** 2)).astype(np.float32),
        age=np.where(cl > 0, ci / np.maximum(cl, 1.0), 0.0).astype(np.float32),
        rift=stack("rift").astype(np.float32),
        n_rift=stack("n_rift").astype(np.int32),
    )
    return out


DRIFT_STRETCH = 1.0 / 1.4  # js/elevation.js:1253


@jax.jit
def hotspot_uplift(pos, domes, hs_t: Tables, hs2_t: Tables):
    """Device accumulation over the dome list (lax.scan). Returns [N] uplift."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    n = pos.shape[0]

    # domain-warped shape distortion (js/elevation.js:1283-1293)
    ws = 8.0
    wx = fbm(hs2_t, x * ws + 5.1, y * ws + 3.7, z * ws + 9.2, 2, 0.5) * 0.4
    wy = fbm(hs2_t, x * ws + 11.3, y * ws + 7.1, z * ws + 2.9, 2, 0.5) * 0.4
    wz = fbm(hs2_t, x * ws + 1.7, y * ws + 13.5, z * ws + 6.4, 2, 0.5) * 0.4
    shape_warp = 1.0 + 0.40 * fbm(
        hs_t, (x + wx) * 20 + 3.2, (y + wy) * 20 + 7.8, (z + wz) * 20 + 1.5, 4, 0.5
    )
    shape_warp_sq = shape_warp * shape_warp

    def step(carry, dome):
        total, swell, w_age, age_sum = carry
        dp = dome["pos"]
        dot = x * dp[0] + y * dp[1] + z * dp[2]

        # thermal swell — smooth, unwarped
        sw_ang_sq = 2.0 * (1.0 - dot)
        sw = dome["swell_strength"] * jnp.exp(sw_ang_sq * dome["inv_s2_swell"])
        swell = swell + jnp.where(dot > dome["cos_swell"], sw, 0.0)

        # volcanic peak — warped, elongated along drift
        near = dot >= dome["cos_peak"]
        offx = x - dot * dp[0]
        offy = y - dot * dp[1]
        offz = z - dot * dp[2]
        u, v = dome["u"], dome["v"]
        par = offx * u[0] + offy * u[1] + offz * u[2]
        perp = offx * v[0] + offy * v[1] + offz * v[2]
        sp = par * DRIFT_STRETCH
        angle_sq = sp * sp + perp * perp
        gauss = jnp.exp(angle_sq * shape_warp_sq * dome["inv_s2"])

        # radial rift-zone ridges: cos^4 boost along rift angles
        ang = jnp.arctan2(perp, par)
        rift_boost = jnp.zeros_like(ang)
        for ri in range(MAX_RIFTS):
            da = ang - dome["rift"][ri]
            da = da - jnp.round(da / (2 * jnp.pi)) * 2 * jnp.pi
            c2 = jnp.cos(da)
            rf = c2 * c2 * c2 * c2
            rift_boost = jnp.where(ri < dome["n_rift"],
                                   jnp.maximum(rift_boost, rf), rift_boost)
        gauss = gauss * (1.0 + 0.5 * rift_boost)

        peak = jnp.where(near, dome["strength"] * gauss, 0.0)
        caldera = jnp.where(
            near, dome["caldera_depth"] * jnp.exp(angle_sq * dome["inv_s2_caldera"]), 0.0
        )
        total = total + peak - caldera
        w_age = w_age + dome["age"] * peak
        age_sum = age_sum + peak
        return (total, swell, w_age, age_sum), None

    zeros = jnp.zeros(n, jnp.float32)
    (total, swell, w_age, age_sum), _ = jax.lax.scan(
        step, (zeros, zeros, zeros, zeros), domes
    )

    # age-dependent volcanic texture (js/elevation.js:1354-1369)
    age = jnp.where(age_sum > 0, w_age / jnp.maximum(age_sum, 1e-20), 0.0)
    tex_base = 0.7 * ridged_fbm(hs_t, x * 12, y * 12, z * 12, 4, 2.0, 0.5, 1.0)
    tex_detail = 0.3 * ridged_fbm(hs_t, x * 30, y * 30, z * 30, 3, 2.0, 0.5, 1.0)
    tex_raw = tex_base + tex_detail
    tex_min = 0.4 + age * 0.3
    tex_max = 1.2 - age * 0.2
    volc = tex_min + (tex_max - tex_min) * tex_raw

    combined = swell + total
    uplift = swell + jnp.maximum(0.0, total) * volc
    return jnp.where(combined > 0.001, uplift, 0.0)
