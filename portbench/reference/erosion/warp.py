"""Terrain domain warp — tangent-frame FBM displacement with a banded
nearest-cell search.

Re-design of reference warpTerrain (js/terrain-post.js:233-309). The
reference walks the mesh greedily per cell (sequential, unbounded). A
per-cell walk on TPU would chain dozens of arbitrary-index gathers, so the
search runs as banded candidate propagation instead: every cell carries its
best "source cell" candidate (index + position); each sweep it adopts any
neighbor's candidate that lies closer to its own warped target point. After
k sweeps cell i has considered every cell within k hops, so ``max_steps``
sweeps (displacement / spacing + slack) finds the exact nearest cell in the
displacement ball — all through roll shifts (ops/banded), with one final
[N] gather to fetch the warped elevation.
"""

from __future__ import annotations

from functools import partial

from ..backend import jax
from ..backend import jnp

from ..ops.noise import Tables, fbm
from ..ops.banded import band_shift, _rem_real


def warp_terrain(elev, pos, valid, band_off, band_mask, rem_src, rem_dst,
                 noise_t: Tables, strength, hotspot, max_steps: int):
    """The domain warp: each cell merges in the elevation of the cell
    nearest its warped target, found by candidate propagation."""
    return _warp_terrain_jnp(elev, pos, valid, band_off, band_mask, rem_src, rem_dst,
                noise_t, strength, hotspot, max_steps)


def _warp_targets(pos, noise_t, strength):
    """Tangent-frame FBM displacement targets w [N,3]
    (js/terrain-post.js:249-289)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    freq, octaves = 4.0, 5
    max_amp = 0.12 * strength

    # tangent frame (east/north), poles fall back to x
    ex, ez = -z, x
    elen = jnp.sqrt(ex * ex + ez * ez)
    ok = elen > 1e-10
    ex = jnp.where(ok, ex / jnp.maximum(elen, 1e-20), 1.0)
    ez = jnp.where(ok, ez / jnp.maximum(elen, 1e-20), 0.0)
    nx = y * ez
    ny = z * ex - x * ez
    nz = -y * ex
    nlen = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    nlen = jnp.where(nlen == 0, 1.0, nlen)
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen

    d1 = fbm(noise_t, x * freq, y * freq, z * freq, octaves) * max_amp
    d2 = fbm(noise_t, x * freq + 31.7, y * freq + 47.3, z * freq + 19.1,
             octaves) * max_amp

    wx = x + ex * d1 + nx * d2
    wy = y * 1.0 + ny * d2        # ey = 0
    wz = z + ez * d1 + nz * d2
    wl = jnp.sqrt(wx * wx + wy * wy + wz * wz)
    wl = jnp.where(wl == 0, 1.0, wl)
    return jnp.stack([wx / wl, wy / wl, wz / wl], axis=1)


def _warp_merge(elev, warped, valid, strength, hotspot):
    """Weighted-max merge, damped near hotspots (js/terrain-post.js:291-308)."""
    warp_bias = 0.25 + 0.5 * strength
    hot_frac = jnp.minimum(
        1.0, jnp.abs(hotspot) / jnp.maximum(jnp.abs(elev), 1e-20))
    bias = warp_bias * (1.0 - 0.8 * hot_frac)
    merged = jnp.where(
        warped > elev,
        elev + (warped - elev) * bias,
        warped + (elev - warped) * (1.0 - bias),
    )
    return jnp.where(valid, merged, elev).astype(jnp.float32)


@partial(jax.jit, static_argnames=("band_off", "max_steps"))
def _warp_terrain_jnp(elev, pos, valid, band_off, band_mask, rem_src,
                      rem_dst, noise_t: Tables, strength, hotspot,
                      max_steps: int):
    """The synchronous banded candidate-propagation loop."""
    n = pos.shape[0]
    w = _warp_targets(pos, noise_t, strength)           # [N,3] targets

    # banded candidate propagation: (src index, src position) per cell
    real = _rem_real(rem_src, n)
    src_r = jnp.clip(rem_src, 0, n - 1)
    idx_f = jnp.arange(n, dtype=jnp.float32)

    def dist2(p):
        d = p - w
        return jnp.einsum("nc,nc->n", d, d)

    def step(_, state):
        # a synchronous sweep, as the JAX package's TPU kernel runs it
        # (ops/sweep_pallas.py _make_warp_kernel): every band reads the
        # candidates of the sweep before (its jnp loop let a band read the
        # candidates the bands before it adopted in the same step, which
        # misses the nearest cell ten times as often)
        src_idx, src_pos, best = state
        idx0, pos0 = src_idx, src_pos
        for d, off in enumerate(band_off):
            cand_pos = band_shift(pos0, off)
            cand_idx = band_shift(idx0, off)
            cd = jnp.where(band_mask[:, d], dist2(cand_pos), jnp.inf)
            upd = cd < best
            best = jnp.where(upd, cd, best)
            src_idx = jnp.where(upd, cand_idx, src_idx)
            src_pos = jnp.where(upd[:, None], cand_pos, src_pos)
        # remainder edges (two-phase scatter-min)
        cp = src_pos[rem_dst]
        dd = cp - w[src_r]
        cd = jnp.where(real, jnp.einsum("mc,mc->m", dd, dd), jnp.inf)
        wmin = jnp.full(n, jnp.inf).at[rem_src].min(cd, mode="drop")
        is_win = real & (cd == wmin[src_r]) & jnp.isfinite(cd)
        picked = jnp.concatenate(
            [src_idx[rem_dst][:, None], cp], axis=1)         # [M,4]
        pick = jnp.full((n, 4), -jnp.inf).at[rem_src].max(
            jnp.where(is_win[:, None], picked, -jnp.inf), mode="drop")
        upd = wmin < best
        best = jnp.where(upd, wmin, best)
        src_idx = jnp.where(upd, pick[:, 0], src_idx)
        src_pos = jnp.where(upd[:, None], pick[:, 1:4], src_pos)
        return src_idx, src_pos, best

    state0 = (idx_f, pos, dist2(pos))
    src_idx, _, _ = jax.lax.fori_loop(0, max_steps, step, state0)
    cur = jnp.clip(src_idx, 0, n - 1).astype(jnp.int32)
    warped = elev[cur]
    return _warp_merge(elev, warped, valid, strength, hotspot)
