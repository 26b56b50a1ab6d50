"""3D simplex noise with fBm / ridged-fBm, in torch.

The reference evaluates scalar simplex noise per cell inside JS loops
(reference ``js/simplex-noise.js:17-53``). The same permutation-table
construction (Fisher-Yates over 256 entries driven by the Park-Miller RNG,
``js/simplex-noise.js:8-14``) seeds a vectorized evaluator: one call
produces noise for a whole [N] field. Branchy corner selection is
re-expressed as ``torch.where`` selects; the permutation lookups are
plain gathers. float32 throughout.

The host half (tables, :func:`noise3_np`) is numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .rng import ParkMiller

# 12 gradient directions (js/simplex-noise.js:7)
_GRAD = np.array(
    [[1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
     [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
     [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1]],
    dtype=np.float32,
)

_F3 = 1.0 / 3.0
_G3 = 1.0 / 6.0


def make_perm_tables(seed: float) -> tuple[np.ndarray, np.ndarray]:
    """Build the 512-entry permutation tables exactly like the reference
    (Fisher-Yates shuffle driven by Park-Miller, js/simplex-noise.js:8-14)."""
    rng = ParkMiller(seed)
    p = np.arange(256, dtype=np.int64)
    for i in range(255, 0, -1):
        j = int(rng() * (i + 1))
        p[i], p[j] = p[j], p[i]
    perm = np.empty(512, dtype=np.int32)
    perm[:256] = p
    perm[256:] = p
    pm12 = (perm % 12).astype(np.int32)
    return perm, pm12


class Tables(NamedTuple):
    """Seed-dependent permutation tables (int64 index tensors)."""

    perm: torch.Tensor   # [512]
    pm12: torch.Tensor   # [512]


def tables(seed: float, device="cpu") -> Tables:
    perm, pm12 = make_perm_tables(seed)
    return tables_from_numpy(perm, pm12, device)


def tables_from_numpy(perm, pm12, device="cpu") -> Tables:
    # np.array copies: the producer's arrays may be read-only views
    return Tables(torch.as_tensor(np.array(perm, np.int64), device=device),
                  torch.as_tensor(np.array(pm12, np.int64), device=device))


def noise3(t: Tables, x, y, z):
    return _noise3(t.perm, t.pm12, x, y, z)


def fbm(t: Tables, x, y, z, octaves: int = 5, persistence: float = 2.0 / 3.0):
    """Power-of-two lacunarity fBm (js/simplex-noise.js:34-38)."""
    total = 0.0
    norm = 0.0
    amp = 1.0
    for o in range(octaves):
        f = float(1 << o)
        total = total + amp * noise3(t, x * f, y * f, z * f)
        norm += amp
        amp *= persistence
    return total / norm


def ridged_fbm(t: Tables, x, y, z, octaves: int = 6, lacunarity: float = 2.0,
               gain: float = 0.5, offset: float = 1.0):
    """Ridged multifractal with previous-term feedback
    (js/simplex-noise.js:40-53)."""
    total = 0.0
    freq = 1.0
    amp = 1.0
    prev = 1.0
    norm = 0.0
    for _ in range(octaves):
        n = noise3(t, x * freq, y * freq, z * freq)
        n = offset - torch.abs(n)
        n = n * n
        total = total + n * amp * prev
        norm += amp
        prev = torch.clamp(n, max=1.0)
        freq *= lacunarity
        amp *= gain
    return total / norm


class SimplexNoise:
    """Seeded simplex noise field evaluator: the object wrapper over
    :func:`tables`, :func:`noise3`, :func:`fbm` and :func:`ridged_fbm`
    (the JAX package's ``SimplexNoise``). Methods take tensors of one
    shape and return that shape."""

    def __init__(self, seed: float, device="cpu"):
        self.tables = tables(seed, device)
        self.perm = self.tables.perm
        self.pm12 = self.tables.pm12
        self.grad = torch.as_tensor(_GRAD, device=device)

    def noise3(self, x, y, z):
        return noise3(self.tables, x, y, z)

    def fbm(self, x, y, z, octaves: int = 5,
            persistence: float = 2.0 / 3.0):
        return fbm(self.tables, x, y, z, octaves, persistence)

    def ridged_fbm(self, x, y, z, octaves: int = 6, lacunarity: float = 2.0,
                   gain: float = 0.5, offset: float = 1.0):
        return ridged_fbm(self.tables, x, y, z, octaves, lacunarity, gain,
                          offset)


def noise3_np(perm: np.ndarray, pm12: np.ndarray, x, y, z):
    """Host (numpy) mirror of :func:`_noise3` for prologue-side scalar/point
    evaluations (hotspot placement, host point projection) — keeps the
    device pipeline free of tiny round-trip noise reads. Same tables, same
    branch logic (reference js/simplex-noise.js:17-33); float64 here vs
    float32 on device differs only at ~1e-7."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    s = (x + y + z) * _F3
    i = np.floor(x + s)
    j = np.floor(y + s)
    k = np.floor(z + s)
    t = (i + j + k) * _G3
    x0 = x - i + t
    y0 = y - j + t
    z0 = z - k + t

    cxy = x0 >= y0
    cyz = y0 >= z0
    cxz = x0 >= z0
    one = np.ones_like(x, np.int64)
    zero = np.zeros_like(x, np.int64)
    i1 = np.where(cxy & (cyz | cxz), one, zero)
    j1 = np.where(~cxy & cyz, one, zero)
    k1 = np.where((cxy & ~cyz & ~cxz) | (~cxy & ~cyz), one, zero)
    i2 = np.where(cxy | (~cxy & cyz & cxz), one, zero)
    j2 = np.where(cxy & cyz, one, np.where(~cxy, one, zero))
    k2 = np.where(cxy & ~cyz, one, np.where(~cxy & (~cyz | ~cxz), one, zero))

    ii = i.astype(np.int64) & 255
    jj = j.astype(np.int64) & 255
    kk = k.astype(np.int64) & 255

    def contrib(di, dj, dk, xo, yo, zo):
        h = pm12[ii + di + perm[jj + dj + perm[kk + dk]]]
        g = _GRAD[h]
        tt = np.maximum(0.6 - xo * xo - yo * yo - zo * zo, 0.0)
        t2 = tt * tt
        return t2 * t2 * (g[..., 0] * xo + g[..., 1] * yo + g[..., 2] * zo)

    n0 = contrib(0, 0, 0, x0, y0, z0)
    n1 = contrib(i1, j1, k1, x0 - i1 + _G3, y0 - j1 + _G3, z0 - k1 + _G3)
    n2 = contrib(i2, j2, k2, x0 - i2 + 2 * _G3, y0 - j2 + 2 * _G3,
                 z0 - k2 + 2 * _G3)
    n3 = contrib(1, 1, 1, x0 - 1 + 3 * _G3, y0 - 1 + 3 * _G3, z0 - 1 + 3 * _G3)
    return 32.0 * (n0 + n1 + n2 + n3)


def _grad_components(h):
    """Gradient components for hash ``h`` in [0,12) from the structured
    _GRAD table: x = ±1 for h<8 by bit 0; y = ±1 for h<4 by bit 1 and
    h≥8 by bit 0; z = ±1 for 4≤h<12 by bit 1."""
    sign0 = 1.0 - 2.0 * (h & 1).to(torch.float32)
    sign1 = 1.0 - 2.0 * ((h >> 1) & 1).to(torch.float32)
    gx = torch.where(h < 8, sign0, 0.0)
    gy = torch.where(h < 4, sign1, torch.where(h >= 8, sign0, 0.0))
    gz = torch.where(h >= 4, sign1, 0.0)
    return gx, gy, gz


def _corner_contrib(perm, pm12, inner, ii, jj, xo, yo, zo):
    """Attenuated gradient dot for one simplex corner; ``inner`` is the
    innermost lookup ``perm[(kk + dk) & 255]``."""
    mid = perm[(jj + inner) & 255]
    gx, gy, gz = _grad_components(pm12[(ii + mid) & 255])
    t = 0.6 - xo * xo - yo * yo - zo * zo
    t = torch.clamp(t, min=0.0)
    t2 = t * t
    dot = gx * xo + gy * yo + gz * zo
    return t2 * t2 * dot


def _noise3(perm, pm12, x, y, z):
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    z = z.to(torch.float32)

    s = (x + y + z) * _F3
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    k = torch.floor(z + s)
    t = (i + j + k) * _G3
    x0 = x - i + t
    y0 = y - j + t
    z0 = z - k + t

    # simplex corner ordering (js/simplex-noise.js:22-23), branch-free
    cxy = x0 >= y0
    cyz = y0 >= z0
    cxz = x0 >= z0
    i1 = cxy & (cyz | cxz)
    j1 = ~cxy & cyz
    k1 = (cxy & ~cyz & ~cxz) | (~cxy & ~cyz)
    i2 = cxy | (~cxy & cyz & cxz)
    j2 = (cxy & cyz) | ~cxy
    k2 = (cxy & ~cyz) | (~cxy & (~cyz | ~cxz))

    f1, g1, h1 = i1.to(x.dtype), j1.to(x.dtype), k1.to(x.dtype)
    f2, g2, h2 = i2.to(x.dtype), j2.to(x.dtype), k2.to(x.dtype)
    x1 = x0 - f1 + _G3
    y1 = y0 - g1 + _G3
    z1 = z0 - h1 + _G3
    x2 = x0 - f2 + 2 * _G3
    y2 = y0 - g2 + 2 * _G3
    z2 = z0 - h2 + 2 * _G3
    x3 = x0 - 1 + 3 * _G3
    y3 = y0 - 1 + 3 * _G3
    z3 = z0 - 1 + 3 * _G3

    ii = i.to(torch.int64) & 255
    jj = j.to(torch.int64) & 255
    kk = k.to(torch.int64) & 255

    # the corner k-offsets are all 0/1 → only two distinct inner lookups
    inner_a = perm[kk]
    inner_b = perm[(kk + 1) & 255]
    inner_1 = torch.where(k1, inner_b, inner_a)
    inner_2 = torch.where(k2, inner_b, inner_a)

    n0 = _corner_contrib(perm, pm12, inner_a, ii, jj, x0, y0, z0)
    n1 = _corner_contrib(perm, pm12, inner_1, ii + i1, jj + j1, x1, y1, z1)
    n2 = _corner_contrib(perm, pm12, inner_2, ii + i2, jj + j2, x2, y2, z2)
    n3 = _corner_contrib(perm, pm12, inner_b, ii + 1, jj + 1, x3, y3, z3)
    return 32.0 * (n0 + n1 + n2 + n3)
