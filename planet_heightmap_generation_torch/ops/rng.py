"""Deterministic seeded RNG — bit-compatible Park-Miller LCG.

The reference's entire determinism story rests on an 11-line Park-Miller
minimal-standard generator (reference ``js/rng.js:3-11``):

    s0   = (|floor(seed*9301 + 49297)| mod 2147483646) + 1
    s    = (s * 16807) mod 2147483647
    out  = (s - 1) / 2147483646

JS computes this in float64; since s*16807 < 2^53 the arithmetic is exact, so
an int64 implementation reproduces it bit-for-bit. Host-side we expose both a
stateful scalar generator (for the few sequential host algorithms) and a
vectorized sequence generator (modular binary exponentiation — O(31) passes
to produce any number of draws at once, which is how device pipelines consume
randomness without a sequential loop).
"""

from __future__ import annotations

import numpy as np

_M = 2147483647  # 2^31 - 1
_A = 16807


def _premix(seed: float) -> int:
    """Seed pre-mix, exactly as reference js/rng.js:4."""
    s = abs(int(np.floor(seed * 9301 + 49297))) % 2147483646 + 1
    return s


class ParkMiller:
    """Stateful scalar generator matching reference ``makeRng(seed)``."""

    __slots__ = ("s",)

    def __init__(self, seed: float):
        self.s = _premix(seed)

    def __call__(self) -> float:
        self.s = (self.s * _A) % _M
        return (self.s - 1) / 2147483646.0

    def rand_int(self, n: int) -> int:
        """Matches reference ``makeRandInt(seed)``: floor(rng()*n)."""
        return int(self() * n)

    def sequence(self, count: int) -> np.ndarray:
        """Draw ``count`` values, advancing state; native loop when the C++
        helper is built (the vectorized modexp costs ~5 s for 4M draws on
        one core; the C loop ~20 ms), numpy otherwise."""
        if count <= 0:
            return np.empty(0, dtype=np.float64)
        try:
            from ..native import get_mesh_build
            native = get_mesh_build()
        except Exception:
            native = None
        if native is not None and count >= 4096:
            out = np.empty(count, dtype=np.float64)
            self.s = int(native.pm_sequence(self.s, count, out))
            return out
        out = pm_sequence_from_state(self.s, count)
        # advance state to s * A^count mod M
        self.s = (self.s * pow(_A, count, _M)) % _M
        return out


def rand_int(seed: float):
    """Factory matching reference makeRandInt (js/rng.js:8-11)."""
    r = ParkMiller(seed)
    return r.rand_int


def pm_sequence_from_state(s0: int, count: int) -> np.ndarray:
    """Vectorized: [ (s0*A^1) , (s0*A^2), ... ] mapped to floats.

    Uses modular binary exponentiation on int64 (products of two residues
    < 2^62, safe in int64).
    """
    if count == 0:
        return np.empty(0, dtype=np.float64)
    k = np.arange(1, count + 1, dtype=np.int64)
    # compute A^k mod M vectorized via binary expansion of k
    result = np.ones(count, dtype=np.int64)
    base = np.int64(_A)
    kk = k.copy()
    while np.any(kk > 0):
        odd = (kk & 1).astype(bool)
        if np.any(odd):
            result[odd] = (result[odd] * base) % _M
        base = (base * base) % _M
        kk >>= 1
    states = (np.int64(s0) * result) % _M
    return (states - 1).astype(np.float64) / 2147483646.0


def pm_sequence(seed: float, count: int) -> np.ndarray:
    """Full sequence for a fresh generator with the given seed."""
    return pm_sequence_from_state(_premix(seed), count)


def pm_hash01(x: np.ndarray) -> np.ndarray:
    """One Park-Miller step applied elementwise — a cheap deterministic
    hash-to-[0,1) used where the reference derives per-entity noise from an
    index (e.g. per-pair collision intensity, js/elevation.js:44-53)."""
    x = np.asarray(x)
    s = (np.abs((x * 9301 + 49297).astype(np.int64)) % 2147483646) + 1
    s = (s * _A) % _M
    return (s - 1).astype(np.float64) / 2147483646.0
