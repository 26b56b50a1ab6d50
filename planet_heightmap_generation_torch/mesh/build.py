"""Sphere mesh construction — host side, producing the padded arrays of the
device graph (mesh/device.py).

The reference builds a Fibonacci sphere, projects it stereographically, runs
Delaunator, stitches the projection pole back in, and wraps the result in a
half-edge dual mesh with CSR adjacency (reference ``js/sphere-mesh.js``).

The port builds the JAX package's mesh, array for array: the same geometry
(bit-identical Fibonacci points and RNG consumption), with the CSR/half-edge
structure replaced by a **fixed-degree padded neighbor-index array**
``nbr_idx [NP, K]`` plus a validity mask (the gather form of ops/graph.py),
and the banded form that the neighbour sweeps and the CUDA kernels read
(:func:`build_banded`). The cell count is padded to a multiple of 1024, as
in the JAX package; the kernels need a multiple of 4, which it is.

Mesh construction is seed-dependent and stays on host, shipping static
arrays to device: native C++ sweep-hull Delaunay + adjacency (scipy fallback
when no compiler), on all the host's cores from ``CHUNKED_MIN_POINTS``
points (csrc/mesh_chunked.cpp; on the 8-core host of an H100 machine
~0.6 s at 999K and ~1.6 s at 2.56M points, band census and packing
included, against ~2.5 and ~6.9 s on one core).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
from scipy.spatial import Delaunay

from ..ops.rng import ParkMiller
from ..pipeline.timing import span

_PAD_MULTIPLE = 1024

# Fixed neighbor-array width, the JAX package's. Fibonacci-Delaunay degree
# is ~6 (5/7 outliers, ~1.3% of jittered cells at 9-11, plus the pole fan).
# K=8 covers 98.7% of cells fully; over-degree cells keep their 8 nearest
# (dropped edges removed symmetrically), so [NP, K] shapes do not depend on
# the seed: a structural deviation confined to the longest edges of rare
# high-degree cells.
K_FIXED = 8

# Banded adjacency width. The Fibonacci spiral ordering concentrates
# neighbor index offsets (j - i) onto ~a few dozen signed Fibonacci numbers
# (latitude-banded): the 32 most common offsets cover 99.5%+ of all edges
# at any tested N/jitter. An edge whose offset is one of these bands is a
# masked shift of the field (ops/banded.py ``band_shift``), and one bit of
# the cell's int32 band word (``band_bits``, bit d = band d) that the CUDA
# kernels walk, so 32 is also the most a word holds. The few off-band
# edges (pole fan, jitter outliers) are the remainder edge list, read as
# CSR rows of their receiving cell.
BAND_COUNT = 32


def generate_fibonacci_sphere(n: int, jitter: float, rng: ParkMiller) -> np.ndarray:
    """N points on the unit sphere via golden-angle spiral with jitter.

    Bit-compatible RNG consumption with reference js/sphere-mesh.js:9-37
    (4 draws per point when jitter > 0, none otherwise).
    """
    k = np.arange(n, dtype=np.float64)
    s = 3.6 / np.sqrt(n)
    dlong = np.pi * (3.0 - np.sqrt(5.0))
    dz = 2.0 / n
    z = 1.0 - dz / 2.0 - k * dz
    lng = k * dlong
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    lat_deg = np.degrees(np.arcsin(z))
    lon_deg = np.degrees(lng)

    if jitter > 0:
        draws = rng.sequence(4 * n).reshape(n, 4)
        j_lat = draws[:, 0] - draws[:, 1]
        j_lon = draws[:, 2] - draws[:, 3]
        next_z = np.maximum(-1.0, z - dz * 2.0 * np.pi * r / s)
        lat_deg = lat_deg + jitter * j_lat * (lat_deg - np.degrees(np.arcsin(next_z)))
        with np.errstate(divide="ignore"):
            lon_deg = lon_deg + jitter * j_lon * np.degrees(s / r)

    lat = np.radians(lat_deg)
    lon = np.radians(lon_deg)
    xyz = np.empty((n, 3), np.float64)  # column fills avoid np.stack's copy
    cl = np.cos(lat)
    np.multiply(cl, np.cos(lon), out=xyz[:, 0])
    np.multiply(cl, np.sin(lon), out=xyz[:, 1])
    np.sin(lat, out=xyz[:, 2])
    return xyz


def _stereographic(xyz: np.ndarray) -> np.ndarray:
    """Project from the north pole onto the z=0 plane
    (js/sphere-mesh.js:41-53); denominator clamped near the pole."""
    denom = np.maximum(1e-12, 1.0 - xyz[:, 2])
    return xyz[:, :2] / denom[:, None]


@dataclasses.dataclass
class SphereGraph:
    """Static mesh arrays, padded for TPU. All [NP] / [NP,K] shaped.

    ``n_cells`` real cells (= N+1, including the added pole) occupy indices
    [0, n_cells); the rest up to NP are inert padding (mask False, degree 0).
    """

    n_cells: int                 # real cell count (N+1)
    n_padded: int                # NP, multiple of 1024
    pos: np.ndarray              # [NP, 3] f32 unit vectors (pad rows = +z pole)
    nbr_idx: np.ndarray          # [NP, K] i32, self-index where invalid
    nbr_mask: np.ndarray         # [NP, K] bool
    nbr_dist: np.ndarray         # [NP, K] f32 chord distance (0 where invalid)
    deg: np.ndarray              # [NP] i32
    valid: np.ndarray            # [NP] bool
    triangles: np.ndarray        # [T, 3] i32 — for rendering / export parity
    pole_id: int                 # index of the stitched pole cell (= N)
    # how build_sphere built it: chunks (0: the serial build), threads,
    # margin re-runs, serial fallbacks; None for a mesh from elsewhere
    build_stats: Optional[dict] = None
    _t_pos: Optional[np.ndarray] = None
    _banded: Optional[tuple] = None
    _banded_packed: Optional[tuple] = ()   # () = not yet computed

    @property
    def k_max(self) -> int:
        return self.nbr_idx.shape[1]

    @property
    def t_pos(self) -> np.ndarray:
        """[T,3] f32 triangle centers (Voronoi vertices) — computed lazily;
        only renderer/export consumers need it (~2 s at 1M cells). The
        vertices are summed in ascending index order, so a center does not
        depend on which vertex a triangle's row starts at."""
        if self._t_pos is None:
            object.__setattr__(
                self, "_t_pos",
                self.pos[np.sort(self.triangles, axis=1)].mean(axis=1)
                .astype(np.float32))
        return self._t_pos

    @property
    def banded(self) -> tuple:
        """(band_off, band_mask, rem_src, rem_dst) — the banded adjacency
        (see BAND_COUNT). Computed lazily and cached; derived from the
        packed form when the native classifier is available."""
        if self._banded is None:
            p = self.banded_packed
            if p is not None:
                band_off, band_bits = p[0], p[1]
                d = len(band_off)
                mask = ((band_bits[:, None]
                         >> np.arange(d, dtype=np.uint32)) & 1).astype(bool)
                object.__setattr__(
                    self, "_banded", (band_off, mask, p[6], p[7]))
            else:
                object.__setattr__(
                    self, "_banded",
                    build_banded(self.nbr_idx, self.nbr_mask))
        return self._banded

    @property
    def banded_packed(self):
        """Native single-pass banded classification + upload packing:
        (band_off, band_bits u32 [NP], mask_bits u32 [NP], off16 [NP,K],
        exc_flat, exc_val, rem_src, rem_dst) — or None without the native
        library. ~1.4 s of numpy at 1M collapses to ~40 ms of C++; the
        device upload consumes the packed forms directly
        (mesh/device.py:to_device)."""
        if self._banded_packed == ():
            object.__setattr__(
                self, "_banded_packed",
                build_banded_packed(self.nbr_idx, self.nbr_mask))
        return self._banded_packed

    @property
    def avg_edge(self) -> float:
        """Mean neighbor chord distance over valid slots (radians ≈ chord
        for small cells) — the reference's avgEdge analog for km scaling."""
        tot = float(self.nbr_dist.sum())
        cnt = int(self.nbr_mask.sum())
        return tot / max(cnt, 1)


def _ordered_adjacency(n_total: int, triangles: np.ndarray, pos: np.ndarray):
    """Directed edge list from triangles → per-vertex neighbor lists ordered
    by tangent-plane angle (so Voronoi polygons export in circulation order)."""
    a = triangles[:, 0]
    b = triangles[:, 1]
    c = triangles[:, 2]
    src = np.concatenate([a, b, b, c, c, a])
    dst = np.concatenate([b, a, c, b, a, c])
    # dedupe directed edges
    key = src.astype(np.int64) * n_total + dst
    key = np.unique(key)
    src = (key // n_total).astype(np.int32)
    dst = (key % n_total).astype(np.int32)

    # tangent-frame angle of each neighbor around its source vertex
    u = pos[src]
    v = pos[dst]
    # build tangent frame per edge from source normal
    ref = np.where(np.abs(u[:, 2:3]) < 0.9, [[0.0, 0.0, 1.0]], [[1.0, 0.0, 0.0]])
    t1 = np.cross(ref, u)
    t1 /= np.maximum(1e-30, np.linalg.norm(t1, axis=1))[:, None]
    t2 = np.cross(u, t1)
    e = v - (v * u).sum(1)[:, None] * u
    ang = np.arctan2((e * t2).sum(1), (e * t1).sum(1))

    order = np.lexsort((ang, src))
    return src[order], dst[order]


def _native_delaunay(fn, flat: np.ndarray):
    """Call the native triangulator; returns (triangles [T,3], hull cycle)."""
    import ctypes

    m = len(flat)
    xs = np.ascontiguousarray(flat[:, 0], np.float64)
    ys = np.ascontiguousarray(flat[:, 1], np.float64)
    tris = np.empty((2 * m, 3), np.int32)
    hull = np.empty(m, np.int32)
    hl = ctypes.c_int64(0)
    t = fn(xs, ys, m, tris, hull, ctypes.byref(hl))
    if t <= 0:
        raise RuntimeError("native Delaunay failed")
    return tris[:t].copy(), hull[: hl.value].copy()


def _pole_closure(hull_cycle: np.ndarray, pole_id: int) -> np.ndarray:
    """Pole triangles from the hull CYCLE: consecutive pairs are hull edges,
    stitched in the REVERSE direction of how they appear in the hull
    triangles so every directed edge keeps exactly one twin (a watertight
    halfedge surface for the renderer bridge)."""
    return np.stack(
        [np.roll(hull_cycle, -1), hull_cycle,
         np.full(len(hull_cycle), pole_id, dtype=np.int32)], axis=1)


# The chunked build (csrc/mesh_chunked.cpp) engages from this many spiral
# points: the default 204K planet takes it, the 20K coarse mesh and the
# test meshes keep the serial build (and with it the JAX package's
# triangle order).
CHUNKED_MIN_POINTS = 100_000


def chunk_count(n: int) -> int:
    """The chunked Delaunay's chunk count for ``n`` spiral points, 0 (the
    serial build) below :data:`CHUNKED_MIN_POINTS`: a function of the
    point count alone, never of the host, so every host builds the same
    chunks. A chunk's margin grows as sqrt(n) (a few spiral rings), so
    chunks of ~48 sqrt(n) points keep the margins at about a quarter of
    the work (9 chunks at 204K, 21 at 999K, 33 at 2.56M)."""
    if n < CHUNKED_MIN_POINTS:
        return 0
    return max(2, round(math.sqrt(n) / 48))


def mesh_threads(n: int) -> int:
    """Threads for the native passes over a mesh of ``n`` cells: the cores
    this process may run on from :data:`CHUNKED_MIN_POINTS`, one below it
    (where starting the threads costs about as much as the work). The
    thread count never changes a result."""
    return len(os.sched_getaffinity(0)) if n >= CHUNKED_MIN_POINTS else 1


def mesh_points(n: int, jitter: float, rng: ParkMiller):
    """The spiral's unit vectors [n, 3], their stereographic doubles
    [n, 2], and the vectors with the stitched pole appended [n + 1, 3]."""
    xyz = generate_fibonacci_sphere(n, jitter, rng)
    return (xyz, _stereographic(xyz),
            np.concatenate([xyz, [[0.0, 0.0, 1.0]]], axis=0))


def build_sphere(
    n: int,
    jitter: float,
    rng: Optional[ParkMiller] = None,
    seed: float = 0.0,
    pad_multiple: int = _PAD_MULTIPLE,
    *,
    threads: Optional[int] = None,
) -> SphereGraph:
    """Fibonacci sphere → Delaunay → pole closure → padded neighbor arrays.

    Mirrors reference buildSphere (js/sphere-mesh.js:174-186): N spiral
    points plus one stitched pole cell at index N, so n_cells = N+1.

    From :data:`CHUNKED_MIN_POINTS` points the Delaunay runs in
    :func:`chunk_count` latitude chunks: every array but ``triangles``
    equals the serial build's bit for bit, and ``triangles`` holds the
    same triangles with the same winding, each rotated to its smallest
    vertex, sorted. The native passes run on ``threads`` threads
    (default: :func:`mesh_threads`). ``build_stats`` counts the chunks,
    threads, margin re-runs and serial fallbacks.
    """
    if rng is None:
        rng = ParkMiller(seed)
    with span("Mesh: points"):
        xyz, flat, pos_all = mesh_points(n, jitter, rng)

    from ..native import get_mesh_build
    native = get_mesh_build()
    threads = max(1, mesh_threads(n) if threads is None else threads)
    chunks = chunk_count(n) if native is not None else 0
    stats = dict(chunks=chunks, threads=threads if native else 1,
                 reruns=0, fallbacks=0)
    pole_id = n
    n_total = n + 1
    n_padded = -(-n_total // pad_multiple) * pad_multiple

    got = None
    if chunks:
        with span("Mesh: Delaunay"):
            tri_rr = _chunked_triangles(native, flat, xyz, chunks, threads)
        if tri_rr is not None:
            triangles, stats["reruns"] = tri_rr
            with span("Mesh: adjacency"):
                got = mesh_adjacency(native, triangles, pos_all, n_padded,
                                     threads)
        stats["fallbacks"] = int(got is None)
    if got is None:
        with span("Mesh: Delaunay"):
            triangles = serial_triangles(native, flat, pole_id)
        with span("Mesh: adjacency"):
            got = mesh_adjacency(native, triangles, pos_all, n_padded,
                                 threads)
        if got is None:
            raise RuntimeError("the serial triangulation is no closed "
                               "surface")
    nbr_idx, nbr_mask, nbr_dist, deg_pad = got

    pos_pad = np.zeros((n_padded, 3), dtype=np.float32)
    pos_pad[:n_total] = pos_all.astype(np.float32)
    pos_pad[n_total:] = [0.0, 0.0, 1.0]

    valid = np.zeros(n_padded, dtype=bool)
    valid[:n_total] = True

    return SphereGraph(
        n_cells=n_total,
        n_padded=n_padded,
        pos=pos_pad,
        nbr_idx=nbr_idx,
        nbr_mask=nbr_mask,
        nbr_dist=nbr_dist,
        deg=deg_pad,
        valid=valid,
        triangles=triangles,
        pole_id=pole_id,
        build_stats=stats,
    )


def _chunked_triangles(native, flat: np.ndarray, xyz: np.ndarray,
                       chunks: int, threads: int):
    """(triangles [T,3] with the pole closure, margin re-runs) from the
    chunked native triangulator, or None where a chunk could not be made
    exact or the triangles miss the Euler count of a closed triangulated
    sphere, T = 2 (N+1) - 4 (the adjacency checks the twins)."""
    import ctypes

    m = len(flat)
    xs = np.ascontiguousarray(flat[:, 0], np.float64)
    ys = np.ascontiguousarray(flat[:, 1], np.float64)
    tris = np.empty((2 * m, 3), np.int32)
    hull = np.empty(m, np.int32)
    hl = ctypes.c_int64(0)
    stats = np.zeros(1, np.int64)
    t = native.delaunay_chunked(
        xs, ys, np.ascontiguousarray(xyz, np.float64), m, chunks, threads,
        tris, hull, ctypes.byref(hl), stats)
    if t <= 0:
        return None
    triangles = np.concatenate(
        [tris[:t], _pole_closure(hull[: hl.value], m)], axis=0)
    if len(triangles) != 2 * (m + 1) - 4:
        return None
    return triangles, int(stats[0])


def serial_triangles(native, flat: np.ndarray, pole_id: int) -> np.ndarray:
    """The serial triangulation and its pole closure (native sweep-hull in
    insertion order, else scipy's Qhull)."""
    if native is not None:
        simplices, hull_cycle = _native_delaunay(native.delaunay, flat)
        pole_tris = _pole_closure(hull_cycle, pole_id)
    else:
        tri = Delaunay(flat)
        simplices = tri.simplices.astype(np.int32)  # [T0, 3]
        # Pole closure: connect every hull edge to the pole point (index n).
        # (The hull of the stereographic projection surrounds the north pole.)
        hull = tri.convex_hull.astype(np.int32)  # [H, 2]
        pole_tris = np.concatenate(
            [hull, np.full((len(hull), 1), pole_id, dtype=np.int32)], axis=1)
    return np.concatenate([simplices, pole_tris], axis=0)


def mesh_adjacency(native, triangles: np.ndarray, pos_all: np.ndarray,
                   n_padded: int, threads: int):
    """(nbr_idx, nbr_mask, nbr_dist, deg), padded to ``n_padded`` rows: the
    native threaded adjacency (the same for any order or rotation of the
    triangles; None when some halfedge lacks exactly one twin), else
    numpy."""
    n_total, k_max = len(pos_all), K_FIXED
    if native is not None:
        nbr_idx = np.empty((n_padded, k_max), np.int32)
        mask_u8 = np.empty((n_padded, k_max), np.uint8)
        nbr_dist = np.empty((n_padded, k_max), np.float32)
        deg = np.empty(n_padded, np.int32)
        if native.adjacency(
                np.ascontiguousarray(triangles), len(triangles),
                np.ascontiguousarray(pos_all), n_total, k_max, n_padded,
                nbr_idx, mask_u8, nbr_dist, deg, threads) != 0:
            return None
        return nbr_idx, mask_u8.view(bool), nbr_dist, deg

    nbr_idx = np.tile(
        np.arange(n_padded, dtype=np.int32)[:, None], (1, k_max)
    )  # self-index default (safe gather)
    nbr_mask = np.zeros((n_padded, k_max), dtype=bool)
    nbr_dist = np.zeros((n_padded, k_max), dtype=np.float32)
    deg_pad = np.zeros(n_padded, dtype=np.int32)
    src, dst = _ordered_adjacency(n_total, triangles, pos_all)
    deg = np.bincount(src, minlength=n_total).astype(np.int32)
    # truncate over-degree vertices (pole fan / rare jitter artifacts) to
    # their K_FIXED nearest neighbors so shapes stay seed-independent
    if int(deg.max()) > k_max:
        edge_d = np.linalg.norm(pos_all[src] - pos_all[dst], axis=1)
        over = np.flatnonzero(deg > k_max)
        keep = np.ones(len(src), dtype=bool)
        offsets0 = np.zeros(n_total + 1, dtype=np.int64)
        np.cumsum(deg, out=offsets0[1:])
        for v in over:
            lo, hi = offsets0[v], offsets0[v + 1]
            order = np.argsort(edge_d[lo:hi], kind="stable")
            keep[lo + order[k_max:]] = False
        # drop the reverse edges of every dropped edge too: an asymmetric
        # graph breaks conservation in proportional-share transport (a
        # receiver's total[j] would count an edge the sender no longer
        # has) and silently skips pole-fan neighbors in circulation order
        dropped = src[~keep].astype(np.int64) * n_total + dst[~keep]
        rev_key = dst.astype(np.int64) * n_total + src
        keep &= ~np.isin(rev_key, dropped)
        src, dst = src[keep], dst[keep]
        deg = np.bincount(src, minlength=n_total).astype(np.int32)

    offsets = np.zeros(n_total + 1, dtype=np.int64)
    np.cumsum(deg, out=offsets[1:])
    slot = np.arange(len(src), dtype=np.int64) - offsets[src]
    nbr_idx[src, slot] = dst
    nbr_mask[src, slot] = True
    d = pos_all[nbr_idx[:n_total]] - pos_all[:, None, :]
    nbr_dist[:n_total] = np.where(
        nbr_mask[:n_total], np.sqrt((d * d).sum(-1)), 0.0
    ).astype(np.float32)
    deg_pad[:n_total] = deg
    return nbr_idx, nbr_mask, nbr_dist, deg_pad


def _band_off_for(nbr_idx: np.ndarray, nbr_mask: np.ndarray, n_bands: int,
                  off_all=None) -> np.ndarray:
    """The ``n_bands`` most common signed index offsets of THIS mesh,
    sorted. Unlike the JAX package, which caches them per (npad, n_bands)
    so that seed sweeps share one jitted executable, the port derives them
    from each mesh anew: with a process-wide cache a planet's band split,
    and with it the order of its sums and first-best ties, would depend on
    which mesh of the same padded size the process built first."""
    npad = nbr_idx.shape[0]
    if off_all is None:
        i = np.arange(npad, dtype=np.int64)[:, None]
        off_all = nbr_idx.astype(np.int64) - i
    offs, counts = np.unique(off_all[nbr_mask], return_counts=True)
    # select ± pairs together (the symmetric graph gives +o and -o
    # equal counts; a cutoff tie must not split a pair)
    pos_sel = offs > 0
    pos_offs, pos_counts = offs[pos_sel], counts[pos_sel]
    order = np.argsort(-pos_counts, kind="stable")
    chosen = pos_offs[order][: n_bands // 2]
    return np.sort(np.concatenate([chosen, -chosen]))


def build_banded_packed(nbr_idx: np.ndarray, nbr_mask: np.ndarray,
                        n_bands: int = BAND_COUNT):
    """Native single-pass banded classification + upload packing.

    Returns ``(band_off tuple, band_bits u32 [NP], mask_bits u32 [NP],
    off16 i16 [NP,K], exc_flat i32, exc_val i32, rem_src i32, rem_dst
    i32)`` — band/slot bit semantics and remainder order/bucketing are
    IDENTICAL to :func:`build_banded` + the former numpy packing in
    mesh/device.py (row-major edge order; rem bucket = max(1024, NP//16)
    doubling, padded with src=NP). Returns None when the native library
    is unavailable (callers fall back to the numpy path). The band census
    (a histogram of the offsets, :func:`_band_off_for`'s picks) and the
    packing run on :func:`mesh_threads` threads."""
    import ctypes

    from ..native import get_mesh_build
    native = get_mesh_build()
    if native is None:
        return None
    npad, k = nbr_idx.shape
    threads = mesh_threads(npad)
    idx_c = np.ascontiguousarray(nbr_idx, np.int32)
    mask_c = np.ascontiguousarray(nbr_mask, np.uint8)
    boff32 = np.empty(n_bands + 1, np.int32)
    boff32 = boff32[:native.census(idx_c, mask_c, npad, k, n_bands, threads,
                                   boff32)].copy()
    band_off = boff32.astype(np.int64)
    band_bits = np.empty(npad, np.uint32)
    mask_bits = np.empty(npad, np.uint32)
    off16 = np.empty((npad, k), np.int16)
    exc_cap = 4096
    rem_cap = max(1024, npad // 16)
    while True:
        exc_flat = np.empty(exc_cap, np.int32)
        exc_val = np.empty(exc_cap, np.int32)
        rem_src = np.empty(rem_cap, np.int32)
        rem_dst = np.empty(rem_cap, np.int32)
        exc_n = ctypes.c_int64(0)
        rem_n = ctypes.c_int64(0)
        if native.pack(idx_c, mask_c, npad, k, boff32, len(band_off),
                       band_bits, mask_bits, off16.reshape(-1),
                       exc_flat, exc_val, exc_cap,
                       rem_src, rem_dst, rem_cap,
                       ctypes.byref(exc_n), ctypes.byref(rem_n),
                       threads) == 0:
            break
        exc_cap *= 2
        rem_cap *= 2
    m = int(rem_n.value)
    rem_src[m:] = npad
    rem_dst[m:] = 0
    e = int(exc_n.value)
    return (tuple(int(o) for o in band_off), band_bits, mask_bits, off16,
            exc_flat[:e].copy(), exc_val[:e].copy(), rem_src, rem_dst)


def build_banded(nbr_idx: np.ndarray, nbr_mask: np.ndarray,
                 n_bands: int = BAND_COUNT):
    """Banded re-expression of the padded adjacency.

    Returns ``(band_off, band_mask, rem_src, rem_dst)``:

    - ``band_off``: sorted tuple of the ``n_bands`` most common signed index
      offsets ``j - i`` over all edges (static per graph — compiled into the
      kernels as roll amounts).
    - ``band_mask [NP, D] bool``: cell i has the neighbor ``i + band_off[d]``.
    - ``rem_src / rem_dst [M] i32``: the off-band edges (pole fan, jitter
      outliers; ~0.5% of edges at jitter 0.75), padded to a size bucket with
      out-of-range sources so padded scatter updates drop (mode='drop').

    Edges never wrap: ``j = i + off`` is an actual cell index, so a masked
    ``jnp.roll(field, -off)`` reads exactly ``field[j]`` wherever the band
    mask is set. Every band/remainder edge is covered exactly once, so
    banded reductions are bit-identical to the [N,K] gather form (modulo
    accumulation order for float sums).
    """
    npad = nbr_idx.shape[0]
    i = np.arange(npad, dtype=np.int64)[:, None]
    off_all = nbr_idx.astype(np.int64) - i
    band_off = _band_off_for(nbr_idx, nbr_mask, n_bands, off_all)

    pos_in = np.clip(np.searchsorted(band_off, off_all), 0, len(band_off) - 1)
    hit = nbr_mask & (band_off[pos_in] == off_all)
    band_mask = np.zeros((npad, len(band_off)), dtype=bool)
    band_mask[np.nonzero(hit)[0], pos_in[hit]] = True

    rem = nbr_mask & ~hit
    rem_src, rem_k = np.nonzero(rem)
    rem_dst = nbr_idx[rem_src, rem_k]
    m = len(rem_src)
    # fixed-fraction bucket so the jit signature is seed-independent at a
    # given N (measured remainder is <=0.6% of edges; bucket is ~6% of cells)
    cap = max(1024, npad // 16)
    while cap < m:  # pathological meshes: grow (rare recompile, still exact)
        cap *= 2
    rem_src = np.concatenate(
        [rem_src, np.full(cap - m, npad)]).astype(np.int32)
    rem_dst = np.concatenate(
        [rem_dst, np.zeros(cap - m)]).astype(np.int32)
    return (tuple(int(o) for o in band_off), band_mask, rem_src, rem_dst)
