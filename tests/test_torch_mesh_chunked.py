"""The chunked host mesh build (``csrc/mesh_chunked.cpp``) against the JAX
package's serial build of the same seed: every array the pipeline reads
bit for bit, the same triangles with the same winding, the same result on
one thread and on two, and triangle means that do not depend on a
triangle's rotation."""

import dataclasses

import numpy as np
import pytest
import torch

from planet_heightmap_generation_tpu.mesh import build as jmesh
from planet_heightmap_generation_torch import native
from planet_heightmap_generation_torch.mesh import build
from planet_heightmap_generation_torch.mesh.build import (
    CHUNKED_MIN_POINTS, _band_off_for, build_sphere, chunk_count)
from planet_heightmap_generation_torch.pipeline.engine import (
    triangle_elevations)

ARRAYS = ("pos", "nbr_idx", "nbr_mask", "nbr_dist", "deg", "valid")


def canonical(tris: np.ndarray):
    """Each triangle rotated to start at its smallest vertex (its winding
    kept), and the order that sorts those rows."""
    r = np.argmin(tris, axis=1)
    c = np.take_along_axis(tris, (r[:, None] + np.arange(3)) % 3, axis=1)
    return c, np.lexsort((c[:, 2], c[:, 1], c[:, 0]))


def assert_same_mesh(a, b):
    for f in ("n_cells", "n_padded", "pole_id"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    (ca, oa), (cb, ob) = canonical(a.triangles), canonical(b.triangles)
    np.testing.assert_array_equal(ca[oa], cb[ob])
    pa, pb = a.banded_packed, b.banded_packed
    assert pa[0] == pb[0]
    for i, (x, y) in enumerate(zip(pa[1:], pb[1:])):
        np.testing.assert_array_equal(x, y, err_msg=f"banded_packed[{i + 1}]")


def jbuild(monkeypatch, n, jitter, seed):
    """The JAX package's mesh with its banded packing computed at once
    from an empty band cache: the bands of this mesh, as the port picks
    them (the JAX package reuses the first mesh's of the same padded
    size)."""
    monkeypatch.setattr(jmesh, "_BAND_OFF_CACHE", {})
    g = jmesh.build_sphere(n, jitter, seed=seed)
    _ = g.banded_packed
    return g


@pytest.fixture(scope="module")
def jax_meshes():
    return {}


@pytest.mark.parametrize("n, jitter, chunks", [
    *((n, jitter, chunks) for n in (20_000, 60_000) for jitter in (0.75, 0.0)
      for chunks in (2, 7, 16)),
    (CHUNKED_MIN_POINTS, 0.75, None),
    (150_000, 0.0, None),
])
def test_chunked_mesh_equals_jax(monkeypatch, jax_meshes, n, jitter, chunks):
    """``chunks`` None: the default chunk count of a mesh at or above the
    threshold; else that many chunks forced on a smaller mesh."""
    assert native.get_mesh_build() is not None
    want = chunk_count(n) if chunks is None else chunks
    if chunks is not None:
        monkeypatch.setattr(build, "chunk_count", lambda _n: chunks)
    seed = 1000.0 + n
    if (n, jitter) not in jax_meshes:
        jax_meshes[n, jitter] = jbuild(monkeypatch, n, jitter, seed)
    ref = jax_meshes[n, jitter]
    two = build_sphere(n, jitter, seed=seed, threads=2)
    st = two.build_stats
    assert (st["chunks"], st["threads"], st["fallbacks"]) == (want, 2, 0)
    assert want >= 2
    assert len(two.triangles) == 2 * (n + 1) - 4
    assert_same_mesh(two, ref)
    # the spiral's triangles in canonical order, then the pole fan
    fan = (two.triangles == n).any(axis=1)
    k = len(two.triangles) - int(fan.sum())
    assert not fan[:k].any()
    c, order = canonical(two.triangles[:k])
    np.testing.assert_array_equal(two.triangles[:k], c[order])
    # one thread: the same arrays, element for element
    one = build_sphere(n, jitter, seed=seed, threads=1)
    assert one.build_stats["threads"] == 1
    for f in ARRAYS + ("triangles",):
        np.testing.assert_array_equal(getattr(one, f), getattr(two, f),
                                      err_msg=f)
    assert one.banded_packed[0] == two.banded_packed[0]
    for x, y in zip(one.banded_packed[1:], two.banded_packed[1:]):
        np.testing.assert_array_equal(x, y)
    # the native census picks _band_off_for's bands
    assert two.banded_packed[0] == tuple(
        int(o) for o in _band_off_for(ref.nbr_idx, ref.nbr_mask,
                                      build.BAND_COUNT))
    # triangle centers and elevations: the same per triangle in the
    # serial build's rotation and order as in the chunked build's
    serial = dataclasses.replace(two, triangles=ref.triangles, _t_pos=None)
    _, os_ = canonical(serial.triangles)
    _, oc = canonical(two.triangles)
    np.testing.assert_array_equal(serial.t_pos[os_], two.t_pos[oc])
    elev = torch.from_numpy(np.random.default_rng(n).standard_normal(
        two.n_padded).astype(np.float32) * 4000)
    np.testing.assert_array_equal(
        triangle_elevations(elev, serial).numpy()[os_],
        triangle_elevations(elev, two).numpy()[oc])


@pytest.mark.parametrize("case", ["below", "at", "euler", "twins", "none"])
def test_chunked_engagement_and_guard(monkeypatch, case):
    """The point count alone engages the chunked path; a triangle set
    that fails the Euler count or the twin check, or a chunk that cannot
    be made exact, falls back to the serial build, counted."""
    if case in ("below", "at"):
        n = CHUNKED_MIN_POINTS - (case == "below")
        got = build_sphere(n, 0.75, seed=77.0,
                           threads=None if case == "below" else 2)
        st = got.build_stats
        if case == "below":
            assert st == dict(chunks=0, threads=1, reruns=0, fallbacks=0)
        else:
            assert st["chunks"] == chunk_count(n) >= 2
            assert st["fallbacks"] == 0
        return
    n = 30_000
    monkeypatch.setattr(build, "chunk_count", lambda _n: 5)
    lib = native.get_mesh_build()
    real = lib.delaunay_chunked

    def spoiled(*a):
        t = real(*a)
        if case == "euler":
            return t - 1                    # drop the last triangle
        if case == "twins":
            a[6][0] = a[6][0, ::-1].copy()  # flip the first one
            return t
        return -1                           # a chunk not made exact

    monkeypatch.setattr(lib, "delaunay_chunked", spoiled)
    got = build_sphere(n, 0.75, seed=77.0, threads=2)
    st = got.build_stats
    assert (st["chunks"], st["fallbacks"]) == (5, 1)
    ref = jbuild(monkeypatch, n, 0.75, 77.0)
    for f in ARRAYS + ("triangles",):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
