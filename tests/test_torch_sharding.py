"""The port's cells × seed split (parallel/sharding.py, windows.py,
loops.py) on the CPU.

- The port's ``terrain_step`` against the JAX package's on the JAX test's
  1500-cell graph (``tests/test_parallel.py``), rtol = atol = 1e-5.
- ``batched_terrain_step`` against the port's single-device step, bit for
  bit, on ``["cpu"] * W`` meshes: seed × cells grids, cells-only splits
  with even and uneven chunks, and one whose chunks are shorter than the
  halo (a halo spans several shards).
- Each of the eight kernel loops split over W ∈ {2, 3, 8} windows of the
  2000-cell ``tiny_sphere`` against its unsplit plain loop, bit for bit,
  in its sweep count too where it is one (not the components' steps nor
  the ε-fill's, whose split form runs stale-halo rounds).
- The mesh rules: too many devices, a ``seed_parallel`` that does not
  divide, ``gather_cells(shard_cells(x))``, nothing copied to the host.

Inputs are made from numpy seeds.
"""

import functools
import inspect
import re

import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import mesh_fields

from planet_heightmap_generation_torch import interop
from planet_heightmap_generation_torch.ops import banded, sweep_cuda
from planet_heightmap_generation_torch.ops.noise import make_perm_tables
from planet_heightmap_generation_torch.parallel import loops, windows
from planet_heightmap_generation_torch.parallel import sharding
from planet_heightmap_generation_torch.parallel.sharding import (
    batched_terrain_step, cells_mesh, gather_cells, make_planet_mesh,
    replicate, shard_cells, terrain_step)

assert torch_parity  # one torch thread per test process


@pytest.fixture(autouse=True, scope="module")
def _band_offsets_left_as_found():
    """The JAX package takes a mesh's band offsets from the first mesh of
    the same padded size built in the process (mesh/build.py
    ``_BAND_OFF_CACHE``). This file's 1500- and 2000-cell meshes pad to
    2048 cells, as conftest's ``tiny_sphere`` does, so leaving its entry
    behind would give a later file on the same worker another band split
    than that file builds alone: the cache is restored on leaving."""
    from planet_heightmap_generation_tpu.mesh import build

    saved = dict(build._BAND_OFF_CACHE)
    yield
    build._BAND_OFF_CACHE.clear()
    build._BAND_OFF_CACHE.update(saved)


@functools.lru_cache(maxsize=1)
def tiny1500():
    """The JAX test's 1500-cell graph, its elevation, and the port's
    DeviceGraph of the same mesh and band split (CPU)."""
    import __graft_entry__ as ge

    g, gd, elev, _ = ge._tiny_graph(n=1500)
    pg = interop.state_from_numpy(mesh_fields(g))["g"]
    return gd, np.array(elev, np.float32), pg


def tables(seed):
    perm, pm12 = make_perm_tables(seed)
    return torch.as_tensor(perm), torch.as_tensor(pm12)


def port_step(pg, elev, perm, pm12):
    return terrain_step(torch.as_tensor(elev), pg.pos, pg.band_mask,
                        pg.rem_src, pg.rem_dst, pg.valid, perm, pm12,
                        pg.band_off)


def test_terrain_step_matches_jax():
    """The port's single-device step against the JAX ``terrain_step``
    (one jit) on the same graph, elevation and noise tables."""
    from functools import partial

    import jax
    from planet_heightmap_generation_tpu.parallel.sharding import (
        terrain_step as jax_step)

    gd, elev, pg = tiny1500()
    perm, pm12 = make_perm_tables(1.0)
    want = jax.jit(partial(jax_step, band_off=gd.band_off))(
        elev, gd.pos, gd.band_mask, gd.rem_src, gd.rem_dst, gd.valid, perm,
        pm12)
    got = port_step(pg, elev, torch.as_tensor(perm), torch.as_tensor(pm12))
    assert pg.band_off == tuple(gd.band_off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# (mesh builder, seeds in the batch)
MESHES = {
    "8 cpu, seed_parallel 2": (lambda: make_planet_mesh(
        8, seed_parallel=2, devices=["cpu"] * 8), 2),
    "8 cpu, seed_parallel 4": (lambda: make_planet_mesh(
        8, seed_parallel=4, devices=["cpu"] * 8), 4),
    "cells 2": (lambda: cells_mesh(2, devices=["cpu"] * 2), 2),
    "cells 3, uneven": (lambda: cells_mesh(3, devices=["cpu"] * 3), 1),
    "cells 8": (lambda: cells_mesh(8, devices=["cpu"] * 8), 1),
    "cells 16, chunk < halo": (lambda: cells_mesh(16, devices=["cpu"] * 16),
                               1),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_split_step_matches_single(name):
    """``batched_terrain_step`` equals the single-device step bit for bit
    for every seed, the output split seeds × cells."""
    build, b = MESHES[name]
    mesh = build()
    _, elev, pg = tiny1500()
    scales = (1.0, 0.5, 1.5, -0.25)[:b]
    elev_b = np.stack([elev * s for s in scales]).astype(np.float32)
    tabs = [tables(float(k + 1)) for k in range(b)]
    perm_b = torch.stack([t[0] for t in tabs])
    pm12_b = torch.stack([t[1] for t in tabs])
    step = batched_terrain_step(mesh, pg.band_off)
    out = step(elev_b, pg.pos, pg.band_mask, pg.rem_src, pg.rem_dst,
               pg.valid, perm_b, pm12_b)
    rows = mesh.shape["seed"]
    assert len(out.rows) == rows and out.batched
    lay = out.rows[0].layout
    assert lay.n_shards == mesh.shape["cells"]
    assert lay.exchanges > 0
    if name.endswith("chunk < halo"):
        assert max(lay.chunk_len(c) for c in range(16)) < lay.halo
        pulls = [len(s["pulls"]) for s in lay._shards]
        assert max(pulls) > 2, pulls   # a halo side spans two shards
    if name.endswith("uneven"):
        assert len({lay.chunk_len(c) for c in range(3)}) == 2
    got = gather_cells(out)
    assert got.shape == (b, pg.n_padded)
    for k in range(b):
        want = port_step(pg, elev_b[k], perm_b[k], pm12_b[k])
        assert torch.equal(got[k], want), (name, k, float(
            (got[k] - want).abs().max()))


# ── the eight loops, split against unsplit ────────────────────────────

@functools.lru_cache(maxsize=1)
def sphere_graph():
    from planet_heightmap_generation_tpu.mesh import build_sphere

    # tests/conftest.py tiny_sphere: a session fixture; rebuilt here so
    # the cached inputs below can be module-level
    g = build_sphere(2000, 0.75, seed=42.0)
    pg = interop.state_from_numpy(mesh_fields(g))["g"]
    ptr, nbr = banded.rem_csr(pg.rem_src, pg.rem_dst, pg.n_padded)
    return pg, ptr, nbr


def layout(w):
    pg, _, _ = sphere_graph()
    return cells_mesh(w, devices=["cpu"] * w).layout(
        0, pg.n_padded, pg.band_off, pg.rem_src, pg.rem_dst)


def planes(lay, x):
    return windows.split(lay, x, -1)


def rng(seed):
    return np.random.default_rng(seed)


def terrain(seed):
    """A smooth random elevation over the sphere (numpy seed)."""
    pg, _, _ = sphere_graph()
    r = rng(seed)
    k = torch.as_tensor(r.normal(size=(3, 6)).astype(np.float32))
    ph = torch.as_tensor(r.uniform(0, 6.28, 6).astype(np.float32))
    e = torch.sin(pg.pos @ k * 3 + ph).sum(1) * 0.3 + 0.1
    return torch.where(pg.valid, e, 0.0).to(torch.float32)


def check_bfs(w):
    pg, ptr, nbr = sphere_graph()
    r = rng(1)
    n = pg.n_padded
    seeds = torch.as_tensor(r.random((2, n)) < 0.02)
    cost = torch.as_tensor(r.uniform(0.5, 1.5, (2, n)).astype(np.float32))
    cost = torch.where(torch.as_tensor(r.random((2, n)) < 0.1) & ~seeds,
                       float("inf"), cost).contiguous()
    cur = torch.where(seeds, 0.0, float("inf")).to(torch.float32)
    full, n_full = sweep_cuda.bfs_relax_plain(cur, cost, pg.band_bits,
                                              pg.band_off, ptr, nbr, 0)
    lay = layout(w)
    wg = lay.graph(pg.band_bits, pg.band_off, ptr, nbr)
    cap = int(n_full) // 2
    for c in (0, cap):
        want, n_want = sweep_cuda.bfs_relax_plain(
            cur, cost, pg.band_bits, pg.band_off, ptr, nbr, c)
        got, n_got = loops.sharded_bfs_relax(planes(lay, cur),
                                             planes(lay, cost), wg, c)
        assert torch.equal(got.gather(), want)
        assert n_got == int(n_want)
    assert cap < int(n_full)   # the capped run stopped before the fixpoint
    assert not torch.equal(got.gather(), full)


def check_stress(w):
    pg, ptr, nbr = sphere_graph()
    r = rng(2)
    n = pg.n_padded
    plate = torch.as_tensor(r.integers(0, 3, n)) + (pg.pos[:, 0] > 0) * 3
    stress = torch.as_tensor(np.where(r.random((n, 2)) < 0.05,
                                      r.random((n, 2)), 0).astype(np.float32))
    subduct = torch.as_tensor((r.random((n, 2)) < 0.3).astype(np.float32))
    ocean = torch.as_tensor(r.random((n, 2)) < 0.3)
    gate = banded.band_gate(plate, pg.band_off, pg.band_mask)
    rem_gate = banded.rem_gate_eq(plate, pg.rem_src, pg.rem_dst)
    state, oc, bits, sptr, snbr, rg = banded.stress_planes(
        stress, subduct, [gate, gate], torch.stack([rem_gate] * 2, 1), ocean,
        pg.band_mask, pg.rem_src, pg.rem_dst)
    lay = layout(w)
    wg = lay.graph(bits, pg.band_off, sptr, snbr)
    for decay, cap in ((0.97, 6), (0.5, 0)):
        want, n_want = sweep_cuda.stress_relax_plain(
            state, oc, bits, pg.band_off, sptr, snbr, rg, decay, 0.99, cap)
        got, n_got = loops.sharded_stress_relax(
            planes(lay, state), planes(lay, oc), wg, rg, decay, 0.99, cap)
        assert torch.equal(got.gather(), want)
        assert n_got == int(n_want)
        assert cap == 0 or n_got == cap


def check_warp(w):
    pg, ptr, nbr = sphere_graph()
    r = rng(3)
    n = pg.n_padded
    state = torch.cat([torch.arange(n, dtype=torch.float32)[None],
                       pg.pos.T]).contiguous()
    tgt = pg.pos + torch.as_tensor(r.normal(0, 0.08, (n, 3))
                                   .astype(np.float32))
    tgt = (tgt / torch.linalg.vector_norm(tgt, dim=1, keepdim=True)).T
    tgt = tgt.contiguous()
    lay = layout(w)
    wg = lay.graph(pg.band_bits, pg.band_off, ptr, nbr)
    for cap in (3, 40):
        want, n_want = sweep_cuda.warp_relax_plain(
            state, tgt, pg.band_bits, pg.band_off, ptr, nbr, cap)
        got, n_got = loops.sharded_warp_relax(planes(lay, state),
                                              planes(lay, tgt), wg, cap)
        assert torch.equal(got.gather(), want)
        assert n_got == int(n_want)
    assert n_got < 40   # it stopped at a sweep that changed nothing


def check_flood(w):
    from planet_heightmap_generation_torch.erosion import flood

    pg, ptr, nbr = sphere_graph()
    elev = terrain(4)
    is_ocean = (elev <= 0) & pg.valid
    open_ocean = flood.open_ocean_mask(is_ocean, pg.valid, *pg.bands)
    inland, _, surface0, frozen = flood._fill_common(
        elev, is_ocean, open_ocean, pg.valid, *pg.bands)
    baked = torch.where(frozen, surface0, elev).to(torch.float32)
    inland_f = inland.to(torch.float32)
    want, _ = sweep_cuda.flood_relax_plain(
        surface0, inland_f, baked, pg.band_bits, pg.band_off, ptr, nbr,
        flood.BIG, flood.EPS)
    lay = layout(w)
    wg = lay.graph(pg.band_bits, pg.band_off, ptr, nbr)
    got, rounds = loops.sharded_flood_relax(
        planes(lay, surface0), planes(lay, inland_f), planes(lay, baked), wg,
        flood.BIG, flood.EPS)
    assert torch.equal(got.gather(), want)
    assert not torch.equal(want, surface0) and rounds >= 2


def check_smooth(w):
    pg, ptr, nbr = sphere_graph()
    r = rng(5)
    n = pg.n_padded
    field = torch.as_tensor(r.normal(size=(2, n)).astype(np.float32))
    mask = torch.as_tensor(r.random(n) < 0.6)
    mf = mask.to(torch.float32)
    lay = layout(w)
    wg = lay.graph(pg.band_bits, pg.band_off, ptr, nbr)
    c_all = banded.banded_count(pg.band_mask, pg.rem_src,
                                dtype=torch.float32) + 1
    c_mask = 1 + banded.banded_sum(mf, *pg.bands)
    for c, gate, upd, passes in ((c_all, None, None, 3),
                                 (c_mask, mf, mf, 2)):
        want = sweep_cuda.smooth_relax_plain(field, c, pg.band_bits,
                                             pg.band_off, ptr, nbr, passes,
                                             gate, upd)
        got = loops.sharded_smooth_relax(
            planes(lay, field), planes(lay, c), wg, passes,
            None if gate is None else planes(lay, gate),
            None if upd is None else planes(lay, upd))
        assert torch.equal(got.gather(), want)


def check_shadow(w):
    pg, ptr, nbr = sphere_graph()
    r = rng(6)
    n = pg.n_padded
    seed = np.where(r.random((n, 2)) < 0.1, r.uniform(-1, 1, (n, 2)), 0)
    state = torch.as_tensor(np.concatenate([seed, seed], 1).T
                            .astype(np.float32)).contiguous()
    wind = r.normal(size=(n, 6)).astype(np.float32)
    aux = torch.cat([pg.pos.T, torch.as_tensor(wind.T)]).contiguous()
    land = torch.as_tensor((r.random(n) < 0.5).astype(np.float32))
    lay = layout(w)
    wg = lay.graph(pg.band_bits, pg.band_off, ptr, nbr)
    want, n_want = sweep_cuda.shadow_relax_plain(
        state, aux, land, pg.band_bits, pg.band_off, ptr, nbr, 0.9, 0.8, 5,
        3)
    got, n_got = loops.sharded_shadow_relax(
        planes(lay, state), planes(lay, aux), planes(lay, land), wg, 0.9,
        0.8, 5, 3)
    assert torch.equal(got.gather(), want)
    assert n_got == int(n_want) == 5


def check_components(w):
    pg, _, _ = sphere_graph()
    n = pg.n_padded
    in_set = torch.as_tensor(rng(7).random(n) < 0.55) & pg.valid
    gate = banded.band_gate(in_set, pg.band_off, pg.band_mask) \
        & in_set[:, None]
    rem_ok = in_set[pg.rem_src] & in_set[pg.rem_dst]
    init = torch.where(in_set, torch.arange(n, dtype=torch.float32),
                       float(n))
    bits = banded.pack_band_bits(gate)
    cptr, cnbr = banded.rem_csr(torch.where(rem_ok, pg.rem_src, n),
                                pg.rem_dst, n)
    want, _ = sweep_cuda.components_relax_plain(
        init, in_set.to(torch.uint8), bits, pg.band_off, cptr, cnbr)
    lay = layout(w)
    wg = lay.graph(bits, pg.band_off, cptr, cnbr)
    got, rounds = loops.sharded_components_relax(planes(lay, init), wg)
    assert torch.equal(got.gather(), want)
    assert len(torch.unique(want[in_set])) > 1 and rounds >= 1
    # and the ungated components of every cell
    full = banded.pack_band_bits(pg.band_mask)
    fptr, fnbr = banded.rem_csr(pg.rem_src, pg.rem_dst, n)
    lab = torch.arange(n, dtype=torch.float32)
    want, _ = sweep_cuda.components_relax_plain(lab, None, full, pg.band_off,
                                                fptr, fnbr)
    got, _ = loops.sharded_components_relax(
        planes(lay, lab), lay.graph(full, pg.band_off, fptr, fnbr))
    assert torch.equal(got.gather(), want)


def check_accumulate(w):
    from planet_heightmap_generation_torch.erosion.fluvial import (
        steepest_receivers)

    pg, _, _ = sphere_graph()
    n = pg.n_padded
    elev = terrain(8)
    is_ocean = (elev <= 0) & pg.valid
    band_dist = banded.band_nbr_dist(pg.pos, pg.band_off, pg.band_mask)
    rem_dist = torch.linalg.vector_norm(pg.pos[pg.rem_src]
                                        - pg.pos[pg.rem_dst], dim=1)
    rcv, _, pit = steepest_receivers(elev, is_ocean, pg.valid, pg.band_off,
                                     pg.band_mask, band_dist, pg.rem_src,
                                     pg.rem_dst, rem_dist)
    land = ~is_ocean & pg.valid
    p = torch.where(land & (rcv >= 0) & ~pit, rcv, n)
    vals = torch.as_tensor(rng(9).random((n, 2)).astype(np.float32))
    lay = layout(w)
    for s, stop in ((land.to(torch.int32), True), (vals, False)):
        want, n_want = sweep_cuda.accumulate_relax_plain(s, p, 12, stop)
        got, n_got = loops.sharded_accumulate_relax(
            windows.split(lay, s), windows.split(lay, p), 12, stop)
        assert torch.equal(got.gather(), want) and n_got == int(n_want)
    want = sweep_cuda.ordered_sum_plain(n, p, vals)
    got = loops.sharded_ordered_sum(n, windows.split(lay, p),
                                    windows.split(lay, vals))
    assert torch.equal(got.gather(), want)
    bins = torch.remainder(torch.arange(n), 37)
    want = sweep_cuda.ordered_sum_plain(37, bins, vals[:, 0].contiguous())
    got = loops.sharded_ordered_sum(37, windows.split(lay, bins),
                                    windows.split(lay, vals[:, 0]))
    assert torch.equal(got, want)


LOOPS = {"bfs_relax": check_bfs, "stress": check_stress, "warp": check_warp,
         "flood": check_flood, "smooth": check_smooth,
         "shadow": check_shadow, "components": check_components,
         "accumulate": check_accumulate}


@pytest.mark.parametrize("w", [2, 3, 8])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_split_loop_matches_unsplit(loop, w):
    LOOPS[loop](w)


# ── the mesh rules ────────────────────────────────────────────────────

def test_mesh_rules(monkeypatch):
    import planet_heightmap_generation_torch.parallel as par

    assert set(par.__all__) == {
        "make_planet_mesh", "cells_mesh", "shard_cells", "replicate",
        "batched_terrain_step", "terrain_step", "generate_batch",
        "sweep_heightmaps"}
    with pytest.raises(ValueError, match="needs as many"):
        cells_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs as many"):
        make_planet_mesh(8, seed_parallel=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide"):
        make_planet_mesh(6, seed_parallel=4, devices=["cpu"] * 6)
    # no CUDA device visible: the default mesh raises, never the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs as many"):
        make_planet_mesh()
    with pytest.raises(ValueError, match="needs as many"):
        cells_mesh(2)
    mesh = make_planet_mesh(6, seed_parallel=3, devices=["cpu"] * 6)
    assert mesh.shape == {"seed": 3, "cells": 2}
    assert cells_mesh(devices=["cpu"] * 5).shape == {"seed": 1, "cells": 5}


def test_shard_gather_roundtrip():
    pg, _, _ = sphere_graph()
    r = rng(10)
    n = pg.n_padded
    x = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32))
    xb = torch.as_tensor(r.normal(size=(4, n)).astype(np.float32))
    mesh = make_planet_mesh(6, seed_parallel=2, devices=["cpu"] * 6)
    sx, s2 = shard_cells(mesh, x, x[:, :2], bands=pg.bands)
    assert torch.equal(gather_cells(sx), x)
    assert torch.equal(gather_cells(s2), x[:, :2])
    assert torch.equal(gather_cells(shard_cells(mesh, xb, batched=True)), xb)
    # windows hold the halo and the remainder slots of their chunk
    lay = sx.rows[0].layout
    assert lay.halo == max(abs(o) for o in pg.band_off)
    for c, win in enumerate(sx.rows[0].windows):
        assert torch.equal(win, x[lay._shards[c]["index"]])
    with pytest.raises(ValueError, match="does not split"):
        shard_cells(mesh, xb[:3], batched=True)
    copies = replicate(mesh, x)
    assert len(copies) == 6 and all(torch.equal(t, x) for t in copies)


def test_nothing_moves_to_the_host(monkeypatch):
    """No function of the split copies a tensor to the host: the sources
    name no host copy, and a split step runs with ``Tensor.cpu`` and
    ``Tensor.numpy`` refusing."""
    for mod in (sharding, windows, loops):
        src = inspect.getsource(mod)
        for word in (r"\.cpu\(", r"\.numpy\(", r"\.tolist\(",
                     r"\bto\(\s*[\"']cpu", r"device=[\"']cpu"):
            assert not re.search(word, src), (mod.__name__, word)

    def refuse(*a, **k):
        raise AssertionError("a tensor was copied to the host")

    _, elev, pg = tiny1500()
    perm, pm12 = tables(1.0)
    mesh = cells_mesh(4, devices=["cpu"] * 4)
    step = batched_terrain_step(mesh, pg.band_off)
    e = torch.as_tensor(elev)[None]
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    out = gather_cells(step(e, pg.pos, pg.band_mask, pg.rem_src, pg.rem_dst,
                            pg.valid, perm[None], pm12[None]))
    assert out.shape == e.shape
