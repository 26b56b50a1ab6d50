"""The port's banded sweep loops, hashes and noise against the JAX jnp
functions on the 2000-cell mesh, inputs made from numpy seeds.

Contracts (each with its reason):

- distance BFS (fixpoint, iteration-capped, random cost), components
  (gated and in-set), flood_assign, carry BFS, stress propagation, ε-fill
  surface and drain pointers, hash01 and the collision pair hash: EXACT.
  Each port sweep is one synchronous iteration of the jnp loop with the
  same float operations (min/max are order-free, the hashes are integer).
- warp: merged elevation close (atol 1e-5) on more than 99.5 % of cells,
  the JAX package's own warp contract (tests/test_sweep_pallas.py:278),
  and, given identical targets, the same source cell on more than 99.5 %
  of cells. The jnp loop updates band by band inside a step, the port's
  sweep is synchronous, so a few cells settle on another local nearest
  candidate (measured on this mesh: 3 of 2000 cells).
- noise: rtol 1e-5 — the f32 expression is the same, but XLA may fuse or
  contract it differently from torch's one-op-at-a-time evaluation.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from planet_heightmap_generation_tpu.mesh.device import to_device as jdevice
from planet_heightmap_generation_torch import interop
from planet_heightmap_generation_torch.ops import banded as tb

import torch_parity as tp

INF = 1e30


@pytest.fixture(scope="module")
def graphs(tiny_sphere):
    """(JAX DeviceGraph, port DeviceGraph) of the same mesh and the same
    band split."""
    g = interop.state_from_numpy(tp.mesh_fields(tiny_sphere))["g"]
    return jdevice(tiny_sphere), g


def _t(a):
    return torch.as_tensor(np.array(a))


def _eq(a, b):
    np.testing.assert_array_equal(np.nan_to_num(np.asarray(a), posinf=INF),
                                  np.nan_to_num(np.asarray(b), posinf=INF))


@pytest.mark.parametrize("op", ["min", "max", "sum", "count", "select",
                                "nbr_dist"])
def test_banded_primitives(graphs, tiny_sphere, op):
    """The neighbour reductions the terrain path builds on, plain and
    gated. Exact, except ``sum``: rtol 1e-6, since the remainder edges'
    scatter-add may sum duplicate destinations in another order."""
    from planet_heightmap_generation_tpu.ops import banded as jb

    jg, g = graphs
    n = g.n_padded
    rng = np.random.default_rng(11)
    field = rng.standard_normal((n, 2)).astype(np.float32)
    classes = (_blobs(tiny_sphere, n, 2) * 2).astype(np.int32) % 3
    jgate = jb.band_gate(jnp.asarray(classes), jg.band_off, jg.band_mask)
    tgate = tb.band_gate(_t(classes), g.band_off, g.band_mask)
    _eq(jgate, tgate)
    if op == "count":
        for gj, gt in ((None, None), (jgate, tgate)):
            _eq(jb.banded_count(jg.band_mask, jg.rem_src, gate=gj),
                tb.banded_count(g.band_mask, g.rem_src, gate=gt))
    elif op == "select":
        key, pay = field[:, 0], field[:, 1]
        for minimize in (False, True):
            a = jb.banded_select(jnp.asarray(key), [jnp.asarray(pay)],
                                 *jg.bands, minimize=minimize)
            b = tb.banded_select(_t(key), [_t(pay)], *g.bands,
                                 minimize=minimize)
            _eq(a[0], b[0])
            _eq(a[1][0], b[1][0])
    elif op == "nbr_dist":
        _eq(jb.band_nbr_dist(jg.pos, jg.band_off, jg.band_mask),
            tb.band_nbr_dist(g.pos, g.band_off, g.band_mask))
    else:
        fa = getattr(jb, f"banded_{op}")
        fb = getattr(tb, f"banded_{op}")
        for x in (field[:, 0], field):
            for gj, gt in ((None, None), (jgate, tgate)):
                a = np.asarray(fa(jnp.asarray(x), *jg.bands, gate=gj))
                b = fb(_t(x), *g.bands, gate=gt).numpy()
                if op == "sum":
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
                else:
                    _eq(a, b)


def _bfs_inputs(n, valid, f=2, seed=0):
    rng = np.random.default_rng(seed)
    seeds = (rng.random((n, f)) < 0.004) & valid[:, None]
    barrier = rng.random((n, f)) < 0.05
    cost = rng.random((n, f)).astype(np.float32) + 0.5
    return seeds, barrier, cost


@pytest.mark.parametrize("case", ["fixpoint", "capped", "rand_cost"])
def test_bfs_exact(graphs, case):
    from planet_heightmap_generation_tpu.ops.banded import _bfs_hops_multi_jnp

    jg, g = graphs
    seeds, barrier, cost = _bfs_inputs(g.n_padded, g.valid.numpy(),
                                       f=4 if case == "rand_cost" else 2,
                                       seed=("fixpoint", "capped",
                                             "rand_cost").index(case))
    hops = {"fixpoint": 0, "capped": 7, "rand_cost": 30}[case]
    rc = cost if case == "rand_cost" else None
    a = _bfs_hops_multi_jnp(jnp.asarray(seeds), jnp.asarray(barrier),
                            *jg.bands, max_hops=hops,
                            rand_cost=None if rc is None else jnp.asarray(rc))
    b = tb.bfs_hops_multi_banded(_t(seeds), _t(barrier), *g.bands,
                                 max_hops=hops,
                                 rand_cost=None if rc is None else _t(rc))
    assert np.isfinite(np.asarray(a)).sum() > 100
    _eq(a, b)


def _blobs(tiny_sphere, n, seed=7):
    rng = np.random.default_rng(seed)
    field = rng.standard_normal(n)
    for _ in range(4):
        field = field + field[np.asarray(tiny_sphere.nbr_idx)].mean(1)
    return field


def test_components_exact(graphs, tiny_sphere):
    from planet_heightmap_generation_tpu.erosion.flood import _cc_inset_jnp
    from planet_heightmap_generation_tpu.ops.banded import _cc_gated_jnp
    from planet_heightmap_generation_torch.erosion.flood import (
        connected_components_banded)

    jg, g = graphs
    field = _blobs(tiny_sphere, g.n_padded)
    in_set = (field > 0) & g.valid.numpy()
    _eq(_cc_inset_jnp(jnp.asarray(in_set), *jg.bands),
        connected_components_banded(_t(in_set), *g.bands))
    classes = (field * 2).astype(np.int32) % 3
    a = _cc_gated_jnp(jnp.asarray(classes), *jg.bands)
    b = tb.connected_components_gated(_t(classes), *g.bands)
    assert b.dtype == torch.int32 and len(np.unique(np.asarray(a))) > 3
    _eq(a, b)


def _components_before(init_lab, member, gate_bits, rem_ok, band_off,
                       rem_src, rem_dst):
    """(labels, steps) of the components loop the port ran before its
    components launch: a one-sweep BFS, then the remainder edges, hooking
    and two jumps as torch scatters, until a step changes nothing."""
    from planet_heightmap_generation_torch.ops import sweep_cuda

    n = init_lab.shape[0]
    cost = torch.zeros((1, n))
    src, dst = rem_src[rem_ok], rem_dst[rem_ok]
    members = torch.nonzero(member).flatten()
    prev, steps = init_lab, 0
    while True:
        new = sweep_cuda.bfs_sweep_plain(prev[None], cost, gate_bits,
                                         band_off)[0]
        new = new.scatter_reduce(0, src, prev[dst], "amin")
        new = new.scatter_reduce(0, prev[members].long(), new[members],
                                 "amin")
        for _ in range(2):
            new = torch.where(member, new[new.long().clamp(0, n - 1)], new)
        steps += 1
        if torch.equal(new, prev):
            return new, steps
        prev = new


@pytest.mark.parametrize("case", ["all_cells", "subset", "isolated_cells"])
def test_components_relax_plain_equals_the_loop_it_replaced(graphs,
                                                            tiny_sphere,
                                                            case):
    """``components_relax_plain`` (the oracle of the components launch):
    the labels and the step count of the loop it replaced, bit for bit,
    and the labels of the JAX ``connected_components_gated`` (every cell a
    member, same-class gate) or ``connected_components_banded`` (a strict
    subset; with isolated cells: members none of whose neighbours is
    one)."""
    from planet_heightmap_generation_tpu.erosion.flood import (
        connected_components_banded as jcc_in)
    from planet_heightmap_generation_tpu.ops.banded import (
        connected_components_gated as jcc_gated)
    from planet_heightmap_generation_torch.ops import sweep_cuda

    jg, g = graphs
    n = g.n_padded
    field = _blobs(tiny_sphere, n, 11)
    ar = torch.arange(n, dtype=torch.float32)
    if case == "all_cells":
        classes = _t((field * 2).astype(np.int32) % 3)
        member = torch.ones(n, dtype=torch.bool)
        bits = tb.pack_band_bits(tb.band_gate(classes, *g.bands[:2]))
        rem_ok = tb.rem_gate_eq(classes, *g.bands[2:])
        init = ar
        want = jcc_gated(jnp.asarray(classes.numpy()), *jg.bands)
    else:
        in_set = (field > 0.3) & g.valid.numpy()
        if case == "isolated_cells":
            lone = np.random.default_rng(12).choice(
                np.flatnonzero(~in_set & g.valid.numpy()), 40, replace=False)
            in_set[lone] = True
        member = _t(in_set)
        gate = tb.band_gate(member, *g.bands[:2]) & member[:, None]
        bits = tb.pack_band_bits(gate)
        rem_ok = member[g.rem_src] & member[g.rem_dst]
        init = torch.where(member, ar, float(n))
        want = jcc_in(jnp.asarray(in_set), *jg.bands)
    ptr, nbr = tb.rem_csr(torch.where(rem_ok, g.rem_src, n), g.rem_dst, n)
    lab, steps = sweep_cuda.components_relax_plain(
        init, None if case == "all_cells" else member.to(torch.uint8), bits,
        g.band_off, ptr, nbr)
    ref, ref_steps = _components_before(init, member, bits, rem_ok,
                                        g.band_off, g.rem_src, g.rem_dst)
    assert torch.equal(lab, ref) and int(steps) == ref_steps > 1
    _eq(want, lab.to(torch.int32))
    if case == "isolated_cells":
        assert bool((lab[_t(lone)] == _t(lone).float()).any())


def test_flood_assign_exact(graphs, tiny_sphere):
    from planet_heightmap_generation_tpu.ops.banded import (
        flood_assign_banded as jflood)

    jg, g = graphs
    rng = np.random.default_rng(5)
    n = g.n_padded
    value = rng.integers(0, 9, n).astype(np.int32)
    frontier = (_blobs(tiny_sphere, n, 5) > 0.5) & g.valid.numpy()
    va, ra = jflood(jnp.asarray(value), jnp.asarray(frontier), *jg.bands)
    vb, rb = tb.flood_assign_banded(_t(value), _t(frontier), *g.bands)
    _eq(va, vb)
    _eq(ra, rb)


def test_carry_bfs_exact(graphs, tiny_sphere):
    """Both terrain-path uses: a single tie-broken field with three carries,
    and five fields with per-field caps, receiver masks and a mixed
    same-class gate."""
    from planet_heightmap_generation_tpu.ops.banded import (
        band_bfs_banded as jbfs, band_gate as jgate, rem_gate_eq as jrgate)

    jg, g = graphs
    n = g.n_padded
    rng = np.random.default_rng(9)
    valid = g.valid.numpy()
    seeds1 = (rng.random((n, 1)) < 0.02) & valid[:, None]
    carr = rng.random((3, n, 1)).astype(np.float32)
    a = jbfs(jnp.asarray(seeds1), jnp.asarray(carr), *jg.bands, max_hops=9,
             tie=jnp.asarray(carr[0]), num_carry=3)
    b = tb.band_bfs_banded(_t(seeds1), _t(carr), *g.bands, max_hops=9,
                           tie=_t(carr[0]), num_carry=3)
    for x, y in zip(a, b):
        _eq(x, y)

    classes = (_blobs(tiny_sphere, n, 3) * 2).astype(np.int32) % 4
    seeds5 = (rng.random((n, 5)) < 0.01) & valid[:, None]
    allow = (rng.random((n, 5)) < 0.8) & valid[:, None]
    carr5 = rng.random((1, n, 5)).astype(np.float32)
    use = np.asarray([True, False, False, True, True])
    caps = np.asarray([3, 5, 4, 7, 6], np.int32)
    jgt, jrg = jgate(jnp.asarray(classes), *jg.bands[:2]), jrgate(
        jnp.asarray(classes), jg.rem_src, jg.rem_dst)
    a = jbfs(jnp.asarray(seeds5), jnp.asarray(carr5), *jg.bands, max_hops=7,
             hops_cap=caps, allow=jnp.asarray(allow), gate_mix=(jgt, use),
             rem_gate=jnp.where(use[None, :], jrg[:, None], True),
             num_carry=1)
    tcl = _t(classes)
    rg = tb.rem_gate_eq(tcl, g.rem_src, g.rem_dst)
    b = tb.band_bfs_banded(
        _t(seeds5), _t(carr5), *g.bands, max_hops=7, hops_cap=caps,
        allow=_t(allow), gate_mix=(tb.band_gate(tcl, *g.bands[:2]), use),
        rem_gate=torch.stack([rg if u else torch.ones_like(rg) for u in use],
                             1), num_carry=1)
    real = np.asarray(jg.rem_src) < n
    assert np.isfinite(np.asarray(a[0])).sum() > 200
    for x, y in zip(a, b):
        _eq(x, y)
    assert np.asarray(jrg)[real].tolist() == rg.tolist()


def test_stress_exact(graphs):
    from planet_heightmap_generation_tpu.ops.banded import (
        _propagate_stress_jnp, band_gate as jgate, rem_gate_eq as jrgate)

    jg, g = graphs
    n = g.n_padded
    rng = np.random.default_rng(3)
    plate = rng.integers(0, 5, (n, 2)).astype(np.int32)
    plate[:, 1] //= 2
    st0 = np.where(rng.random((n, 2)) < 0.01,
                   rng.random((n, 2)), 0.0).astype(np.float32)
    sf0 = rng.random((n, 2)).astype(np.float32)
    ocean = rng.random((n, 2)) < 0.3
    decay, sub_decay, passes = 0.93, 0.78, 40

    jp = [jnp.asarray(plate[:, k]) for k in range(2)]
    a_st, a_sf = _propagate_stress_jnp(
        jnp.asarray(st0), jnp.asarray(sf0),
        tuple(jgate(p, jg.band_off, jg.band_mask) for p in jp),
        jnp.stack([jrgate(p, jg.rem_src, jg.rem_dst) for p in jp], 1),
        jnp.asarray(ocean), jg.band_off, jg.band_mask, jg.rem_src,
        jg.rem_dst, jnp.float32(decay), jnp.float32(sub_decay), passes)
    tp = [_t(plate[:, k]) for k in range(2)]
    b_st, b_sf = tb.propagate_stress_banded(
        _t(st0), _t(sf0), tuple(tb.band_gate(p, *g.bands[:2]) for p in tp),
        torch.stack([tb.rem_gate_eq(p, g.rem_src, g.rem_dst) for p in tp], 1),
        _t(ocean), *g.bands, decay, sub_decay, passes)
    assert (np.asarray(a_st) > 0.01).sum() > 3 * (st0 > 0.01).sum()
    _eq(a_st, b_st)
    _eq(a_sf, b_sf)


def test_hashes_exact():
    from planet_heightmap_generation_tpu.elevation.collisions import (
        _pair_intensity)
    from planet_heightmap_generation_tpu.ops.graph import hash01 as jhash
    from planet_heightmap_generation_torch.elevation.collisions import (
        pair_intensity)
    from planet_heightmap_generation_torch.ops.graph import hash01

    idx = np.arange(300_000, dtype=np.int32)
    for salt in (0, 7919, 123 + 5, 16_777_215 + 4):
        _eq(jhash(jnp.asarray(idx), salt), hash01(_t(idx), salt))
    rng = np.random.default_rng(1)
    a = rng.integers(0, 120, 5000).astype(np.int32)
    b = rng.integers(0, 120, 5000).astype(np.int32)
    _eq(_pair_intensity(jnp.asarray(a), jnp.asarray(b)),
        pair_intensity(_t(a), _t(b)))


def test_epsilon_fill_exact(graphs, tiny_sphere):
    from planet_heightmap_generation_tpu.erosion.flood import (
        _epsilon_fill_jnp, open_ocean_mask as joo)
    from planet_heightmap_generation_tpu.ops.noise import SimplexNoise
    from planet_heightmap_generation_torch.erosion.flood import (
        epsilon_fill, open_ocean_mask)

    jg, g = graphs
    sn = SimplexNoise(3.0)
    pos = tiny_sphere.pos
    e = np.asarray(sn.fbm(pos[:, 0] * 2, pos[:, 1] * 2, pos[:, 2] * 2))
    e = np.where(tiny_sphere.valid, e * 0.6 + 0.25 * pos[:, 2],
                 0.0).astype(np.float32)
    elev = jnp.asarray(e)
    is_ocean = (elev <= 0) & jg.valid
    oo = joo(is_ocean, jg.valid, *jg.bands)
    sa, da = _epsilon_fill_jnp(elev, is_ocean, oo, jg.valid, *jg.bands)
    t_ocean = _t(is_ocean)
    t_oo = open_ocean_mask(t_ocean, g.valid, *g.bands)
    _eq(oo, t_oo)
    sb, db = epsilon_fill(_t(e), t_ocean, t_oo, g.valid, *g.bands)
    assert (np.asarray(sa) > e + 1e-7).sum() > 10       # pits were filled
    _eq(sa, sb)
    _eq(da, db)


def test_warp_matches_jax_contract(graphs):
    from planet_heightmap_generation_tpu.erosion.warp import (
        _warp_terrain_jnp, _warp_targets)
    from planet_heightmap_generation_tpu.ops.noise import tables as jtables
    from planet_heightmap_generation_tpu.ops.noise import fbm as jfbm
    from planet_heightmap_generation_torch.erosion.warp import (
        warp_terrain, warp_targets)
    from planet_heightmap_generation_torch.ops.noise import tables

    jg, g = graphs
    pos = jg.pos
    elev = jfbm(jtables(7.0), pos[:, 0] * 3, pos[:, 1] * 3, pos[:, 2] * 3,
                4) * 0.5
    elev = np.asarray(jnp.where(jg.valid, elev, 0.0))
    hot = np.zeros_like(elev)
    a = np.asarray(_warp_terrain_jnp(
        jnp.asarray(elev), pos, jg.valid, *jg.bands, noise_t=jtables(9.0),
        strength=jnp.float32(0.5), hotspot=jnp.asarray(hot), max_steps=20))
    strength = torch.tensor(0.5, dtype=torch.float32)
    b = warp_terrain(_t(elev), g.pos, g.valid, *g.bands,
                     noise_t=tables(9.0), strength=strength,
                     hotspot=_t(hot), max_steps=20).numpy()
    close = np.isclose(a, b, atol=1e-5)
    assert close.mean() > 0.995, f"warp mismatch on {(~close).sum()} cells"
    assert np.abs(a - b).max() < 0.5
    wa = np.asarray(_warp_targets(pos, jtables(9.0), jnp.float32(0.5)))
    wb = warp_targets(g.pos, tables(9.0), strength).numpy()
    np.testing.assert_allclose(wa, wb, rtol=1e-5, atol=1e-6)


def test_warp_sources_given_identical_targets(graphs):
    """Both searches from the same targets ``w`` (the JAX ones): the source
    cell each one picks. The JAX loop's sources are read back from its
    merged output: with an elevation that codes the cell index, no hotspot
    and strength 0.5, the merge is the mean of own and warped elevation."""
    from planet_heightmap_generation_tpu.erosion.warp import (
        _warp_terrain_jnp, _warp_targets)
    from planet_heightmap_generation_tpu.ops.noise import tables as jtables
    from planet_heightmap_generation_torch.erosion.warp import warp_sources

    jg, g = graphs
    n, steps = g.n_padded, 20
    code = ((np.arange(n) + 1) * 1e-3).astype(np.float32)
    merged = np.asarray(_warp_terrain_jnp(
        jnp.asarray(code), jg.pos, jnp.ones(n, bool), *jg.bands,
        noise_t=jtables(9.0), strength=jnp.float32(0.5),
        hotspot=jnp.zeros(n), max_steps=steps))
    src_a = np.rint((2.0 * merged.astype(np.float64) - code) / 1e-3) - 1
    w = np.array(_warp_targets(jg.pos, jtables(9.0), jnp.float32(0.5)))
    src_b = warp_sources(g.pos, _t(w), *g.bands, max_steps=steps).numpy()
    valid = g.valid.numpy()
    same = (src_a == src_b)[valid]
    assert (src_b[valid] != np.flatnonzero(valid)).sum() > 100   # cells moved
    assert same.mean() > 0.995, f"sources differ on {(~same).sum()} cells"


def test_noise_close():
    from planet_heightmap_generation_tpu.ops import noise as jn
    from planet_heightmap_generation_torch.ops import noise as tn

    rng = np.random.default_rng(4)
    p = (rng.standard_normal((3, 20000)) * 3).astype(np.float32)
    jt, tt = jn.tables(42.0), tn.tables(42.0)
    for fa, fb, kw in ((jn.noise3, tn.noise3, {}),
                       (jn.fbm, tn.fbm, dict(octaves=4, persistence=0.5)),
                       (jn.ridged_fbm, tn.ridged_fbm, dict(octaves=3))):
        a = np.asarray(fa(jt, *map(jnp.asarray, p), **kw))
        b = fb(tt, *map(_t, p), **kw).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
