"""The port's gather-form graph ops (ops/graph.py) and climate utilities
(climate/util.py) against the JAX functions on the same numpy inputs, on
the 2000-cell mesh; the port's banded forms against its gather forms; and
the field groups of the smoothing launch.

Contracts (each with its reason):

- gather, masked min / max, components, flood_assign, the hop, multi-field
  and band BFS, carry BFS: EXACT. Each loop is the JAX ``while_loop``
  sweep for sweep with the same operations (gathers, min / max, one f32
  add, integer hops; ``torch.argmin`` and ``jnp.argmin`` both take the
  first slot of a tie).
- masked mean, smooth_field, smooth_masked, compute_gradients: rtol 1e-6,
  with an atol of 1e-6 times the output's largest magnitude for values
  near zero, where the gradients' neighbour terms cancel: XLA adds the
  sums over the K neighbour slots in another order (and may contract
  them), so the last bits differ.
- banded against gather, within the port: the tolerances of
  tests/test_banded.py, which holds the JAX banded forms to the same
  oracles.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from planet_heightmap_generation_tpu.mesh.device import to_device as jdevice
from planet_heightmap_generation_tpu.ops import graph as jgraph
from planet_heightmap_generation_tpu.climate import util as jutil
from planet_heightmap_generation_torch import interop
from planet_heightmap_generation_torch.ops import banded as tb
from planet_heightmap_generation_torch.ops import graph as tgraph
from planet_heightmap_generation_torch.ops import sweep_cuda
from planet_heightmap_generation_torch.climate import util as tutil

import torch_parity as tp

INF = 1e30


@pytest.fixture(scope="module")
def graphs(tiny_sphere):
    """(JAX DeviceGraph, port DeviceGraph) of the same mesh and band
    split."""
    g = interop.state_from_numpy(tp.mesh_fields(tiny_sphere))["g"]
    return jdevice(tiny_sphere), g


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return np.nan_to_num(np.asarray(x, np.float64), posinf=INF, neginf=-INF)


def _inputs(g, seed):
    """Numpy inputs on the mesh: a smooth field, a bool mask of blobs, and
    a class label per cell."""
    rng = np.random.default_rng(seed)
    n = g.n_padded
    ni = g.nbr_idx.numpy()
    field = rng.standard_normal(n)
    for _ in range(3):
        field = field + field[ni].mean(1)
    valid = g.valid.numpy()
    return (rng, field.astype(np.float32), (field > 0.3) & valid,
            (field * 2).astype(np.int32) % 3)


def _jax_port(name, jg, g):
    """(JAX outputs, port outputs) of ``name`` on the same inputs."""
    rng, field, blob, classes = _inputs(g, len(name))
    n = g.n_padded
    valid = g.valid.numpy()
    ji, jm = jg.nbr_idx, jg.nbr_mask
    ti, tm = g.nbr_idx, g.nbr_mask
    if name in ("gather_nbrs",):
        return (jgraph.gather_nbrs(jnp.asarray(field), ji),
                tgraph.gather_nbrs(_t(field), ti))
    if name in ("masked_min_nbr", "masked_max_nbr", "masked_mean_nbr"):
        return (getattr(jgraph, name)(jnp.asarray(field), ji, jm),
                getattr(tgraph, name)(_t(field), ti, tm))
    if name == "connected_components":
        same = classes[np.asarray(ji)] == classes[:, None]
        return (jgraph.connected_components(ji, jm, jnp.asarray(same)),
                tgraph.connected_components(ti, tm, _t(same)))
    if name == "flood_assign":
        value = rng.integers(0, 9, n).astype(np.int32)
        return (jgraph.flood_assign(jnp.asarray(value), jnp.asarray(blob),
                                    ji, jm),
                tgraph.flood_assign(_t(value), _t(blob), ti, tm))
    if name == "bfs_hops":
        seeds = (rng.random(n) < 0.005) & valid
        barrier = rng.random(n) < 0.05
        cost = (rng.random(n) + 0.5).astype(np.float32)
        out = []
        for hops, c in ((0, None), (6, None), (0, cost)):
            kw = dict(max_hops=hops)
            out.append((jgraph.bfs_hops(
                jnp.asarray(seeds), jnp.asarray(barrier), ji, jm,
                rand_cost=None if c is None else jnp.asarray(c), **kw),
                tgraph.bfs_hops(_t(seeds), _t(barrier), ti, tm,
                                rand_cost=None if c is None else _t(c), **kw)))
        return tuple(zip(*out))
    if name == "bfs_hops_multi":
        seeds = (rng.random((n, 3)) < 0.005) & valid[:, None]
        barrier = rng.random((n, 3)) < 0.05
        cost = (rng.random((n, 3)) + 0.5).astype(np.float32)
        return (jgraph.bfs_hops_multi(jnp.asarray(seeds), jnp.asarray(barrier),
                                      ji, jm, rand_cost=jnp.asarray(cost)),
                tgraph.bfs_hops_multi(_t(seeds), _t(barrier), ti, tm,
                                      rand_cost=_t(cost)))
    if name == "band_bfs":
        f = 3
        seeds = (rng.random((n, f)) < 0.01) & valid[:, None]
        carr = rng.random((2, n, f)).astype(np.float32) * seeds[None]
        tie = rng.random((n, f)).astype(np.float32) * seeds
        allow = rng.random((n, f)) < 0.9
        caps = np.asarray([6, 9, 4], np.int32)
        gate = (classes[np.asarray(ji)] == classes[:, None]) & np.asarray(jm)
        use = np.asarray([True, False, True])
        return (jgraph.band_bfs(
            jnp.asarray(seeds), jnp.asarray(carr), ji, jm, max_hops=9,
            hops_cap=jnp.asarray(caps), allow=jnp.asarray(allow),
            edge_gate=jnp.asarray(gate), use_gate=jnp.asarray(use),
            tie=jnp.asarray(tie), num_carry=2),
            tgraph.band_bfs(
                _t(seeds), _t(carr), ti, tm, max_hops=9, hops_cap=_t(caps),
                allow=_t(allow), edge_gate=_t(gate), use_gate=_t(use),
                tie=_t(tie), num_carry=2))
    if name == "carry_bfs":
        seeds = (rng.random(n) < 0.03) & valid
        carr = rng.random((3, n)).astype(np.float32)
        same = (classes[np.asarray(ji)] == classes[:, None])
        allow = rng.random(n) < 0.9
        return (jgraph.carry_bfs(
            jnp.asarray(seeds), jnp.asarray(carr), ji, jm, max_hops=8,
            allow=jnp.asarray(allow), edge_same=jnp.asarray(same),
            tie=jnp.asarray(carr[0]), num_carry=3),
            tgraph.carry_bfs(
                _t(seeds), _t(carr), ti, tm, max_hops=8, allow=_t(allow),
                edge_same=_t(same), tie=_t(carr[0]), num_carry=3))
    if name == "smooth_field":
        f2 = rng.standard_normal((n, 2)).astype(np.float32)
        return ((jutil.smooth_field(jnp.asarray(field), ji, jm, 4),
                 jutil.smooth_field(jnp.asarray(f2), ji, jm, 3)),
                (tutil.smooth_field(_t(field), ti, tm, 4),
                 tutil.smooth_field(_t(f2), ti, tm, 3)))
    if name == "smooth_masked":
        f2 = rng.standard_normal((n, 2)).astype(np.float32)
        return ((jutil.smooth_masked(jnp.asarray(field), jnp.asarray(blob),
                                     ji, jm, 5),
                 jutil.smooth_masked(jnp.asarray(f2), jnp.asarray(blob),
                                     ji, jm, 2)),
                (tutil.smooth_masked(_t(field), _t(blob), ti, tm, 5),
                 tutil.smooth_masked(_t(f2), _t(blob), ti, tm, 2)))
    if name == "compute_gradients":
        f2 = np.stack([field, rng.standard_normal(n).astype(np.float32)], 1)
        jf = jutil.geo_frame(jg.pos)
        east, north = np.asarray(jf.east), np.asarray(jf.north)
        return ((*jutil.compute_gradients(jg.pos, jnp.asarray(field),
                                          jnp.asarray(east),
                                          jnp.asarray(north), ji, jm),
                 *jutil.compute_gradients(jg.pos, jnp.asarray(f2),
                                          jnp.asarray(east),
                                          jnp.asarray(north), ji, jm)),
                (*tutil.compute_gradients(g.pos, _t(field), _t(east),
                                          _t(north), ti, tm),
                 *tutil.compute_gradients(g.pos, _t(f2), _t(east),
                                          _t(north), ti, tm)))
    raise KeyError(name)


EXACT = ("gather_nbrs", "masked_min_nbr", "masked_max_nbr",
         "connected_components", "flood_assign", "bfs_hops",
         "bfs_hops_multi", "band_bfs", "carry_bfs")
CLOSE = ("masked_mean_nbr", "smooth_field", "smooth_masked",
         "compute_gradients")


@pytest.mark.parametrize("name", EXACT + CLOSE)
def test_gather_forms_match_jax(graphs, name):
    jg, g = graphs
    a, b = _jax_port(name, jg, g)
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = _np(x), _np(y.numpy())
        assert x.shape == y.shape
        if name in EXACT:
            np.testing.assert_array_equal(y, x)
        else:
            np.testing.assert_allclose(y, x, rtol=1e-6,
                                       atol=1e-6 * np.abs(x).max())
    if name in ("bfs_hops", "band_bfs", "carry_bfs", "flood_assign"):
        # the loops reached cells beyond their seeds
        assert (np.isfinite(np.asarray(a[0], np.float64))).sum() > 100


# ── the port's banded forms against its gather forms ─────────────────

BANDED = ("min_max", "sum_count", "bfs_hops_multi", "smooth_field",
          "smooth_masked", "band_bfs", "compute_gradients",
          "components", "flood_assign")


@pytest.mark.parametrize("op", BANDED)
def test_banded_forms_match_gather_forms(graphs, op):
    _, g = graphs
    rng, field, blob, classes = _inputs(g, 100 + len(op))
    n = g.n_padded
    valid = g.valid.numpy()
    ti, tm = g.nbr_idx, g.nbr_mask
    f = _t(field)
    has = tm.any(1)
    if op == "min_max":
        for gather, band in ((tgraph.masked_min_nbr, tb.banded_min),
                             (tgraph.masked_max_nbr, tb.banded_max)):
            assert torch.equal(band(f, *g.bands)[has],
                               gather(f, ti, tm)[has])
    elif op == "sum_count":
        ref = torch.where(tm, f[ti], 0.0).sum(1)
        np.testing.assert_allclose(tb.banded_sum(f, *g.bands).numpy(),
                                   ref.numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(tb.banded_count(g.band_mask, g.rem_src).long(),
                           tm.sum(1))
    elif op == "bfs_hops_multi":
        seeds = _t((rng.random((n, 3)) < 0.005) & valid[:, None])
        barrier = _t(rng.random((n, 3)) < 0.05)
        cost = _t((rng.random((n, 3)) + 0.5).astype(np.float32))
        ref = tgraph.bfs_hops_multi(seeds, barrier, ti, tm, rand_cost=cost)
        got = tb.bfs_hops_multi_banded(seeds, barrier, *g.bands,
                                       rand_cost=cost)
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isfinite(got), fin)
        np.testing.assert_allclose(got[fin].numpy(), ref[fin].numpy(),
                                   rtol=1e-5)
    elif op in ("smooth_field", "smooth_masked"):
        f2 = _t(rng.standard_normal((n, 2)).astype(np.float32))
        for x, passes in ((f, 4), (f2, 3)):
            if op == "smooth_field":
                ref = tutil.smooth_field(x, ti, tm, passes)
                got = tb.smooth_field_banded(x, *g.bands, passes)
            else:
                m = _t(blob)
                ref = tutil.smooth_masked(x, m, ti, tm, passes)
                got = tb.smooth_masked_banded(x, m, *g.bands, passes)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                                       atol=2e-5)
    elif op == "band_bfs":
        k = 3
        seeds = (rng.random((n, k)) < 0.01) & valid[:, None]
        carr = rng.random((2, n, k)).astype(np.float32) * seeds[None]
        tie = rng.random((n, k)).astype(np.float32) * seeds
        allow = np.ones((n, k), bool)
        allow[g.pos.numpy()[:, 2] > 0.9, 1] = False
        caps = [6, 9, 4]
        lab = _t(classes)
        use = np.asarray([True, False, True])
        ref = tgraph.band_bfs(
            _t(seeds), _t(carr), ti, tm, max_hops=9, hops_cap=caps,
            allow=_t(allow), edge_gate=(lab[ti] == lab[:, None]) & tm,
            use_gate=_t(use), tie=_t(tie), num_carry=2)
        rg = tb.rem_gate_eq(lab, g.rem_src, g.rem_dst)
        got = tb.band_bfs_banded(
            _t(seeds), _t(carr), *g.bands, max_hops=9, hops_cap=caps,
            allow=_t(allow),
            gate_mix=(tb.band_gate(lab, g.band_off, g.band_mask), use),
            rem_gate=torch.stack([rg if u else torch.ones_like(rg)
                                  for u in use], 1),
            tie=_t(tie), num_carry=2)
        assert torch.equal(torch.isfinite(got[0]), torch.isfinite(ref[0]))
        fin = torch.isfinite(ref[0])
        assert torch.equal(got[0][fin], ref[0][fin])
        assert np.isclose(got[1].numpy(), ref[1].numpy(),
                          atol=2e-5).mean() > 0.995
        assert (got[2] == ref[2]).float().mean() > 0.995
    elif op == "compute_gradients":
        gf = tutil.geo_frame(g.pos)
        f2 = _t(rng.standard_normal((n, 2)).astype(np.float32))
        ref = tutil.compute_gradients(g.pos, f2, gf.east, gf.north, ti, tm)
        got = tb.compute_gradients_banded(g.pos, f2, gf.east, gf.north,
                                          *g.bands)
        for x, y in zip(got, ref):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=5e-3,
                                       atol=5e-4)
    elif op == "components":
        lab = _t(classes)
        ref = tgraph.connected_components(ti, tm, lab[ti] == lab[:, None])
        got = tb.connected_components_gated(lab, *g.bands)
        assert torch.equal(got, ref)
    elif op == "flood_assign":
        value = _t(rng.integers(0, 9, n).astype(np.int32))
        ref = tgraph.flood_assign(value, _t(blob), ti, tm)
        got = tb.flood_assign_banded(value, _t(blob), *g.bands)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# ── the smoothing launch's field groups ──────────────────────────────

# (band half-width H, fields F, groups): the 204K and 1M meshes (H 1,597
# and 3,571) in one group; ±5,760 (2.56M) and ±7,200 (~4M) in 2 + 2, where
# one four-field launch took T 2,933 and 53; ±7,300 and the 4.5M mesh
# (~7,640), where four windows no longer fit, one field a group
GROUPS = [
    (1597, 4, [(0, 4)]), (3571, 4, [(0, 4)]), (3571, 3, [(0, 3)]),
    (5760, 4, [(0, 2), (2, 4)]), (5760, 2, [(0, 2)]),
    (7200, 4, [(0, 2), (2, 4)]), (7200, 3, [(0, 2), (2, 3)]),
    (7300, 4, [(0, 1), (1, 2), (2, 3), (3, 4)]),
    (7640, 2, [(0, 1), (1, 2)]), (20000, 1, [(0, 1)]),
]


@pytest.mark.parametrize("h,f,groups", GROUPS)
def test_smooth_groups(h, f, groups):
    assert sweep_cuda.smooth_groups(f, h) == groups
    size = groups[0][1] - groups[0][0]
    # every group's windows fit (T >= 1); the chosen size covers its halo
    # unless it is one field
    assert sweep_cuda.capped_chunk(size, h) >= (2 * h if size > 1 else 1)
    assert size == f or sweep_cuda.capped_chunk(size + 1, h) < 2 * h


def test_smooth_groups_fit_up_to_the_one_field_limit():
    """One field's window fits up to H 28,922 (~66M cells); from 28,923
    the one-field launch is refused, as before grouping."""
    for h in range(0, 28_923, 97):
        for f in range(1, sweep_cuda.SMOOTH_MAX_FIELDS + 1):
            groups = sweep_cuda.smooth_groups(f, h)
            assert groups[0][0] == 0 and groups[-1][1] == f
            assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
            assert sweep_cuda.capped_chunk(groups[0][1], h) >= 1
    assert sweep_cuda.capped_chunk(1, 28_922) >= 1
    assert sweep_cuda.capped_chunk(1, 28_923) < 1


@pytest.mark.parametrize("masked", [False, True])
def test_grouped_plain_smoothing_equals_one_launch(graphs, masked):
    """The plain smoothing loop run group by group (4 fields as 2 + 2 and
    as 1 + 1 + 1 + 1) equals the same loop over all four fields, bit for
    bit: a field's passes read no other field."""
    _, g = graphs
    rng = np.random.default_rng(4)
    n = g.n_padded
    field = _t(rng.standard_normal((4, n)).astype(np.float32))
    bits = tb.pack_band_bits(g.band_mask)
    ptr, nbr = tb.rem_csr(g.rem_src, g.rem_dst, n)
    gate = upd = None
    if masked:
        gate = _t((rng.random(n) < 0.8).astype(np.float32))
        upd = _t((rng.random(n) < 0.9).astype(np.float32))
    c = tb.banded_count(g.band_mask, g.rem_src, dtype=torch.float32) + 1
    whole = sweep_cuda.smooth_relax_plain(field, c, bits, g.band_off, ptr,
                                          nbr, 3, gate, upd)
    for h in (7200, 7300):
        grouped = torch.cat([
            sweep_cuda.smooth_relax_plain(field[lo:hi], c, bits, g.band_off,
                                          ptr, nbr, 3, gate, upd)
            for lo, hi in sweep_cuda.smooth_groups(4, h)])
        assert torch.equal(grouped, whole)
