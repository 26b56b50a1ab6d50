"""The stress and smoothing relax loops of the port (ops/sweep_cuda.py
``stress_relax`` / ``smooth_relax``, through their plain versions on the
CPU) and the row-walk remainder sum of ``banded_sum``, against the JAX jnp
functions on the 2000-cell mesh, inputs made from numpy seeds.

Contracts (each with its reason):

- stress, G = 1 and G = 2 layers (same-plate gates of a small and a
  super-plate map), with a cap that binds, a fixpoint before the cap and
  random decays: EXACT against ``_propagate_stress_jnp`` in stress and
  subduct factor, and the same number of sweeps. Each sweep is one Jacobi
  iteration of the jnp loop with the same float operations (one multiply
  per sender); the jnp returns no count, so the count is pinned by the jnp
  loop's own results at caps just below it. The remainder payload rule
  (largest sf among the edges with the largest key) is the jnp's
  two-phase scatter-max; a built tie checks it.
- smoothing (plain, masked, frozen cells) at F = 1, 2 and 4 and an odd
  and an even pass count: rtol 2e-6 / atol 2e-6 (diffuse warmth rtol
  2e-5), the contracts of tests/test_torch_climate_ops.py (the JAX
  package's own, tests/test_sweep_pallas.py:121,126,230).
- ``banded_sum``'s remainder rows: EXACT against the edge-order scatter
  they replaced, on the CPU where that scatter adds in edge order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from planet_heightmap_generation_tpu.mesh.device import to_device as jdevice
from planet_heightmap_generation_torch import interop
from planet_heightmap_generation_torch.ops import banded as tb
from planet_heightmap_generation_torch.ops import sweep_cuda as sc

import torch_parity as tp


@pytest.fixture(scope="module")
def graphs(tiny_sphere):
    """(JAX DeviceGraph, port DeviceGraph) of the same mesh and the same
    band split."""
    g = interop.state_from_numpy(tp.mesh_fields(tiny_sphere))["g"]
    assert g.rem_src.shape[0] > 0
    return jdevice(tiny_sphere), g


def _t(a):
    return torch.as_tensor(np.array(a))


def _plates(g, n_layers):
    """Same-plate maps from the mesh positions: 6 small plates and, for a
    second layer, 2 super plates that each join three of them."""
    pos = g.pos.numpy()
    small = ((pos[:, 0] > 0).astype(np.int32)
             + 2 * np.digitize(pos[:, 2], [-0.3, 0.4]).astype(np.int32))
    return [small, small % 2][:n_layers]


def _stress_inputs(g, n_layers, seed, stmax):
    rng = np.random.default_rng(seed)
    n = g.n_padded
    st0 = np.where(rng.random((n, n_layers)) < 0.01,
                   rng.random((n, n_layers)) * stmax, 0.0).astype(np.float32)
    sf0 = rng.random((n, n_layers)).astype(np.float32)
    ocean = rng.random((n, n_layers)) < 0.2
    return st0, sf0, ocean


def _jnp_stress(jg, plates, st0, sf0, ocean, decay, sub_decay, passes):
    from planet_heightmap_generation_tpu.ops.banded import (
        _propagate_stress_jnp, band_gate as jgate, rem_gate_eq as jrgate)

    jp = [jnp.asarray(p) for p in plates]
    st, sf = _propagate_stress_jnp(
        jnp.asarray(st0), jnp.asarray(sf0),
        tuple(jgate(p, jg.band_off, jg.band_mask) for p in jp),
        jnp.stack([jrgate(p, jg.rem_src, jg.rem_dst) for p in jp], 1),
        jnp.asarray(ocean), jg.band_off, jg.band_mask, jg.rem_src,
        jg.rem_dst, jnp.float32(decay), jnp.float32(sub_decay), passes)
    return np.asarray(st), np.asarray(sf)


def _port_stress(g, plates, st0, sf0, ocean, decay, sub_decay, passes):
    """The plain relax loop on the inputs propagate_stress_banded builds:
    (st [N,G], sf [N,G], sweeps)."""
    tps = [_t(p) for p in plates]
    ins = tb.stress_planes(
        _t(st0), _t(sf0), [tb.band_gate(p, *g.bands[:2]) for p in tps],
        torch.stack([tb.rem_gate_eq(p, g.rem_src, g.rem_dst) for p in tps],
                    1), _t(ocean), g.band_mask, g.rem_src, g.rem_dst)
    out, sweeps = sc.stress_relax_plain(*ins[:3], g.band_off, *ins[3:],
                                        decay, sub_decay, passes)
    return out[:, 0].T.numpy(), out[:, 1].T.numpy(), int(sweeps)


STRESS_CASES = {
    # (seed, decay, sub_decay, cap, stmax): the default generate's decays
    # at this mesh's resolution, large start stress so the cap binds
    "cap_binds": (5, 0.9, 0.75, 12, 1.5),
    # fast decay: every front dies out well before the cap
    "fixpoint": (6, 0.55, 0.4, 60, 1.0),
    "random_decays": (7, None, None, 40, 1.2),
}


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("case", list(STRESS_CASES))
def test_stress_relax_plain_exact(graphs, case, layers):
    jg, g = graphs
    seed, decay, sub_decay, cap, stmax = STRESS_CASES[case]
    if decay is None:
        r = np.random.default_rng(seed + 100)
        decay, sub_decay = (float(np.float32(x)) for x in
                            (0.6 + 0.35 * r.random(), 0.6 * r.random()))
    plates = _plates(g, layers)
    ins = _stress_inputs(g, layers, seed, stmax)
    st, sf, sweeps = _port_stress(g, plates, *ins, decay, sub_decay, cap)
    a_st, a_sf = _jnp_stress(jg, plates, *ins, decay, sub_decay, cap)
    assert (a_st > 0.01).sum() > 2 * (ins[0] > 0.01).sum()
    np.testing.assert_array_equal(a_st, st)
    np.testing.assert_array_equal(a_sf, sf)
    # the jnp loop's count: its last sweep changed something where the cap
    # binds; otherwise the sweep before the last was its last change
    if case == "cap_binds":
        assert sweeps == cap
        short = _jnp_stress(jg, plates, *ins, decay, sub_decay, cap - 1)
        assert not np.array_equal(short[0], a_st)
    else:
        assert 2 < sweeps < cap
        done = _jnp_stress(jg, plates, *ins, decay, sub_decay, sweeps - 1)
        short = _jnp_stress(jg, plates, *ins, decay, sub_decay, sweeps - 2)
        assert np.array_equal(done[0], a_st) and np.array_equal(done[1], a_sf)
        assert not (np.array_equal(short[0], a_st)
                    and np.array_equal(short[1], a_sf))


def test_stress_remainder_tie_takes_the_largest_sf(graphs):
    """Two gated remainder edges of one cell send the same key with
    different subduct factors: the cell takes the larger factor, whichever
    edge comes first, as the jnp's two-phase scatter-max does."""
    jg, g = graphs
    n = g.n_padded
    src, dst = g.rem_src.numpy(), g.rem_dst.numpy()
    counts = np.bincount(src, minlength=n)
    cell = int(np.flatnonzero(counts >= 2)[0])
    j1, j2 = (int(j) for j in dst[src == cell][:2])
    plates = [np.zeros(n, np.int32)]
    for first, second in ((0.2, 0.4), (0.4, 0.2)):
        st0 = np.zeros((n, 1), np.float32)
        sf0 = np.zeros((n, 1), np.float32)
        st0[[j1, j2], 0] = 0.8
        sf0[j1, 0], sf0[j2, 0] = first, second
        ocean = np.zeros((n, 1), bool)
        st, sf, _ = _port_stress(g, plates, st0, sf0, ocean, 0.9, 0.5, 1)
        a_st, a_sf = _jnp_stress(jg, plates, st0, sf0, ocean, 0.9, 0.5, 1)
        assert st[cell, 0] == np.float32(0.8) * np.float32(0.9)
        assert sf[cell, 0] == np.float32(0.4)
        np.testing.assert_array_equal(a_st, st)
        np.testing.assert_array_equal(a_sf, sf)


@pytest.mark.parametrize("kind", ["field", "masked", "warmth"])
@pytest.mark.parametrize("f, passes", [(1, 3), (2, 4), (4, 5)])
def test_smooth_relax_plain_matches_jnp(graphs, kind, f, passes):
    from planet_heightmap_generation_tpu.ops.banded import (
        _smooth_field_jnp, _smooth_masked_jnp)
    from planet_heightmap_generation_tpu.climate.temperature import (
        _diffuse_warmth_jnp)

    jg, g = graphs
    n = g.n_padded
    rng = np.random.default_rng(30 + f)
    field = rng.standard_normal((n, f)).astype(np.float32)
    mask = (rng.random(n) < 0.6) & g.valid.numpy()
    ptr, nbr = tb.rem_csr(g.rem_src, g.rem_dst, n)
    deg = tb.banded_count(g.band_mask, g.rem_src, dtype=torch.float32)
    planes = _t(field).T.contiguous()
    rtol = 2e-6
    if kind == "field":
        a = _smooth_field_jnp(jnp.asarray(field), *jg.bands, passes)
        b = sc.smooth_relax_plain(planes, deg + 1, g.band_bits, g.band_off,
                                  ptr, nbr, passes)
    elif kind == "masked":
        mf = _t(mask).float()
        a = _smooth_masked_jnp(jnp.asarray(field), jnp.asarray(mask),
                               *jg.bands, passes)
        b = sc.smooth_relax_plain(
            planes, 1 + tb.banded_sum(mf, *g.bands), g.band_bits,
            g.band_off, ptr, nbr, passes, gate=mf, upd=mf)
    else:
        rtol = 2e-5
        p_cont = rng.random(n).astype(np.float32)
        a = _diffuse_warmth_jnp(jnp.asarray(field), jnp.asarray(mask),
                                jnp.asarray(p_cont), *jg.bands, passes)
        start = torch.where(~_t(mask)[None], planes, 0.0)
        b = sc.smooth_relax_plain(start, deg + 1, g.band_bits, g.band_off,
                                  ptr, nbr, passes,
                                  upd=(_t(p_cont) < 0.95).float())
    a = np.asarray(a)
    assert b.dtype == torch.float32 and b.T.shape == a.shape
    assert np.abs(a - field).max() > 0.1               # the passes moved it
    np.testing.assert_allclose(a, b.T.numpy(), rtol=rtol, atol=2e-6)


def test_banded_sum_rows_equal_the_edge_order_scatter(graphs):
    """The row walk (tb.rem_walk_edges) against the scatter-add it replaced, on
    the CPU, where that scatter adds the edges in edge order; on a walk
    built from the device tensors (host=None) as well as on the one
    to_device built from its host copy."""
    _, g = graphs
    n = g.n_padded
    rng = np.random.default_rng(41)
    field = _t(rng.standard_normal((n, 5)).astype(np.float32) * 100)
    cells, edges = tb.rem_walk_edges(g.rem_src, g.rem_dst)
    nbrs = tuple(g.rem_dst[e] for e in edges)
    assert len(nbrs) >= 2 and cells.shape[0] == nbrs[0].shape[0]
    out = tb.banded_sum(field, *g.bands)
    band = torch.zeros_like(field)
    for d, off in enumerate(g.band_off):
        band = band + torch.where(g.band_mask[:, d, None],
                                  tb.band_shift(field, off), 0)
    old = band.scatter_reduce(0, g.rem_src[:, None].expand(-1, 5),
                              field[g.rem_dst], "sum")
    assert torch.equal(out, old)
    src, dst = g.rem_src.clone(), g.rem_dst.clone()
    assert torch.equal(tb.banded_sum(field, g.band_off, g.band_mask, src, dst),
                       old)
