"""The rain-shadow and warp relax loops of the port (ops/sweep_cuda.py
``shadow_relax`` / ``warp_relax``, through their plain versions on the
CPU) against the loops they replaced and the JAX jnp functions, on the
2000-cell mesh, inputs made from numpy seeds.

Contracts (each with its reason):

- ``_rain_shadow2`` through ``shadow_relax``: rtol 1e-5 / atol 1e-6 and
  the same sign structure against ``_rain_shadow2_jnp``, the contract of
  tests/test_torch_climate_ops.py (the JAX package's own,
  tests/test_sweep_pallas.py:205), with more shadow hops, more windward
  hops and as many of each; ``shadow_relax`` on CPU tensors is
  ``shadow_relax_plain`` and both count ``max(shadow_hops,
  windward_hops)`` hops.
- ``shadow_relax_plain`` with one column pair's hop count at 0: those
  columns keep their input EXACTLY (the per-column cap), the others move.
- ``warp_relax_plain``: EXACT in state against the loop ``warp_sources``
  ran before it had one launch (``relax()`` driving a band sweep and the
  remainder edges' scatter pick, reading the change flag every 8 sweeps),
  at a cap that binds and at one that does not; min and max are
  order-free, and sweeps past a fixpoint change nothing. Its sweep count
  is the count up to the first sweep that changes nothing.
- the remainder pick: among the edges at the least distance, the largest
  value of each plane SEPARATELY, as the four ``amax`` scatters it
  replaced: EXACT on a built tie.
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

INF = float("inf")


@pytest.fixture(scope="module")
def graphs(tiny_sphere):
    """(JAX DeviceGraph, port DeviceGraph) of the same mesh and the same
    band split."""
    g = interop.state_from_numpy(tp.mesh_fields(tiny_sphere))["g"]
    assert g.rem_src.shape[0] > 0
    return jdevice(tiny_sphere), g


def _t(a):
    return torch.as_tensor(np.array(a))


def _shadow_inputs(g, seed=11):
    """(elev, height_km, is_land, wind3d2, wdg2) as numpy."""
    n = g.n_padded
    rng = np.random.default_rng(seed)
    elev = (rng.standard_normal(n) * 0.4).astype(np.float32) \
        * g.valid.numpy()
    height_km = (np.maximum(0.0, elev) * 6.0).astype(np.float32)
    is_land = (elev > 0) & g.valid.numpy()
    wind3d2 = rng.standard_normal((n, 2, 3)).astype(np.float32) * 0.3
    wdg2 = rng.standard_normal((n, 2)).astype(np.float32) * 0.1
    return elev, height_km, is_land, wind3d2, wdg2


def _shadow_args(g, ins, hops):
    """The CPU arguments of ``shadow_relax`` for ``_shadow_inputs``."""
    from planet_heightmap_generation_torch.climate.precipitation import (
        _shadow_seeds2, shadow_retain)

    elev, height_km, is_land, wind3d2, wdg2 = map(_t, ins)
    seed2 = _shadow_seeds2(elev, height_km, is_land, wdg2)
    state = torch.cat([seed2, seed2], 1).T.contiguous()
    aux = torch.cat([g.pos.T, wind3d2[:, 0].T, wind3d2[:, 1].T]).contiguous()
    ptr, nbr = tb.rem_csr(g.rem_src, g.rem_dst, g.n_padded)
    return (state, aux, is_land.float().contiguous(), g.band_bits,
            g.band_off, ptr, nbr, *shadow_retain(*hops), *hops)


@pytest.mark.parametrize("hops", [(6, 4), (4, 6), (5, 5)],
                         ids=["shadow_longer", "windward_longer", "equal"])
def test_rain_shadow_jnp_contract(graphs, hops):
    from planet_heightmap_generation_tpu.climate.precipitation import (
        _rain_shadow2_jnp)
    from planet_heightmap_generation_torch.climate.precipitation import (
        _rain_shadow2)

    jg, g = graphs
    ins = _shadow_inputs(g, seed=12)
    a = np.asarray(_rain_shadow2_jnp(jg.pos, *map(jnp.asarray, ins),
                                     *jg.bands, *hops))
    b = _rain_shadow2(g.pos, *map(_t, ins), *g.bands, *hops).numpy()
    assert (np.abs(a) > 0.01).mean() > 0.1
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.sign(np.round(a * 1e4)),
                                  np.sign(np.round(b * 1e4)))
    # the wrapper, given CPU tensors, runs the plain loop and counts its hops
    args = _shadow_args(g, ins, hops)
    got, n = sc.shadow_relax(*args)
    want, n_plain = sc.shadow_relax_plain(*args)
    assert torch.equal(got, want)
    assert int(n) == int(n_plain) == max(hops)


@pytest.mark.parametrize("hops", [(5, 0), (0, 5)],
                         ids=["windward_frozen", "shadow_frozen"])
def test_shadow_relax_frozen_columns_keep_their_input(graphs, hops):
    _, g = graphs
    # the retention of 5 hops each; only the hop counts differ
    args = _shadow_args(g, _shadow_inputs(g), (5, 5))[:-2] + hops
    got, n = sc.shadow_relax_plain(*args)
    frozen = slice(2, 4) if hops[1] == 0 else slice(0, 2)
    live = slice(0, 2) if hops[1] == 0 else slice(2, 4)
    assert int(n) == 5
    assert torch.equal(got[frozen], args[0][frozen])
    assert int((got[live] != args[0][live]).sum()) > 20


def _old_warp_step(wt, bits, band_off, rem_src, rem_dst):
    """One sweep of the loop warp_sources ran under relax(): the band
    sweep, then the remainder edges' two-phase scatter pick."""
    n = wt.shape[1]
    wr = wt[:, rem_src]
    idx4 = rem_src[None, :].expand(4, -1)

    def step(state, flag):
        new = sc.warp_sweep_plain(state, wt, bits, band_off, flag)
        cp = new[1:4, rem_dst]
        cd = sc.dist2(cp, wr)
        wmin = torch.full((n,), INF).scatter_reduce(0, rem_src, cd, "amin")
        is_win = (cd == wmin[rem_src]) & torch.isfinite(cd)
        picked = torch.cat([new[0, rem_dst][None], cp])
        pick = torch.full((4, n), -INF).scatter_reduce(
            1, idx4, torch.where(is_win, picked, -INF), "amax")
        upd = wmin < sc.dist2(new[1:4], wt)
        if flag is not None:
            flag |= upd.any().to(torch.int32)
        return torch.where(upd, pick, new)

    return step


def _warp_case(g, strength):
    from planet_heightmap_generation_torch.erosion.warp import warp_targets
    from planet_heightmap_generation_torch.ops.noise import tables

    n = g.n_padded
    w = warp_targets(g.pos, tables(9.0), torch.tensor(strength))
    state = torch.cat([torch.arange(n, dtype=torch.float32)[None],
                       g.pos.T]).contiguous()
    return state, w.T.contiguous()


@pytest.mark.parametrize("cap", [3, 40], ids=["cap_binds", "cap_free"])
def test_warp_relax_plain_equals_relax_driven_loop(graphs, cap):
    _, g = graphs
    state, wt = _warp_case(g, 2.5)
    step = _old_warp_step(wt, g.band_bits, g.band_off, g.rem_src, g.rem_dst)
    # the count up to the first sweep that changes nothing
    x, first, took_rem = state, None, False
    flag = torch.zeros(1, dtype=torch.int32)
    for k in range(1, cap + 1):
        flag.zero_()
        band = sc.warp_sweep_plain(x, wt, g.band_bits, g.band_off)
        x = step(x, flag)
        took_rem |= not torch.equal(x, band)
        if int(flag) == 0:
            first = k
            break
    want, _ = tb.relax(step, state, cap=cap)
    ptr, nbr = tb.rem_csr(g.rem_src, g.rem_dst, g.n_padded)
    got, sweeps = sc.warp_relax_plain(state, wt, g.band_bits, g.band_off,
                                      ptr, nbr, cap)
    assert took_rem                                  # remainder picks ran
    assert (first is None) == (cap == 3)             # the cap binds or not
    assert int(sweeps) == (cap if first is None else first)
    assert int((got[0] != state[0]).sum()) > 100
    assert torch.equal(got, want)
    # the wrapper, given CPU tensors, runs the same loop
    assert torch.equal(sc.warp_relax(state, wt, g.band_bits, g.band_off,
                                     ptr, nbr, cap)[0], want)


def test_warp_remainder_pick_is_per_plane():
    """Cell 0's remainder row reaches cells 1 and 2, whose candidates lie
    at the same distance from its target; the pick takes the larger index
    and, plane by plane, the larger coordinate: a point neither candidate
    holds, as the four ``amax`` scatters took it."""
    n = 8
    new = torch.zeros((4, n))
    new[:, 0] = torch.tensor([0.0, 2.0, 0.0, 0.0])    # own: distance 4
    new[:, 1] = torch.tensor([5.0, 1.0, 0.0, 0.0])    # distance 1
    new[:, 2] = torch.tensor([3.0, 0.0, 1.0, 0.0])    # distance 1
    new[:, 3] = torch.tensor([7.0, 0.0, 0.0, 1.5])    # distance 2.25
    w = torch.zeros((3, n))
    rem_src = torch.tensor([0, 0, 0])
    rem_dst = torch.tensor([3, 2, 1])
    ptr, nbr = tb.rem_csr(rem_src, rem_dst, n)
    got, taken = sc.warp_remainder_plain(new, w, ptr, nbr)
    assert taken.tolist() == [True] + [False] * (n - 1)
    assert got[:, 0].tolist() == [5.0, 1.0, 1.0, 0.0]
    assert torch.equal(got[:, 1:], new[:, 1:])
    step = _old_warp_step(w, torch.zeros(n, dtype=torch.int32), (),
                          rem_src, rem_dst)
    state = new.clone()
    assert torch.equal(step(state, None), got)
