"""The relax loops of the port (ops/sweep_cuda.py ``bfs_relax`` /
``flood_relax``, through their plain versions on the CPU) against the JAX
jnp loops on the 2000-cell mesh, inputs made from numpy seeds.

Contracts (each with its reason):

- distance BFS (uncapped, with a cap that binds, 4 fields of random
  cost): EXACT against ``_bfs_hops_multi_jnp``, and the sweep count equals
  the cap where it binds. Each sweep is one Jacobi iteration with the same
  float operations; the remainder edges fold into the band min, and f32
  addition rounds monotonically, so min(a + c, b + c) == min(a, b) + c.
- ε-fill surface: EXACT against ``_epsilon_fill_jnp``.
- a chaotic relaxation (blocks of cells in a shuffled order, several
  sweeps per block with its own cells current and its neighbours stale,
  as the CUDA kernel's inner sweeps run): EXACT against the Jacobi
  surface, in fewer rounds. The fill operator is monotone and its
  iterates fall from surface0, so every order reaches the same greatest
  fixpoint.
- the CSR remainder min: EXACT against the torch scatter step it replaced.
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
    return jdevice(tiny_sphere), g


@pytest.fixture(scope="module")
def csr(graphs):
    _, g = graphs
    return tb.rem_csr(g.rem_src, g.rem_dst, g.n_padded)


def _t(a):
    return torch.as_tensor(np.array(a))


def _eq(a, b):
    np.testing.assert_array_equal(np.nan_to_num(np.asarray(a), posinf=1e30),
                                  np.nan_to_num(np.asarray(b), posinf=1e30))


def _bfs_case(g, f, seed, rand_cost):
    """Seeds, barriers and costs from numpy, and the [F, NP] planes the
    port's driver bakes from them (dist0 = 0 at seeds, cost = +inf at
    non-seed barriers)."""
    rng = np.random.default_rng(seed)
    n = g.n_padded
    seeds = (rng.random((n, f)) < 0.004) & g.valid.numpy()[:, None]
    barrier = rng.random((n, f)) < 0.05
    cost = (rng.random((n, f)).astype(np.float32) + 0.5 if rand_cost
            else np.ones((n, f), np.float32))
    cur = torch.where(_t(seeds).T, 0.0, INF).contiguous()
    cost_t = torch.where(_t(barrier).T & ~_t(seeds).T, INF,
                         _t(cost).T).contiguous()
    return seeds, barrier, (cost if rand_cost else None), cur, cost_t


@pytest.mark.parametrize("case", ["uncapped", "cap_binds", "rand_cost"])
def test_bfs_relax_plain_exact(graphs, csr, case):
    from planet_heightmap_generation_tpu.ops.banded import _bfs_hops_multi_jnp

    jg, g = graphs
    f = 4 if case == "rand_cost" else 2
    seeds, barrier, rc, cur, cost_t = _bfs_case(
        g, f, 10 + ("uncapped", "cap_binds", "rand_cost").index(case),
        rand_cost=case == "rand_cost")
    args = (cur, cost_t, g.band_bits, g.band_off, *csr)
    cap = 0
    if case == "cap_binds":
        fix, to_fix = sc.bfs_relax_plain(*args, 0)
        cap = int(to_fix) - 3
    out, sweeps = sc.bfs_relax_plain(*args, cap)
    if case == "cap_binds":
        assert int(sweeps) == cap and not torch.equal(out, fix)
    a = _bfs_hops_multi_jnp(jnp.asarray(seeds), jnp.asarray(barrier),
                            *jg.bands, max_hops=cap,
                            rand_cost=None if rc is None else jnp.asarray(rc))
    assert np.isfinite(np.asarray(a)).sum() > 100
    _eq(a, out.T)


@pytest.fixture(scope="module")
def fill_case(graphs, tiny_sphere):
    """A noise terrain with its inland seas: the JAX ε-fill surface and the
    port's relax inputs."""
    from planet_heightmap_generation_tpu.erosion.flood import (
        _epsilon_fill_jnp, open_ocean_mask as joo)
    from planet_heightmap_generation_tpu.ops.noise import SimplexNoise
    from planet_heightmap_generation_torch.erosion import flood

    jg, g = graphs
    pos = tiny_sphere.pos
    e = np.asarray(SimplexNoise(5.0).fbm(pos[:, 0] * 2, pos[:, 1] * 2,
                                         pos[:, 2] * 2))
    e = np.where(tiny_sphere.valid, e * 0.6 + 0.25 * pos[:, 2],
                 0.0).astype(np.float32)
    is_ocean = (jnp.asarray(e) <= 0) & jg.valid
    oo = joo(is_ocean, jg.valid, *jg.bands)
    sa, _ = _epsilon_fill_jnp(jnp.asarray(e), is_ocean, oo, jg.valid,
                              *jg.bands)
    elev = _t(e)
    inland, _, surf0, frozen = flood._fill_common(
        elev, _t(is_ocean), _t(oo), g.valid, *g.bands)
    planes = (surf0.contiguous(), inland.float().contiguous(),
              torch.where(frozen, surf0, elev).contiguous())
    return np.asarray(sa), elev, planes


def test_flood_relax_plain_exact(graphs, csr, fill_case):
    from planet_heightmap_generation_torch.erosion.flood import BIG, EPS

    _, g = graphs
    sa, elev, planes = fill_case
    out, sweeps = sc.flood_relax_plain(*planes, g.band_bits, g.band_off,
                                       *csr, BIG, EPS)
    assert int(sweeps) > 10
    assert (out < planes[0]).sum() > 100                 # the fill moved
    _eq(sa, torch.where(out >= BIG * 0.5, elev, out))


def _chaotic_fill(surf0, inland, baked, bits, band_off, rem_ptr, rem_nbr,
                  big, eps, block=64, inner=3, seed=0):
    """Blocks of ``block`` cells in a shuffled order each round; inside a
    block, ``inner`` sweeps with the block's own cells current (updated in
    place) and every other cell as the round began. Ends after a round
    that changed nothing. Returns (surface, rounds)."""
    n = surf0.shape[0]
    offs = torch.tensor(band_off)
    nbr = (torch.arange(n)[:, None] + offs[None, :]) % n
    has = ((bits.long()[:, None] >> torch.arange(len(band_off))) & 1).bool()
    rows = list(sc._rem_rows(rem_ptr, rem_nbr))
    r_has = torch.stack([h for h, _ in rows], 1)
    r_nbr = torch.stack([j for _, j in rows], 1)
    order = np.random.default_rng(seed)
    surf, rounds = surf0.clone(), 0
    while True:
        rounds += 1
        stale = surf.clone()
        changed = False
        for b in order.permutation(n // block):
            cells = torch.arange(b * block, (b + 1) * block)
            view = stale.clone()
            view[cells] = surf[cells]
            for _ in range(inner):
                seen = torch.where(inland > 0, big, view)
                best = torch.where(has[cells], seen[nbr[cells]], INF).amin(1)
                best = torch.minimum(best, torch.where(
                    r_has[cells], seen[r_nbr[cells]], INF).amin(1))
                new = torch.minimum(view[cells],
                                    torch.maximum(baked[cells], best + eps))
                changed |= bool((new != view[cells]).any())
                view[cells] = new
            surf[cells] = view[cells]
        if not changed:
            return surf, rounds


def test_chaotic_fill_reaches_the_jacobi_surface(graphs, csr, fill_case):
    from planet_heightmap_generation_torch.erosion.flood import BIG, EPS

    _, g = graphs
    _, _, planes = fill_case
    jac, sweeps = sc.flood_relax_plain(*planes, g.band_bits, g.band_off,
                                       *csr, BIG, EPS)
    assert g.n_padded % 64 == 0
    got, rounds = _chaotic_fill(*planes, g.band_bits, g.band_off, *csr,
                                BIG, EPS)
    assert torch.equal(got, jac)
    assert rounds < int(sweeps)


def test_csr_remainder_min_equals_the_scatter_step(graphs, csr):
    """The old driver step (one sweep, then the remainder edges as a torch
    ``scatter_reduce_`` of ``cur[rem_dst] + cost[rem_src]``) against one
    sweep of the relax loop, which folds the CSR rows into the band min."""
    _, g = graphs
    n = g.n_padded
    assert g.rem_src.numel() > 0
    rng = np.random.default_rng(21)
    cur = rng.standard_normal((3, n)).astype(np.float32)
    cur[:, rng.random(n) < 0.2] = np.inf
    cost = rng.random((3, n)).astype(np.float32)
    cur, cost = _t(cur), _t(cost)
    src, dst = g.rem_src, g.rem_dst

    old = torch.full_like(cur, INF).scatter_reduce_(
        1, src[None].expand(3, -1), cur[:, dst], "amin")
    assert torch.equal(sc.rem_min_plain(cur, *csr), old)

    new = sc.bfs_sweep_plain(cur, cost, g.band_bits, g.band_off)
    cand = cur[:, dst] + cost[:, src]
    old_step = new.scatter_reduce_(1, src[None].expand_as(cand), cand, "amin")
    step, sweeps = sc.bfs_relax_plain(cur, cost, g.band_bits, g.band_off,
                                      *csr, 1)
    assert int(sweeps) == 1
    assert torch.equal(step, old_step)
