"""The erosion loop's thermal and glacial steps, one stencil form on every
device, against the JAX package's steps, and split over three windows
against the unsplit call.

``thermal_shed``, ``thermal_receive``, ``ice_flow`` and ``glacial_step``
call the stencils of ops/sweep_cuda.py (section 9): one kernel launch
each on CUDA tensors, the kernels' plain versions on CPU tensors, which
walk each cell's neighbours as the kernels do: the set band bits in band
order, then the remainder row in edge order. Cases, one parametrised
test:

- the thermal step at three talus slopes against the JAX
  ``thermal_step``, and the glacial step at strengths 0.2 and 1.0 against
  the JAX ``glacial_step``, on the 2000-cell ``tiny_sphere`` mesh carried
  across with ``interop.state_from_numpy`` (the JAX band split, so sums
  and ties run in the same order): every output EXACT, the same f32
  operations in the same order. The ice targets and flow are held to the
  head of the JAX step (the same argmin and the same ordered sums), the
  glacial elevation to the jitted JAX step. The thermal elevation is held
  to the JAX step run op by op (``jax.disable_jit``), and to the jitted
  step within rtol 1e-5 / atol 1e-6, as tests/test_torch_glacial.py
  holds its steps, the cells it moves exactly the jitted step's: XLA's
  fused compile of the jitted step gives one cell of the talus-1.0 case
  a last bit that its op-by-op run does not;
- planted ties in the ice argmin: two equal-elevation band neighbours
  (the first band wins) and a band/remainder tie (the band wins; a
  remainder/remainder tie goes to the larger index), the targets exactly
  the JAX ice-flow head's;
- the thermal and glacial steps split over three windows of the port's
  own 2000-cell mesh (parallel/spmd.py, the window graphs of
  parallel/windows.py) against the unsplit call, bit for bit.

Inputs are made from numpy seeds.
"""

import functools

import numpy as np
import pytest
import torch

import torch_parity as tp

from planet_heightmap_generation_torch.erosion import glacial, thermal
from planet_heightmap_generation_torch.erosion.composite import _edge_lengths


@functools.lru_cache(maxsize=1)
def sphere():
    """(graph, band_dist, rem_dist) of the port's 2000-cell sphere."""
    from planet_heightmap_generation_torch.mesh.build import build_sphere
    from planet_heightmap_generation_torch.mesh.device import to_device
    from planet_heightmap_generation_torch.ops.rng import ParkMiller

    g = to_device(build_sphere(2000, 0.75, rng=ParkMiller(42)), "cpu")
    assert g.rem_src.numel() > 0
    return (g, *_edge_lengths(g))


@pytest.fixture(scope="module")
def jax_pair(tiny_sphere):
    """(JAX DeviceGraph, its (band_dist, rem_dist), port DeviceGraph, its
    (band_dist, rem_dist)) of the same mesh and band split."""
    from planet_heightmap_generation_tpu.erosion.composite import (
        _edge_lengths as jedges)
    from planet_heightmap_generation_tpu.mesh.device import to_device
    from planet_heightmap_generation_torch import interop

    g_j = to_device(tiny_sphere)
    g_t = interop.state_from_numpy(tp.mesh_fields(tiny_sphere))["g"]
    assert g_t.rem_src.numel() > 0
    return g_j, jedges(g_j), g_t, _edge_lengths(g_t)


def polar_terrain(seed, g=None):
    """Rough land toward the poles and scattered land elsewhere; ocean
    below 0 (as tests/test_torch_glacial.py draws it), on ``g`` (the
    port's sphere by default)."""
    g = sphere()[0] if g is None else g
    rng = np.random.default_rng(seed)
    y = g.pos[:, 1].numpy()
    n = len(y)
    land = (np.abs(y) > 0.55) | (rng.random(n) < 0.15)
    elev = np.where(land, 0.3 + 0.6 * np.abs(y) + 0.25 * rng.random(n),
                    -0.4 + 0.35 * rng.random(n))
    elev = torch.as_tensor(elev.astype(np.float32))
    return torch.where(g.valid, elev, 0.0)


def thermal_args(elev, g=None, lengths=None):
    if g is None:
        g, *lengths = sphere()
    is_ocean = (elev <= 0) & g.valid
    return (elev, is_ocean, g.valid, g.band_off, g.band_mask, lengths[0],
            g.rem_src, g.rem_dst, lengths[1])


def glacial_inputs(elev, strength, g=None, lengths=None):
    args = thermal_args(elev, g, lengths)
    g = sphere()[0] if g is None else g
    glac = glacial.glaciation_index(g.pos, elev, args[1], g.valid,
                                    torch.tensor(strength))
    g_scale = 1.0 / round(strength * 10)
    return (*args, glac), strength, g_scale


def jax_ice_flow(g_j, elev, glac):
    """(ice targets, ice flow) of the head of the JAX ``glacial_step`` on
    numpy ``elev`` and ``glac``, derived as tests/test_torch_glacial.py
    derives its reference ice flow."""
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.ops.banded import banded_select

    ej, gi = jnp.asarray(elev), jnp.asarray(glac)
    land = (ej > 0) & g_j.valid
    n = g_j.n_padded
    band_idx = (jnp.arange(n, dtype=jnp.float32)[:, None]
                + np.asarray(g_j.band_off, np.float32)[None, :])
    min_e, _, (tgt,) = banded_select(
        ej, [], g_j.band_off, g_j.band_mask, g_j.rem_src, g_j.rem_dst,
        minimize=True,
        edge_payloads=[jnp.broadcast_to(band_idx, g_j.band_mask.shape)],
        rem_edge_payloads=[g_j.rem_dst.astype(jnp.float32)])
    has = land & (gi > 0) & (ej - min_e > 0) & jnp.isfinite(min_e)
    target = jnp.where(has, tgt, -1.0).astype(jnp.int32)
    p = jnp.where(has, jnp.clip(target, 0, n - 1), n)
    s = gi
    for _ in range(glacial.ICE_FLOW_STEPS):
        s = s + jnp.zeros(n + 1, jnp.float32).at[p].add(s)[:n]
        p = jnp.concatenate([p, jnp.array([n], p.dtype)])[p]
    return np.asarray(target), np.asarray(s)


def check_thermal(talus, pair):
    import jax
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.erosion.thermal import (
        thermal_step as jax_step)

    g_j, (bd_j, rd_j), g_t, lengths = pair
    k = 0.15 * (1.2 - talus) / 0.4
    elev = polar_terrain(3, g_t)
    args = thermal_args(elev, g_t, lengths)
    shed, _ = thermal.thermal_shed(*args, talus, k)
    assert (shed > 0).sum() > 50          # the slopes exceed the talus
    got = thermal.thermal_step(*args, talus, k).numpy()
    ej = jnp.asarray(elev.numpy())
    jargs = (ej, (ej <= 0) & g_j.valid, g_j.valid, g_j.band_off,
             g_j.band_mask, bd_j, g_j.rem_src, g_j.rem_dst, rd_j,
             jnp.float32(talus), jnp.float32(k))
    with jax.disable_jit():
        np.testing.assert_array_equal(got, np.asarray(jax_step(*jargs)))
    want, e = np.asarray(jax_step(*jargs)), elev.numpy()
    assert (want != e).sum() > 100
    np.testing.assert_array_equal(got != e, want != e)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def check_glacial(strength, pair):
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.erosion.glacial import (
        glacial_step as jax_step)

    g_j, (bd_j, rd_j), g_t, lengths = pair
    elev = polar_terrain(6, g_t)
    args, s, g_scale = glacial_inputs(elev, strength, g_t, lengths)
    is_ocean, valid, glac = args[1], args[2], args[-1]
    got = glacial.glacial_step(*args, s, g_scale)
    # the tensors the engine passes give the numbers' bits
    f32 = [torch.tensor(x, dtype=torch.float32) for x in (s, g_scale)]
    assert torch.equal(glacial.glacial_step(*args, *f32), got)
    # the ice flow: exactly the head of the JAX step
    target, flow = glacial.ice_flow(elev, ~is_ocean & valid, glac,
                                    *args[3:5], *args[6:8])
    tw, fw = jax_ice_flow(g_j, elev.numpy(), glac.numpy())
    np.testing.assert_array_equal(target.numpy(), tw)
    np.testing.assert_array_equal(flow.numpy(), fw)
    assert (tw >= 0).sum() > 50
    assert (fw > 0.1).sum() > 20                    # the step carves
    ej = jnp.asarray(elev.numpy())
    want = np.asarray(jax_step(
        ej, (ej <= 0) & g_j.valid, g_j.valid, g_j.band_off, g_j.band_mask,
        bd_j, g_j.rem_src, g_j.rem_dst, rd_j, jnp.asarray(glac.numpy()),
        jnp.float32(s), jnp.float32(g_scale)))
    assert (want != elev.numpy()).sum() > 100
    np.testing.assert_array_equal(got.numpy(), want)


def _neighbours(g, i):
    """([(band d, neighbour j)] in band order, [remainder neighbours] in
    edge order) of cell i."""
    bands = [(d, i + off) for d, off in enumerate(g.band_off)
             if bool(g.band_mask[i, d])]
    rem = g.rem_dst[g.rem_src == i].tolist()
    return bands, rem


def check_ties(kind, pair):
    """Plant ties around cells far apart: every neighbour of a planted cell
    high but the tied ones, the planted cell above them."""
    g_j, _, g, _ = pair
    elev = polar_terrain(9, g).clone()
    valid = g.valid
    touched = torch.zeros_like(valid)
    planted, expect = [], {}
    for i in range(0, g.n_cells, 7):
        bands, rem = _neighbours(g, i)
        if kind == "band" and len(bands) >= 3:
            tied = [bands[1][1], bands[2][1]]
            win = bands[1][1]                 # the first band of the tie
        elif kind == "remainder" and rem and len(bands) >= 2:
            tied = [bands[0][1], rem[0]]
            win = bands[0][1]                 # the band: no strict gain
            if len(rem) >= 2:                 # remainder ties: largest
                tied = [rem[0], rem[1]]
                win = max(rem[0], rem[1])
        else:
            continue
        hood = [i] + [j for _, j in bands] + rem
        if bool(touched[hood].any()):
            continue
        touched[hood] = True
        for j in hood:
            elev[j] = 2.0
        elev[i] = 1.5
        for j in tied:
            elev[j] = 0.75
        planted.append(i)
        expect[i] = win
    assert len(planted) >= 8, len(planted)
    land = (elev > 0) & valid
    glac = torch.where(land, 0.5, 0.0).to(torch.float32)
    target, flow = glacial.ice_flow(elev, land, glac, g.band_off,
                                    g.band_mask, g.rem_src, g.rem_dst)
    tw, fw = jax_ice_flow(g_j, elev.numpy(), glac.numpy())
    np.testing.assert_array_equal(target.numpy(), tw)
    np.testing.assert_array_equal(flow.numpy(), fw)
    for i in planted:
        assert int(tw[i]) == expect[i], (i, int(tw[i]), expect[i])


def check_split(step):
    """The step over three windows of a cells split against the unsplit
    call of the same function."""
    from planet_heightmap_generation_torch.parallel import spmd
    from planet_heightmap_generation_torch.parallel.sharding import (
        cells_mesh)

    g, _, _ = sphere()
    lay = cells_mesh(3, ["cpu"] * 3).layout(0, g.n_padded, g.band_off,
                                            g.rem_src, g.rem_dst)
    wgs = lay.window_graphs(g)
    if step == "thermal":
        elev = polar_terrain(12)
        whole = thermal.thermal_step(*thermal_args(elev), 0.9, 0.0375)
        planes = [elev]

        def body(c, wg, e):
            return thermal.thermal_step(
                *thermal_args(e, wg, _edge_lengths(wg)), 0.9, 0.0375)
    else:
        args, s, g_scale = glacial_inputs(polar_terrain(15), 1.0)
        whole = glacial.glacial_step(*args, s, g_scale)
        planes = [args[0], args[-1]]

        def body(c, wg, e, glac):
            return glacial.glacial_step(
                *thermal_args(e, wg, _edge_lengths(wg)), glac, s, g_scale)

    assert (whole != planes[0]).sum() > 100
    split = [lay.split(p) for p in planes]
    outs, stats = spmd.run(lay, body, [(wgs[c], *(w[c] for w in split))
                                       for c in range(lay.n_shards)])
    assert stats["exchanges"] > 0
    assert torch.equal(lay.gather(outs), whole)


# the cases on the JAX pair, then the split cases on the port's mesh
JAX_CASES = {
    **{f"thermal talus {t}": functools.partial(check_thermal, t)
       for t in (0.8, 1.0, 1.16)},
    **{f"glacial strength {s}": functools.partial(check_glacial, s)
       for s in (0.2, 1.0)},
    "ice tie between bands": functools.partial(check_ties, "band"),
    "ice tie with the remainder": functools.partial(check_ties, "remainder"),
}
SPLIT_CASES = {
    "thermal split over 3 windows": functools.partial(check_split,
                                                      "thermal"),
    "glacial split over 3 windows": functools.partial(check_split,
                                                      "glacial"),
}


@pytest.mark.parametrize("case", [*JAX_CASES, *SPLIT_CASES])
def test_stencil_form_equals_band_loop(case, request):
    if case in JAX_CASES:
        JAX_CASES[case](request.getfixturevalue("jax_pair"))
    else:
        SPLIT_CASES[case]()
