"""Glacial erosion and the ordered float sums of the port against the JAX
package, on the 2000-cell ``tiny_sphere`` mesh carried across with
``interop.state_from_numpy`` (the JAX band split, so sums and ties run in
the same order). Inputs are made from numpy seeds.

Contracts:

- ``ordered_index_sum`` (its plain version on CPU tensors) equals the jnp
  scatter-add ``.at[idx].add`` bit for bit, on random pointers with a
  dropped sink and on the 2592 geo bins with an overflow slot;
- the ``avg_edge`` default of ``run_post_processing`` is the JAX
  expression Σ nbr_dist / max(1, Σ nbr_mask) within f32 summation order
  (rtol 1e-6), giving the same warp step cap;
- ``glaciation_index``: the hand-evaluated goldens of
  tests/test_reference_goldens.py (no JAX call), within 2e-6;
- ``glacial_step`` at glacial 0.2 on a polar-land elevation: the ice
  targets, ice flow and so the carving mask EXACT (the same argmin and
  the same ordered sums); the elevation within rtol 1e-5 / atol 1e-6 (f32
  ``pow`` differs between the libraries in the last bits);
- ``glacial_post_smooth`` on the JAX step's output: within rtol 1e-6 /
  atol 1e-7 (the blend itself is exact; ``glaciation_index``'s ``asin``
  may differ in the last bit);
- the post stage with glacial erosion alone on (the composite runs for it):
  by distribution, as ``test_post_processing_distribution`` holds the
  default sliders: land/ocean agreement ≥ 99.9 %, ≥ 90 % of cells within
  1e-3, mean absolute difference below 5e-3.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import torch_parity as tp

STRENGTH = 0.2
G_SCALE = 1.0 / round(STRENGTH * 10)


@pytest.fixture(scope="module")
def pair(tiny_sphere):
    """(JAX DeviceGraph, port DeviceGraph, polar-land elevation f32)."""
    from planet_heightmap_generation_tpu.mesh.device import to_device
    from planet_heightmap_generation_torch import interop

    g_j = to_device(tiny_sphere)
    g_t = interop.state_from_numpy(tp.mesh_fields(tiny_sphere))["g"]
    rng = np.random.default_rng(6)
    y = tiny_sphere.pos[:, 1]
    n = len(y)
    land = (np.abs(y) > 0.55) | (rng.random(n) < 0.15)
    elev = np.where(land, 0.3 + 0.6 * np.abs(y) + 0.25 * rng.random(n),
                    -0.4 + 0.35 * rng.random(n))
    elev = np.where(tiny_sphere.valid, elev, 0.0).astype(np.float32)
    return g_j, g_t, elev


@pytest.mark.parametrize("case", ["pointers_with_sink", "geo_bins"])
def test_ordered_index_sum_equals_jnp_scatter_add(case):
    import jax.numpy as jnp
    from planet_heightmap_generation_torch.ops.banded import ordered_index_sum

    rng = np.random.default_rng(11)
    if case == "pointers_with_sink":
        # 3000 cells, a third pointing into the sink, the rest onto few
        # targets (long runs, as after several pointer doublings)
        n, k = 3000, 3000
        idx = rng.choice(60, k).astype(np.int64)
        idx[rng.random(k) < 0.33] = n
        vals = rng.standard_normal(k).astype(np.float32)
    else:
        n, k = 36 * 72, 20000
        idx = rng.integers(0, n + 3, k).astype(np.int64)   # past n: skipped
        vals = np.stack([np.ones(k), rng.random(k) < 0.3,
                         rng.random(k) * 1.7], 1).astype(np.float32)
    want = np.asarray(jnp.zeros((n + 1, *vals.shape[1:]), jnp.float32)
                      .at[jnp.asarray(idx)].add(jnp.asarray(vals))[:n])
    got = ordered_index_sum(n, torch.as_tensor(idx), torch.as_tensor(vals))
    np.testing.assert_array_equal(got.numpy(), want)


def test_avg_edge_default_is_the_mean_neighbour_distance(pair, tiny_sphere):
    import jax.numpy as jnp
    from planet_heightmap_generation_torch.erosion.composite import (
        mean_edge, run_post_processing)

    g_j, g_t, elev = pair
    want = float(jnp.sum(g_j.nbr_dist) / jnp.maximum(1, jnp.sum(g_j.nbr_mask)))
    got = mean_edge(g_t)
    assert got == pytest.approx(want, rel=1e-6)
    nominal = math.pi / math.sqrt(tiny_sphere.n_cells)
    assert abs(got - nominal) / got > 0.1     # not π/√N
    cap = [math.ceil(0.12 * 0.5 / max(a, 1e-6)) + 8 for a in (got, want)]
    assert cap[0] == cap[1]
    # the default is what the post stage takes when none is given
    sliders = dict(terrain_warp=0.5)
    a, _ = run_post_processing(g_t, tp.t(elev), 3, sliders)
    b, _ = run_post_processing(g_t, tp.t(elev), 3, sliders, avg_edge=got)
    assert torch.equal(a, b)


def test_glaciation_index_goldens():
    """tests/test_reference_goldens.py's hand-evaluated rows (float64),
    through the port."""
    from planet_heightmap_generation_torch.erosion.glacial import (
        glaciation_index)

    s60, s80 = math.sin(math.pi / 3), math.sin(80 * math.pi / 180)
    rows = [
        # (y, elev, strength, is_ocean, expected)
        (1.0, 0.3, 1.0, False, 1.0),
        (s60, 0.7, 1.0, False, 0.15625),
        (0.0, 1.0, 1.0, False, 0.09),
        (s80, 0.2, 0.5, False, 0.25),
        (0.5, 0.6, 0.8, False, 0.01398),
        (1.0, 0.3, 1.0, True, 0.0),
    ]
    y = np.array([r[0] for r in rows], np.float32)
    pos = torch.as_tensor(np.stack([np.sqrt(np.maximum(0, 1 - y * y)), y,
                                    np.zeros_like(y)], axis=1))
    elev = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    oc = torch.tensor([r[3] for r in rows])
    valid = torch.ones(len(rows), dtype=torch.bool)
    for s in sorted({r[2] for r in rows}):
        got = glaciation_index(pos, elev, oc, valid,
                               torch.tensor(s, dtype=torch.float32))
        for i, r in enumerate(rows):
            if r[2] == s:
                assert abs(float(got[i]) - r[4]) < 2e-6, (i, float(got[i]))


@pytest.fixture(scope="module")
def glacial_pair(pair):
    """One glacial step and the post-loop blend through both packages on
    the same elevation, glaciation index and edge lengths."""
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.erosion import glacial as jgl
    from planet_heightmap_generation_tpu.erosion.composite import (
        _edge_lengths as jedges)
    from planet_heightmap_generation_tpu.ops.banded import banded_select
    from planet_heightmap_generation_torch.erosion import glacial as tgl

    g_j, g_t, elev = pair
    ej = jnp.asarray(elev)
    oc_j = (ej <= 0) & g_j.valid
    gi_j = jgl.glaciation_index(g_j.pos, ej, oc_j, g_j.valid,
                                jnp.float32(STRENGTH))
    bd, rd = jedges(g_j)
    step_j = jgl.glacial_step(ej, oc_j, g_j.valid, g_j.band_off,
                              g_j.band_mask, bd, g_j.rem_src, g_j.rem_dst, rd,
                              gi_j, jnp.float32(STRENGTH),
                              jnp.float32(G_SCALE))
    post_j = jgl.glacial_post_smooth(step_j, oc_j, g_j.valid, *g_j.bands,
                                     gi_j)

    # the reference ice flow (the head of the JAX glacial_step)
    n = g_j.n_padded
    band_idx = (jnp.arange(n, dtype=jnp.float32)[:, None]
                + np.asarray(g_j.band_off, np.float32)[None, :])
    min_e, _, (tgt,) = banded_select(
        ej, [], g_j.band_off, g_j.band_mask, g_j.rem_src, g_j.rem_dst,
        minimize=True,
        edge_payloads=[jnp.broadcast_to(band_idx, g_j.band_mask.shape)],
        rem_edge_payloads=[g_j.rem_dst.astype(jnp.float32)])
    land_j = (~oc_j) & g_j.valid
    has = land_j & (gi_j > 0) & (ej - min_e > 0) & jnp.isfinite(min_e)
    target_j = jnp.where(has, tgt, -1.0).astype(jnp.int32)
    p = jnp.where(has, jnp.clip(target_j, 0, n - 1), n)
    s = gi_j
    for _ in range(tgl.ICE_FLOW_STEPS):
        s = s + jnp.zeros(n + 1, jnp.float32).at[p].add(s)[:n]
        p = jnp.concatenate([p, jnp.array([n], p.dtype)])[p]

    et = tp.t(elev)
    oc_t = (et <= 0) & g_t.valid
    gi_t = tgl.glaciation_index(g_t.pos, et, oc_t, g_t.valid,
                                torch.tensor(STRENGTH, dtype=torch.float32))
    from planet_heightmap_generation_torch.erosion.composite import (
        _edge_lengths as tedges)
    bd_t, rd_t = tedges(g_t)
    # the port's flow from the JAX index, so the flow sums see one input
    gi_in = tp.t(np.asarray(gi_j))
    target_t, flow_t = tgl.ice_flow(et, (~oc_t) & g_t.valid, gi_in,
                                    g_t.band_off, g_t.band_mask, g_t.rem_src,
                                    g_t.rem_dst)
    step_t = tgl.glacial_step(et, oc_t, g_t.valid, g_t.band_off,
                              g_t.band_mask, bd_t, g_t.rem_src, g_t.rem_dst,
                              rd_t, gi_in,
                              torch.tensor(STRENGTH, dtype=torch.float32),
                              torch.tensor(G_SCALE, dtype=torch.float32))
    post_t = tgl.glacial_post_smooth(tp.t(np.asarray(step_j)), oc_t,
                                     g_t.valid, *g_t.bands, gi_t)
    return dict(
        elev=elev, gi=(np.asarray(gi_j), gi_t.numpy()),
        target=(np.asarray(target_j), target_t.numpy()),
        flow=(np.asarray(s), flow_t.numpy()),
        step=(np.asarray(step_j), step_t.numpy()),
        post=(np.asarray(post_j), post_t.numpy()),
        land=np.asarray(land_j))


def test_glacial_step_matches_jax(glacial_pair):
    r = glacial_pair
    np.testing.assert_allclose(r["gi"][1], r["gi"][0], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(r["target"][1], r["target"][0])
    np.testing.assert_array_equal(r["flow"][1], r["flow"][0])
    carving = r["land"] & (r["flow"][0] > 0.1)
    assert carving.sum() > 20, carving.sum()    # the step really carves
    a, b = r["step"]
    moved = a != r["elev"]
    assert (moved == (b != r["elev"])).all()
    assert (moved & ~carving).any()             # widening, moraines
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_glacial_post_smooth_matches_jax(glacial_pair):
    a, b = glacial_pair["post"]
    assert (a != glacial_pair["step"][0]).sum() > 20
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_post_processing_glacial_distribution(pair):
    """run_post_processing with glacial erosion as the only erosion slider
    (the composite runs for glacial alone), both packages on one input."""
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.erosion import (
        run_post_processing as jpost)
    from planet_heightmap_generation_tpu.config import GenerationParams
    from planet_heightmap_generation_torch.erosion.composite import (
        run_post_processing)

    g_j, g_t, elev = pair
    sliders = dataclasses.asdict(GenerationParams(
        glacial_erosion=STRENGTH, hydraulic_erosion=0.0, thermal_erosion=0.0,
        smoothing=0.0, ridge_sharpening=0.0, terrain_warp=0.0))
    avg_edge = math.pi / math.sqrt(g_t.n_cells)
    a, _ = jpost(g_j, jnp.asarray(elev), 0, sliders, avg_edge=avg_edge)
    b, _ = run_post_processing(g_t, tp.t(elev), 0, sliders,
                                   avg_edge=avg_edge)
    a, b = np.asarray(a), b.numpy()
    valid = np.asarray(g_j.valid)
    d = np.abs(a - b)[valid]
    assert np.isfinite(b).all()
    plain, _ = run_post_processing(g_t, tp.t(elev), 0,
                                   dict(sliders, glacial_erosion=0.0),
                                   avg_edge=avg_edge)
    assert (plain.numpy() != b).sum() > 50     # glacial erosion carved
    assert ((a > 0) == (b > 0))[valid].mean() >= 0.999
    assert (d < 1e-3).mean() >= 0.90, (d < 1e-3).mean()
    assert d.mean() < 5e-3, d.mean()
