"""The JAX package's public names in the port, each held against its JAX
function on the CPU, one JAX call per contract:

- the subpackage re-exports (``ops``, ``mesh``, ``erosion``,
  ``tectonics``, ``elevation``): the same ``__all__`` as the JAX
  package's, every name importable; the top-level ``__version__``;
- ``ops.noise.SimplexNoise``: the same tables and gradient directions,
  and ``noise3`` / ``fbm`` / ``ridged_fbm`` within rtol = atol = 1e-5
  (f32 expression order, as the port's other noise tests);
- ``tectonics.coarse.project_coarse_plates``: the same plate ids, exactly
  (the projection is exact, tests/test_torch_slice.py);
- ``elevation.collisions.propagate_stress`` and ``propagate_stress_multi``
  (the gather-form oracles of the banded stress loop): exactly equal on
  the 2000-cell ``tiny_sphere`` (the same f32 products and first-maximum
  rule);
- ``climate.heuristic_precip.heuristic_precip_season`` within rtol =
  atol = 1e-5 (a Laplacian sum in another association order);
- ``ops.banded.rem_gather``: exactly ``field[rem_dst]``.

Inputs are made from numpy seeds.
"""

import importlib

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import mesh_fields

from planet_heightmap_generation_torch import interop

SUBPACKAGES = ("ops", "mesh", "erosion", "tectonics", "elevation")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    jax_mod = importlib.import_module(f"planet_heightmap_generation_tpu.{sub}")
    port = importlib.import_module(f"planet_heightmap_generation_torch.{sub}")
    assert list(port.__all__) == list(jax_mod.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_version_matches_jax():
    import planet_heightmap_generation_torch as port
    import planet_heightmap_generation_tpu as jax_pkg

    assert port.__version__ == jax_pkg.__version__


def _points(n=257, seed=5):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    return (p / np.linalg.norm(p, axis=1, keepdims=True) * 3).astype(
        np.float32)


def test_simplex_noise_matches_jax():
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.ops import SimplexNoise as JaxNoise
    from planet_heightmap_generation_torch.ops import SimplexNoise

    j, t = JaxNoise(77.0), SimplexNoise(77.0)
    np.testing.assert_array_equal(np.asarray(j.perm), t.perm.numpy())
    np.testing.assert_array_equal(np.asarray(j.pm12), t.pm12.numpy())
    np.testing.assert_array_equal(np.asarray(j.grad), t.grad.numpy())
    p = _points()
    jx = [jnp.asarray(p[:, i]) for i in range(3)]
    tx = [torch.as_tensor(p[:, i]) for i in range(3)]
    for name, kw in (("noise3", {}), ("fbm", dict(octaves=4)),
                     ("ridged_fbm", dict(octaves=3, gain=0.6))):
        want = np.asarray(getattr(j, name)(*jx, **kw))
        got = getattr(t, name)(*tx, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_project_coarse_plates_matches_jax():
    from planet_heightmap_generation_tpu.tectonics import (
        project_coarse_plates as jax_project)
    from planet_heightmap_generation_torch.tectonics import (
        project_coarse_plates)

    s, _ = tp.setup()
    p = tp.PARAMS
    want = np.asarray(jax_project(s.graph, s.coarse, p.seed, p.n_plates))
    got = project_coarse_plates(s.graph, s.coarse, p.seed, p.n_plates)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _stress_inputs(g, seed=3):
    rng = np.random.default_rng(seed)
    n = g.n_padded
    stress = np.where(rng.random(n) < 0.05, rng.random(n) * 2,
                      0).astype(np.float32)
    sub = rng.random(n).astype(np.float32)
    rp = (np.floor((g.pos[:, 0] + 1) * 2)
          + 3 * np.floor((g.pos[:, 1] + 1) * 1.5)).astype(np.int32)
    ocean = rng.random(int(rp.max()) + 1) < 0.4
    return stress, sub, rp, ocean


def test_propagate_stress_matches_jax(tiny_sphere):
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.elevation import collisions as jc
    from planet_heightmap_generation_torch.elevation import collisions as pc

    g = tiny_sphere
    stress, sub, rp, ocean = _stress_inputs(g)
    want = jc.propagate_stress(
        jnp.asarray(stress), jnp.asarray(sub), jnp.asarray(rp),
        jnp.asarray(ocean), jnp.asarray(g.nbr_idx), jnp.asarray(g.nbr_mask),
        0.7, 0.4, 30)
    got = pc.propagate_stress(
        torch.as_tensor(stress), torch.as_tensor(sub), torch.as_tensor(rp),
        torch.as_tensor(ocean), torch.as_tensor(g.nbr_idx.astype(np.int64)),
        torch.as_tensor(g.nbr_mask), 0.7, 0.4, 30)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))
    assert (got[0] > 0).sum() > (torch.as_tensor(stress) > 0).sum()


def test_propagate_stress_multi_matches_jax(tiny_sphere):
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.elevation import collisions as jc
    from planet_heightmap_generation_torch.elevation import collisions as pc

    g = tiny_sphere
    s1, f1, rp, oc = _stress_inputs(g, 3)
    s2, f2, _, _ = _stress_inputs(g, 4)
    rp2 = rp // 2
    nbr = g.nbr_idx.astype(np.int64)
    same = np.stack([(rp[nbr] == rp[:, None]) & g.nbr_mask,
                     (rp2[nbr] == rp2[:, None]) & g.nbr_mask], 2)
    ocean = np.stack([oc[rp], oc[rp2]], 1)
    args = (np.stack([s1, s2], 1), np.stack([f1, f2], 1), same, ocean)
    want = jc.propagate_stress_multi(*map(jnp.asarray, args),
                                     jnp.asarray(g.nbr_idx), 0.7, 0.4, 30)
    got = pc.propagate_stress_multi(*map(torch.as_tensor, args),
                                    torch.as_tensor(nbr), 0.7, 0.4, 30)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))


def test_heuristic_precip_season_matches_jax(tiny_sphere):
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.climate.heuristic_precip import (
        heuristic_precip_season as jax_season)
    from planet_heightmap_generation_torch.climate.heuristic_precip import (
        heuristic_precip_season)
    from planet_heightmap_generation_torch.climate.util import geo_frame

    sph = tiny_sphere
    pg = interop.state_from_numpy(mesh_fields(sph))["g"]
    rng = np.random.default_rng(9)
    n = sph.n_padded
    gf = geo_frame(pg.pos)
    elev = (rng.random(n) * 1.6 - 0.6).astype(np.float32)
    is_land = elev > 0
    cont = rng.random(n).astype(np.float32)
    coast = np.where(is_land, rng.integers(0, 12, n), -1).astype(np.float32)
    ge, gn = (rng.normal(size=(2, n)) * 0.05).astype(np.float32)
    itcz = (rng.random(72) * 0.2).astype(np.float32)
    fields = [gf.lat.numpy(), gf.lon.numpy(), elev, is_land, cont, coast,
              ge, gn, gf.east.numpy(), itcz]
    band_off, band_mask, rem_src, rem_dst = sph.banded
    for summer in (True, False):
        want = jax_season(
            jnp.asarray(sph.pos), *map(jnp.asarray, fields), band_off,
            jnp.asarray(band_mask), jnp.asarray(rem_src),
            jnp.asarray(rem_dst), 120.0, 3, 2, summer)
        got = heuristic_precip_season(pg.pos, *map(torch.as_tensor, fields),
                                      *pg.bands, 120.0, 3, 2, summer)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_rem_gather_matches_jax(tiny_sphere):
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.ops.banded import (
        rem_gather as jax_rem_gather)
    from planet_heightmap_generation_torch.ops.banded import rem_gather

    rem_dst = np.asarray(tiny_sphere.banded[3])
    field = np.random.default_rng(1).random(
        (tiny_sphere.n_padded + 1, 3)).astype(np.float32)
    want = np.asarray(jax_rem_gather(jnp.asarray(field), jnp.asarray(rem_dst)))
    got = rem_gather(torch.as_tensor(field), torch.as_tensor(rem_dst).long())
    np.testing.assert_array_equal(got.numpy(), want)
