"""The port's host prologue against the JAX package's, same seed.

The prologue modules are numpy/scipy/native copies, so every product must
be exactly equal: mesh and banded packing, coarse plates, super plates,
hotspot domes, noise tables and projection inputs. ``to_device`` must
reproduce the JAX DeviceGraph field by field (index dtypes differ: int64
in torch, int32 in JAX; the port keeps only the real remainder edges).
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_tpu.mesh.build import build_sphere as jbuild
from planet_heightmap_generation_tpu.mesh.device import to_device as jdevice
from planet_heightmap_generation_torch.mesh.build import build_sphere
from planet_heightmap_generation_torch.mesh.device import to_device
from planet_heightmap_generation_torch import interop

SEED = 123
N_PLATES = 12


@pytest.fixture(scope="module")
def coarse_pair():
    from planet_heightmap_generation_tpu.tectonics.coarse import (
        generate_coarse_plates as jgen, assign_plate_densities as jdens)
    from planet_heightmap_generation_torch.tectonics.coarse import (
        generate_coarse_plates, assign_plate_densities)

    a = jgen(SEED, N_PLATES, 2)
    jdens(a.plates)
    b = generate_coarse_plates(SEED, N_PLATES, 2)
    assign_plate_densities(b.plates)
    return a, b


def test_mesh_and_banded_packing_equal(tiny_sphere):
    a = tiny_sphere
    b = build_sphere(2000, 0.75, seed=42.0)
    for f in ("n_cells", "n_padded", "pole_id"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("pos", "nbr_idx", "nbr_mask", "nbr_dist", "deg", "valid",
              "triangles"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    pa, pb = a.banded_packed, b.banded_packed
    assert pa[0] == pb[0]
    for x, y in zip(pa[1:], pb[1:]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("device_graph_source", ["port_mesh", "interop"])
def test_to_device_matches_jax(tiny_sphere, device_graph_source):
    ja = jdevice(tiny_sphere)
    if device_graph_source == "port_mesh":
        g = to_device(build_sphere(2000, 0.75, seed=42.0), "cpu")
    else:
        g = interop.state_from_numpy(
            {f: getattr(tiny_sphere, f) for f in interop.SPHERE_FIELDS})["g"]
    assert g.band_off == ja.band_off and g.n_cells == ja.n_cells
    for f in ("pos", "nbr_idx", "nbr_mask", "valid", "band_mask"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    real = np.asarray(ja.rem_src) < ja.n_padded
    np.testing.assert_array_equal(g.rem_src.numpy(),
                                  np.asarray(ja.rem_src)[real])
    np.testing.assert_array_equal(g.rem_dst.numpy(),
                                  np.asarray(ja.rem_dst)[real])
    bits = np.asarray(ja.band_mask).astype(np.uint64) @ (
        np.uint64(1) << np.arange(len(ja.band_off), dtype=np.uint64))
    np.testing.assert_array_equal(g.band_bits.numpy().view(np.uint32),
                                  bits.astype(np.uint32))


def test_coarse_plates_equal(coarse_pair):
    a, b = coarse_pair
    np.testing.assert_array_equal(a.r_plate, b.r_plate)
    for f in ("seeds", "pole", "omega", "is_ocean", "density"):
        np.testing.assert_array_equal(getattr(a.plates, f),
                                      getattr(b.plates, f), err_msg=f)
    for f in ("cand_idx", "cand_mask", "points"):
        np.testing.assert_array_equal(getattr(a.bins, f),
                                      getattr(b.bins, f), err_msg=f)


def test_super_plates_equal(coarse_pair):
    from planet_heightmap_generation_tpu.tectonics.super_plates import (
        build_super_plates as jsuper)
    from planet_heightmap_generation_torch.tectonics.super_plates import (
        build_super_plates)

    a, b = coarse_pair
    sa = jsuper(a.graph, a.r_plate, a.plates)
    sb = build_super_plates(b.graph, b.r_plate, b.plates)
    assert sa.num_super == sb.num_super
    for f in ("plate_to_super", "pole", "omega", "is_ocean", "density"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f),
                                      err_msg=f)


def test_domes_equal(coarse_pair, tiny_sphere):
    from planet_heightmap_generation_tpu.elevation.hotspots import (
        build_domes as jdomes)
    from planet_heightmap_generation_tpu.tectonics.coarse import (
        project_points_host as jproj)
    from planet_heightmap_generation_torch.elevation.hotspots import (
        build_domes)
    from planet_heightmap_generation_torch.tectonics.coarse import (
        project_points_host)

    a, b = coarse_pair
    pos = tiny_sphere.pos

    def args(coarse, proj):
        pl = coarse.plates
        return (SEED, pos,
                lambda c: int(proj(coarse, SEED, N_PLATES, pos[c])[0]),
                pl.pole, pl.omega, pl.is_ocean, tiny_sphere.n_cells)

    da, db = jdomes(*args(a, jproj)), build_domes(*args(b, project_points_host))
    assert da.keys() == db.keys() and da
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_noise_tables_and_projection_inputs_equal(coarse_pair):
    from planet_heightmap_generation_tpu.ops.noise import tables as jtables
    from planet_heightmap_generation_tpu.tectonics.coarse import (
        projection_inputs as jproj)
    from planet_heightmap_generation_torch.ops.noise import tables
    from planet_heightmap_generation_torch.tectonics.coarse import (
        projection_inputs)

    for s in (SEED, SEED + 419, SEED + 9999):
        ja, tb = jtables(s), tables(s)
        np.testing.assert_array_equal(np.asarray(ja.perm), tb.perm.numpy())
        np.testing.assert_array_equal(np.asarray(ja.pm12), tb.pm12.numpy())
    a, b = coarse_pair
    pa, pb = jproj(a, SEED, N_PLATES), projection_inputs(b, SEED, N_PLATES)
    assert np.float32(pa[2]) == np.float32(pb[2])
    for i in (0, 1, 3, 4, 5, 6):
        np.testing.assert_array_equal(np.asarray(pa[i]), pb[i].numpy(),
                                      err_msg=str(i))
    assert pb[0].dtype == torch.int64 and pb[6].dtype == torch.int32
