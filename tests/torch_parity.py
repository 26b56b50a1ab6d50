"""Shared set-up for the port's stage tests: the JAX package's host
prologue for the canonical 4K planet, carried into the port's tensors
through ``interop.state_from_numpy`` so both packages compute from
identical inputs. Not a test module (no ``test_`` prefix)."""

import functools

import numpy as np
import torch

from planet_heightmap_generation_tpu.config import GenerationParams

# One torch thread per test process. The port's tests run small tensors
# (below torch's parallel grain) in several xdist workers at once; with a
# pool per worker as wide as the machine, the idle OpenMP threads spin
# between ops and take the cores the other workers need (the port's test
# files ran ~2.5x slower under six workers). Every test_torch_* file
# imports this module.
torch.set_num_threads(1)

PARAMS = GenerationParams(seed=123, n_cells=4000, n_plates=12,
                          num_continents=2, skip_climate=True)

# the JAX package's pinned self-snapshot c4k_s123
# (tests/test_reference_parity.py:45-55); land fraction, elevation
# histogram and plate count describe terrain only — climate runs after
# the final elevation and does not change it
SNAPSHOT_C4K = dict(
    land_fraction=0.31042,
    elevation_hist=[0.0, 0.0, 0.0, 0.0055, 0.02424, 0.03274, 0.06048,
                    0.12297, 0.24494, 0.1987, 0.02899, 0.02649, 0.04699,
                    0.09198, 0.04574, 0.03024, 0.019, 0.00625, 0.00525,
                    0.0095],
    plate_count=12,
)
PROJ_NAMES = ("perm", "pm12", "perturb_amp", "cand_idx", "cand_mask",
              "points", "coarse_plate")
SUPER_NAMES = ("plate_to_super", "is_ocean", "pole", "omega", "density")


def t(a):
    return torch.as_tensor(np.array(a))


def mesh_fields(sphere):
    """The fields of a JAX SphereGraph for ``interop.state_from_numpy``,
    with the band split that graph really uses: the JAX package picks a
    mesh's band offsets from the FIRST mesh of the same padded size built
    in the process (mesh/build.py _BAND_OFF_CACHE), so under xdist another
    test file's mesh can set them."""
    from planet_heightmap_generation_torch import interop

    mesh = {f: getattr(sphere, f) for f in interop.SPHERE_FIELDS}
    mesh.update(banded=sphere.banded, banded_packed=sphere.banded_packed)
    return mesh


@functools.lru_cache(maxsize=1)
def setup():
    """(JAX PlanetSetup, port state dict) for PARAMS."""
    from planet_heightmap_generation_tpu.pipeline.engine import host_setup
    from planet_heightmap_generation_torch import interop

    s = host_setup(PARAMS)
    po, pp, pw, pd = s.args[2]
    st = interop.state_from_numpy(
        mesh_fields(s.graph),
        plates=dict(is_ocean=np.asarray(po), pole=np.asarray(pp),
                    omega=np.asarray(pw), density=np.asarray(pd)),
        super_plates=dict(zip(SUPER_NAMES, map(np.asarray, s.args[3]))),
        domes={k: np.asarray(v) for k, v in s.domes.items()},
        noise={k: (np.asarray(v.perm), np.asarray(v.pm12))
               for k, v in list(s.noise_pack.items())
               + [("warp", s.warp_t), ("climate", s.args[7])]},
        projection=dict(zip(PROJ_NAMES, map(np.asarray, s.args[1]))))
    return s, st


@functools.lru_cache(maxsize=1)
def plates_jax():
    """The JAX projected + smoothed plate map of PARAMS (numpy i32)."""
    from planet_heightmap_generation_tpu.ops.noise import _GRAD_J
    from planet_heightmap_generation_tpu.pipeline.engine import (
        _smooth_and_reconnect_device)
    from planet_heightmap_generation_tpu.tectonics.coarse import (
        _project_kernel)

    s, _ = setup()
    p = s.args[1]
    projected = _project_kernel(s.g.pos, p[0], p[1], _GRAD_J, *p[2:],
                                s.coarse.bins.n_lat, s.coarse.bins.n_lon)
    smoothed = _smooth_and_reconnect_device(s.g, projected,
                                            s.plates.num_plates, 3)
    return np.asarray(projected), np.asarray(smoothed)


def assign_port(trunc):
    """The port's assign_elevation(trunc=...) on the JAX plate map."""
    from planet_heightmap_generation_torch.elevation.assemble import (
        assign_elevation)

    _, st = setup()
    tr = t(plates_jax()[1])
    tsa = st["super_plates"]
    return assign_elevation(
        st["g"], tr, *st["plates"], seed=PARAMS.seed,
        noise_mag=PARAMS.roughness, spread=PARAMS.spread,
        r_super_plate=tsa[0][tr.long()], super_is_ocean=tsa[1],
        super_pole=tsa[2], super_omega=tsa[3], super_density=tsa[4],
        noise_pack={k: v for k, v in st["noise"].items()
                    if k not in ("warp", "climate")},
        domes=st["domes"], trunc=trunc)


@functools.lru_cache(maxsize=1)
def final_elevation():
    """The port's final elevation of PARAMS (its assign_elevation on the
    JAX plate map, then its post-processing at the default sliders) as
    numpy f32: the shared input of the climate stage tests."""
    import dataclasses

    from planet_heightmap_generation_torch.erosion.composite import (
        run_post_processing)

    s, st = setup()
    b = assign_port(None)
    elev, _ = run_post_processing(
        st["g"], b.elevation, 0, dataclasses.asdict(PARAMS),
        hotspot=b.debug["hotspot"], avg_edge=np.pi / np.sqrt(s.graph.n_cells),
        warp_t=st["noise"]["warp"])
    return elev.numpy()


def assign_both(trunc):
    """assign_elevation(trunc=...) of both packages on the JAX plate map."""
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.elevation import (
        assign_elevation as jassign)

    s, _ = setup()
    jr = jnp.asarray(plates_jax()[1])
    po, pp, pw, pd = s.args[2]
    sa = s.args[3]
    a = jassign(s.g, jr, po, pp, pw, pd, seed=PARAMS.seed,
                noise_mag=PARAMS.roughness, spread=PARAMS.spread,
                r_super_plate=sa[0][jr], super_is_ocean=sa[1],
                super_pole=sa[2], super_omega=sa[3], super_density=sa[4],
                noise_pack=s.noise_pack, domes=s.domes, trunc=trunc)
    return a, assign_port(trunc)


def assert_masks_equal(a, b):
    for f in ("mountain", "coastline", "ocean_seeds"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)


def snapshot_metrics(elevation, r_plate, n):
    e = np.asarray(elevation)[:n]
    hist = np.histogram(np.clip(e, -1, 1 - 1e-6), bins=20,
                        range=(-1, 1))[0] / n
    return dict(land_fraction=float((e > 0).mean()),
                hist_l1=float(np.abs(
                    hist - np.asarray(SNAPSHOT_C4K["elevation_hist"])).sum()),
                plate_count=len(np.unique(np.asarray(r_plate)[:n])))
