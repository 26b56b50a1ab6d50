"""The terrain slice of the port against the JAX package, stage by stage,
on the canonical 4K planet (seed 123, 12 plates), and the whole
terrain-only ``generate`` against the pinned c4k_s123 snapshot.

Every stage gets the JAX stage's own inputs, carried across with
``interop.state_from_numpy``. Tolerances and their reasons:

- projection, smoothing + reconnection, the bfs5 phase and all seed
  masks: EXACT (gathers, integer votes, components, hash costs);
- stress and carry phases: rtol/atol 1e-5 — the collision metrics and
  fBm undulation are f32 expressions that XLA may contract differently
  (measured: ≤ 1.2e-6 absolute);
- post-processing: both packages eroding one elevation field. The
  ε-fill's spill ties and the warp's tie resolution (band-sequential in
  JAX's jnp loop, synchronous here) move some cells by whole drainage
  decisions, so the stage is held at distribution level: land/ocean
  agreement ≥ 99.9 %, ≥ 90 % of cells within 1e-3 and the mean absolute
  difference below 5e-3 (measured on this planet: 100 %, 95.9 %,
  4.4e-4);
- generate: the JAX package's own snapshot tolerances (land fraction
  within 0.02, histogram L1 < 0.05, plate count exact).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp


def test_projection_exact():
    from planet_heightmap_generation_torch.tectonics.coarse import (
        project_kernel)

    s, st = tp.setup()
    r = project_kernel(st["g"].pos, *st["projection"], s.coarse.bins.n_lat,
                       s.coarse.bins.n_lon)
    assert r.dtype == torch.int32
    np.testing.assert_array_equal(tp.plates_jax()[0], r.numpy())


def test_smooth_and_reconnect_exact():
    from planet_heightmap_generation_torch.pipeline.engine import (
        smooth_and_reconnect)

    s, st = tp.setup()
    projected, smoothed = tp.plates_jax()
    r = smooth_and_reconnect(st["g"], tp.t(projected), s.plates.num_plates)
    assert r.dtype == torch.int32
    np.testing.assert_array_equal(smoothed, r.numpy())


@pytest.mark.parametrize("phase", ["stress", "bfs5", "carry"])
def test_assign_elevation_phase(phase):
    a, b = tp.assign_both(phase)
    tp.assert_masks_equal(a, b)
    for f in ("stress", "subduct"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   getattr(b, f).numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    pa, pb = np.asarray(a.elevation), b.elevation.numpy()
    if phase == "bfs5":
        np.testing.assert_array_equal(pa, pb)
    else:
        np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def post_pair():
    """Both packages' run_post_processing on the port's elevation of the
    canonical planet, default sliders."""
    import jax.numpy as jnp
    from planet_heightmap_generation_tpu.erosion import (
        run_post_processing as jpost)
    from planet_heightmap_generation_torch.erosion.composite import (
        run_post_processing)
    from planet_heightmap_generation_torch.ops.noise import Tables

    s, st = tp.setup()
    b = tp.assign_port(None)
    elev, hot = b.elevation.numpy(), b.debug["hotspot"].numpy()
    pdict = dataclasses.asdict(tp.PARAMS)
    avg_edge = np.pi / np.sqrt(s.graph.n_cells)
    ja, _ = jpost(s.g, jnp.asarray(elev), 0, pdict, hotspot=jnp.asarray(hot),
                  avg_edge=avg_edge, warp_t=s.warp_t)
    tb_, delta = run_post_processing(st["g"], tp.t(elev), 0, pdict,
                                     hotspot=tp.t(hot), avg_edge=avg_edge,
                                     warp_t=st["noise"]["warp"])
    assert isinstance(st["noise"]["warp"], Tables)
    return elev, np.asarray(ja), tb_.numpy(), delta.numpy()


def test_post_processing_distribution(post_pair):
    _, a, b, _ = post_pair
    valid = tp.setup()[0].graph.valid
    d = np.abs(a - b)[valid]
    assert np.isfinite(b).all()
    assert ((a > 0) == (b > 0))[valid].mean() >= 0.999
    assert (d < 1e-3).mean() >= 0.90, (d < 1e-3).mean()
    assert d.mean() < 5e-3, d.mean()


@pytest.fixture(scope="module")
def generate_c4k():
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    params = GenerationParams(**{
        f.name: getattr(tp.PARAMS, f.name)
        for f in dataclasses.fields(tp.PARAMS)})
    res = PlanetEngine(device="cpu").generate(params)
    return res, tp.snapshot_metrics(res.elevation.numpy(), res.r_plate.numpy(),
                                    res.graph.n_cells)


def test_generate_c4k_land_fraction(generate_c4k):
    res, m = generate_c4k
    assert res.diagnostics()["nan_count"] == 0
    assert abs(m["land_fraction"] - tp.SNAPSHOT_C4K["land_fraction"]) < 0.02


def test_generate_c4k_elevation_histogram(generate_c4k):
    _, m = generate_c4k
    assert m["hist_l1"] < 0.05, m["hist_l1"]


def test_generate_c4k_plate_count(generate_c4k):
    res, m = generate_c4k
    assert m["plate_count"] == tp.SNAPSHOT_C4K["plate_count"]
    assert res.r_plate.dtype == torch.int32
