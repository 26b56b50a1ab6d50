"""The one-pass stencil forms of the erosion loop's glacial and thermal
steps against the band loops they replace, bit for bit, on the port's
2000-cell sphere with its remainder edges.

On CUDA tensors ``thermal_shed``, ``thermal_receive``, ``ice_flow`` and
``glacial_step`` launch the stencil kernels of ops/sweep_cuda.py (section
9); on CPU tensors they run the band loops (``*_bands``). The stencil
forms (``*_stencil``) run the kernels' plain versions on CPU tensors,
which walk each cell's neighbours as the kernels do: the set band bits in
band order, then the remainder row in edge order. Cases, one parametrised
test:

- the thermal shed and receive passes at three talus slopes;
- the glacial step at strengths 0.2 and 1.0, the ice targets and flow too;
- planted ties in the ice argmin: two equal-elevation band neighbours
  (the first band wins) and a band/remainder tie (the band wins; a
  remainder/remainder tie goes to the larger index);
- the thermal and glacial steps split over three windows
  (parallel/spmd.py, the window graphs of parallel/windows.py) against the
  unsplit call.

Inputs are made from numpy seeds.
"""

import functools

import numpy as np
import pytest
import torch

import torch_parity

from planet_heightmap_generation_torch.erosion import glacial, thermal
from planet_heightmap_generation_torch.erosion.composite import _edge_lengths

assert torch_parity  # one torch thread per test process


@functools.lru_cache(maxsize=1)
def sphere():
    """(graph, band_dist, rem_dist) of the port's 2000-cell sphere."""
    from planet_heightmap_generation_torch.mesh.build import build_sphere
    from planet_heightmap_generation_torch.mesh.device import to_device
    from planet_heightmap_generation_torch.ops.rng import ParkMiller

    g = to_device(build_sphere(2000, 0.75, rng=ParkMiller(42)), "cpu")
    assert g.rem_src.numel() > 0
    return (g, *_edge_lengths(g))


def polar_terrain(seed):
    """Rough land toward the poles and scattered land elsewhere; ocean
    below 0 (as tests/test_torch_glacial.py draws it)."""
    g, _, _ = sphere()
    rng = np.random.default_rng(seed)
    y = g.pos[:, 1].numpy()
    n = len(y)
    land = (np.abs(y) > 0.55) | (rng.random(n) < 0.15)
    elev = np.where(land, 0.3 + 0.6 * np.abs(y) + 0.25 * rng.random(n),
                    -0.4 + 0.35 * rng.random(n))
    elev = torch.as_tensor(elev.astype(np.float32))
    return torch.where(g.valid, elev, 0.0)


def thermal_args(elev):
    g, band_dist, rem_dist = sphere()
    is_ocean = (elev <= 0) & g.valid
    return (elev, is_ocean, g.valid, g.band_off, g.band_mask, band_dist,
            g.rem_src, g.rem_dst, rem_dist)


def glacial_inputs(elev, strength):
    g, band_dist, rem_dist = sphere()
    is_ocean = (elev <= 0) & g.valid
    glac = glacial.glaciation_index(g.pos, elev, is_ocean, g.valid,
                                    torch.tensor(strength))
    g_scale = 1.0 / round(strength * 10)
    return ((elev, is_ocean, g.valid, g.band_off, g.band_mask, band_dist,
             g.rem_src, g.rem_dst, rem_dist, glac), strength, g_scale)


def check_thermal(talus):
    k = 0.15 * (1.2 - talus) / 0.4
    args = thermal_args(polar_terrain(3))
    want = thermal.thermal_shed_bands(*args, talus, k)
    got = thermal.thermal_shed_stencil(*args, talus, k)
    assert (want[0] > 0).sum() > 50          # the slopes exceed the talus
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # both passes from one shed, and the whole step
    new_w = thermal.thermal_receive_bands(*args, talus, *want)
    new_g = thermal.thermal_receive_stencil(*args, talus, *want)
    assert torch.equal(new_g, new_w)
    assert (new_w != args[0]).sum() > 100
    step = thermal.thermal_step(*args, talus, k)   # CPU: the band loop
    assert torch.equal(step, new_w)


def check_glacial(strength):
    args, s, g_scale = glacial_inputs(polar_terrain(6), strength)
    elev, is_ocean, valid = args[:3]
    want = glacial.glacial_step_bands(*args, s, g_scale)
    got = glacial.glacial_step_stencil(*args, s, g_scale)
    assert torch.equal(got, want)
    moved = want != elev
    assert moved.sum() > 100, int(moved.sum())
    # the tensors the engine's CPU path passes give the same bits
    f32 = [torch.tensor(x, dtype=torch.float32) for x in (s, g_scale)]
    assert torch.equal(glacial.glacial_step_bands(*args, *f32), want)
    land = ~is_ocean & valid
    tw, fw = glacial.ice_flow_bands(elev, land, args[-1], *args[3:5],
                                    *args[6:8])
    tg, fg = glacial._ice_flow_stencil(elev, is_ocean, valid, args[-1],
                                       *args[3:5], *args[6:8])[:2]
    assert (tw >= 0).sum() > 50
    assert torch.equal(tg, tw) and torch.equal(fg, fw)
    assert (fw > glacial.G_FLOW_THRESHOLD).sum() > 20    # the step carves


def _neighbours(g, i):
    """([(band d, neighbour j)] in band order, [remainder neighbours] in
    edge order) of cell i."""
    bands = [(d, i + off) for d, off in enumerate(g.band_off)
             if bool(g.band_mask[i, d])]
    rem = g.rem_dst[g.rem_src == i].tolist()
    return bands, rem


def check_ties(kind):
    """Plant ties around cells far apart: every neighbour of a planted cell
    high but the tied ones, the planted cell above them."""
    g, _, _ = sphere()
    elev = polar_terrain(9).clone()
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
    is_ocean = (elev <= 0) & valid
    land = ~is_ocean & valid
    glac = torch.where(land, 0.5, 0.0).to(torch.float32)
    bands_args = (g.band_off, g.band_mask, g.rem_src, g.rem_dst)
    tw, fw = glacial.ice_flow_bands(elev, land, glac, *bands_args)
    tg, fg = glacial._ice_flow_stencil(elev, is_ocean, valid, glac,
                                       *bands_args)[:2]
    assert torch.equal(tg, tw) and torch.equal(fg, fw)
    for i in planted:
        assert int(tw[i]) == expect[i], (i, int(tw[i]), expect[i])


def check_split(step):
    """The stencil form over three windows of a cells split against the
    unsplit call (both plain versions)."""
    from planet_heightmap_generation_torch.parallel import spmd
    from planet_heightmap_generation_torch.parallel.sharding import (
        cells_mesh)

    g, _, _ = sphere()
    lay = cells_mesh(3, ["cpu"] * 3).layout(0, g.n_padded, g.band_off,
                                            g.rem_src, g.rem_dst)
    wgs = lay.window_graphs(g)
    if step == "thermal":
        elev = polar_terrain(12)
        a = thermal_args(elev)
        want = thermal.thermal_receive_bands(
            *a, 0.9, *thermal.thermal_shed_bands(*a, 0.9, 0.0375))
        whole = thermal.thermal_receive_stencil(
            *a, 0.9, *thermal.thermal_shed_stencil(*a, 0.9, 0.0375))
        planes = [elev]

        def body(c, wg, e):
            bd, rd = _edge_lengths(wg)
            is_ocean = (e <= 0) & wg.valid
            a = (e, is_ocean, wg.valid, wg.band_off, wg.band_mask, bd,
                 wg.rem_src, wg.rem_dst, rd)
            shed, share = thermal.thermal_shed_stencil(*a, 0.9, 0.0375)
            return thermal.thermal_receive_stencil(*a, 0.9, shed, share)
    else:
        args, s, g_scale = glacial_inputs(polar_terrain(15), 1.0)
        want = glacial.glacial_step_bands(*args, s, g_scale)
        whole = glacial.glacial_step_stencil(*args, s, g_scale)
        planes = [args[0], args[-1]]

        def body(c, wg, e, glac):
            bd, rd = _edge_lengths(wg)
            is_ocean = (e <= 0) & wg.valid
            return glacial.glacial_step_stencil(
                e, is_ocean, wg.valid, wg.band_off, wg.band_mask, bd,
                wg.rem_src, wg.rem_dst, rd, glac, s, g_scale)

    split = [lay.split(p) for p in planes]
    outs, stats = spmd.run(lay, body, [(wgs[c], *(w[c] for w in split))
                                       for c in range(lay.n_shards)])
    assert stats["exchanges"] > 0
    assert torch.equal(whole, want)
    assert torch.equal(lay.gather(outs), want)


CASES = {
    **{f"thermal talus {t}": functools.partial(check_thermal, t)
       for t in (0.8, 1.0, 1.16)},
    **{f"glacial strength {s}": functools.partial(check_glacial, s)
       for s in (0.2, 1.0)},
    "ice tie between bands": functools.partial(check_ties, "band"),
    "ice tie with the remainder": functools.partial(check_ties, "remainder"),
    "thermal split over 3 windows": functools.partial(check_split,
                                                      "thermal"),
    "glacial split over 3 windows": functools.partial(check_split,
                                                      "glacial"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stencil_form_equals_band_loop(case):
    CASES[case]()
