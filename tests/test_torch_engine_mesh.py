"""``PlanetEngine(mesh=)`` on the CPU (``timing=False`` given: the test
configuration turns timing mode on by default, and it never splits): the split generate over
``cells_mesh(4, ["cpu"] * 4)`` at 2000 cells (the JAX test's params:
``seed=11, n_plates=10, num_continents=2``), terrain only, against the
port's single-device generate; the branches that run unsplit; the split
runtime's collectives; ``shard_fused_args``.

Contracts (the JAX package's ``tests/test_parallel.py:144-169`` and
``ROADMAP.md``): elevation within 2e-3 of the single generate,
``r_plate`` exact, ``nan_count == 0``. The split computes the single
generate bit for bit (pointwise work on the window, neighbour reads after
an exchange, kernel loops by their split routes, global reductions on
gathered arrays with the single path's call), so bit equality is asserted
too, output by output. Glacial erosion (0.2) runs split under the same
contract. Timing mode and planets above ``FUSED_MAX_CELLS`` run unsplit
and equal the single generate bit for bit. The climate-on split and the
retained state are in ``test_torch_engine_mesh_climate.py``.
"""

import dataclasses
import threading
import time

import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.parallel import cells_mesh, spmd
from planet_heightmap_generation_torch.parallel.sharding import (
    shard_fused_args)
from planet_heightmap_generation_torch.pipeline import engine as eng_mod
from planet_heightmap_generation_torch.pipeline.engine import (
    PlanetEngine, host_setup)
from planet_heightmap_generation_torch.pipeline.timing import StageTimer

PARAMS = GenerationParams(seed=11, n_cells=2000, n_plates=10,
                          num_continents=2, skip_climate=True)
OUTPUTS = ("r_plate", "pre_post_elevation", "elevation", "t_elevation",
           "stress", "mountain_mask", "coastline_mask", "ocean_seed_mask")


def mesh4():
    return cells_mesh(4, ["cpu"] * 4)


@pytest.fixture(scope="module")
def single():
    return PlanetEngine(device="cpu").generate(PARAMS)


@pytest.fixture(scope="module")
def split():
    eng = PlanetEngine(device="cpu", timing=False, mesh=mesh4())
    return eng, eng.generate(PARAMS)


def assert_split_contract(res, ref):
    d = (res.elevation - ref.elevation).abs().max().item()
    assert d < 2e-3, d
    assert torch.equal(res.r_plate, ref.r_plate)
    assert res.diagnostics()["nan_count"] == 0
    for name in OUTPUTS:
        a, b = getattr(res, name), getattr(ref, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), name


def test_split_generate_matches_single(split, single):
    eng, res = split
    assert_split_contract(res, single)
    assert set(res.debug) == set(single.debug)
    for k, v in single.debug.items():
        assert torch.equal(res.debug[k], v), k
    st = eng.split_stats
    assert st["shards"] == 4
    assert st["exchanges"] > 0 and st["launches"] > 0
    assert st["gathered_calls"] > 0 and st["gathered_bytes"] > 0
    # the gathered state is the engine's device's, the whole planet's
    assert eng._w["g"] is not None and eng._w["g"].n_padded == \
        res.elevation.shape[0]


def test_split_generate_with_glacial_erosion():
    params = PARAMS.replace(glacial_erosion=0.2)
    ref = PlanetEngine(device="cpu").generate(params)
    res = PlanetEngine(device="cpu", timing=False,
                       mesh=mesh4()).generate(params)
    assert_split_contract(res, ref)


@pytest.mark.parametrize("mode", ["timing", "fused_max"])
def test_unsplit_branches_equal_single(mode, single, monkeypatch):
    if mode == "timing":
        eng = PlanetEngine(device="cpu", timing=True, mesh=mesh4())
    else:
        monkeypatch.setattr(eng_mod, "FUSED_MAX_CELLS", PARAMS.n_cells - 1)
        eng = PlanetEngine(device="cpu", timing=False, mesh=mesh4())
    res = eng.generate(PARAMS)
    assert eng.split_stats is None
    for name in OUTPUTS:
        assert torch.equal(getattr(res, name), getattr(single, name)), name


def test_device_must_be_the_mesh_first():
    mesh = mesh4()
    assert PlanetEngine(mesh=mesh).device == torch.device("cpu")
    assert PlanetEngine(device="cpu", mesh=mesh).device.type == "cpu"
    with pytest.raises(ValueError, match="first device"):
        PlanetEngine(device="cpu", mesh=cells_mesh(2, ["meta", "cpu"]))


def test_shard_fused_args_splits_the_cell_tensors():
    s = host_setup(PARAMS, "cpu", StageTimer(sync_enabled=False),
                   lambda *a: None)
    lay, shards = shard_fused_args(mesh4(), s)
    npd = s.g.n_padded
    assert len(shards) == lay.n_shards == 4
    for c, sc in enumerate(shards):
        idx = lay._t(c, "index")
        w = sc.g
        assert w.n_padded == lay.length(c) and w.n_cells == s.g.n_cells
        assert torch.equal(w.pos, s.g.pos[idx])
        assert torch.equal(w.valid, s.g.valid[idx])
        chunk = lay._t(c, "chunk")
        assert not w.band_mask[~chunk].any()
        assert torch.equal(w.band_mask[chunk], s.g.band_mask[idx[chunk]])
        # window neighbours are the global ones, seen from the window
        m = w.nbr_mask
        assert torch.equal(idx[w.nbr_idx][m], s.g.nbr_idx[idx][m])
        assert torch.equal(m[chunk], s.g.nbr_mask[idx[chunk]])
        # everything without a cell axis is replicated, value for value
        for a, b in zip(sc.plate_arrays, s.plate_arrays):
            assert torch.equal(a, b)
        for k, v in s.domes.items():
            assert torch.equal(sc.domes[k], v) and v.shape[:1] != (npd,)
        for a, b in zip(sc.projection, s.projection):
            assert (a == b) if not torch.is_tensor(b) else torch.equal(a, b)
        assert torch.equal(sc.warp_t.perm, s.warp_t.perm)
        assert sc.graph is s.graph and sc.coarse is s.coarse
    # the remainder edges of the chunk rows, in global edge order
    src = torch.cat([lay._t(c, "index")[w.g.rem_src]
                     for c, w in enumerate(shards)])
    dst = torch.cat([lay._t(c, "index")[w.g.rem_dst]
                     for c, w in enumerate(shards)])
    assert torch.equal(src, s.g.rem_src) and torch.equal(dst, s.g.rem_dst)


def _layout(n=4):
    s = host_setup(PARAMS, "cpu", StageTimer(sync_enabled=False),
                   lambda *a: None)
    return shard_fused_args(cells_mesh(n, ["cpu"] * n), s)


@pytest.fixture(scope="module")
def layout():
    return _layout()[0]


def test_collectives_of_diverging_shards_raise(layout):
    """Shards at different call sites raise at once, naming both sites;
    a shard that never arrives raises at the timeout; a shard's own error
    reaches the caller. None of them hangs."""
    def diverge(c):
        x = torch.zeros(layout.length(c))
        if c == 2:
            return spmd.gathered(torch.sum, x)
        return spmd.fresh(x)

    t0 = time.perf_counter()
    with pytest.raises(spmd.SplitError, match="diverged") as info:
        spmd.run(layout, diverge, [()] * 4, timeout=20)
    assert "shard 2 at 'gathered" in str(info.value)
    assert "shard 0 at 'exchange" in str(info.value)

    def late(c):
        if c == 1:
            time.sleep(1.5)
        return spmd.flag_any(torch.zeros(1, dtype=torch.int32))

    with pytest.raises(spmd.SplitError, match="did not complete within"):
        spmd.run(layout, late, [()] * 4, timeout=0.3)

    def fails(c):
        if c == 3:
            raise KeyError("shard three")
        return spmd.flag_any(torch.ones(1, dtype=torch.int32))

    with pytest.raises(KeyError, match="shard three"):
        spmd.run(layout, fails, [()] * 4, timeout=20)
    assert time.perf_counter() - t0 < 15
    assert not [t for t in threading.enumerate()
                if t.name.startswith("split-shard")]


def test_collectives_compute_the_single_results(layout):
    """Off a split every primitive is the plain call; on one, each shard
    gets its window of the whole-array result."""
    whole = torch.arange(layout.n_padded, dtype=torch.float32) * 0.5
    x = torch.tensor([1.0, 2.0])
    assert spmd.fresh(x) is x and spmd.total(7) == 7
    assert torch.equal(spmd.arange(5), torch.arange(5))
    assert spmd.gathered(torch.sum, x) == 3.0
    assert spmd.launch("bfs_relax", lambda *a: a, 1, 2) == (1, 2)

    def body(c):
        idx = layout._t(c, "index")
        w = torch.where(layout._t(c, "chunk"), whole[idx], -1.0)
        w = spmd.fresh(w)
        return (w, spmd.gathered(torch.cumsum, w, dim=0),
                spmd.gathered(torch.sum, w), spmd.arange(w.shape[0]),
                spmd.total(w.shape[0]), spmd.flag_any(
                    torch.tensor([int(c == 3)], dtype=torch.int32)))

    out, stats = spmd.run(layout, body, [()] * 4)
    for c, (w, cs, s, ar, n, flag) in enumerate(out):
        idx = layout._t(c, "index")
        assert torch.equal(w, whole[idx])          # halo and slots filled
        assert torch.equal(cs, torch.cumsum(whole, 0)[idx])
        assert s == whole.sum() and n == layout.n_padded and flag
        assert torch.equal(ar, idx)
    assert stats["exchanges"] == 1 and stats["gathered_calls"] == 2
