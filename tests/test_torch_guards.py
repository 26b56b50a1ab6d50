"""Import and dispatch guards of the PyTorch port.

- The port imports neither JAX nor the JAX package (checked in a fresh
  interpreter, and by scanning its sources).
- Entry points never fall back to the CPU on their own: the engine
  refuses to start without CUDA unless the caller asks for the CPU, and a
  sweep wrapper given a CUDA tensor launches its kernel or raises.
- Glacial erosion, which raised before it was ported, runs under every
  climate setting; climate itself runs, on the CPU too.
"""

import functools

import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

import planet_heightmap_generation_torch as port
from planet_heightmap_generation_torch.ops import sweep_cuda
from planet_heightmap_generation_torch.ops.banded import (
    ordered_index_sum, pointer_accumulate)

PKG = pathlib.Path(port.__file__).parent
MODULES = sorted(
    "planet_heightmap_generation_torch." + ".".join(
        p.relative_to(PKG).with_suffix("").parts).replace(".__init__", "")
    for p in PKG.rglob("*.py"))


def test_imports_pull_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m.rstrip('.'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or"
        " m.startswith('planet_heightmap_generation_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr


def test_sources_name_no_jax():
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for word in ("import jax", "from jax", "planet_heightmap_generation_tpu"):
            assert word not in text, f"{path}: {word}"


def test_relax_plans_decode():
    """The plan rows the library's relax_plans() writes, as dicts: the
    kernel's name, and ``capped`` where the window cap bound T."""
    rows = [[4, 2561024, 1, 4, 5760, 2933, 20480, 132, 231424],
            [0, 1024, 1, 1, 40, 1024, 1024, 1, 4512]]
    got = sweep_cuda.decode_plans(rows)
    assert [p["kernel"] for p in got] == ["smooth", "bfs_relax"]
    assert [p["capped"] for p in got] == [True, False]
    assert got[0]["T"] == 2933 and got[0]["T_free"] == 20480
    assert set(got[1]) == set(sweep_cuda.PLAN_FIELDS) | {"capped"}


def test_engine_without_cuda_raises(monkeypatch):
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanetEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanetEngine(device="cuda")
    assert PlanetEngine(device="cpu").device.type == "cpu"


@functools.lru_cache(maxsize=1)
def _elevation_without_glacial():
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    return PlanetEngine(device="cpu").generate(GenerationParams(
        seed=1, n_cells=2000, n_plates=8, skip_climate=True)).elevation


@pytest.mark.parametrize("kw", [dict(skip_climate=False,
                                     glacial_erosion=0.5),
                                dict(skip_climate=None, glacial_erosion=0.5),
                                dict(skip_climate=True, glacial_erosion=0.5)])
def test_uncovered_requests_raise(kw):
    """Glacial erosion, the request this test once held to raise, is
    ported: a glacial generate runs on the CPU under every climate setting
    and carves the terrain (its elevation differs from glacial 0)."""
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    res = PlanetEngine(device="cpu").generate(
        GenerationParams(seed=1, n_cells=2000, n_plates=8, **kw))
    assert res.error is None
    assert res.diagnostics()["nan_count"] == 0
    assert (res.climate is None) == bool(kw["skip_climate"])
    changed = res.elevation != _elevation_without_glacial()
    assert bool(changed.any())


@pytest.mark.parametrize("skip_climate", [False, None, True])
def test_climate_runs_on_cpu(skip_climate):
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    res = PlanetEngine(device="cpu").generate(GenerationParams(
        seed=1, n_cells=2000, n_plates=8, skip_climate=skip_climate))
    if skip_climate:
        assert res.climate is None and "koppen" not in res.debug
    else:
        assert res.climate["koppen"].shape == (res.graph.n_padded,)
        assert "Climate: Köppen" in dict(res.timing.stages)


def _fake_cuda(shape):
    """Stands in for a CUDA tensor: the wrappers route on ``.device``
    before touching any data."""
    return types.SimpleNamespace(device=torch.device("cuda"), shape=shape)


@pytest.mark.parametrize("kernel", ["bfs", "stress", "warp", "flood",
                                    "smooth", "shadow", "bfs_relax",
                                    "ordered_sum", "accumulate"])
def test_cuda_request_without_kernel_raises(monkeypatch, tmp_path, kernel):
    """``bfs``: the components loop, the BFS family's other use (its
    launch is ``components_relax``); ``ordered_sum``: the one-round sum,
    now a launch of the accumulate kernel; ``accumulate``: a whole
    pointer-doubling loop."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(sweep_cuda, "_LIB", None)
    monkeypatch.setattr(sweep_cuda, "LIBRARY", str(tmp_path / "missing.so"))
    monkeypatch.setattr(sweep_cuda, "_nvcc", no_nvcc)
    before = dict(sweep_cuda.LAUNCHES)
    x = _fake_cuda((4, 64))
    call = {
        "bfs": lambda: sweep_cuda.components_relax(x, None, x, (1,), x, x),
        "stress": lambda: sweep_cuda.stress_relax(x, x, x, (1,), x, x, x,
                                                  0.9, 0.8, 5),
        "warp": lambda: sweep_cuda.warp_relax(x, x, x, (1,), x, x, 5),
        "flood": lambda: sweep_cuda.flood_relax(x, x, x, x, (1,), x, x, 1e9,
                                                1e-6),
        "smooth": lambda: sweep_cuda.smooth_relax(x, x, x, (1,), x, x, 3),
        "shadow": lambda: sweep_cuda.shadow_relax(x, x, x, x, (1,), x, x,
                                                  0.9, 0.8, 3, 2),
        "bfs_relax": lambda: sweep_cuda.bfs_relax(x, x, x, (1,), x, x, 5),
        "ordered_sum": lambda: ordered_index_sum(4, x, x),
        "accumulate": lambda: pointer_accumulate(x, x, 5),
    }[kernel]
    with pytest.raises(RuntimeError):
        call()
    assert sweep_cuda.LAUNCHES == before


def test_other_devices_refused():
    x = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError):
        sweep_cuda.components_relax(x[0], None, x, (1,), x, x)
    with pytest.raises(ValueError):
        sweep_cuda.accumulate_relax(x[0], x[0], 3)


@pytest.mark.parametrize("bad", ["plane_shape", "plane_dtype", "bits_dtype",
                                 "strided", "flag_dtype", "csr_ptr_shape",
                                 "csr_nbr_dtype", "np_not_multiple_of_4",
                                 "misaligned", "layer_planes_shape",
                                 "layer_bits_shape", "rem_gate_dtype",
                                 "rem_gate_shape", "no_smoothing_pass",
                                 "sum_idx_dtype", "sum_vals_dtype",
                                 "sum_vals_shape", "sum_n_out_range",
                                 "acc_vals_dtype", "acc_int_fields",
                                 "acc_fields", "acc_ptr_dtype",
                                 "acc_ptr_shape", "acc_strided",
                                 "member_dtype"])
def test_kernel_input_check_refuses_what_the_kernel_cannot_read(bad):
    """The checks every wrapper runs before handing pointers to a kernel
    (``_check``; ``_check_csr`` for the kernels that walk remainder
    rows, with the stress relax's per-layer remainder gates; ``_check_sum``
    for the one-round sum; ``_check_acc`` for the accumulate loop; the
    components launch's member mask). The staged kernels load planes as
    float4 words, so NP must be a multiple of 4 and every plane 16-byte
    aligned; the stress relax takes [G, 3, NP] state and [G, NP] bits; a
    smoothing launch runs at least one pass; the ordered sum takes integer
    indices, contiguous float32 values of at most 4 columns and an output
    count in int32 range; the accumulate loop takes contiguous float32
    values of at most 4 columns or int32 counts of one, and contiguous
    int32 or int64 targets, one a value; the components launch a uint8
    member mask."""
    bits = torch.zeros(64, dtype=torch.int32)
    plane = torch.zeros((4, 64))
    flag = torch.zeros(1, dtype=torch.int32)
    ptr = torch.zeros(65, dtype=torch.int32)
    nbr = torch.zeros(3, dtype=torch.int32)
    layers = torch.zeros((2, 3, 64))
    lbits = torch.zeros((2, 64), dtype=torch.int32)
    rgate = torch.zeros((2, 3), dtype=torch.uint8)
    sweep_cuda._check(bits, flag, (plane, 4), (plane[0].clone(), None))
    sweep_cuda._check_csr(bits, ptr, nbr)
    sweep_cuda._check(lbits, None, (layers, (2, 3)), (plane[:2], 2),
                      bit_rows=2)
    sweep_cuda._check_csr(lbits, ptr, nbr, rgate, 2)
    idx = torch.zeros(5, dtype=torch.int64)
    sweep_cuda._check_sum(8, idx, plane[:, :5].T.contiguous())
    vals = plane[:, :5].T.contiguous()
    sweep_cuda._check_acc(vals, idx, 5)
    sweep_cuda._check_acc(idx.int(), idx.int(), 5)
    call = {
        "plane_shape": lambda: sweep_cuda._check(
            bits, flag, (plane[:, :32].contiguous(), 4)),
        "plane_dtype": lambda: sweep_cuda._check(bits, flag,
                                                 (plane.double(), 4)),
        "bits_dtype": lambda: sweep_cuda._check(bits.long(), flag,
                                                (plane, 4)),
        "strided": lambda: sweep_cuda._check(
            bits, flag, (plane.T.contiguous().T, 4)),
        "flag_dtype": lambda: sweep_cuda._check(bits, flag.bool(),
                                                (plane, 4)),
        "csr_ptr_shape": lambda: sweep_cuda._check_csr(bits, ptr[:-1], nbr),
        "csr_nbr_dtype": lambda: sweep_cuda._check_csr(bits, ptr,
                                                       nbr.long()),
        "np_not_multiple_of_4": lambda: sweep_cuda._check(
            bits[:62].clone(), flag, (plane[:, :62].contiguous(), 4)),
        "misaligned": lambda: sweep_cuda._check(
            bits, flag, (torch.zeros(65)[1:], None)),
        "layer_planes_shape": lambda: sweep_cuda._check(
            lbits, None, (layers[:, :2].contiguous(), (2, 3)), bit_rows=2),
        "layer_bits_shape": lambda: sweep_cuda._check(
            bits, None, (layers, (2, 3)), bit_rows=2),
        "rem_gate_dtype": lambda: sweep_cuda._check_csr(
            lbits, ptr, nbr, rgate.bool(), 2),
        "rem_gate_shape": lambda: sweep_cuda._check_csr(
            lbits, ptr, nbr, rgate[:1].contiguous(), 2),
        "no_smoothing_pass": lambda: sweep_cuda.smooth_relax(
            plane, plane[0] + 1, bits, (1,), ptr, nbr, 0),
        "sum_idx_dtype": lambda: sweep_cuda._check_sum(
            8, idx.float(), plane[0, :5].clone()),
        "sum_vals_dtype": lambda: sweep_cuda._check_sum(
            8, idx, plane[0, :5].double()),
        "sum_vals_shape": lambda: sweep_cuda._check_sum(
            8, idx, torch.zeros((5, 5))),
        "sum_n_out_range": lambda: sweep_cuda._check_sum(
            -1, idx, plane[0, :5].clone()),
        "acc_vals_dtype": lambda: sweep_cuda._check_acc(vals.double(), idx, 5),
        "acc_int_fields": lambda: sweep_cuda._check_acc(
            torch.zeros((5, 2), dtype=torch.int32), idx, 5),
        "acc_fields": lambda: sweep_cuda._check_acc(torch.zeros((5, 5)), idx,
                                                    5),
        "acc_ptr_dtype": lambda: sweep_cuda._check_acc(vals, idx.to(
            torch.int16), 5),
        "acc_ptr_shape": lambda: sweep_cuda._check_acc(vals, idx[:4], 5),
        "acc_strided": lambda: sweep_cuda._check_acc(
            plane[:, :5].T, idx, 5),
        "member_dtype": lambda: _components_as_on_card(
            plane[0].clone(), plane[0].bool(), bits, ptr, nbr),
    }[bad]
    with pytest.raises(ValueError):
        call()


def _components_as_on_card(lab, member, bits, ptr, nbr):
    """``components_relax``'s input checks on CPU tensors, routed as CUDA
    ones (it raises before it loads the library or reads any data)."""
    import unittest.mock as mock

    with mock.patch.object(sweep_cuda, "_on_cpu", lambda x: False), \
            mock.patch.object(sweep_cuda, "_kernel", lambda name: None):
        sweep_cuda.components_relax(lab, member, bits, (1,), ptr, nbr)


def test_cpu_wrappers_run_plain_versions_uncounted():
    gen = torch.Generator().manual_seed(0)
    n, offs = 64, (-3, 1, 5)
    bits = torch.randint(0, 8, (n,), generator=gen, dtype=torch.int32)
    st = torch.rand((4, n), generator=gen)
    st[2:] = (st[2:] > 0.5).float()
    w = torch.rand((3, n), generator=gen)
    aux = torch.rand((9, n), generator=gen) - 0.5
    rem_ptr = torch.zeros(n + 1, dtype=torch.int32)
    rem_ptr[6:] = 2
    rem_nbr = torch.tensor([9, 40], dtype=torch.int32)
    layers = torch.stack([st[:3], st[[1, 0, 2]]]).contiguous()
    lbits = torch.stack([bits, bits.flip(0)]).contiguous()
    rgate = torch.tensor([[1, 0], [1, 1]], dtype=torch.uint8)
    before = dict(sweep_cuda.LAUNCHES)
    relaxed = [
        (sweep_cuda.bfs_relax(st, st + 0.5, bits, offs, rem_ptr, rem_nbr, 3),
         sweep_cuda.bfs_relax_plain(st, st + 0.5, bits, offs, rem_ptr,
                                    rem_nbr, 3)),
        (sweep_cuda.flood_relax(st[0], st[2], st[1], bits, offs, rem_ptr,
                                rem_nbr, 1e9, 1e-6),
         sweep_cuda.flood_relax_plain(st[0], st[2], st[1], bits, offs,
                                      rem_ptr, rem_nbr, 1e9, 1e-6)),
        (sweep_cuda.stress_relax(layers, st[2:], lbits, offs, rem_ptr,
                                 rem_nbr, rgate, 0.9, 0.7, 4),
         sweep_cuda.stress_relax_plain(layers, st[2:], lbits, offs, rem_ptr,
                                       rem_nbr, rgate, 0.9, 0.7, 4)),
        (sweep_cuda.warp_relax(st, w, bits, offs, rem_ptr, rem_nbr, 3),
         sweep_cuda.warp_relax_plain(st, w, bits, offs, rem_ptr, rem_nbr,
                                     3)),
        (sweep_cuda.shadow_relax(st - 0.5, aux, st[2], bits, offs, rem_ptr,
                                 rem_nbr, 0.9, 0.8, 3, 2),
         sweep_cuda.shadow_relax_plain(st - 0.5, aux, st[2], bits, offs,
                                       rem_ptr, rem_nbr, 0.9, 0.8, 3, 2)),
    ]
    lab = torch.where(st[2] > 0, torch.arange(n, dtype=torch.float32),
                      float(n))
    member = (st[2] > 0).to(torch.uint8)
    sinks = torch.where(st[3] > 0.5, n, (torch.arange(n) * 7) % n)
    relaxed += [
        (sweep_cuda.components_relax(lab, member, bits, offs, rem_ptr,
                                     rem_nbr),
         sweep_cuda.components_relax_plain(lab, member, bits, offs, rem_ptr,
                                           rem_nbr)),
        (sweep_cuda.components_relax(torch.arange(n, dtype=torch.float32),
                                     None, bits, offs, rem_ptr, rem_nbr),
         sweep_cuda.components_relax_plain(
             torch.arange(n, dtype=torch.float32), None, bits, offs,
             rem_ptr, rem_nbr)),
        (sweep_cuda.accumulate_relax(st[0].clone(), sinks, 6),
         sweep_cuda.accumulate_relax_plain(st[0].clone(), sinks, 6)),
        (sweep_cuda.accumulate_relax(member.int(), sinks, 6),
         sweep_cuda.accumulate_relax_plain(member.int(), sinks, 6)),
    ]
    pairs = [x for (a, b) in relaxed for x in zip(a, b)] + [
        (sweep_cuda.smooth_relax(st, st[0] + 2, bits, offs, rem_ptr, rem_nbr,
                                 2, st[2], st[3]),
         sweep_cuda.smooth_relax_plain(st, st[0] + 2, bits, offs, rem_ptr,
                                       rem_nbr, 2, st[2], st[3])),
        (ordered_index_sum(40, bits.long() % 41, st[:3].T.contiguous()),
         sweep_cuda.ordered_sum_plain(40, bits.long() % 41,
                                      st[:3].T.contiguous())),
    ]
    for a, b in pairs:
        assert torch.equal(a, b)
    assert sweep_cuda.LAUNCHES == before
