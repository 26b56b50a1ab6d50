"""Run the CUDA kernels of planet_heightmap_generation_torch/csrc/sweeps.cu
on the CPU, through the wrappers of ops/sweep_cuda.py, against their
plain-torch versions, bit for bit:

    python3 tools/cuda_emu/run.py

The source is compiled with g++ against emu.h, which emulates the CUDA
subset it uses: every CUDA thread is an OS thread, ``__syncthreads``, warp
shuffles and ballots and the grid barrier are barriers, ``__shared__``
variables live once per block. The launch plan sees ``EMU_NSM`` SMs
(default 2) of ``EMU_PER_SM`` co-resident blocks (default 1). Checked: the
accumulate launch (pointer-doubling loops: forests, int32 counts, F=3, a
star row past the ranking limit, a fixed-round ice flow with -0.0 values)
and its one-round form (few targets, long rows), and the components
launch on a 2000-cell mesh (every cell, a subset, a sparse subset), and
every staged launch at chip_smoke.py's synthetic shapes past 204K, whose
chunks the window cap binds, with the capped launches each call counted
against the library's plans (``plan_checks``), and the eight loops split
over three windows of a 2000-cell mesh (parallel/loops.py) against their
unsplit plain loops (``split_checks``), and the erosion loop's stencils
(``stencil_checks``: ``thermal_shed``, ``thermal_receive``, ``ice_argmin``
and ``glacial_stencil`` against their plain versions, and the thermal and
glacial steps through them against the steps through the plain
versions, and split over three windows of the 2000-cell mesh against
unsplit). It
checks indexing, barriers, shuffles and loop control before a run on the
card; it says nothing about speed. Exits 1 on any difference.
"""
import contextlib
import os
import re
import subprocess
import sys
import tempfile
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from planet_heightmap_generation_torch.ops import banded  # noqa: E402
from planet_heightmap_generation_torch.ops import sweep_cuda as sc  # noqa: E402


def build(out_dir: str) -> str:
    """sweeps.cu rewritten for emu.h and compiled into a shared library."""
    src = open(sc.SOURCE).read()
    src = src.replace("#include <cooperative_groups.h>\n"
                      "#include <cuda_runtime.h>\n", '#include "emu.h"\n')
    src = src.replace("extern __shared__ __align__(16) float win[];",
                      "float* win = emu_dyn_shared();")
    src = re.sub(r"__shared__ (\w+) (\w+)(\[[^\]]*\])?;",
                 lambda m: f"auto& {m.group(2)} = emu_shared<{m.group(1)}"
                           f"{m.group(3) or ''}>(__LINE__);", src)
    src = src.replace("cudaLaunchCooperativeKernel((const void*)kern,",
                      "emu_launch(kern,")
    src = src.replace("cudaLaunchKernel(\n      (const void*)kern,",
                      "emu_launch(kern,")
    assert "__shared__" not in src
    cpp = os.path.join(out_dir, "sweeps_emu.cpp")
    lib = os.path.join(out_dir, "sweeps_emu.so")
    with open(cpp, "w") as f:
        f.write(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-I", HERE, "-o", lib, cpp], check=True)
    return lib


def use_library(lib: str) -> None:
    """Route every wrapper to the kernels of ``lib``, on CPU tensors."""
    sc.LIBRARY = lib
    sc.build = lambda: ""
    sc._LIB = None
    sc._on_cpu = lambda x: False
    torch.cuda.current_stream = lambda *a: types.SimpleNamespace(
        cuda_stream=0)
    torch.cuda.device = lambda *a: contextlib.nullcontext()


def plain(fn, *args):
    """``fn(*args)`` with the wrappers routed to the plain versions."""
    route = sc._on_cpu
    sc._on_cpu = lambda x: True
    try:
        return fn(*args)
    finally:
        sc._on_cpu = route


def check(label, fn, *args) -> bool:
    got, want = fn(*args), plain(fn, *args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    ok = all(torch.equal(a, b) for a, b in zip(got, want))
    counted = len(got) > 1 and got[1].numel() == 1
    print(f"{label}: {'bit-identical' if ok else 'DIFFERS'}"
          + (f", {int(got[1])} / {int(want[1])} rounds or steps"
             if counted else ""), flush=True)
    return ok


def accumulate_checks() -> bool:
    rng = np.random.default_rng(0)
    n = 3000
    i = np.arange(n)
    p = torch.as_tensor(np.where(rng.random(n) < 0.25, n,
                                 np.maximum(i - rng.integers(1, 64, n), 0)))
    s = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    s3 = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32))
    neg = s.clone()
    neg[::3] = -0.0
    star = np.where(rng.random(n) < 0.8, 7, n)
    star[7] = n
    acc = sc.accumulate_relax
    ok = all([
        check("accumulate forest F=1", acc, s, p, 14, True),
        check("accumulate forest F=1 int32 pointers", acc, s,
              p.to(torch.int32), 14, True),
        check("accumulate forest, cap binds", acc, s, p, 2, True),
        check("accumulate forest F=3", acc, s3, p, 14, True),
        check("accumulate int32 counts", acc, (s > 0).to(torch.int32), p, 14,
              True),
        check("accumulate star row of 2400", acc, s, torch.as_tensor(star),
              14, True),
        check("accumulate ice flow, 22 rounds, -0.0", acc, neg, p, 22,
              False),
        check("accumulate all at the sink", acc, neg, torch.full((n,), n),
              22, False),
        check("accumulate rows of 12", acc, s,
              torch.as_tensor(np.minimum(i // 12 + 1, n)), 14, True)])
    for n_out in (30, 60, 700):
        idx = rng.integers(0, n_out + 2, n)
        idx[rng.random(n) < 0.05] = 3
        for f in (1, 3):
            v = torch.as_tensor(rng.standard_normal(
                (n, f) if f > 1 else n).astype(np.float32))
            ok &= check(f"one-round sum, {n_out} targets, F={f}",
                        sc.ordered_sum, n_out, torch.as_tensor(idx), v)
    return ok


def components_checks() -> bool:
    from planet_heightmap_generation_torch.mesh.build import build_sphere
    from planet_heightmap_generation_torch.mesh.device import to_device
    from planet_heightmap_generation_torch.ops.rng import ParkMiller

    g = to_device(build_sphere(2000, 0.75, rng=ParkMiller(42)), "cpu")
    npad = g.n_padded
    field = np.random.default_rng(1).standard_normal(npad)
    for _ in range(4):
        field = field + field[g.nbr_idx.numpy()].mean(1)
    ar = torch.arange(npad, dtype=torch.float32)

    def case(label, lab, member, gate, rem_ok):
        ptr, nbr = banded.rem_csr(torch.where(rem_ok, g.rem_src, npad),
                                  g.rem_dst, npad)
        return check(f"components, {label}", sc.components_relax, lab,
                     member, banded.pack_band_bits(gate), g.band_off, ptr,
                     nbr)

    classes = torch.as_tensor((field * 2).astype(np.int32) % 3)
    ok = case("every cell", ar, None,
              banded.band_gate(classes, g.band_off, g.band_mask),
              banded.rem_gate_eq(classes, g.rem_src, g.rem_dst))
    for thr in (0.0, 1.5):
        in_set = torch.as_tensor(field > thr) & g.valid
        ok &= case(f"subset above {thr}",
                   torch.where(in_set, ar, float(npad)),
                   in_set.to(torch.uint8),
                   banded.band_gate(in_set, g.band_off, g.band_mask)
                   & in_set[:, None],
                   in_set[g.rem_src] & in_set[g.rem_dst])
    return ok


def plan_checks() -> bool:
    """The staged launches at chip_smoke.py's synthetic shapes past 204K
    (the 204K band set with a band pair at ±5760, about the 2.56M mesh's
    half-width, on 8,192 cells an SM, and at ±7200, ~4M, on 16,384 an
    SM, and the smoothing launches alone at ±7300, whose fields launch one
    a group): their chunks are capped at these half-widths, as on the card
    at 2.56M cells, and are no multiple of 4."""
    import chip_smoke
    from planet_heightmap_generation_torch.mesh.build import build_sphere
    from planet_heightmap_generation_torch.ops.rng import ParkMiller

    band_off = build_sphere(204000, 0.75,
                            rng=ParkMiller(42)).banded_packed[0]
    try:
        nsm = int(os.environ.get("EMU_NSM", "2"))
        chip_smoke.plan_checks(torch.device("cpu"), band_off,
                               [(5760, 8192 * nsm), (7200, 16384 * nsm),
                                (7300, 16384 * nsm, ("smooth",))],
                               plain=plain)
    except AssertionError as e:
        print(e, flush=True)
        return False
    return True


def split_checks() -> bool:
    """The eight loops split over three windows (parallel/loops.py: the
    kernels on every window, per sweep or in stale-halo rounds) against
    their unsplit plain loops, on a 2000-cell mesh: the checks of
    tests/test_torch_sharding.py with the emulated kernels in the split
    loops' wrappers."""
    from planet_heightmap_generation_torch.mesh.build import build_sphere
    from planet_heightmap_generation_torch.mesh.device import to_device
    from planet_heightmap_generation_torch.ops.rng import ParkMiller

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_sharding as t

    g = to_device(build_sphere(2000, 0.75, rng=ParkMiller(42)), "cpu")
    csr = banded.rem_csr(g.rem_src, g.rem_dst, g.n_padded)
    t.sphere_graph = lambda: (g, *csr)
    ok = True
    for name, fn in t.LOOPS.items():
        try:
            fn(3)
            print(f"split {name} over 3 windows: bit-identical", flush=True)
        except AssertionError as e:
            print(f"split {name} over 3 windows: DIFFERS {e}", flush=True)
            ok = False
    return ok


def stencil_checks() -> bool:
    """The erosion stencils on the 2000-cell mesh of
    tests/test_torch_erosion_stencil.py: each launch against its plain
    version, then the thermal and glacial steps through the launches
    against the same steps through the plain versions, and split over
    three windows against unsplit (the split cases of that test, with the
    emulated kernels in the wrappers)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_erosion_stencil as t
    from planet_heightmap_generation_torch.erosion import glacial, thermal

    g, band_dist, rem_dist = t.sphere()
    bits, ptr, nbr, rd = banded.stencil_graph(g.band_mask, g.rem_src,
                                              g.rem_dst, rem_dist)
    graph = (bits, g.band_off, band_dist, ptr, nbr, rd)
    elev = t.polar_terrain(6)
    ocean = (elev <= 0) & g.valid
    ok = True
    for talus, k in ((0.8, 0.15), (1.16, 0.015)):
        shed = plain(sc.thermal_shed, elev, ocean, g.valid, *graph, talus, k)
        ok &= check(f"thermal_shed, talus {talus}", sc.thermal_shed, elev,
                    ocean, g.valid, *graph, talus, k)
        ok &= check(f"thermal_receive, talus {talus}", sc.thermal_receive,
                    elev, ocean, g.valid, *graph, talus, *shed)
    args, s, g_scale = t.glacial_inputs(elev, 1.0)
    glac = args[-1]
    gidx = torch.arange(g.n_padded, dtype=torch.int32) * 3 % g.n_padded
    for label, gi in (("own index", None), ("permuted index", gidx)):
        ok &= check(f"ice_argmin, {label}", sc.ice_argmin, elev, ocean,
                    g.valid, glac, gi, bits, g.band_off, ptr, nbr,
                    g.n_padded)
    target, p = plain(sc.ice_argmin, elev, ocean, g.valid, glac, None, bits,
                      g.band_off, ptr, nbr, g.n_padded)
    flow = plain(sc.accumulate_relax, glac, p, 22, False)[0]
    pows = [torch.pow(flow, e) for e in (0.6, 0.3, 0.4, 0.5)]
    ok &= check("glacial_stencil", sc.glacial_stencil, elev, ocean, g.valid,
                glac, flow, target, None, *pows, *graph, 0.002, 0.0005,
                0.001, 0.0015, 1.0)
    # the steps through the launches against the plain versions
    targs = t.thermal_args(elev)
    ok &= check("thermal_step through the launches against the plain "
                "versions", thermal.thermal_step, *targs, 1.0, 0.075)
    for strength in (0.2, 1.0):
        a, s, g_scale = t.glacial_inputs(elev, strength)
        ok &= check(f"glacial_step {strength} through the launches against "
                    "the plain versions", glacial.glacial_step, *a, s, g_scale)
    for step in ("thermal", "glacial"):
        try:
            t.check_split(step)
            print(f"split {step} step over 3 windows: bit-identical",
                  flush=True)
        except AssertionError as e:
            print(f"split {step} step over 3 windows: DIFFERS {e}",
                  flush=True)
            ok = False
    return ok


def main() -> int:
    with tempfile.TemporaryDirectory() as d:
        use_library(build(d))
        ok = (accumulate_checks() & components_checks() & plan_checks()
              & split_checks() & stencil_checks())
    print("all bit-identical" if ok else "DIFFERENCES FOUND")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
