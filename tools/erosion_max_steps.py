"""The elevation maximum after each step of the port's terrain
post-processing, for one generate:

    python3 tools/erosion_max_steps.py --cells 1000000 --seed 42 \
        [--device cpu] [--climate]

Runs ``PlanetEngine(device).generate(GenerationParams(seed, n_cells,
skip_climate=not --climate))`` with each step function that
erosion/composite.py calls (the warp, smoothing, the flood carve, the
stream-power solve, the thermal step, ridge sharpening, soil creep)
wrapped to record the maximum of its output over the real cells, in call
order; and erosion/flood.py ``monotonic_enforce`` (inside each flood
carve) to record its round cap R, the land cells whose drain pointers
lead into a cycle (still off the sink after 2^R steps, which no acyclic
chain of the mesh needs) and the largest rise it gives a cell. Prints one
line per call and one ``RESULT`` JSON line: the pre-erosion and final
maxima, and for each step the largest rise of the maximum across one of
its calls. The first step whose calls raise the maximum is where its
growth with N starts.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STEPS = ("warp_terrain", "smooth_elevation", "priority_flood_carve",
         "stream_power_solve", "thermal_step", "sharpen_ridges",
         "apply_soil_creep")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--climate", action="store_true")
    a = ap.parse_args()
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.erosion import composite
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    rows = []
    n_real = []

    def top(x):
        return float(x[:n_real[0]].max())

    def wrap(name, fn):
        def run(elev, *args, **kw):
            out = fn(elev, *args, **kw)
            e = out[0] if isinstance(out, tuple) else out
            rows.append((name, sum(r[0] == name for r in rows), top(elev),
                         top(e)))
            return out
        return run

    from planet_heightmap_generation_torch.erosion import flood
    from planet_heightmap_generation_torch.erosion.fluvial import log_rounds

    enforce = flood.monotonic_enforce
    cycles = []

    def enforce_probe(elev, drain, is_ocean, valid, rounds=0):
        out = enforce(elev, drain, is_ocean, valid, rounds)
        n = elev.shape[0]
        r = rounds if rounds > 0 else log_rounds(n)
        land = (~is_ocean) & valid & (drain >= 0)
        p = torch.where(land, drain.long(), n)
        for _ in range(r):
            p = torch.cat([p, p.new_tensor([n])])[p]
        cycles.append(dict(rounds=r, cells_into_cycles=int((p != n).sum()),
                           rise=float((out - elev).max())))
        return out

    flood.monotonic_enforce = enforce_probe
    saved = {s: getattr(composite, s) for s in STEPS}
    for s, fn in saved.items():
        setattr(composite, s, wrap(s, fn))
    params = GenerationParams(seed=a.seed, n_cells=a.cells,
                              skip_climate=not a.climate)
    engine = PlanetEngine(device=a.device)
    n_real.append(params.n_cells)
    t0 = time.perf_counter()
    try:
        res = engine.generate(params)
    finally:
        flood.monotonic_enforce = enforce
        for s, fn in saved.items():
            setattr(composite, s, fn)
    wall = time.perf_counter() - t0
    n = res.graph.n_cells
    for name, k, lo, hi in rows:
        print(f"{name} [{k}]: max {lo:.4f} -> {hi:.4f}", flush=True)
    rise = {}
    for name, _, lo, hi in rows:
        rise[name] = max(rise.get(name, float("-inf")), hi - lo)
    print("RESULT " + json.dumps(dict(
        cells=a.cells, seed=a.seed, device=str(res.elevation.device),
        wall_s=wall, calls=len(rows),
        pre_erosion_max=float(res.pre_post_elevation[:n].max()),
        final_max=float(res.elevation[:n].max()), largest_rise=rise,
        monotonic_enforce=cycles)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
