"""The elevation of both packages' terrain-only generate on the CPU, one
seed, one size, side by side:

    JAX_PLATFORMS=cpu python3 tools/compare_elevation_max.py \
        --cells 204000 --seed 42 --out DIR

Runs the JAX package's ``PlanetEngine(timing=True).generate`` (its staged
path) and the PyTorch port's ``PlanetEngine(device="cpu").generate`` of
``GenerationParams(seed=SEED, n_cells=CELLS, skip_climate=True)``, each in
a process of its own (wall seconds and peak resident memory per process),
saves each result's plate map, pre-erosion and final elevation to
``DIR/<package>_<cells>_<seed>.npz``, and prints one ``RESULT`` JSON line:
for each package and each of the two elevations the maximum, the 99.9th
and 99th percentiles, the land fraction and the counts over fixed bins
(``EDGES``); then the share of cells with the same plate, the largest
difference of each elevation and the share of cells differing by more
than 1e-3. The stages compare in pipeline order (plates, elevation
assembly, erosion), so the first that differs beyond the port's known
differences is the first to look at.
"""
import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = [-1e9, -1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0,
         1e9]

CHILD = r'''
import sys, time, resource
import numpy as np
sys.path.insert(0, ROOT)
t0 = time.perf_counter()
if PACKAGE == "jax":
    from planet_heightmap_generation_tpu.config import GenerationParams
    from planet_heightmap_generation_tpu.pipeline import PlanetEngine
    # the staged path (a stage a program): the fused program asks XLA:CPU
    # for one 64 GiB buffer at 204K
    engine = PlanetEngine(timing=True)
else:
    import torch
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine
    engine = PlanetEngine(device="cpu")
params = GenerationParams(seed=SEED, n_cells=CELLS, skip_climate=True)
res = engine.generate(params)
n = res.graph.n_cells
def host(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)[:n]
np.savez(OUT, r_plate=host(res.r_plate), pre=host(res.pre_post_elevation),
         elev=host(res.elevation))
print("CHILD", time.perf_counter() - t0,
      resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
'''


def stats(e) -> dict:
    e = np.asarray(e, np.float64)
    return dict(max=float(e.max()), p999=float(np.percentile(e, 99.9)),
                p99=float(np.percentile(e, 99)),
                land=float((e > 0).mean()),
                bins=np.histogram(e, EDGES)[0].tolist())


def run(package: str, cells: int, seed: int, out: str) -> dict:
    path = os.path.join(out, f"{package}_{cells}_{seed}.npz")
    code = (f"ROOT={ROOT!r}; PACKAGE={package!r}; SEED={seed}; "
            f"CELLS={cells}; OUT={path!r}\n" + CHILD)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{package} at {cells}:\n{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("CHILD")][-1]
    _, secs, gib = line.split()
    return dict(path=path, wall_s=float(secs), peak_gib=float(gib),
                process_s=time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=204_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    os.makedirs(a.out, exist_ok=True)
    runs = {p: run(p, a.cells, a.seed, a.out) for p in ("jax", "torch")}
    data = {p: np.load(r["path"]) for p, r in runs.items()}
    result = dict(cells=a.cells, seed=a.seed, edges=EDGES[1:-1])
    for p, r in runs.items():
        result[p] = dict(wall_s=r["wall_s"], peak_gib=r["peak_gib"],
                         pre=stats(data[p]["pre"]),
                         final=stats(data[p]["elev"]))
    j, t = data["jax"], data["torch"]
    result["same_plate"] = float((j["r_plate"] == t["r_plate"]).mean())
    for k in ("pre", "elev"):
        d = np.abs(j[k].astype(np.float64) - t[k])
        result[f"{k}_max_abs_diff"] = float(d.max())
        result[f"{k}_cells_over_1e-3"] = float((d > 1e-3).mean())
    print("RESULT " + json.dumps(result), flush=True)
    print("this process peak GiB",
          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
