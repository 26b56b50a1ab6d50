"""Phase 10 of chip_smoke.py alone:

    python3 tools/split_phase.py [--cards N]

Builds the kernels, records the loops of one default 204K generate
(``GenerationParams(seed=42)``, climate on) through ``LOOP_SITES``, then
runs ``split_step_checks`` (the terrain step whole and split over
``make_planet_mesh(8, seed_parallel=2)`` and ``cells_mesh(4)``, bit for
bit) and ``split_loop_checks`` (each of the eight
kernel loops split over four windows against its one launch, bit for
bit). With ``--cards N`` the meshes and windows take the devices
``cuda:0`` .. ``cuda:N-1`` in turn (distinct cards: the exchange's copies
go between cards, each kernel launches on its window's card); by default
all on ``cuda:0``. Prints each card's name and power limit and one
``RESULT`` JSON line. Exits 1 without CUDA or with fewer than N cards.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=1)
    cards = ap.parse_args().cards
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"split_phase: needs {cards} CUDA devices", file=sys.stderr)
        return 1
    devices = [f"cuda:{i}" for i in range(cards)]
    import chip_smoke as cs
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.mesh.build import build_sphere
    from planet_heightmap_generation_torch.mesh.device import to_device
    from planet_heightmap_generation_torch.ops import sweep_cuda
    from planet_heightmap_generation_torch.ops.rng import ParkMiller

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    sweep_cuda.build()
    dev = torch.device("cuda")
    g = to_device(build_sphere(cs.N_CELLS, 0.75, rng=ParkMiller(cs.SEED)),
                  dev)
    params = GenerationParams(seed=cs.SEED)
    cs.run_generate(dev, params)
    (_, wall), calls = cs.record_calls(lambda: cs.run_generate(dev, params),
                                       cs.LOOP_SITES)
    print(f"default generate, loops recorded: {wall:.3f} s", flush=True)
    step = cs.split_step_checks(g, devices)
    rows = cs.split_loop_checks(calls, devices)
    print("RESULT " + json.dumps(dict(card=smi, devices=devices, step=step,
                                      loops=rows,
                                      seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
