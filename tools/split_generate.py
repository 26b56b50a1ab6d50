"""Phase 11 of chip_smoke.py alone:

    python3 tools/split_generate.py [--cards N]

Builds the kernels, runs one default 204K generate (``GenerationParams(
seed=42)``, climate on) to warm the card, then ``split_generate_checks``:
the same generate under ``PlanetEngine(mesh=cells_mesh(4, devices))``,
cold then warm, against a single-device generate (the 2e-3 elevation
gate, no NaN, the plate count, the climate gates; each output's largest
difference and bit equality; the warm split's kernel launches,
exchanges, collectives, gathered calls and bytes, peak device memory),
then a reapply on both engines. With ``--cards N`` (N = 4) the windows
take ``cuda:0`` .. ``cuda:3``; by default all four are ``cuda:0``. Prints
each card's name and power limit and one ``RESULT`` JSON line. Exits 1
without CUDA or with fewer than N cards.
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
        print(f"split_generate: needs {cards} CUDA devices", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from planet_heightmap_generation_torch.config import GenerationParams
    from planet_heightmap_generation_torch.ops import sweep_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    sweep_cuda.build()
    dev = torch.device("cuda", 0)
    params = GenerationParams(seed=cs.SEED)
    _, cold = cs.run_generate(dev, params)
    print(f"default generate (single, cold): {cold:.3f} s", flush=True)
    devices = [torch.device("cuda", i % cards)
               for i in range(cs.SPLIT_SHARDS)]
    rec = cs.split_generate_checks(dev, params, devices)
    print("RESULT " + json.dumps(dict(card=smi, record=rec,
                                      seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
