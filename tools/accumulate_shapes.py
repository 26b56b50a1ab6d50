"""Device time of one accumulate launch (ops/sweep_cuda.py) at synthetic
row-length shapes on the 204K mesh, to tell its fixed cost per round from
the cost of its rows:

    python3 tools/accumulate_shapes.py

One-round sums (``ordered_sum``) over 204,800 entries: the wind stage's
2592 geo bins (F=3 and F=1, in cell order and shuffled), rows of one
entry, every entry skipped (the round's fixed cost), rows of ~10 over
20,000 targets (interleaved and consecutive), rows of ~80 (consecutive
and interleaved sources), one entry per target; and two loops over a
forest (float32 and int32 counts). Prints the mean device µs per launch
over ten launches (``torch.profiler``). Needs one CUDA device.
"""
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from planet_heightmap_generation_torch.mesh.build import build_sphere  # noqa: E402
from planet_heightmap_generation_torch.mesh.device import to_device  # noqa: E402
from planet_heightmap_generation_torch.ops import sweep_cuda as sc  # noqa: E402
from planet_heightmap_generation_torch.ops.rng import ParkMiller  # noqa: E402


def device_us(fn) -> float:
    events = cs.device_events(lambda: [fn() for _ in range(10)])
    t = [e.time_range.elapsed_us() for e in events
         if cs.KERNEL_FNS["accumulate"] in e.name]
    return sum(t) / max(1, len(t))


def main() -> int:
    if not torch.cuda.is_available():
        print("accumulate_shapes: no CUDA device", file=sys.stderr)
        return 1
    sc.build()
    dev = torch.device("cuda")
    g = to_device(build_sphere(204000, 0.75, rng=ParkMiller(42)), dev)
    npad = g.n_padded
    p = g.pos
    lat = torch.asin(torch.clamp(p[:, 1], -1.0, 1.0))
    lon = torch.atan2(p[:, 0], p[:, 2])
    bi = torch.clamp(((lat + math.pi / 2) / math.pi * 36).long(), 0, 35)
    bj = torch.clamp(((lon + math.pi) / (2 * math.pi) * 72).long(), 0, 71)
    nb = 2592
    bins = torch.where(g.valid, bi * 72 + bj, nb)
    rng = np.random.default_rng(0)
    v3 = torch.as_tensor(rng.random((npad, 3)).astype(np.float32),
                         device=dev)
    v1 = v3[:, 0].contiguous()
    i = torch.arange(npad, device=dev)
    shuffle = torch.as_tensor(rng.permutation(npad), device=dev)
    sums = [
        ("geo bins, F=3", nb, bins, v3), ("geo bins, F=1", nb, bins, v1),
        ("geo bins shuffled, F=3", nb, bins[shuffle], v3),
        ("2592 rows of one entry, F=3", nb, torch.where(i < nb, i, nb), v3),
        ("every entry skipped, F=3", nb, torch.full_like(i, nb), v3),
        ("every entry skipped, 204800 targets", npad,
         torch.full_like(i, npad), v1),
        ("rows of ~10, 20000 targets, interleaved", 20000, i % 20000, v1),
        ("rows of 10, 20480 targets, consecutive", 20480, i // 10, v1),
        ("rows of 80, consecutive sources, F=3", nb,
         torch.clamp(i // 80, max=nb), v3),
        ("rows of 80, interleaved sources, F=3", nb, i % 2560, v3),
        ("204800 rows of one entry", npad, i, v1)]
    for label, n_out, idx, v in sums:
        us = device_us(lambda: sc.ordered_sum(n_out, idx, v))
        print(f"{label:45s} {us:8.2f} us", flush=True)
    ip = i.cpu().numpy()
    forest = np.where(rng.random(npad) < 0.25, npad,
                      np.maximum(ip - rng.integers(1, 64, npad), 0))
    forest[0] = npad
    ptr = torch.as_tensor(forest, device=dev)
    for label, s in (("forest loop, float32", v1),
                     ("forest loop, int32 counts", (v1 > 0.3).int())):
        us = device_us(lambda: sc.accumulate_relax(s, ptr, 20))
        rounds = int(sc.accumulate_relax(s, ptr, 20)[1])
        print(f"{label:45s} {us:8.2f} us ({rounds} rounds)", flush=True)
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
