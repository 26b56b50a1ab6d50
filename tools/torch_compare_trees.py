"""The PyTorch port's default generate in several checkouts of this repo
on one card, each in a process of its own, in the order given:

    python3 tools/torch_compare_trees.py [--cells N] PARENT CHANGE CHANGE PARENT

For each tree: build its kernels, run the default 204K generate
(``GenerationParams(seed=42)``, climate on; with ``--cells N``,
``GenerationParams(seed=42, n_cells=N)``, climate by the 300K rule) cold,
then three warm runs (wall seconds, the kernel launches and the stage
table of the last; with ``PLANET_TIMING=1`` in the environment an engine
that has the timing mode syncs after every stage, as engines without it
always do), then one warm run of
the default and one of the terrain-only generate under ``torch.profiler``
(device busy ms and the number of device events), and one more default
run traced for the device time and calls of the scatter-add kernels
(``index_add``, an atomic add), the sorts, the one-sweep BFS, the
ordered-sum kernel and the accumulate and components launches, and one
more default run under CUDA sync debug mode, whose warnings count the
generate's host syncs. Prints one ``RESULT`` JSON line per tree. Give the trees in turns, so that host drift falls on
both sides. Needs one CUDA device; uses each tree's ``chip_smoke.py``.
"""
import subprocess
import sys

# run in a fresh interpreter per tree, TREE set first
CODE = r'''
import sys, json
sys.path.insert(0, TREE)
import torch
import chip_smoke as cs
from planet_heightmap_generation_torch.config import GenerationParams
from planet_heightmap_generation_torch.ops import sweep_cuda
sweep_cuda.build()
sweep_cuda._kernel(next(iter(sweep_cuda._ARGTYPES)))
dev = torch.device("cuda")
p = GenerationParams(seed=42, **KW)
cs.run_generate(dev, p)
walls = []
for _ in range(3):
    sweep_cuda.reset_launches()
    res, w = cs.run_generate(dev, p)
    walls.append(w)
launches = dict(sweep_cuda.LAUNCHES)
stages = res.timing.stages
del res
prof = cs.profile_generate(dev, p)
pt = cs.profile_generate(dev, p.replace(skip_climate=True))
kinds = {"index_add": ("indexFuncLargeIndex", "indexFuncSmallIndex"),
         "sort": ("Sort", "sort"), "ordered_sum": ("ordered_sum_kernel",),
         "bfs_sweep": ("bfs_sweep_kernel",),
         "accumulate": ("accumulate_relax",),
         "components": ("components_relax_kernel",)}
by_kind = {k: [0.0, 0] for k in kinds}
for e in cs.device_events(lambda: cs.run_generate(dev, p)):
    for k, names in kinds.items():
        if any(n in e.name for n in names):
            by_kind[k][0] += e.time_range.elapsed_us() / 1e3
            by_kind[k][1] += 1
import warnings
torch.cuda.synchronize()
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    cs.run_generate(dev, p)
    torch.cuda.set_sync_debug_mode("default")
syncs = sum("synchroniz" in str(w.message) for w in caught)
print("RESULT " + json.dumps(dict(
    tree=TREE, walls=walls, launches=launches, stages=stages,
    busy_ms=prof["busy_ms"],
    events=prof["n_events"], terrain_busy_ms=pt["busy_ms"],
    terrain_events=pt["n_events"], device_ms_calls=by_kind,
    host_syncs=syncs)))
'''


def main(args) -> int:
    kw = {}
    if args[:1] == ["--cells"]:
        kw, args = dict(n_cells=int(args[1])), args[2:]
    for tree in args:
        r = subprocess.run([sys.executable, "-c",
                            f"TREE = {tree!r}\nKW = {kw!r}\n" + CODE],
                           capture_output=True, text=True, timeout=900)
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        if r.returncode or not line:
            print(r.stdout[-3000:], r.stderr[-3000:])
            return 1
        print(line[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
