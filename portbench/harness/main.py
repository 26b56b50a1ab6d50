"""One run of one cell: set-up, the measured window (or, with ``--trace
1``, the traced pass), the comparison with the reference, and the result
line."""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time
import traceback

from . import check, spec, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "planet_heightmap_generation_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def p90(values) -> float:
    """The nearest-rank 90th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


class Reservoir:
    """A sample of ``k`` items of a stream, drawn from ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = int(k), rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


def base_params(cfg: dict) -> dict:
    """The ``GenerationParams`` fields of a configuration file."""
    from planet_heightmap_generation_torch.config import GenerationParams

    names = {f.name for f in dataclasses.fields(GenerationParams)}
    unknown = set(cfg) - names - set(spec.META_KEYS)
    if unknown:
        raise ValueError(f"configuration keys of no planet setting: "
                         f"{sorted(unknown)}")
    out = {k: v for k, v in cfg.items() if k in names}
    out["toggled_indices"] = tuple(out.get("toggled_indices", ()))
    return out


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Client:
    """The program under test and the cell's entry: ``call(cmd)`` runs
    one command and returns its ``PlanetResult`` after a device sync."""

    def __init__(self, mix: dict, base: dict, device, engine=None):
        from planet_heightmap_generation_torch.config import (
            AUTO_CLIMATE_THRESHOLD, GenerationParams)
        from planet_heightmap_generation_torch.pipeline.engine import (
            PlanetEngine)

        self.GenerationParams = GenerationParams
        self.entry = mix["entry"]
        if self.entry not in ("generate", "reapply"):
            raise ValueError(f"traffic entry {self.entry!r} is not driven")
        self.base, self.device = dict(base), device
        sc = self.base.get("skip_climate")
        self.skip_climate = (self.base["n_cells"] > AUTO_CLIMATE_THRESHOLD
                             if sc is None else bool(sc))
        self.engine = engine or PlanetEngine(device=device, timing=False)
        self.sliders: dict = {}

    def prime(self) -> None:
        """The set-up generate of a ``reapply`` mix: the configuration's
        planet."""
        self.engine.generate(self.GenerationParams(**self.base))
        _sync(self.device)

    def call(self, cmd: dict):
        if self.entry == "generate":
            res = self.engine.generate(
                self.GenerationParams(**dict(self.base, **cmd)))
        else:
            self.sliders.update(cmd)
            res = self.engine.reapply(sculpt=cmd,
                                      skip_climate=self.skip_climate)
        _sync(self.device)
        return res

    def sample_key(self, cmd: dict) -> dict:
        """What the reference needs to recompute this answer: the fields
        a generate set, or every slider set since the set-up generate."""
        return dict(cmd) if self.entry == "generate" else dict(self.sliders)


def _attempt(client, cmd):
    """(key, result or None): one command; a raised error or a degraded
    result counts as failed."""
    try:
        res = client.call(cmd)
    except Exception:  # noqa: BLE001 — a failed command is counted
        traceback.print_exc(file=sys.stderr)
        return client.sample_key(cmd), None
    key = client.sample_key(cmd)
    if res.error is not None:
        print(f"command failed: {res.error.get('message')}", file=sys.stderr)
        return key, None
    return key, res


def window(client, cmds, seconds: float, sample: Reservoir):
    """The measured window: commands back to back until ``seconds`` have
    passed; the window ends at the last command's sync. Returns
    (latencies s, failed, window s, completed)."""
    lat, failed = [], 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        cmd = next(cmds)
        a = time.perf_counter()
        key, res = _attempt(client, cmd)
        b = time.perf_counter()
        if res is None:
            failed += 1
            lat.append(math.inf)
        else:
            lat.append(b - a)
            sample.offer((key, res))
        if b >= deadline:
            return lat, failed, b - t0, len(lat) - failed


def end_to_end(names, lat, wall: float, completed: int, setup_s: float):
    """The cell's end-to-end metrics from the window."""
    values = dict(setup_s=setup_s)
    if "generate_s" in names:
        values["generate_s"] = wall / completed if completed else math.inf
    if "command_p90_ms" in names:
        values["command_p90_ms"] = p90(lat) * 1e3
    return values


def device_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":      # the CPU tests only
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def judge(client, samples, base: dict, device, reference: str = "numpy"):
    """(numbers, limits): the sampled answers against the configuration's
    reference, run after the program's state is freed and the card's
    cache emptied."""
    import torch

    limits = spec.limits()
    if not samples:                   # no answer came: nothing is correct
        return {k: None for k in check.NUMBERS}, limits
    prog = [(key, check.result_products(res)) for key, res in samples]
    samples.clear()
    client.engine = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return check.check(client.entry, base, prog, reference), limits


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench=None, cfg=None, engine=None):
    """One run of the cell: the result object of the last line, and the
    numbers compared with their limits. ``cfg`` and ``engine`` stand in
    for the configuration file and the program's engine (the tests)."""
    bench = bench or spec.load_benchmark()
    wl = spec.workload(bench, workload_name)
    cfg = cfg if cfg is not None else spec.config(bench, wl["config"])
    mix = spec.traffic(wl["traffic"])
    base = base_params(cfg)
    reference = check.reference_of(cfg)
    client = Client(mix, base, device, engine)

    # set-up: the set-up generate of a reapply mix and the warm-up
    # commands at the cell's own size, the first of the run's stream:
    # every code path of the mix runs once (CUDA loads a kernel on its
    # first launch)
    if client.entry == "reapply":
        client.prime()
    cmds = traffic.commands(seed, mix)
    for cmd in traffic.warm(mix, cmds):
        _, res = _attempt(client, cmd)
        if res is None:
            raise RuntimeError("a warm-up command failed")
    # the set-up's objects out of the collector's way: a collection in the
    # window then walks only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    sample = Reservoir(int(mix["check_calls"]),
                       traffic.rng(seed, traffic.CHECK))
    result = dict(correct=False, attempted=0, failed=0, metrics={})
    if trace:
        from . import trace as tracing

        readers = {m["name"]: spec.metric_reader(m["name"])
                   for m in spec.per_layer_metrics(bench, workload_name)}
        lists = sorted({r.KERNELS for r in readers.values()
                        if getattr(r, "KERNELS", None)})
        tr, results = tracing.traced(
            lambda cmd: _attempt(client, cmd), cmds, int(mix["trace_calls"]),
            int(mix["sync_calls"]), {n: spec.kernels(n) for n in lists},
            device)
        for key, res in results:
            if res is not None:
                sample.offer((key, res))
        result["attempted"] = len(results)
        result["failed"] = sum(res is None for _, res in results)
        for m in spec.per_layer_metrics(bench, workload_name):
            v = readers[m["name"]].read(tr)
            if v is not None:
                result["metrics"][m["name"]] = dict(value=v, unit=m["unit"])
        result["device"] = device_info(device)
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = dict(
            device_ops=[[n[:160], s] for n, s in tr["device_ops"]],
            idle_gaps=[[n, s] for n, s in tr["idle_gaps"]])
    else:
        names = [m["name"] for m in spec.end_to_end_metrics(bench,
                                                             workload_name)]
        lat, failed, wall, completed = window(client, cmds, seconds, sample)
        print(f"window: {wall:.3f} s, {len(lat)} commands, latencies s "
              f"{[round(x, 4) for x in lat]}", file=sys.stderr)
        values = end_to_end(names, lat, wall, completed, setup_s)
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        result.update(attempted=len(lat), failed=failed)
        for name in names:
            v = values[name]
            result["metrics"][name] = dict(
                value=v if math.isfinite(v) else None, unit=units[name])
        result["device"] = device_info(device)
    t_ref = time.perf_counter()
    numbers, limits = judge(client, sample.items, base, device, reference)
    print(f"setup {setup_s:.3f} s; reference check "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    result["correct"] = result["failed"] == 0 and check.judge(numbers,
                                                              limits)
    result["compared"] = {k: dict(value=numbers[k], limit=limits[k])
                          for k in check.NUMBERS}
    return result


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch

    bench = spec.load_benchmark()
    wl = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_start,
                      bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    from . import yardstick

    print(f"card: {yardstick.power_limit()}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
