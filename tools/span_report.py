"""Where the host holds the card back inside a command: the program's span
records joined with a profiled pass, per cell of the benchmark.

    python3 tools/span_report.py [--root DIR] [--cells NAME ...]
        [--seed N] [--calls N] [--cost N] [--out FILE]

For each cell (default: every cell of ``BENCHMARK.json``), with the
program and the benchmark of the tree at ``--root`` (default: this
checkout), the set-up the benchmark makes (the set-up generate of a
reapply mix, the warm-up commands), then:

- a profiled pass of ``--calls`` commands through
  ``portbench/harness/trace.py`` ``traced`` that keeps every idle gap and
  the label the harness gives it (the innermost span holding the gap's
  midpoint): device idle by label per call; for each stage, the idle its
  own label and its sub-stage spans' labels hold; each per-layer metric
  of the cell beside the labelled idle it reads; device events per call
  and per depth-0 span;
- one command under CUDA sync debug mode: each sync's call site (the two
  innermost frames of the program) and the innermost span open at it;
- the spans' cost (trees with span records): the time to open and close
  one span, the spans per command, and the wall of ``--cost`` commands
  with the sub-stage spans on, in turns with ``--cost`` with them a
  no-op.

Prints the card's name and power limit and one ``SPANS {...}`` JSON line
a cell; ``--out`` appends the lines to a file. On a tree whose stages are
bare ``(name, ms)`` pairs it reports what those give. Exits 1 without
CUDA.
"""

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import time
import traceback
import warnings


def _setup(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    return root


def _parent(stages, s):
    """The name of the depth-0 span of ``stages`` holding ``s``."""
    for p in stages:
        if p.depth == 0 and p.start <= s.start and s.end <= p.end:
            return p[0]
    return None


def _has_spans(calls):
    return bool(calls) and all(getattr(s, "start", None) is not None
                               for c in calls for s in c["stages"])


def profiled(client, cmds, n_calls, bench, name, device):
    """The traced pass with every idle gap and its label kept."""
    from portbench.harness import main as hmain, spec, trace as tracing

    gaps, labels = [], []
    orig_gaps, orig_label = tracing.yardstick.idle_gaps, tracing._label

    def idle_gaps(spans, lo, hi):
        out = orig_gaps(spans, lo, hi)
        gaps.extend(out)
        return out

    def label(spans, t):
        out = orig_label(spans, t)
        labels.append(out)
        return out

    metrics = spec.per_layer_metrics(bench, name)
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in metrics}
    lists = sorted({r.KERNELS for r in readers.values()
                    if getattr(r, "KERNELS", None)})
    tracing.yardstick.idle_gaps, tracing._label = idle_gaps, label
    try:
        tr, results = tracing.traced(
            lambda cmd: hmain._attempt(client, cmd), cmds, n_calls, 1,
            {n: spec.kernels(n) for n in lists}, device)
    finally:
        tracing.yardstick.idle_gaps, tracing._label = orig_gaps, orig_label
    assert len(gaps) == len(labels)
    failed = sum(res is None for _, res in results)
    n = len(tr["calls"])
    by_label = {}
    for (a, b), lab in zip(gaps, labels):
        by_label[lab] = by_label.get(lab, 0.0) + (b - a) * 1e3 / n
    out = dict(calls=n, failed=failed,
               events_per_call=len(tr["events"]) / n,
               window_s=tr["window_s"], busy_s=tr["busy_s"],
               idle_by_label_ms=dict(sorted(by_label.items(),
                                            key=lambda kv: -kv[1])),
               metrics={k: r.read(tr) for k, r in readers.items()})
    if not _has_spans(tr["calls"]):
        return out, tr
    # each stage's family: its own label and its sub-stage spans' labels
    family, kernels = {}, {}
    for c in tr["calls"]:
        stages = c["stages"]
        for s in stages:
            top = s[0] if s.depth == 0 else _parent(stages, s)
            family.setdefault(top, set()).add(s[0])
            if s.depth == 0:
                k = sum(1 for _, a, _ in tr["events"]
                        if s.start <= a < s.end)
                kernels[s[0]] = kernels.get(s[0], 0) + k / n
    out["stages"] = {
        top: dict(labelled_ms=sum(by_label.get(x, 0.0) for x in names),
                  own_label_ms=by_label.get(top, 0.0),
                  sub_labels_ms={x: by_label[x] for x in sorted(names)
                                 if x != top and x in by_label},
                  device_events=kernels.get(top, 0.0))
        for top, names in family.items()}
    for st in out["stages"].values():
        st["sub_share"] = (1.0 - st["own_label_ms"] / st["labelled_ms"]
                           if st["labelled_ms"] > 0 else None)
    # each idle reader beside the idle labelled with its stages
    checks = {"elevation_idle_ms": lambda t: t == "Elevation",
              "post_idle_ms": lambda t: t == "Terrain post-processing",
              "climate_idle_ms": lambda t: t.startswith("Climate: ")}
    out["reader_vs_labelled"] = {}
    for m, v in out["metrics"].items():
        sel = checks.get(m.rsplit(".", 1)[0])
        if sel is None or v is None:
            continue
        lab = sum(st["labelled_ms"] for top, st in out["stages"].items()
                  if sel(top))
        out["reader_vs_labelled"][m] = dict(
            reader_ms=v, labelled_ms=lab,
            ratio=v / lab if lab else None)
    return out, tr


def sync_sites(client, cmd):
    """One command under CUDA sync debug mode: the syncs by (innermost open
    span, call site)."""
    import torch
    from planet_heightmap_generation_torch.pipeline.timing import StageTimer

    open_names, sites = [], {}
    orig = StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name, sync=None):
        open_names.append(name)
        try:
            with orig(self, name, sync):
                yield
        finally:
            open_names.pop()

    here = os.path.abspath(__file__)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "warnings" not in os.path.basename(f.filename)
                  and os.path.abspath(f.filename) != here]
        where = " < ".join(f"{os.path.basename(f.filename)}:{f.lineno} "
                           f"({f.name})" for f in reversed(frames[-2:]))
        key = (open_names[-1] if open_names else "outside stages", where)
        sites[key] = sites.get(key, 0) + 1

    StageTimer.stage = stage
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                client.call(cmd)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        StageTimer.stage = orig
    rows = sorted(([span, where, n] for (span, where), n in sites.items()),
                  key=lambda r: -r[2])
    flag = sum(n for _, where, n in rows
               if where.startswith("spmd.py") and "(flag_any)" in where)
    return dict(total=sum(r[2] for r in rows), flag_reads=flag,
                sites=rows)


def span_cost(client, cmds, n_cost):
    """The sub-stage spans' cost: one span's open and close, and the wall
    of commands with the spans on, in turns with them a no-op."""
    from planet_heightmap_generation_torch.pipeline import timing

    t = timing.StageTimer(sync_enabled=False)
    reps = 20000
    with timing.current(t):
        a = time.perf_counter()
        for _ in range(reps):
            with timing.span("x"):
                pass
        per_span_us = (time.perf_counter() - a) / reps * 1e6
    orig = timing.span
    mods = [m for m in list(sys.modules.values())
            if getattr(m, "__name__", "").startswith(
                "planet_heightmap_generation_torch")
            and getattr(m, "span", None) is orig]

    def off(name):
        return contextlib.nullcontext()

    walls = dict(on=[], off=[])
    spans_per_call = []
    for i in range(2 * n_cost):
        mode = "on" if i % 4 in (0, 3) else "off"
        for m in mods:
            m.span = orig if mode == "on" else off
        try:
            a = time.perf_counter()
            res = client.call(next(cmds))
            walls[mode].append((time.perf_counter() - a) * 1e3)
        finally:
            for m in mods:
                m.span = orig
        if mode == "on":
            spans_per_call.append(sum(1 for s in res.timing.stages
                                      if s.depth > 0))
    med = {k: statistics.median(v) for k, v in walls.items()}
    return dict(per_span_us=per_span_us,
                sub_spans_per_call=statistics.mean(spans_per_call),
                est_ms_per_call=per_span_us
                * statistics.mean(spans_per_call) / 1e3,
                wall_ms=walls, median_ms=med,
                median_on_minus_off_ms=med["on"] - med["off"])


def report(root, name, seed, n_calls, n_cost, device):
    from portbench.harness import main as hmain, spec, traffic

    bench = spec.load_benchmark()
    wl = spec.workload(bench, name)
    mix = spec.traffic(wl["traffic"])
    client = hmain.Client(mix, hmain.base_params(
        spec.config(bench, wl["config"])), device)
    t0 = time.perf_counter()
    if client.entry == "reapply":
        client.prime()
    cmds = traffic.commands(seed, mix)
    for cmd in traffic.warm(mix, cmds):
        client.call(cmd)
    gc.collect()
    setup_s = time.perf_counter() - t0
    out, tr = profiled(client, cmds, n_calls, bench, name, device)
    out.update(cell=name, root=root, seed=seed, setup_s=setup_s)
    out["syncs"] = sync_sites(client, next(cmds))
    if _has_spans(tr["calls"]) and n_cost:
        out["cost"] = span_cost(client, cmds, n_cost)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--cells", nargs="*")
    ap.add_argument("--seed", type=int, default=2_400_000_017)
    ap.add_argument("--calls", type=int, default=0,
                    help="profiled commands (default: the mix's "
                         "trace_calls)")
    ap.add_argument("--cost", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()
    root = _setup(args.root)
    import torch

    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 1
    from portbench.harness import spec, yardstick

    print(f"card: {yardstick.power_limit()}", flush=True)
    bench = spec.load_benchmark()
    cells = args.cells or [w["name"] for w in bench["workloads"]]
    device = torch.device("cuda", 0)
    for name in cells:
        mix = spec.traffic(spec.workload(bench, name)["traffic"])
        line = "SPANS " + json.dumps(report(
            root, name, args.seed, args.calls or int(mix["trace_calls"]),
            args.cost, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
