"""The files of a cell, found by the names in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"

# the configuration keys that describe the file, not the planet; the
# "reference" one names where the check's reference runs
# (``check.REFERENCES``; NumPy where absent)
META_KEYS = ("source", "reduced", "assumed", "deployment", "precision",
             "guarantees", "reference")


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries, name: str, kind: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {kind} named {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    """The configuration file of ``name``: the planet's settings (the
    ``GenerationParams`` fields) and the keys of ``META_KEYS``."""
    entry = _named(bench["configs"], name, "config")
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def kernels(name: str) -> dict:
    with open(BENCH_DIR / "kernels" / f"{name}.json") as f:
        return json.load(f)


def limits() -> dict:
    """The limit of each number compared with the reference
    (``limits.json``)."""
    with open(BENCH_DIR / "limits.json") as f:
        return json.load(f)["limits"]


def metric_reader(name: str):
    """The reader module of the per-layer metric ``name``:
    ``metrics/<name>.py``, or for a quantity split by the end-to-end
    metric it moves (``<quantity>.<suffix>``) ``metrics/<quantity>.py``.
    ``read(trace)`` returns the value or None."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_metrics(bench: dict, workload_name: str) -> list:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if workload_name in m.get("workloads", [workload_name])]


def per_layer_metrics(bench: dict, workload_name: str) -> list:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list that move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(bench, workload_name)}
    return [m for m in bench["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
