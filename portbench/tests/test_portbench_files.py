"""Every file BENCHMARK.json names is there and loads by its name, and
the benchmark keeps to the contract's shape."""

import dataclasses
import json
import re

import pytest

from portbench.harness import check, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_loads(entry):
    from planet_heightmap_generation_torch.config import GenerationParams

    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = spec.config(BENCH, entry["name"])
    assert entry["file"].startswith("portbench/configs/")
    assert cfg["reduced"] == entry["reduced"]
    assert len(cfg["source"]) <= 200 and len(entry["source"]) <= 200
    names = {f.name for f in dataclasses.fields(GenerationParams)}
    assert set(cfg) <= names | set(spec.META_KEYS)
    assert "seed" not in cfg
    GenerationParams(**dict({k: v for k, v in cfg.items() if k in names},
                            toggled_indices=tuple(cfg["toggled_indices"])))


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files_load(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert wl["chips"] == 1 and len(wl["why"]) <= 200
    mix = spec.traffic(wl["traffic"])
    assert mix["entry"] in ("generate", "reapply")
    spec.config(BENCH, wl["config"])
    assert set(spec.limits()) >= set(check.NUMBERS)
    e2e = {m["name"] for m in spec.end_to_end_metrics(BENCH, wl["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer_metrics(BENCH, wl["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    reader = spec.metric_reader(m["name"])
    assert reader.UNIT == m["unit"]
    assert callable(reader.read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for kernels in [getattr(reader, "KERNELS", None)] if hasattr(
            reader, "KERNELS") else []:
        listed = spec.kernels(kernels)
        import importlib

        mod = importlib.import_module(listed["module"])
        for fn in listed["functions"]:
            assert callable(getattr(mod, fn))


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + \
        [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024
