"""A run end to end on the CPU at 2,000 cells (the harness's look for a
card skipped), its result line, and ``correct`` coming out false for the
lower-precision control and for each fault a cell can have."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import check, main, spec

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 4242
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]
CELLS = ("default-204k.new-planet", "default-204k.sculpt")
# the reference's two backends (PyTorch on the CPU for the card)
REFS = ("numpy", "torch-cpu")


def _run(wl, cfg, engine=None, trace=False):
    return main.run_cell(wl, SEED, 2.0, trace, "cpu", time.perf_counter(),
                         cfg=cfg, engine=engine)


@pytest.mark.parametrize("wl", CELLS)
def test_a_sound_run_is_correct(wl, tiny_cfg):
    res = _run(wl, tiny_cfg(wl))
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    bench = spec.load_benchmark()
    want = {m["name"] for m in spec.end_to_end_metrics(bench, wl)}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(res["compared"]) == set(check.NUMBERS)
    for v in res["compared"].values():
        assert v["value"] <= v["limit"]
    json.dumps(res, allow_nan=False)


def _engine():
    from planet_heightmap_generation_torch.pipeline.engine import PlanetEngine

    return PlanetEngine(device="cpu", timing=False)


class _Unchanged:
    """A step that returns its state unchanged: every command answers with
    the set-up's first answer."""

    def __init__(self, kind):
        self.kind, self.first = kind, None

    def wrap(self, eng):
        orig = getattr(eng, self.kind)

        def step(*a, **kw):
            res = orig(*a, **kw)
            if self.first is None:
                self.first = res
            return self.first

        setattr(eng, self.kind, step)
        if self.kind == "reapply":      # unchanged from the generate
            gen = eng.generate

            def generate(*a, **kw):
                self.first = gen(*a, **kw)
                return self.first

            eng.generate = generate
        return eng


def _altered(eng, kind):
    """An answer altered where it is produced: its elevation off by 1 %."""
    orig = getattr(eng, kind)

    def step(*a, **kw):
        res = orig(*a, **kw)
        res.elevation = res.elevation * 1.01
        return res

    setattr(eng, kind, step)
    return eng


def _cfg(tiny_cfg, wl, ref):
    return dict(tiny_cfg(wl), reference=ref)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("wl,kind", [("default-204k.new-planet", "generate"),
                                     ("default-204k.sculpt", "reapply")])
def test_a_step_that_returns_its_state_unchanged_is_not_correct(
        wl, kind, ref, tiny_cfg):
    res = _run(wl, _cfg(tiny_cfg, wl, ref),
               engine=_Unchanged(kind).wrap(_engine()))
    assert res["correct"] is False


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("wl,kind", [("default-204k.new-planet", "generate"),
                                     ("default-204k.sculpt", "reapply")])
def test_an_answer_altered_where_produced_is_not_correct(wl, kind, ref,
                                                         tiny_cfg):
    res = _run(wl, _cfg(tiny_cfg, wl, ref),
               engine=_altered(_engine(), kind))
    assert res["correct"] is False


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("wl", CELLS)
def test_the_lower_precision_control_is_not_correct(wl, ref, tiny_cfg):
    from portbench.readings import program_answer

    entry, base, key, prog = program_answer(wl, SEED, "cpu", tiny_cfg(wl))
    lim = spec.limits()
    assert check.judge(check.check(entry, base, [(key, prog)], ref), lim)
    ctl = check.control_answers(entry, base, [key], ref)
    assert not check.judge(check.check(entry, base, ctl, ref), lim)


def test_a_failed_command_makes_the_run_not_correct(tiny_cfg):
    wl = "default-204k.new-planet"
    eng = _engine()
    orig, calls = eng.generate, []

    def generate(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted failure")
        return orig(*a, **kw)

    eng.generate = generate
    res = main.run_cell(wl, SEED, 4.0, False, "cpu", time.perf_counter(),
                        cfg=tiny_cfg(wl), engine=eng)
    assert res["failed"] >= 1 and res["correct"] is False


def test_no_card_fails_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = main.main(["--workload", CELLS[0], "--seed", str(SEED),
                    "--seconds", "1", "--trace", "0"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.chip
@pytest.mark.parametrize("wl", CELLS + ("detail-1m.new-planet",))
def test_the_control_fails_on_the_card(wl, cuda_device):
    """The program passes and the control fails at the cell's own size on
    three seeds, both on the cell's reference (many minutes)."""
    from portbench.readings import program_answer

    bench = spec.load_benchmark()
    ref = check.reference_of(spec.config(bench,
                                         spec.workload(bench, wl)["config"]))
    lim = spec.limits()
    for seed in (SEED, SEED + 1, SEED + 2):
        entry, base, key, prog = program_answer(wl, seed, cuda_device)
        assert check.judge(check.check(entry, base, [(key, prog)], ref), lim)
        ctl = check.control_answers(entry, base, [key], ref)
        assert not check.judge(check.check(entry, base, ctl, ref), lim)
