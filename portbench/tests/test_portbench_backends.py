"""The reference's two backends: the configuration's ``"reference"`` key
chooses one, the choice holds for the process, PyTorch keeps NumPy's JAX
meanings (``npjax``), and the two agree at 2,000 cells on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import check, main, spec
from portbench.reference import npjax, torchjax

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 4242
CELLS = ("default-204k.new-planet", "default-204k.sculpt")


def _config(name):
    return spec.config(spec.load_benchmark(), name)


def test_a_configuration_without_reference_takes_numpy():
    assert check.reference_of({}) == "numpy"
    assert "reference" not in _config("default-204k")
    assert check.reference_of(_config("default-204k")) == "numpy"
    assert check.reference_of(_config("detail-1m")) == "torch-cuda"
    with pytest.raises(ValueError):
        check.reference_of({"reference": "jax"})


def test_base_params_takes_the_reference_key():
    base = main.base_params(_config("detail-1m"))
    assert "reference" not in base and base["n_cells"] == 999000
    assert base["skip_climate"] is None
    with pytest.raises(ValueError):
        main.base_params(dict(_config("detail-1m"), no_such_setting=1))


def _in_fresh_process(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_the_backend_is_numpy_unless_chosen_and_holds_once_loaded():
    out = _in_fresh_process(
        "from portbench.reference import backend\n"
        "from portbench.reference.ops import banded\n"
        "print(backend.chosen(), banded.jnp is __import__("
        "'portbench.reference.npjax', fromlist=['x']).jnp)\n"
        "try:\n    backend.use('torch', 'cpu')\nexcept RuntimeError:\n"
        "    print('refused')\n")
    assert out.splitlines() == ["('numpy', None) True", "refused"]


@pytest.mark.parametrize("wl", CELLS)
def test_the_torch_reference_agrees_with_the_numpy_one(wl, tiny_cfg):
    """The PyTorch reference's own answer, stage by stage against the
    NumPy reference: the mesh and the plates exact, every other number
    under its limit."""
    from portbench.readings import program_answer

    entry, base, key, _ = program_answer(wl, SEED, "cpu", tiny_cfg(wl))
    ans = check.reference_answers(entry, base, [key], "torch-cpu")
    nums = check.check(entry, base, ans, "numpy")
    lim = spec.limits()
    assert nums["mesh_rows_off"] == 0 and nums["plate_off_pct"] == 0
    assert check.judge(nums, lim), nums


def test_both_backends_judge_one_program_answer_alike(tiny_cfg):
    """One program answer, checked on each backend and twice on PyTorch:
    both pass, the exact numbers agree, and PyTorch's two checks read the
    same bits."""
    from portbench.readings import program_answer

    wl = CELLS[0]
    entry, base, key, prog = program_answer(wl, SEED, "cpu", tiny_cfg(wl))
    lim = spec.limits()
    by_np = check.check(entry, base, [(key, prog)], "numpy")
    by_torch = [check.check(entry, base, [(key, prog)], "torch-cpu")
                for _ in range(2)]
    assert check.judge(by_np, lim) and check.judge(by_torch[0], lim)
    for k in ("mesh_rows_off", "plate_off_pct"):
        assert by_np[k] == by_torch[0][k] == 0
    assert by_torch[0] == by_torch[1]


# ── torchjax keeps npjax's JAX meanings ───────────────────────────────


def _both(fn):
    """``fn(jnp)`` on each shim, as NumPy arrays."""
    return [np.asarray(fn(m.jnp)) for m in (npjax, torchjax)]


def _same(fn):
    a, b = _both(fn)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [
    # 32-bit results
    lambda jnp: jnp.arange(5) * 3,
    lambda jnp: jnp.arange(5) / 2,
    lambda jnp: jnp.asarray(np.arange(4, dtype=np.float64)),
    lambda jnp: jnp.sum(jnp.arange(5) > 2),
    # uint32 arithmetic wraps at 32 bits
    lambda jnp: (jnp.arange(4, dtype=jnp.uint32) + jnp.uint32(7))
    * jnp.uint32(2654435761) ^ (jnp.arange(4, dtype=jnp.uint32) >> 1),
    lambda jnp: (jnp.arange(3).astype(jnp.uint32) - jnp.uint32(1))
    % jnp.uint32(1 << 24),
    # a gather wraps negatives and clamps the rest
    lambda jnp: jnp.arange(5.0)[jnp.asarray([-1, 0, 7, 2])],
    # a scatter wraps negatives and drops what is out of range
    lambda jnp: jnp.zeros(4).at[jnp.asarray([-1, 1, 9, 1])].add(1.0),
    lambda jnp: jnp.full(4, 5).at[jnp.asarray([0, 0, 6])].min(
        jnp.asarray([3, 1, 0])),
    lambda jnp: jnp.zeros((3, 2)).at[jnp.asarray([2, 4])].max(
        jnp.asarray([[1.0, -1.0], [2.0, 2.0]])),
    lambda jnp: jnp.zeros(3, jnp.int32).at[1].set(4),
    # take_along_axis fills out-of-range reads
    lambda jnp: jnp.take_along_axis(jnp.arange(6.0).reshape(2, 3),
                                    jnp.asarray([[0, 5], [-1, 1]]), 1),
    # a stable argsort
    lambda jnp: jnp.argsort(jnp.asarray([2, 1, 2, 1, 0])),
    lambda jnp: jnp.where(jnp.arange(4) > 1, jnp.arange(4), 0.5),
    lambda jnp: jnp.choose(jnp.asarray([0, 2, 1, 5]),
                           np.array([10, 20, 30]), mode="clip"),
    lambda jnp: jnp.clip(jnp.arange(6), 1.5, 3),
])
def test_torchjax_keeps_npjax_meanings(case):
    _same(case)


def test_segment_ops_and_value_semantics():
    for m in (npjax, torchjax):
        ids = m.jnp.asarray([0, 2, 2, -1, 5])
        data = m.jnp.asarray([1.0, 2.0, 3.0, 4.0, 5.0])
        np.testing.assert_array_equal(
            np.asarray(m.jax.ops.segment_sum(data, ids, num_segments=3)),
            [1.0, 0.0, 5.0])
        np.testing.assert_array_equal(
            np.asarray(m.jax.ops.segment_max(data, ids, num_segments=3)),
            [1.0, -np.inf, 3.0])
        x = m.jnp.zeros(3)
        y = x.at[0].set(1.0)
        assert float(x[0]) == 0.0 and float(y[0]) == 1.0
        with pytest.raises(TypeError):
            x[0] = 2.0
