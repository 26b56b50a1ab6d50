"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by
their whole top-level name: the port's name begins with the JAX
package's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench.harness.main import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PORT = "planet_heightmap_generation_torch"


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _loaded_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return eval(out.stdout.strip().splitlines()[-1])


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        tops = set(_imported_tops(path))
        assert not tops & set(FORBIDDEN), path


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PORT not in set(_imported_tops(path)), path


def test_reference_loads_nothing_of_the_program():
    tops = _loaded_after("from portbench.reference import ReferenceEngine")
    assert PORT not in tops
    assert not set(tops) & set(FORBIDDEN)


def test_torch_reference_run_loads_nothing_of_the_program():
    """``torchjax`` and a whole reference run on it."""
    tops = _loaded_after(
        "from portbench.reference import backend, torchjax\n"
        "backend.use('torch', 'cpu')\n"
        "import numpy as np\n"
        "from portbench.reference import GenerationParams, ReferenceEngine\n"
        "with np.errstate(all='ignore'):\n"
        "    ReferenceEngine(GenerationParams(seed=3, n_cells=2000, "
        "n_plates=10, num_continents=2)).generate()\n"
        "assert backend.chosen() == ('torch', 'cpu')")
    assert "torch" in tops and PORT not in tops
    assert not set(tops) & set(FORBIDDEN)


def test_harness_and_program_load_no_jax():
    tops = _loaded_after(
        "import portbench.harness.main, portbench.harness.trace, "
        "portbench.harness.check, portbench.readings\n"
        "import planet_heightmap_generation_torch.pipeline.engine\n"
        "import planet_heightmap_generation_torch.ops.sweep_cuda\n"
        "import portbench.reference")
    assert PORT in tops
    assert not set(tops) & set(FORBIDDEN)


def test_forbidden_compares_whole_top_level_names():
    sys.modules.setdefault("jaxlike_probe", sys)
    try:
        assert "jaxlike_probe" not in forbidden_modules()
        assert PORT.startswith("planet_heightmap_generation_")
        assert not [m for m in forbidden_modules() if m.startswith(PORT)]
    finally:
        del sys.modules["jaxlike_probe"]
