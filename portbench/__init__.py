"""The benchmark of the PyTorch/CUDA port (``planet_heightmap_generation_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, per-layer metric, kernel list
is a file of its own, found by its name: ``configs/``, ``traffic/``,
``metrics/``, ``kernels/``; ``limits.json`` holds the limits of the
numbers compared. ``harness/`` is the general runner, ``reference/`` the
plain reference (the JAX package's stage definitions, on NumPy on the
host or, where the configuration's ``"reference"`` says so, on plain
PyTorch on the card) that decides ``correct``.
"""
