"""The general generator of the traffic mixes (``traffic/<name>.json``).

A mix is a closed loop with one client: each command is sent when the
one before it has completed. A mix file names its ``entry`` (the
``PlanetEngine`` command: ``generate`` or ``reapply``) and the fields a
command sets (``set``). A field is a range ``min``, ``step``, ``count``:
its positions are ``min + step * k``, k < count. Each command draws
every field uniformly over its positions; a field marked ``distinct``
never takes a value twice in a run.

A run's commands are one stream drawn from its ``--seed``: the set-up
sends the first ``warm_calls`` of them (after, with ``warm_extremes``,
one command with every field at its last position and one at its
first), and the window the rest.
"""

from __future__ import annotations

import numpy as np

# one stream per use of the seed
COMMANDS, CHECK = 0, 1


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])


def draw_at(spec: dict, k: int):
    """The value of a range at position ``k``; whole-number ranges give
    ints."""
    v = spec["min"] + spec["step"] * k
    if isinstance(spec["min"], int) and isinstance(spec["step"], int):
        return int(v)
    return round(float(v), 10)


def extremes(mix: dict) -> list:
    """The commands with every field at its last position, then at its
    first."""
    return [{k: draw_at(s, int(s["count"]) - 1) for k, s in mix["set"].items()},
            {k: draw_at(s, 0) for k, s in mix["set"].items()}]


def commands(seed: int, mix: dict):
    """The endless command stream of ``mix`` for ``seed``."""
    r = rng(seed, COMMANDS)
    used = {k: set() for k, s in mix["set"].items() if s.get("distinct")}
    while True:
        cmd = {}
        for k, s in mix["set"].items():
            pos = int(r.integers(0, int(s["count"])))
            while k in used and pos in used[k]:
                pos = int(r.integers(0, int(s["count"])))
            if k in used:
                used[k].add(pos)
            cmd[k] = draw_at(s, pos)
        yield cmd


def warm(mix: dict, cmds) -> list:
    """The set-up's warm-up commands, the first ``warm_calls`` taken from
    the run's stream ``cmds``."""
    out = extremes(mix) if mix.get("warm_extremes") else []
    return out + [next(cmds) for _ in range(int(mix["warm_calls"]))]
