"""Multi-device scaling: the cells × seed split (sharding.py, windows.py,
loops.py), the split generate's runtime (spmd.py) and seed batches
(batch.py). The public names load on first use, so ``from ..parallel
import spmd`` in the stage modules pulls in nothing of the stages."""

_NAMES = {
    "make_planet_mesh": "sharding", "cells_mesh": "sharding",
    "shard_cells": "sharding", "replicate": "sharding",
    "batched_terrain_step": "sharding", "terrain_step": "sharding",
    "generate_batch": "batch", "sweep_heightmaps": "batch",
}

__all__ = list(_NAMES)


def __getattr__(name):
    mod = _NAMES.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
