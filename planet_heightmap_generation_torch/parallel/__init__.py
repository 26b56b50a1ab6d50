from .sharding import (make_planet_mesh, cells_mesh, shard_cells, replicate,
                       batched_terrain_step, terrain_step)
from .batch import generate_batch, sweep_heightmaps

__all__ = ["make_planet_mesh", "cells_mesh", "shard_cells", "replicate",
           "batched_terrain_step", "terrain_step",
           "generate_batch", "sweep_heightmaps"]
