from .batch import generate_batch, sweep_heightmaps

__all__ = ["generate_batch", "sweep_heightmaps"]
