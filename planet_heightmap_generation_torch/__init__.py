"""PyTorch/CUDA port of the planet heightmap generator.

The terrain path of ``PlanetEngine.generate`` runs here on an NVIDIA GPU:
host prologue (mesh, coarse tectonics, domes, noise tables) in numpy and
native C++, the per-cell pipeline in torch, and the banded sweep loops in
hand-written CUDA kernels (ops/sweep_cuda.py, csrc/sweeps.cu).
"""

from .config import GenerationParams, detail_from_slider, slider_from_detail

__all__ = ["GenerationParams", "detail_from_slider", "slider_from_detail"]
