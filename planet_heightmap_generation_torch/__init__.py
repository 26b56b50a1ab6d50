"""PyTorch/CUDA port of the planet heightmap generator.

``PlanetEngine`` runs here on an NVIDIA GPU: ``generate`` and the
retained-state commands (``reapply``, ``edit_recompute``,
``compute_climate``, ``import_heightmap``, sessions), with
``WorkerProtocol`` as their message surface. The host prologue (mesh,
coarse tectonics, domes, noise tables) is numpy and native C++, the
per-cell pipeline torch, and the banded sweep loops and ordered sums
hand-written CUDA kernels (ops/sweep_cuda.py, csrc/sweeps.cu).
"""

__version__ = "0.1.0"

from .config import GenerationParams, detail_from_slider, slider_from_detail
from .pipeline import PlanetEngine, PlanetResult, WorkerProtocol

__all__ = ["GenerationParams", "PlanetEngine", "PlanetResult",
           "WorkerProtocol", "detail_from_slider", "slider_from_detail"]
