"""The benchmark's plain reference: the JAX package's stage definitions
(mesh, tectonics, elevation, erosion, climate), transcribed to run on
NumPy on the host (``npjax``), with no kernels: the plain loop of each
sweep. The host C++ of the mesh build and the coarse plate fill is a copy
of the JAX package's ``native/`` sources (``csrc/``), built into this
package's own ``_build/``.

It imports nothing of the program (``planet_heightmap_generation_torch``)
and nothing of JAX, and takes nothing the program made: the comparison
that decides a run's ``correct`` holds the program to these definitions,
whatever later changes make of the program.
"""

from .config import GenerationParams
from .pipeline import ReferenceEngine

__all__ = ["GenerationParams", "ReferenceEngine"]
