"""The benchmark's plain reference: the JAX package's stage definitions
(mesh, tectonics, elevation, erosion, climate), transcribed to run on
an array library chosen once per process (``backend``): NumPy on the
host (``npjax``), the default, or plain PyTorch on a device
(``torchjax``), with no kernels: the plain loop of each sweep. The host
C++ of the mesh build and the coarse plate fill is a copy of the JAX
package's ``native/`` sources (``csrc/``), built into this package's own
``_build/``, and runs on the host either way.

It imports nothing of the program (``planet_heightmap_generation_torch``)
and nothing of JAX, and takes nothing the program made: the comparison
that decides a run's ``correct`` holds the program to these definitions,
whatever later changes make of the program.

``GenerationParams`` and ``ReferenceEngine`` load the stage modules on
first use, so that ``backend.use`` can come first.
"""

__all__ = ["GenerationParams", "ReferenceEngine"]


def __getattr__(name):
    if name == "GenerationParams":
        from .config import GenerationParams
        return GenerationParams
    if name == "ReferenceEngine":
        from .pipeline import ReferenceEngine
        return ReferenceEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
