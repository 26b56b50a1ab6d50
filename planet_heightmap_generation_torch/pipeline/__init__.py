from .engine import PlanetEngine, PlanetResult
from .protocol import WorkerProtocol

__all__ = ["PlanetEngine", "PlanetResult", "WorkerProtocol"]
