from .assemble import assign_elevation, ElevationResult

__all__ = ["assign_elevation", "ElevationResult"]
