from .assemble import assign_elevation, ElevationResult
