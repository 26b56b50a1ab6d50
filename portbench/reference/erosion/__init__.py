from .composite import erode_composite, run_post_processing
from .flood import priority_flood_carve
from .smooth import smooth_elevation, sharpen_ridges, apply_soil_creep
from .warp import warp_terrain

__all__ = [
    "erode_composite", "run_post_processing", "priority_flood_carve",
    "smooth_elevation", "sharpen_ridges", "apply_soil_creep", "warp_terrain",
]
