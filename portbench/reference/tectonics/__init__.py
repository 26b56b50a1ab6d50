from .plates import PlateSet, generate_plates, smooth_and_reconnect_host
from .ocean_land import assign_ocean_land
from .super_plates import SuperPlates, build_super_plates
from .coarse import CoarsePlates, generate_coarse_plates, project_coarse_plates

__all__ = [
    "PlateSet", "generate_plates", "smooth_and_reconnect_host",
    "assign_ocean_land", "SuperPlates", "build_super_plates",
    "CoarsePlates", "generate_coarse_plates", "project_coarse_plates",
]
