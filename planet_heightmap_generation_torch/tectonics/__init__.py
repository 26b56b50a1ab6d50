from .plates import PlateSet, generate_plates
from .ocean_land import assign_ocean_land
from .super_plates import SuperPlates, build_super_plates
from .coarse import CoarsePlates, generate_coarse_plates
