from .wind import compute_wind
from .ocean_currents import compute_ocean_currents
from .precipitation import compute_precipitation
from .temperature import compute_temperature
from .koppen import classify_koppen, KOPPEN_CODES, KOPPEN_COLORS

__all__ = [
    "compute_wind", "compute_ocean_currents", "compute_precipitation",
    "compute_temperature", "classify_koppen", "KOPPEN_CODES", "KOPPEN_COLORS",
]
