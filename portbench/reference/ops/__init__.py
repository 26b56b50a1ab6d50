from .rng import ParkMiller, rand_int, pm_sequence, pm_hash01
from .noise import SimplexNoise, Tables, tables, noise3, fbm, ridged_fbm

__all__ = [
    "ParkMiller", "rand_int", "pm_sequence", "pm_hash01",
    "SimplexNoise", "Tables", "tables", "noise3", "fbm", "ridged_fbm",
]
