"""Generation parameters — the typed equivalent of the reference's slider DOM.

The reference stores its config in 16 HTML sliders read by
``readSliders()`` (reference ``js/generate.js:18-50``) and quantizes them via
the ``SLIDERS`` table in ``js/planet-code.js:5-22``. Here the same surface is
a frozen dataclass; quantization lives in :mod:`..api.planet_code`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Detail slider mapping — power curve p=5 over 5_000..2_560_000 cells,
# 1000-step slider (reference js/detail-scale.js:7-14).
_DETAIL_MIN = 5_000
_DETAIL_MAX = 2_560_000
_DETAIL_STEPS = 1000
_DETAIL_POW = 5.0


def detail_from_slider(t: float) -> int:
    """Map slider position [0,1] to a cell count (js/detail-scale.js:7-10)."""
    n = _DETAIL_MIN + (_DETAIL_MAX - _DETAIL_MIN) * (t ** _DETAIL_POW)
    return int(round(n / 1000.0) * 1000)


def slider_from_detail(n: int) -> float:
    """Inverse mapping (js/detail-scale.js:12-14)."""
    t = ((n - _DETAIL_MIN) / (_DETAIL_MAX - _DETAIL_MIN)) ** (1.0 / _DETAIL_POW)
    return min(1.0, max(0.0, t))


SEED_MAX = 16_777_216  # 2**24, reference js/planet-code.js:26


@dataclasses.dataclass(frozen=True)
class GenerationParams:
    """Full parameter set for one planet (seed + 16 sliders + plate edits).

    Field names mirror the reference worker message payload
    (js/planet-worker.js:137) so planet codes round-trip losslessly.
    """

    seed: int = 0
    n_cells: int = 204_000          # "N" — detail (5_000..2_560_000)
    jitter: float = 0.75            # irregularity (0..1)
    n_plates: int = 80              # "P" — plates (4..120)
    num_continents: int = 4         # continents (1..10)
    roughness: float = 0.25         # "nMag" — noise magnitude (0..0.5)
    smoothing: float = 0.3
    glacial_erosion: float = 0.0
    hydraulic_erosion: float = 0.5
    thermal_erosion: float = 0.1
    ridge_sharpening: float = 0.35
    soil_creep: float = 0.05        # encoded in codes; worker always applies 3 iters
    terrain_warp: float = 0.5
    continent_size_variety: float = 0.0
    temperature_offset: float = 0.0     # °C, -15..15
    precipitation_offset: float = 0.0   # -1..1
    land_coverage: float = 0.3          # 0..1
    toggled_indices: Tuple[int, ...] = ()  # plate ocean/land edit toggles
    skip_climate: Optional[bool] = None    # None = auto (N <= AUTO_CLIMATE_THRESHOLD)

    # Fixed pipeline constants (not sliders)
    spread: float = 5.0             # stress spread, js/planet-worker.js:138

    def __post_init__(self):
        if not (0 <= self.seed < SEED_MAX):
            raise ValueError(f"seed must be in [0, {SEED_MAX}), got {self.seed}")
        if not (4 <= self.n_plates <= 120):
            raise ValueError(f"n_plates must be in [4, 120], got {self.n_plates}")
        if not (1 <= self.num_continents <= 10):
            raise ValueError(f"num_continents in [1, 10], got {self.num_continents}")

    def replace(self, **kw) -> "GenerationParams":
        return dataclasses.replace(self, **kw)


# Climate is auto-computed only at or below this cell count
# (reference js/main.js:82-83).
AUTO_CLIMATE_THRESHOLD = 300_000

# Coarse reference-grid resolution for plates — fixed so planet shape is
# independent of the detail slider (reference js/coarse-plates.js:11).
N_COARSE = 20_000
COARSE_JITTER = 0.75
