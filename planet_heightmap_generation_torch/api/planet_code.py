"""Planet codes — the serialized parameter "API".

Re-design of reference js/planet-code.js: mixed-radix packing of seed (2^24)
plus 16 quantized sliders into a 22-char base36 string, with a ``-``-suffixed
plate-toggle list (2 base36 chars per index), and decoders for all seven
legacy format generations (13/14/16/17/18/21/22 chars) with per-format
defaults. Codes are interchangeable with the reference's."""

from __future__ import annotations

from typing import Dict, List, Optional

# Slider quantization (js/planet-code.js:5-22)
SLIDERS = [
    dict(min=5000, step=1000, count=2556),   # 0 Detail (N)
    dict(min=0, step=0.05, count=21),        # 1 Irregularity (jitter)
    dict(min=4, step=1, count=117),          # 2 Plates (P)
    dict(min=1, step=1, count=10),           # 3 Continents
    dict(min=0, step=0.01, count=51),        # 4 Roughness
    dict(min=0, step=0.05, count=21),        # 5 Smoothing
    dict(min=0, step=0.05, count=21),        # 6 Glacial Erosion
    dict(min=0, step=0.05, count=21),        # 7 Hydraulic Erosion
    dict(min=0, step=0.05, count=21),        # 8 Thermal Erosion
    dict(min=0, step=0.05, count=21),        # 9 Ridge Sharpening
    dict(min=0, step=0.05, count=21),        # 10 Soil Creep
    dict(min=0, step=0.05, count=21),        # 11 Terrain Warp
    dict(min=0, step=0.05, count=21),        # 12 Continent Size Variety
    dict(min=-15, step=1, count=31),         # 13 Temperature
    dict(min=-1, step=0.1, count=21),        # 14 Precipitation
    dict(min=0, step=0.01, count=101),       # 15 Land Coverage
]

RADICES = [101, 21, 31, 21, 21, 21, 21, 21, 21, 21, 21, 51, 10, 117, 21, 2556]
SEED_MAX = 16_777_216
BASE_LEN = 22
IDX_CHARS = 2

# Legacy format tables (js/planet-code.js:37-52)
_FORMATS: Dict[int, dict] = {
    13: dict(
        radices=[21, 21, 51, 10, 117, 21, 2559],
        fields=[("hydraulicErosion", 7), ("smoothing", 5), ("roughness", 4),
                ("numContinents", 3), ("P", 2), ("jitter", 1), ("N", 0)],
        defaults=dict(terrainWarp=0.5, glacialErosion=0, thermalErosion=0.1,
                      ridgeSharpening=0.35, soilCreep=0.05,
                      continentSizeVariety=0, temperatureOffset=0,
                      precipitationOffset=0, landCoverage=0.3),
    ),
    14: dict(
        radices=[21, 21, 21, 51, 10, 117, 21, 2559],
        fields=[("thermalErosion", 8), ("hydraulicErosion", 7),
                ("smoothing", 5), ("roughness", 4), ("numContinents", 3),
                ("P", 2), ("jitter", 1), ("N", 0)],
        defaults=dict(terrainWarp=0.5, glacialErosion=0, ridgeSharpening=0.35,
                      soilCreep=0.05, continentSizeVariety=0,
                      temperatureOffset=0, precipitationOffset=0,
                      landCoverage=0.3),
    ),
    16: dict(
        radices=[21, 21, 21, 21, 21, 51, 10, 117, 21, 2559],
        fields=[("soilCreep", 10), ("ridgeSharpening", 9),
                ("thermalErosion", 8), ("hydraulicErosion", 7),
                ("smoothing", 5), ("roughness", 4), ("numContinents", 3),
                ("P", 2), ("jitter", 1), ("N", 0)],
        defaults=dict(terrainWarp=0.5, glacialErosion=0,
                      continentSizeVariety=0, temperatureOffset=0,
                      precipitationOffset=0, landCoverage=0.3),
    ),
    17: dict(
        radices=[21, 21, 21, 21, 21, 21, 51, 10, 117, 21, 2559],
        fields=[("soilCreep", 10), ("ridgeSharpening", 9),
                ("thermalErosion", 8), ("hydraulicErosion", 7),
                ("glacialErosion", 6), ("smoothing", 5), ("roughness", 4),
                ("numContinents", 3), ("P", 2), ("jitter", 1), ("N", 0)],
        defaults=dict(terrainWarp=0.5, continentSizeVariety=0,
                      temperatureOffset=0, precipitationOffset=0,
                      landCoverage=0.3),
    ),
    18: dict(
        radices=[21, 21, 21, 21, 21, 21, 21, 51, 10, 117, 21, 2556],
        fields=[("terrainWarp", 11), ("soilCreep", 10), ("ridgeSharpening", 9),
                ("thermalErosion", 8), ("hydraulicErosion", 7),
                ("glacialErosion", 6), ("smoothing", 5), ("roughness", 4),
                ("numContinents", 3), ("P", 2), ("jitter", 1), ("N", 0)],
        defaults=dict(continentSizeVariety=0, temperatureOffset=0,
                      precipitationOffset=0, landCoverage=0.3),
    ),
    21: dict(
        radices=[21, 31, 21, 21, 21, 21, 21, 21, 21, 21, 51, 10, 117, 21, 2556],
        fields=[("precipitationOffset", 14), ("temperatureOffset", 13),
                ("continentSizeVariety", 12), ("terrainWarp", 11),
                ("soilCreep", 10), ("ridgeSharpening", 9),
                ("thermalErosion", 8), ("hydraulicErosion", 7),
                ("glacialErosion", 6), ("smoothing", 5), ("roughness", 4),
                ("numContinents", 3), ("P", 2), ("jitter", 1), ("N", 0)],
        defaults=dict(landCoverage=0.3),
    ),
    22: dict(
        radices=RADICES,
        fields=[("landCoverage", 15), ("precipitationOffset", 14),
                ("temperatureOffset", 13), ("continentSizeVariety", 12),
                ("terrainWarp", 11), ("soilCreep", 10), ("ridgeSharpening", 9),
                ("thermalErosion", 8), ("hydraulicErosion", 7),
                ("glacialErosion", 6), ("smoothing", 5), ("roughness", 4),
                ("numContinents", 3), ("P", 2), ("jitter", 1), ("N", 0)],
        defaults={},
    ),
}

_B36 = "0123456789abcdefghijklmnopqrstuvwxyz"


def _to_index(value: float, slider: dict) -> int:
    return round((value - slider["min"]) / slider["step"])


def _from_index(idx: int, slider: dict) -> float:
    raw = slider["min"] + idx * slider["step"]
    step = slider["step"]
    if step < 1:
        decimals = len(str(step).split(".")[1])
        return round(raw, decimals)
    return raw


def _to_base36(v: int) -> str:
    if v == 0:
        return "0"
    out = []
    while v > 0:
        out.append(_B36[v % 36])
        v //= 36
    return "".join(reversed(out))


def encode_planet_code(seed: int, N: int, jitter: float, P: int,
                       numContinents: int, roughness: float,
                       terrainWarp: float, smoothing: float,
                       glacialErosion: float, hydraulicErosion: float,
                       thermalErosion: float, ridgeSharpening: float,
                       soilCreep: float, continentSizeVariety: float,
                       temperatureOffset: float, precipitationOffset: float,
                       landCoverage: float,
                       toggledIndices: Optional[List[int]] = None) -> str:
    """Mixed-radix encode (js/planet-code.js:197-244). Argument order matches
    the reference signature."""
    idxs_in_pack_order = [  # MSB→LSB packing order (js/planet-code.js:216-232)
        _to_index(N, SLIDERS[0]), _to_index(jitter, SLIDERS[1]),
        _to_index(P, SLIDERS[2]), _to_index(numContinents, SLIDERS[3]),
        _to_index(roughness, SLIDERS[4]), _to_index(smoothing, SLIDERS[5]),
        _to_index(glacialErosion, SLIDERS[6]),
        _to_index(hydraulicErosion, SLIDERS[7]),
        _to_index(thermalErosion, SLIDERS[8]),
        _to_index(ridgeSharpening, SLIDERS[9]),
        _to_index(soilCreep, SLIDERS[10]), _to_index(terrainWarp, SLIDERS[11]),
        _to_index(continentSizeVariety, SLIDERS[12]),
        _to_index(temperatureOffset, SLIDERS[13]),
        _to_index(precipitationOffset, SLIDERS[14]),
        _to_index(landCoverage, SLIDERS[15]),
    ]
    mults = [RADICES[15], RADICES[14], RADICES[13], RADICES[12], RADICES[11],
             RADICES[10], RADICES[9], RADICES[8], RADICES[7], RADICES[6],
             RADICES[5], RADICES[4], RADICES[3], RADICES[2], RADICES[1],
             RADICES[0]]
    packed = seed
    for mult, idx in zip(mults, idxs_in_pack_order):
        packed = packed * mult + idx

    code = _to_base36(packed).rjust(BASE_LEN, "0")
    if toggledIndices:
        code += "-" + "".join(
            _to_base36(i).rjust(IDX_CHARS, "0") for i in toggledIndices)
    return code


def decode_planet_code(code: str) -> Optional[dict]:
    """Decode any of the 7 format generations (js/planet-code.js:252-275).
    Returns a dict of reference-named fields or None on invalid input."""
    if not isinstance(code, str):
        return None
    code = code.strip().lower()
    dash = code.find("-")
    base = code if dash == -1 else code[:dash]
    toggle_str = "" if dash == -1 else code[dash + 1:]

    config = _FORMATS.get(len(base))
    if config is None:
        return None
    if not base or any(ch not in _B36 for ch in base):
        return None
    if toggle_str and (any(ch not in _B36 for ch in toggle_str)
                       or len(toggle_str) % IDX_CHARS != 0):
        return None

    packed = int(base, 36)
    result: dict = {}
    for (name, si), radix in zip(config["fields"], config["radices"]):
        idx = packed % radix
        packed //= radix
        if idx >= SLIDERS[si]["count"]:
            return None
        result[name] = _from_index(idx, SLIDERS[si])
    result["seed"] = packed
    if not (0 <= result["seed"] < SEED_MAX):
        return None
    result.update(config["defaults"])

    toggled = []
    for i in range(0, len(toggle_str), IDX_CHARS):
        idx = int(toggle_str[i:i + IDX_CHARS], 36)
        if idx >= result["P"]:
            return None
        toggled.append(idx)
    result["toggledIndices"] = toggled
    return result
