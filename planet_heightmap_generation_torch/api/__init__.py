from .planet_code import encode_planet_code, decode_planet_code
from .layers import LAYERS, available_layers, layer_color
from .picking import nearest_region, cell_info

__all__ = [
    "encode_planet_code", "decode_planet_code",
    "LAYERS", "available_layers", "layer_color",
    "nearest_region", "cell_info",
]
