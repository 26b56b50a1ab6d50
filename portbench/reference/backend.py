"""The array library the reference's stage modules run on, chosen once
per process before any of them loads (they take ``jax``, ``jnp`` and
``bfloat16`` from here):

- ``use("numpy")``, the default: ``npjax``, NumPy on the host;
- ``use("torch", device)``: ``torchjax``, plain PyTorch on ``device``.

The first stage module to load fixes the choice; a later ``use`` of
another library raises.
"""

from __future__ import annotations

import importlib

_NAMES = ("jax", "jnp", "bfloat16")
_choice = ("numpy", None)
_module = None


def use(name: str, device=None) -> None:
    """Run this process's reference on ``name`` ("numpy" or "torch"),
    the latter on ``device``."""
    global _choice
    if name not in ("numpy", "torch"):
        raise ValueError(f"no reference backend {name!r}")
    want = (name, None if device is None else str(device))
    if _module is not None and want != _choice:
        raise RuntimeError(f"the reference already runs on {_choice}")
    _choice = want


def chosen() -> tuple:
    """(library, device) of this process's reference."""
    return _choice


def _load():
    global _module
    if _module is None:
        name, device = _choice
        if name == "torch":
            mod = importlib.import_module(".torchjax", __package__)
            mod.set_device(device or "cpu")
        else:
            mod = importlib.import_module(".npjax", __package__)
        _module = mod
    return _module


def __getattr__(attr):
    if attr in _NAMES:
        return getattr(_load(), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")
