"""Native (C++) host components — loader.

The coarse-grid plate flood fill is the one genuinely sequential stage
(data-dependent RNG draws inside a frontier loop), so it runs as native
host code. The shared library is compiled on first use from
``csrc/coarse_fill.cpp`` (a copy of the JAX package's ``native/`` source,
the path that package takes wherever a compiler is found) into this
package's own ``_build/``; everything degrades to the pure-Python
implementation when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_ROOT, "csrc", "coarse_fill.cpp")
_BUILD_DIR = os.path.join(_ROOT, "_build")
_SO = os.path.join(_BUILD_DIR, "coarse_fill.so")


def _build(src: str, so: str, timeout: int) -> bool:
    """Compile ``src`` into ``so`` under a name of this process's own and
    rename it into place, so a process that loads the library while
    another compiles never reads a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    for cc in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cc, "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
                 "-o", tmp, src],
                check=True, capture_output=True, timeout=timeout)
            os.replace(tmp, so)
            return True
        except (subprocess.SubprocessError, FileNotFoundError):
            continue
    return False


def _compile() -> bool:
    return _build(_SRC, _SO, 120)


def get_coarse_fill():
    """ctypes handle to coarse_fill_plates, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SRC):
            return None
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        import numpy as np
        from numpy.ctypeslib import ndpointer

        fn = lib.coarse_fill_plates
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ndpointer(np.int32, flags="C_CONTIGUOUS"),   # nbr_idx
            ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # nbr_mask
            ndpointer(np.float64, flags="C_CONTIGUOUS"), # pos
            ndpointer(np.int32, flags="C_CONTIGUOUS"),   # seeds
            ndpointer(np.float64, flags="C_CONTIGUOUS"), # growth_rate
            ndpointer(np.float64, flags="C_CONTIGUOUS"), # growth_dir
            ndpointer(np.float64, flags="C_CONTIGUOUS"), # dir_strength
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64),              # rng_state
            ctypes.POINTER(ctypes.c_int64),              # randint_state
            ndpointer(np.int32, flags="C_CONTIGUOUS"),   # r_plate
        ]
        _LIB = fn
        return _LIB


_MESH_SRC = os.path.join(_ROOT, "csrc", "mesh_build.cpp")
_MESH_SO = os.path.join(_BUILD_DIR, "mesh_build.so")
_MESH_LOCK = threading.Lock()
_MESH_LIB = None
_MESH_TRIED = False


def _compile_mesh() -> bool:
    return _build(_MESH_SRC, _MESH_SO, 180)


def get_mesh_build():
    """(mesh_delaunay, mesh_adjacency) ctypes handles, or None.

    The native mesh builder replaces scipy Qhull + numpy adjacency on the
    host prologue hot path (~40x at 1M cells); mesh/build.py falls back to
    the pure-Python implementation when no compiler is available."""
    global _MESH_LIB, _MESH_TRIED
    with _MESH_LOCK:
        if _MESH_TRIED:
            return _MESH_LIB
        _MESH_TRIED = True
        if not os.path.exists(_MESH_SRC):
            return None
        if not os.path.exists(_MESH_SO) or (
                os.path.getmtime(_MESH_SO) < os.path.getmtime(_MESH_SRC)):
            if not _compile_mesh():
                return None
        try:
            lib = ctypes.CDLL(_MESH_SO)
        except OSError:
            return None
        import numpy as np
        from numpy.ctypeslib import ndpointer

        dl = lib.mesh_delaunay
        dl.restype = ctypes.c_int64
        dl.argtypes = [
            ndpointer(np.float64, flags="C_CONTIGUOUS"),  # xs
            ndpointer(np.float64, flags="C_CONTIGUOUS"),  # ys
            ctypes.c_int64,
            ndpointer(np.int32, flags="C_CONTIGUOUS"),    # out_tris
            ndpointer(np.int32, flags="C_CONTIGUOUS"),    # out_hull
            ctypes.POINTER(ctypes.c_int64),               # hull_len
        ]
        pm = lib.pm_sequence
        pm.restype = ctypes.c_int64
        pm.argtypes = [ctypes.c_int64, ctypes.c_int64,
                       ndpointer(np.float64, flags="C_CONTIGUOUS")]
        adj = lib.mesh_adjacency
        adj.restype = ctypes.c_int
        adj.argtypes = [
            ndpointer(np.int32, flags="C_CONTIGUOUS"),    # tris
            ctypes.c_int64,
            ndpointer(np.float64, flags="C_CONTIGUOUS"),  # pos
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            ndpointer(np.int32, flags="C_CONTIGUOUS"),    # nbr_idx
            ndpointer(np.uint8, flags="C_CONTIGUOUS"),    # nbr_mask
            ndpointer(np.float32, flags="C_CONTIGUOUS"),  # nbr_dist
            ndpointer(np.int32, flags="C_CONTIGUOUS"),    # deg
        ]
        try:
            bp = lib.banded_pack
            bp.restype = ctypes.c_int
            bp.argtypes = [
                ndpointer(np.int32, flags="C_CONTIGUOUS"),   # nbr_idx
                ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # nbr_mask
                ctypes.c_int64, ctypes.c_int32,
                ndpointer(np.int32, flags="C_CONTIGUOUS"),   # band_off
                ctypes.c_int32,
                ndpointer(np.uint32, flags="C_CONTIGUOUS"),  # band_bits
                ndpointer(np.uint32, flags="C_CONTIGUOUS"),  # mask_bits
                ndpointer(np.int16, flags="C_CONTIGUOUS"),   # off16
                ndpointer(np.int32, flags="C_CONTIGUOUS"),   # exc_flat
                ndpointer(np.int32, flags="C_CONTIGUOUS"),   # exc_val
                ctypes.c_int64,
                ndpointer(np.int32, flags="C_CONTIGUOUS"),   # rem_src
                ndpointer(np.int32, flags="C_CONTIGUOUS"),   # rem_dst
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),              # exc_n
                ctypes.POINTER(ctypes.c_int64),              # rem_n
            ]
        except AttributeError:                               # stale .so
            bp = None
        _MESH_LIB = (dl, adj, pm, bp)
        return _MESH_LIB


def build() -> bool:
    """Build (or load) both libraries now; True where both are there."""
    return get_coarse_fill() is not None and get_mesh_build() is not None
