"""Native (C++) host components — loader.

The coarse-grid plate flood fill is the one genuinely sequential stage
(data-dependent RNG draws inside a frontier loop), so it runs as native
host code. The shared library is compiled on first use from
``native/coarse_fill.cpp`` with the system toolchain; everything degrades
gracefully to the pure-Python implementation when no compiler is available.
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

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "coarse_fill.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build", "native")
_SO = os.path.join(_BUILD_DIR, "coarse_fill.so")


def _build(src: str, so: str, timeout: int) -> bool:
    """Compile ``src`` into ``so``. The library is written under a name of
    this process's own and renamed into place, so a process that loads it
    while another compiles never reads a half-written file (processes that
    start together, such as test workers, all compile on a fresh
    checkout)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    for cc in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cc, "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
                 "-pthread", "-o", tmp, src],
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


_MESH_SRC = os.path.join(_ROOT, "native", "mesh_build.cpp")
_CHUNKED_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "csrc", "mesh_chunked.cpp")
_MESH_SO = os.path.join(_BUILD_DIR, "mesh_chunked.so")
_MESH_LOCK = threading.Lock()
_MESH_LIB = None
_MESH_TRIED = False


def get_mesh_build():
    """The native mesh builder's ctypes handles, or None without a
    compiler (mesh/build.py then falls back to scipy and numpy):
    ``delaunay`` (the serial sweep-hull), ``pm_sequence`` (Park-Miller
    draws), ``delaunay_chunked``, ``adjacency``, ``census`` and ``pack``
    (the threaded mesh build, bit for bit with the serial functions).

    ``csrc/mesh_chunked.cpp`` compiles ``native/mesh_build.cpp`` in; the
    library is rebuilt when either source is newer than it."""
    global _MESH_LIB, _MESH_TRIED
    with _MESH_LOCK:
        if _MESH_TRIED:
            return _MESH_LIB
        _MESH_TRIED = True
        if not (os.path.exists(_CHUNKED_SRC) and os.path.exists(_MESH_SRC)):
            return None
        newest = max(os.path.getmtime(_CHUNKED_SRC),
                     os.path.getmtime(_MESH_SRC))
        if not os.path.exists(_MESH_SO) or (
                os.path.getmtime(_MESH_SO) < newest):
            if not _build(_CHUNKED_SRC, _MESH_SO, 180):
                return None
        try:
            lib = ctypes.CDLL(_MESH_SO)
        except OSError:
            return None
        import types

        import numpy as np
        from numpy.ctypeslib import ndpointer

        f32 = ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64 = ndpointer(np.float64, flags="C_CONTIGUOUS")
        i16 = ndpointer(np.int16, flags="C_CONTIGUOUS")
        i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64 = ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8 = ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32 = ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64p = ctypes.POINTER(ctypes.c_int64)
        dl = lib.mesh_delaunay
        dl.restype = ctypes.c_int64
        dl.argtypes = [f64, f64, ctypes.c_int64,         # xs, ys, n
                       i32, i32, i64p]                   # tris, hull, len
        pm = lib.pm_sequence
        pm.restype = ctypes.c_int64
        pm.argtypes = [ctypes.c_int64, ctypes.c_int64, f64]
        dlc = lib.mesh_delaunay_chunked
        dlc.restype = ctypes.c_int64
        dlc.argtypes = [f64, f64, f64,                   # xs, ys, xyz
                        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                        i32, i32, i64p, i64]             # tris, hull, stats
        adj = lib.mesh_adjacency_mt
        adj.restype = ctypes.c_int
        adj.argtypes = [i32, ctypes.c_int64, f64,        # tris, t, pos
                        ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                        i32, u8, f32, i32, ctypes.c_int32]  # .., threads
        census = lib.band_census
        census.restype = ctypes.c_int32
        census.argtypes = [i32, u8, ctypes.c_int64, ctypes.c_int32,
                           ctypes.c_int32, ctypes.c_int32, i32]
        bp = lib.banded_pack_mt
        bp.restype = ctypes.c_int
        bp.argtypes = [i32, u8, ctypes.c_int64, ctypes.c_int32,
                       i32, ctypes.c_int32,              # band_off, d
                       u32, u32, i16,                    # bits, off16
                       i32, i32, ctypes.c_int64,         # exceptions
                       i32, i32, ctypes.c_int64,         # remainder
                       i64p, i64p, ctypes.c_int32]
        _MESH_LIB = types.SimpleNamespace(
            delaunay=dl, pm_sequence=pm, delaunay_chunked=dlc,
            adjacency=adj, census=census, pack=bp)
        return _MESH_LIB
