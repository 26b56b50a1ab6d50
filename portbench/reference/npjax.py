"""The ``jax`` and ``jax.numpy`` names the reference's stage code uses,
carried out eagerly by NumPy on the host.

The stage modules of this reference are the JAX package's stage
definitions, with their ``import jax`` / ``import jax.numpy as jnp``
lines pointed here. This module gives those names JAX's meaning where
it differs from NumPy's:

- 32-bit types by default (JAX without x64): every result of a float64,
  int64 or uint64 type is stored in the 32-bit type;
- arrays are values: ``x += y`` makes a new array, and ``x.at[i].set(v)``
  / ``.add`` / ``.min`` / ``.max`` return an updated copy; a scatter
  wraps negative indices and drops those out of range;
- a gather ``x[i]`` wraps negative indices and clamps those out of
  range; ``take_along_axis`` fills out-of-range reads (NaN for floats);
- ``argsort`` is stable;
- ``jit`` is the function itself, and ``lax``'s loops are Python loops.
"""

from __future__ import annotations

import types

import numpy as np

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def bfloat16(x: np.ndarray) -> np.ndarray:
    """Float32 ``x`` rounded to bfloat16 (to nearest even), as float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = ((b >> 16) & np.uint32(1)) + np.uint32(0x7FFF)
    out = ((b + r) & np.uint32(0xFFFF0000)).view(np.float32)
    return np.where(np.isfinite(x), out, x).reshape(np.shape(x))


class Array(np.ndarray):
    """A NumPy array with JAX's value semantics (see the module doc)."""

    __array_priority__ = 100.0

    def __array_ufunc__(self, ufunc, method, *inputs, out=None, **kw):
        if out is not None:
            raise TypeError("JAX arrays are values: no out= argument")
        args = [_plain(x) for x in inputs]
        return _wrap(getattr(ufunc, method)(*args, **kw))

    def __getitem__(self, idx):
        return _wrap(np.ndarray.__getitem__(
            self.view(np.ndarray), _gather_index(idx, self.shape)))

    def __setitem__(self, idx, value):
        raise TypeError("JAX arrays are values: use x.at[i].set(v)")

    @property
    def at(self):
        return _At(self)

    # in-place operators make a new array, as JAX's do
    def __iadd__(self, o): return self + o
    def __isub__(self, o): return self - o
    def __imul__(self, o): return self * o
    def __itruediv__(self, o): return self / o
    def __ifloordiv__(self, o): return self // o
    def __imod__(self, o): return self % o
    def __ipow__(self, o): return self ** o
    def __iand__(self, o): return self & o
    def __ior__(self, o): return self | o
    def __ixor__(self, o): return self ^ o
    def __ilshift__(self, o): return self << o
    def __irshift__(self, o): return self >> o

    def astype(self, dtype, *a, **k):
        return _wrap(np.ndarray.astype(self.view(np.ndarray),
                                       _dtype(dtype), *a, **k))


def _plain(x):
    return x.view(np.ndarray) if isinstance(x, Array) else x


def _dtype(d):
    if d is None:
        return None
    d = np.dtype(d)
    return np.dtype(_NARROW.get(d, d))


def _wrap(x):
    """A result in JAX's form: 32-bit, an ``Array`` (tuples element-wise)."""
    if isinstance(x, tuple):
        return tuple(_wrap(v) for v in x)
    if isinstance(x, list):
        return [_wrap(v) for v in x]
    if isinstance(x, np.ndarray):
        narrow = _NARROW.get(x.dtype)
        if narrow is not None:
            x = x.astype(narrow)
        return x.view(Array)
    if isinstance(x, np.generic):
        return _wrap(np.asarray(x))
    return x


def _norm_index(i, size: int, clamp: bool):
    """An integer index array with negatives wrapped; clamped into range
    (a gather) or left for the caller to drop (a scatter)."""
    i = np.asarray(_plain(i))
    i = np.where(i < 0, i + size, i)
    if clamp:
        i = np.clip(i, 0, max(size - 1, 0))
    return i


def _is_int_array(i) -> bool:
    return isinstance(i, np.ndarray) and i.dtype.kind in "iu" and \
        not isinstance(i, bool)


def _gather_index(idx, shape):
    if _is_int_array(idx):
        return _norm_index(idx, shape[0], True)
    if isinstance(idx, tuple):
        out, axis = [], 0
        for part in idx:
            if part is None:
                out.append(part)
                continue
            if part is Ellipsis:
                n_real = sum(p is not None and p is not Ellipsis
                             for p in idx)
                axis += len(shape) - n_real
                out.append(part)
                continue
            if _is_int_array(part):
                part = _norm_index(part, shape[axis], True)
            elif isinstance(part, Array):
                part = part.view(np.ndarray)
            out.append(part)
            axis += 1
        return tuple(out)
    if isinstance(idx, Array):
        return idx.view(np.ndarray)
    return idx


class _At:
    def __init__(self, arr):
        self.arr = arr

    def __getitem__(self, idx):
        return _Update(self.arr, idx)


class _Update:
    def __init__(self, arr, idx):
        self.arr, self.idx = arr, idx

    def _scatter(self, ufunc, value):
        base = np.array(self.arr.view(np.ndarray))      # a copy
        idx = self.idx
        value = np.asarray(_plain(value))
        if _is_int_array(idx) or isinstance(idx, (list, Array)):
            i = _norm_index(idx, base.shape[0], False)
            keep = (i >= 0) & (i < base.shape[0])
            if not keep.all():
                value = np.broadcast_to(
                    value, i.shape + base.shape[1:])[keep]
                i = i[keep]
            idx = i
        elif isinstance(idx, tuple):
            idx = tuple(_plain(p) for p in idx)
        value = value.astype(base.dtype, copy=False)
        if ufunc is None:
            base[idx] = value
        else:
            ufunc.at(base, idx, value)
        return _wrap(base)

    def set(self, value, mode=None, **_):
        return self._scatter(None, value)

    def add(self, value, mode=None, **_):
        return self._scatter(np.add, value)

    def min(self, value, mode=None, **_):
        return self._scatter(np.minimum, value)

    def max(self, value, mode=None, **_):
        return self._scatter(np.maximum, value)


# ── jax.numpy ─────────────────────────────────────────────────────────


def _wrapped(fn):
    def call(*args, **kw):
        args = [_plain(a) if not isinstance(a, (list, tuple)) else
                type(a)(_plain(v) for v in a) for a in args]
        kw = {k: _plain(v) for k, v in kw.items()}
        if "dtype" in kw:
            kw["dtype"] = _dtype(kw["dtype"])
        return _wrap(fn(*args, **kw))
    call.__name__ = getattr(fn, "__name__", "jnp_function")
    return call


class _Namespace(types.SimpleNamespace):
    """Names not set here are NumPy's, their results wrapped."""

    def __init__(self, base, **names):
        super().__init__(**names)
        object.__setattr__(self, "_base", base)

    def __getattr__(self, name):
        v = getattr(object.__getattribute__(self, "_base"), name)
        if callable(v) and not isinstance(v, type):
            v = _wrapped(v)
        setattr(self, name, v)
        return v


def asarray(x, dtype=None, copy=None):
    return _wrap(np.array(_plain(x), dtype=_dtype(dtype), copy=True))


def clip(x, min=None, max=None, a_min=None, a_max=None):
    lo = min if min is not None else a_min
    hi = max if max is not None else a_max
    out = np.asarray(_plain(x))
    if lo is not None:
        out = np.maximum(out, _plain(lo))
    if hi is not None:
        out = np.minimum(out, _plain(hi))
    return _wrap(np.asarray(out))


def argsort(x, axis=-1, kind=None, stable=True, descending=False):
    x = np.asarray(_plain(x))
    if descending:
        return _wrap(np.flip(np.argsort(-x if x.dtype.kind != "b" else ~x,
                                        axis=axis, kind="stable"), axis))
    return _wrap(np.argsort(x, axis=axis, kind="stable"))


def take_along_axis(arr, indices, axis, mode=None, fill_value=None):
    arr = np.asarray(_plain(arr))
    i = np.asarray(_plain(indices))
    size = arr.shape[axis]
    i = np.where(i < 0, i + size, i)
    bad = (i < 0) | (i >= size)
    out = np.take_along_axis(arr, np.clip(i, 0, size - 1), axis)
    if bad.any():
        if fill_value is None:
            if arr.dtype.kind == "f":
                fill_value = np.nan
            elif arr.dtype.kind == "i":
                fill_value = np.iinfo(arr.dtype).min
            elif arr.dtype.kind == "u":
                fill_value = np.iinfo(arr.dtype).max
            else:
                fill_value = True
        out = np.where(bad, np.asarray(fill_value, arr.dtype), out)
    return _wrap(out)


def _creator(fn, default):
    def call(shape, dtype=None, **kw):
        return _wrap(fn(_plain(shape),
                        dtype=_dtype(dtype) if dtype is not None else default))
    return call


class _ScalarType:
    """``jnp.float32`` and the like: a dtype, and a cast of a value."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __call__(self, x):
        return _wrap(np.asarray(_plain(x)).astype(self.dtype))

    def __eq__(self, other):
        try:
            return self.dtype == np.dtype(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.dtype)

    def __repr__(self):
        return f"jnp.{self.dtype.name}"


def arange(*args, dtype=None, **kw):
    args = [_plain(a) for a in args]
    out = np.arange(*args, **kw)
    if dtype is not None:
        out = out.astype(_dtype(dtype))
    return _wrap(out)


def full(shape, fill_value, dtype=None, **kw):
    fill_value = _plain(fill_value)
    if dtype is None:
        dtype = np.asarray(fill_value).dtype
    return _wrap(np.full(shape, fill_value, dtype=_dtype(dtype)))


def full_like(x, fill_value, dtype=None, **kw):
    return _wrap(np.full_like(_plain(x), _plain(fill_value),
                              dtype=_dtype(dtype)))


jnp = _Namespace(
    np,
    float32=_ScalarType(np.float32), int32=_ScalarType(np.int32),
    uint32=_ScalarType(np.uint32), bool_=_ScalarType(np.bool_),
    iinfo=lambda t: np.iinfo(np.dtype(t)),
    asarray=asarray, clip=clip, argsort=argsort,
    take_along_axis=take_along_axis, arange=arange, full=full,
    full_like=full_like,
    zeros=_creator(np.zeros, np.float32), ones=_creator(np.ones, np.float32),
    linalg=_Namespace(np.linalg),
)


# ── jax, jax.lax, jax.ops ─────────────────────────────────────────────


def jit(fn=None, **_):
    if fn is None:
        return lambda f: f
    return fn


def _tree_map(f, *trees):
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(f, *xs) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: _tree_map(f, *(x[k] for x in trees)) for k in t}
    if t is None:
        return None
    return f(*trees)


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [v for x in t for v in _leaves(x)]
    if isinstance(t, dict):
        return [v for k in t for v in _leaves(t[k])]
    return [] if t is None else [t]


def while_loop(cond_fun, body_fun, init):
    val = init
    while bool(cond_fun(val)):
        val = body_fun(val)
    return val


def fori_loop(lower, upper, body_fun, init, **_):
    val = init
    for i in range(int(lower), int(upper)):
        val = body_fun(i, val)
    return val


def scan(f, init, xs=None, length=None, **_):
    if length is None:
        length = len(_leaves(xs)[0])
    carry, ys = init, []
    for i in range(int(length)):
        x = None if xs is None else _tree_map(lambda a: a[i], xs)
        carry, y = f(carry, x)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, _tree_map(lambda *vs: _wrap(np.stack(
        [np.asarray(_plain(v)) for v in vs])), *ys)


def cond(pred, true_fun, false_fun, *operands):
    return true_fun(*operands) if bool(pred) else false_fun(*operands)


def lax_map(f, xs):
    return scan(lambda c, x: (c, f(x)), None, xs)[1]


def slice_in_dim(x, start, limit, stride=1, axis=0):
    sl = [slice(None)] * np.ndim(x)
    sl[axis] = slice(start, limit, stride)
    return x[tuple(sl)]


def _segment(ufunc, init):
    def seg(data, segment_ids, num_segments=None, **_):
        data = np.asarray(_plain(data))
        ids = np.asarray(_plain(segment_ids))
        if num_segments is None:
            num_segments = int(ids.max()) + 1
        fill = init(data.dtype)
        out = np.full((num_segments,) + data.shape[1:], fill, data.dtype)
        keep = (ids >= 0) & (ids < num_segments)
        ufunc.at(out, ids[keep], data[keep])
        return _wrap(out)
    return seg


def _lowest(dt):
    return -np.inf if dt.kind == "f" else (
        False if dt.kind == "b" else np.iinfo(dt).min)


def _highest(dt):
    return np.inf if dt.kind == "f" else (
        True if dt.kind == "b" else np.iinfo(dt).max)


lax = types.SimpleNamespace(
    while_loop=while_loop, fori_loop=fori_loop, scan=scan, cond=cond,
    map=lax_map, slice_in_dim=slice_in_dim)

ops = types.SimpleNamespace(
    segment_sum=_segment(np.add, lambda dt: 0),
    segment_max=_segment(np.maximum, _lowest),
    segment_min=_segment(np.minimum, _highest))


def _register_dataclass(cls=None, **_):
    return cls if cls is not None else (lambda c: c)


jax = types.SimpleNamespace(
    lax=lax, ops=ops, jit=jit, Array=np.ndarray,
    tree_util=types.SimpleNamespace(register_dataclass=_register_dataclass))
