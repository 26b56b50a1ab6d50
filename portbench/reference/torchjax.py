"""The ``jax`` and ``jax.numpy`` names the reference's stage code uses,
carried out eagerly by plain PyTorch on a device the caller chooses
(:func:`set_device`), with the JAX meanings that ``npjax`` gives them:

- 32-bit types by default (JAX without x64): every result of a float64,
  int64 or uint64 type is stored in the 32-bit type;
- arrays are values: ``x += y`` makes a new array, and ``x.at[i].set(v)``
  / ``.add`` / ``.min`` / ``.max`` return an updated copy; a scatter
  wraps negative indices and drops those out of range;
- a gather ``x[i]`` wraps negative indices and clamps those out of
  range; ``take_along_axis`` fills out-of-range reads (NaN for floats);
- ``argsort`` is stable;
- ``jit`` is the function itself, and ``lax``'s loops are Python loops.

The result type of an operation is NumPy's for the same operands (a
Python scalar is weak), narrowed to 32 bits as in ``npjax``; a float
operation runs in that type, as JAX's does, where NumPy may run it in
float64 and round the result. On the card float32 stays float32: TF32
is off for matmuls (``jnp.einsum``) and cuDNN. The run is deterministic:
``torch.use_deterministic_algorithms`` is on, so every scatter-add and
segment sum (``index_put_(accumulate=True)``) sorts its indices before
it adds, and a scatter's min and max (``scatter_reduce_``, ``amin`` /
``amax``) do not depend on the order. uint32 values are held in int64
and cut to 32 bits after each operation that can carry out of them
(PyTorch has no uint32 arithmetic on the card). A scalar reaches the
card as a kernel argument, never as a copy from the host, which would
wait for the card. Host code that reads an array with ``np.`` gets a
NumPy copy through ``__array__``.
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch

# the control's rounding to bfloat16 is a host operation, the same on
# either backend
from .npjax import bfloat16  # noqa: F401

_DEVICE = torch.device("cpu")

_NARROW = {np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32),
           np.dtype(np.complex128): np.dtype(np.complex64)}
_U32 = np.dtype(np.uint32)
_I64 = np.dtype(np.int64)
_F32 = np.dtype(np.float32)
_I32 = np.dtype(np.int32)
_BOOL = np.dtype(np.bool_)
_MASK = 0xFFFFFFFF
# the storage of each type (uint32 in int64, cut to 32 bits)
_STORE = {_F32: torch.float32, np.dtype(np.float16): torch.float16,
          _I32: torch.int32, np.dtype(np.int16): torch.int16,
          np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
          _BOOL: torch.bool, _U32: torch.int64, _I64: torch.int64,
          np.dtype(np.complex64): torch.complex64}
_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16, torch.int32: np.int32,
             torch.int64: np.int64, torch.int16: np.int16,
             torch.int8: np.int8, torch.uint8: np.uint8,
             torch.bool: np.bool_, torch.complex64: np.complex64,
             torch.complex128: np.complex128}
_SCALARS = (bool, int, float)


def set_device(device) -> None:
    """Run every later array on ``device``, in float32 without TF32 and
    with PyTorch's deterministic algorithms."""
    global _DEVICE
    _DEVICE = torch.device(device)
    # PyTorch refuses a cuBLAS call in deterministic mode unless cuBLAS
    # has a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    # no array here reads memory it has not written: filling every new
    # buffer with NaN would only cost time
    torch.utils.deterministic.fill_uninitialized_memory = False


# ── types ─────────────────────────────────────────────────────────────


def _dtype(d):
    """A NumPy dtype, narrowed to 32 bits (None stays None)."""
    if d is None:
        return None
    d = np.dtype(d)                 # a scalar type gives its .dtype
    return _NARROW.get(d, d)


def _store(dt: np.dtype) -> torch.dtype:
    try:
        return _STORE[dt]
    except KeyError:
        raise TypeError(f"no array of type {dt} here") from None


def _fit(t: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """``t`` in the storage of ``dt``: cast, and cut to 32 bits for
    uint32."""
    if dt == _U32:
        return (t if t.dtype == torch.int64 else t.to(torch.int64)) & _MASK
    s = _store(dt)
    return t if t.dtype == s else t.to(s)


def _convert(t: torch.Tensor, src: np.dtype, dst: np.dtype) -> torch.Tensor:
    """A cast between the types of this module (C casts, as NumPy's)."""
    return t if dst == src else _fit(t, dst)


def _kind(x):
    """What ``np.result_type`` takes for ``x``: a Python scalar as it is
    (weak), anything else as its dtype."""
    if isinstance(x, Array):
        return x.dtype
    if isinstance(x, _SCALARS):
        return x
    if isinstance(x, (np.ndarray, np.generic)):
        return x.dtype
    return np.asarray(x).dtype


def _wide(*xs) -> np.dtype:
    return np.result_type(*[_kind(x) for x in xs])


def _narrow(dt: np.dtype) -> np.dtype:
    return _NARROW.get(dt, dt)


def _full(shape, value, dt: np.dtype) -> torch.Tensor:
    """A tensor of one value on the device, the value passed to the fill
    kernel (no copy from the host)."""
    if dt == _U32:
        value = int(value) & _MASK
    elif isinstance(value, (np.generic, np.ndarray)):
        value = np.asarray(value).astype(dt).item()
    elif dt.kind in "iu" and isinstance(value, float):
        value = int(value)
    return torch.full(tuple(shape), value, dtype=_store(dt), device=_DEVICE)


def _tensor(x, dt: np.dtype | None = None) -> torch.Tensor:
    """``x`` as a tensor on the device, in the storage of ``dt`` (its own
    narrowed type where None)."""
    if isinstance(x, Array):
        return x.t if dt is None else _convert(x.t, x.dtype, dt)
    a = np.asarray(x)
    own = _narrow(a.dtype)
    dt = own if dt is None else dt
    if a.size == 1:                   # a scalar: no copy from the host
        return _full(a.shape, a.reshape(-1)[0].astype(own), dt)
    a = a.astype(np.int64 if own == _U32 else own, copy=False)
    t = torch.tensor(np.ascontiguousarray(a), device=_DEVICE)
    return _convert(t, own, dt)


def _operand(x, dt: np.dtype):
    """A Python scalar stays a scalar (a kernel argument); anything else
    becomes a tensor in the storage of ``dt``."""
    if isinstance(x, _SCALARS):
        if dt.kind == "f":
            return float(x)
        if dt.kind == "b":
            return bool(x)
        return int(x) & _MASK if dt == _U32 else int(x)
    return _tensor(x, dt)


class _ScalarType:
    """``jnp.float32`` and the like: a dtype (``np.dtype`` reads its
    ``.dtype``, so ``x.dtype == jnp.float32`` holds), and a cast of a
    value."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __call__(self, x):
        return asarray(x, self.dtype)


# ── the array ─────────────────────────────────────────────────────────


def _binary(fn, kind: str = "arith"):
    """An operator of two operands in NumPy's result type, narrowed to 32
    bits; integers combine in int64 where NumPy's type is int64 (an
    int32 with a uint32). ``kind`` "cmp" gives booleans, "div" a float
    for integers."""
    def op(a, b):
        wide = _wide(a, b)
        dt = _narrow(wide)
        if kind == "div" and dt.kind in "biu":
            dt = wide = _F32
        work = _I64 if wide == _I64 else dt
        ta, tb = _operand(a, work), _operand(b, work)
        if not isinstance(ta, torch.Tensor):
            ta = _full((), ta, work)
        r = fn(ta, tb)
        if kind == "cmp":
            return Array(r, _BOOL)
        return Array(_fit(r, dt), dt)
    return op


def _swap(op):
    return lambda a, b: op(b, a)


_add = _binary(torch.add)
_sub = _binary(torch.sub)
_mul = _binary(torch.mul)
_truediv = _binary(torch.true_divide, "div")
_floordiv = _binary(torch.floor_divide)
_mod = _binary(torch.remainder)
_pow = _binary(torch.pow)
_and = _binary(torch.bitwise_and)
_or = _binary(torch.bitwise_or)
_xor = _binary(torch.bitwise_xor)
_lshift = _binary(torch.bitwise_left_shift)
_rshift = _binary(torch.bitwise_right_shift)
_matmul = _binary(torch.matmul)


class Array:
    """A tensor with JAX's value semantics (see the module doc)."""

    __slots__ = ("t", "dtype")
    __array_priority__ = 100.0
    __array_ufunc__ = None       # NumPy's operators defer to this class

    def __init__(self, t: torch.Tensor, dtype: np.dtype):
        self.t, self.dtype = t, dtype

    # ── reading ──
    @property
    def shape(self):
        return tuple(self.t.shape)

    @property
    def ndim(self):
        return self.t.dim()

    @property
    def T(self):
        return Array(self.t.permute(*reversed(range(self.t.dim()))),
                     self.dtype)

    def __len__(self):
        return len(self.t)

    def __array__(self, dtype=None, copy=None):
        a = self.t.detach().cpu().numpy()
        if self.dtype == _U32:
            a = a.astype(np.uint32)
        return a if dtype is None else a.astype(dtype)

    def item(self):
        return self.__array__().item()

    def __bool__(self):
        return bool(self.t)

    def __int__(self):
        return int(self.item())

    def __float__(self):
        return float(self.item())

    def __index__(self):
        if self.dtype.kind not in "iu":
            raise TypeError("only integer arrays are indices")
        return int(self.item())

    def __repr__(self):
        return f"Array({self.__array__()!r}, dtype={self.dtype})"

    # ── operators ──
    __add__ = _add
    __radd__ = _swap(_add)
    __sub__ = _sub
    __rsub__ = _swap(_sub)
    __mul__ = _mul
    __rmul__ = _swap(_mul)
    __truediv__ = _truediv
    __rtruediv__ = _swap(_truediv)
    __floordiv__ = _floordiv
    __rfloordiv__ = _swap(_floordiv)
    __mod__ = _mod
    __rmod__ = _swap(_mod)
    __pow__ = _pow
    __rpow__ = _swap(_pow)
    __and__ = _and
    __rand__ = _swap(_and)
    __or__ = _or
    __ror__ = _swap(_or)
    __xor__ = _xor
    __rxor__ = _swap(_xor)
    __lshift__ = _lshift
    __rlshift__ = _swap(_lshift)
    __rshift__ = _rshift
    __rrshift__ = _swap(_rshift)
    __matmul__ = _matmul
    __rmatmul__ = _swap(_matmul)
    __lt__ = _binary(torch.lt, "cmp")
    __le__ = _binary(torch.le, "cmp")
    __gt__ = _binary(torch.gt, "cmp")
    __ge__ = _binary(torch.ge, "cmp")
    __eq__ = _binary(torch.eq, "cmp")
    __ne__ = _binary(torch.ne, "cmp")
    __hash__ = None

    def __neg__(self):
        return Array(_fit(-self.t, self.dtype), self.dtype)

    def __pos__(self):
        return self

    def __abs__(self):
        return abs_(self)

    def __invert__(self):
        return Array(_fit(~self.t, self.dtype), self.dtype)

    # ── values: no update in place ──
    def __setitem__(self, idx, value):
        raise TypeError("JAX arrays are values: use x.at[i].set(v)")

    @property
    def at(self):
        return _At(self)

    def __getitem__(self, idx):
        return Array(self.t[_gather_index(idx, self.t.shape)], self.dtype)

    # ── methods ──
    def astype(self, dtype, *a, **k):
        dt = _dtype(dtype)
        return Array(_convert(self.t, self.dtype, dt), dt)

    def view(self, dtype):
        """The same bits read as ``dtype`` (of the same width)."""
        dt = _dtype(dtype)
        if _U32 in (dt, self.dtype):
            raise NotImplementedError("a uint32 view (held in int64 here)")
        return Array(self.t.view(_store(dt)), dt)

    def reshape(self, *shape, **_):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Array(self.t.reshape(*[int(s) for s in shape]), self.dtype)


def _as_array(x) -> Array:
    return x if isinstance(x, Array) else asarray(x)


# ── indices ───────────────────────────────────────────────────────────


def _is_int_index(i) -> bool:
    if isinstance(i, Array):
        return i.dtype.kind in "iu"
    if isinstance(i, torch.Tensor):
        return not i.is_floating_point() and i.dtype != torch.bool
    return isinstance(i, np.ndarray) and i.dtype.kind in "iu"


def _index_tensor(i) -> torch.Tensor:
    """An integer index as an int64 tensor on the device."""
    if isinstance(i, Array):
        return i.t.to(torch.int64)
    if isinstance(i, torch.Tensor):
        return i.to(torch.int64)
    return _tensor(np.asarray(i, np.int64), _I64)


def _wrapped_index(i, size: int, clamp: bool) -> torch.Tensor:
    """An integer index tensor with negatives wrapped; clamped into range
    (a gather) or left for the caller to drop (a scatter)."""
    t = _index_tensor(i)
    t = torch.where(t < 0, t + size, t)
    if clamp:
        t = t.clamp(0, max(size - 1, 0))
    return t


def _gather_index(idx, shape):
    """The tensor index of a JAX gather: integer arrays wrapped and
    clamped along their axis, 0-d arrays in slices as their values."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    n_real = sum(p is not None and p is not Ellipsis for p in idx)
    out, axis = [], 0
    for part in idx:
        if part is Ellipsis:
            axis += len(shape) - n_real
        elif _is_int_index(part):
            part = _wrapped_index(part, shape[axis], True)
        elif isinstance(part, Array):
            raise IndexError("an array index here is an integer array")
        elif isinstance(part, slice):
            if part.step is not None and int(part.step) < 0:
                raise IndexError("a negative slice step is not carried here")
            part = slice(*[None if v is None else int(v)
                           for v in (part.start, part.stop, part.step)])
        out.append(part)
        axis += part is not None and part is not Ellipsis
    return tuple(out)


class _At:
    def __init__(self, arr):
        self.arr = arr

    def __getitem__(self, idx):
        return _Update(self.arr, idx)


class _Update:
    """``x.at[i]``: a scatter along the first axis into a copy of ``x``;
    indices out of range go to a spare row that is then cut off."""

    def __init__(self, arr, idx):
        self.arr, self.idx = arr, idx

    def _scatter(self, how: str, value):
        arr, idx = self.arr, self.idx
        dt, t = arr.dtype, arr.t
        n, rest = t.shape[0], tuple(t.shape[1:])
        if isinstance(idx, (int, np.integer)) and not isinstance(idx, bool):
            idx = torch.full((1,), int(idx), dtype=torch.int64,
                             device=_DEVICE)
        if not _is_int_index(idx):
            raise NotImplementedError(
                "only a scatter along the first axis by integer indices")
        i = _wrapped_index(idx, n, False)
        shape_i = tuple(i.shape)
        i = i.reshape(-1)
        i = torch.where((i >= 0) & (i < n), i, n)
        v = _operand(value, dt)
        v = _full((), v, dt) if not isinstance(v, torch.Tensor) else \
            _fit(v, dt)
        v = v.expand(shape_i + rest).reshape((-1,) + rest)
        ext = torch.empty((n + 1,) + rest, dtype=t.dtype, device=t.device)
        ext[:n] = t
        if how == "set":
            ext.index_put_((i,), v)
        elif how == "add":
            ext.index_put_((i,), v, accumulate=True)
            if dt == _U32:
                ext &= _MASK
        else:
            boolean = ext.dtype == torch.bool
            if boolean:
                ext, v = ext.to(torch.uint8), v.to(torch.uint8)
            ii = i.reshape((-1,) + (1,) * len(rest)).expand(v.shape)
            ext.scatter_reduce_(0, ii, v, reduce=how, include_self=True)
            if boolean:
                ext = ext != 0
        return Array(ext[:n], dt)

    def set(self, value, mode=None, **_):
        return self._scatter("set", value)

    def add(self, value, mode=None, **_):
        return self._scatter("add", value)

    def min(self, value, mode=None, **_):
        return self._scatter("amin", value)

    def max(self, value, mode=None, **_):
        return self._scatter("amax", value)


# ── jax.numpy ─────────────────────────────────────────────────────────


def asarray(x, dtype=None, copy=None):
    dt = _dtype(dtype)
    if isinstance(x, Array):
        return x if dt is None or dt == x.dtype else x.astype(dt)
    a = np.asarray(x)
    dt = dt or _narrow(a.dtype)
    return Array(_tensor(a, dt), dt)


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _reduce(fn, t: torch.Tensor, axis, keepdims, dt: np.dtype) -> Array:
    ax = _axis(axis)
    r = fn(t, dim=tuple(range(t.dim())) if ax is None else ax,
           keepdim=bool(keepdims))
    return Array(_fit(r, dt), dt)


def sum_(x, axis=None, dtype=None, keepdims=False, **_):
    x = _as_array(x)
    dt = _dtype(dtype) or (_I32 if x.dtype.kind == "b" else x.dtype)
    t = x.t.to(torch.int64) if x.dtype.kind in "bu" else \
        _convert(x.t, x.dtype, dt)
    return _reduce(torch.sum, t, axis, keepdims, dt)


def _minmax(fn):
    def red(x, axis=None, keepdims=False, **_):
        x = _as_array(x)
        t = x.t.to(torch.uint8) if x.dtype.kind == "b" else x.t
        return _reduce(fn, t, axis, keepdims, x.dtype)
    return red


max_ = _minmax(torch.amax)
min_ = _minmax(torch.amin)


def mean(x, axis=None, keepdims=False, **_):
    x = _as_array(x)
    return _reduce(torch.mean, _convert(x.t, x.dtype, _F32), axis, keepdims,
                   _F32)


def _logical(fn):
    def red(x, axis=None, keepdims=False, **_):
        x = _as_array(x)
        return _reduce(fn, _convert(x.t, x.dtype, _BOOL), axis, keepdims,
                       _BOOL)
    return red


any_ = _logical(torch.any)
all_ = _logical(torch.all)


def _argext(fn):
    def red(x, axis=None, **_):
        x = _as_array(x)
        t = x.t.to(torch.uint8) if x.dtype.kind == "b" else x.t
        r = fn(t) if axis is None else fn(t, dim=int(axis))
        return Array(r.to(torch.int32), _I32)
    return red


argmax = _argext(torch.argmax)
argmin = _argext(torch.argmin)


def _unary(fn, floating: bool = False):
    """An element-wise function; ``floating`` casts integers to float32
    first (NumPy's float64, narrowed)."""
    def call(x):
        x = _as_array(x)
        dt = _F32 if floating and x.dtype.kind in "biu" else x.dtype
        r = fn(_convert(x.t, x.dtype, dt))
        if r.dtype == torch.bool:
            return Array(r, _BOOL)
        return Array(_fit(r, dt), dt)
    return call


abs_ = _unary(torch.abs)
sqrt = _unary(torch.sqrt, True)
exp = _unary(torch.exp, True)
floor = _unary(torch.floor, True)
ceil = _unary(torch.ceil, True)
cos = _unary(torch.cos, True)
sin = _unary(torch.sin, True)
arcsin = _unary(torch.asin, True)
tanh = _unary(torch.tanh, True)
sign = _unary(torch.sign)
round_ = _unary(torch.round)
isfinite = _unary(torch.isfinite)
isinf = _unary(torch.isinf)


def _two(fn):
    """A function of two operands in their NumPy result type, narrowed."""
    def call(a, b):
        dt = _narrow(_wide(a, b))
        ta, tb = _operand(a, dt), _operand(b, dt)
        ta = ta if isinstance(ta, torch.Tensor) else _full((), ta, dt)
        tb = tb if isinstance(tb, torch.Tensor) else _full((), tb, dt)
        return Array(_fit(fn(ta, tb), dt), dt)
    return call


maximum = _two(torch.maximum)
minimum = _two(torch.minimum)
arctan2 = _two(torch.atan2)


def clip(x, min=None, max=None, a_min=None, a_max=None):
    lo = min if min is not None else a_min
    hi = max if max is not None else a_max
    out = _as_array(x)
    if lo is not None:
        out = maximum(out, lo)
    if hi is not None:
        out = minimum(out, hi)
    return out


def where(cond, x, y):
    dt = _narrow(_wide(x, y))
    c = _tensor(cond, _BOOL)
    tx, ty = _operand(x, dt), _operand(y, dt)
    if not isinstance(tx, torch.Tensor):
        tx = _full((), tx, dt)
    return Array(_fit(torch.where(c, tx, ty), dt), dt)


def _join(fn):
    def call(arrays, axis=0, dtype=None, **_):
        arrays = [a if isinstance(a, (Array, np.ndarray)) else np.asarray(a)
                  for a in arrays]
        dt = _dtype(dtype) or _narrow(_wide(*arrays))
        return Array(fn([_tensor(a, dt) for a in arrays], int(axis)), dt)
    return call


stack = _join(torch.stack)
concatenate = _join(torch.cat)


def _shape(shape):
    if isinstance(shape, (int, np.integer, Array)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def full(shape, fill_value, dtype=None, **_):
    dt = _dtype(dtype)
    if isinstance(fill_value, Array):
        dt = dt or fill_value.dtype
        return Array(_tensor(fill_value, dt).expand(_shape(shape)).clone(),
                     dt)
    dt = dt or _narrow(np.asarray(fill_value).dtype)
    return Array(_full(_shape(shape), fill_value, dt), dt)


def zeros(shape, dtype=None, **_):
    return full(shape, 0, dtype or _F32)


def ones(shape, dtype=None, **_):
    return full(shape, 1, dtype or _F32)


def full_like(x, fill_value, dtype=None, **_):
    x = _as_array(x)
    return full(x.shape, fill_value, dtype or x.dtype)


def zeros_like(x, dtype=None, **_):
    return full_like(x, 0, dtype)


def ones_like(x, dtype=None, **_):
    return full_like(x, 1, dtype)


def arange(*args, dtype=None, **_):
    args = [a.item() if isinstance(a, Array) else a for a in args]
    dt = _dtype(dtype)
    if all(isinstance(a, (int, np.integer)) for a in args):
        dt = dt or _I32
        t = torch.arange(*[int(a) for a in args], dtype=torch.int64,
                         device=_DEVICE)
        return Array(_convert(t, _I64, dt), dt)
    return asarray(np.arange(*args), dt)


def roll(x, shift, axis=None):
    x = _as_array(x)
    if axis is None:
        return Array(torch.roll(x.t.reshape(-1), int(shift)).reshape(
            x.t.shape), x.dtype)
    return Array(torch.roll(x.t, int(shift), int(axis)), x.dtype)


def _fill_of(dt: np.dtype):
    if dt.kind == "f":
        return float("nan")
    if dt == _U32:
        return _MASK
    if dt.kind in "iu":
        return int(np.iinfo(dt).min)
    return True


def take_along_axis(arr, indices, axis, mode=None, fill_value=None):
    arr = _as_array(arr)
    t, i = arr.t, _index_tensor(indices)
    ax = int(axis) % t.dim()
    size = t.shape[ax]
    i = torch.where(i < 0, i + size, i)
    # the other axes broadcast against each other
    other = torch.broadcast_shapes(
        *[tuple(1 if d == ax else s for d, s in enumerate(x.shape))
          for x in (t, i)])
    t = t.expand(tuple(size if d == ax else s for d, s in enumerate(other)))
    i = i.expand(tuple(i.shape[ax] if d == ax else s
                       for d, s in enumerate(other)))
    bad = (i < 0) | (i >= size)
    out = torch.gather(t, ax, i.clamp(0, max(size - 1, 0)))
    fill = _fill_of(arr.dtype) if fill_value is None else fill_value
    return Array(torch.where(bad, _full((), fill, arr.dtype), out),
                 arr.dtype)


def argsort(x, axis=-1, kind=None, stable=True, descending=False):
    x = _as_array(x)
    t = x.t
    if descending:
        key = ~t if t.dtype == torch.bool else -t
        r = torch.flip(torch.sort(key, dim=int(axis), stable=True).indices,
                       (int(axis),))
    else:
        r = torch.sort(t, dim=int(axis), stable=True).indices
    return Array(r.to(torch.int32), _I32)


def sort(x, axis=-1, **_):
    x = _as_array(x)
    t = x.t.to(torch.uint8) if x.dtype.kind == "b" else x.t
    r = torch.sort(t, dim=int(axis), stable=True).values
    return Array(r.to(x.t.dtype), x.dtype)


def choose(a, choices, mode="raise"):
    a = _as_array(a)
    choices = [c if isinstance(c, (Array, np.ndarray)) else np.asarray(c)
               for c in choices]
    dt = _narrow(_wide(*choices))
    ts = [_tensor(c, dt) for c in choices]
    shape = torch.broadcast_shapes(a.t.shape, *[t.shape for t in ts])
    stacked = torch.stack([t.expand(shape) for t in ts])
    i = a.t.to(torch.int64)
    k = len(ts)
    i = torch.remainder(i, k) if mode == "wrap" else i.clamp(0, k - 1)
    out = torch.gather(stacked, 0, i.expand(shape).unsqueeze(0))[0]
    return Array(out, dt)


def broadcast_to(x, shape):
    x = _as_array(x)
    return Array(x.t.expand(_shape(shape)), x.dtype)


def repeat(x, repeats, axis=None, **_):
    x = _as_array(x)
    t = x.t if axis is not None else x.t.reshape(-1)
    r = int(repeats) if np.ndim(repeats) == 0 else _index_tensor(repeats)
    return Array(torch.repeat_interleave(
        t, r, dim=0 if axis is None else int(axis)), x.dtype)


def pad(x, pad_width, mode="constant", constant_values=0, **_):
    if mode != "constant":
        raise NotImplementedError(f"pad mode {mode!r}")
    x = _as_array(x)
    pw = np.broadcast_to(np.asarray(pad_width, np.int64), (x.ndim, 2))
    flat = [int(v) for pair in reversed(pw.tolist()) for v in pair]
    return Array(torch.nn.functional.pad(x.t, flat, value=constant_values),
                 x.dtype)


def einsum(subscripts, *operands, **_):
    dt = _narrow(_wide(*operands))
    return Array(_fit(torch.einsum(subscripts,
                                   *[_tensor(o, dt) for o in operands]), dt),
                 dt)


def norm(x, ord=None, axis=None, keepdims=False):
    """The 2-norm: the square root of the sum of squares."""
    if ord is not None:
        raise NotImplementedError("a norm of another order")
    x = _as_array(x)
    t = _convert(x.t, x.dtype, _F32)
    return Array(torch.sqrt(_reduce(torch.sum, t * t, axis, keepdims,
                                    _F32).t), _F32)


jnp = types.SimpleNamespace(
    float32=_ScalarType(np.float32), int32=_ScalarType(np.int32),
    uint32=_ScalarType(np.uint32), bool_=_ScalarType(np.bool_),
    inf=float("inf"), pi=float(np.pi),
    iinfo=lambda t: np.iinfo(_dtype(t)),
    asarray=asarray, array=asarray, where=where, clip=clip,
    maximum=maximum, minimum=minimum, arctan2=arctan2, power=_pow,
    mod=_mod, abs=abs_, sqrt=sqrt, exp=exp, floor=floor, ceil=ceil,
    cos=cos, sin=sin, arcsin=arcsin, tanh=tanh, sign=sign, round=round_,
    isfinite=isfinite, isinf=isinf,
    sum=sum_, max=max_, min=min_, mean=mean, any=any_, all=all_,
    argmax=argmax, argmin=argmin, argsort=argsort, sort=sort,
    stack=stack, concatenate=concatenate, zeros=zeros, ones=ones,
    full=full, zeros_like=zeros_like, ones_like=ones_like,
    full_like=full_like, arange=arange, roll=roll,
    take_along_axis=take_along_axis, choose=choose,
    broadcast_to=broadcast_to, repeat=repeat, pad=pad, einsum=einsum,
    linalg=types.SimpleNamespace(norm=norm),
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
    return carry, _tree_map(lambda *vs: stack(list(vs)), *ys)


def cond(pred, true_fun, false_fun, *operands):
    return true_fun(*operands) if bool(pred) else false_fun(*operands)


def lax_map(f, xs):
    return scan(lambda c, x: (c, f(x)), None, xs)[1]


def slice_in_dim(x, start, limit, stride=1, axis=0):
    sl = [slice(None)] * x.ndim
    sl[int(axis)] = slice(int(start), int(limit), int(stride))
    return x[tuple(sl)]


def _segment(how: str, init):
    def seg(data, segment_ids, num_segments=None, **_):
        data = _as_array(data)
        ids = _index_tensor(segment_ids)
        n = int(num_segments)
        out = full((n,) + data.shape[1:], init(data.dtype), data.dtype)
        # a negative id is dropped, not wrapped
        return _Update(out, torch.where(ids < 0, n, ids))._scatter(how,
                                                                    data)
    return seg


def _lowest(dt):
    return -np.inf if dt.kind == "f" else (
        False if dt.kind == "b" else int(np.iinfo(dt).min))


def _highest(dt):
    return np.inf if dt.kind == "f" else (
        True if dt.kind == "b" else int(np.iinfo(dt).max))


lax = types.SimpleNamespace(
    while_loop=while_loop, fori_loop=fori_loop, scan=scan, cond=cond,
    map=lax_map, slice_in_dim=slice_in_dim)

ops = types.SimpleNamespace(
    segment_sum=_segment("add", lambda dt: 0),
    segment_max=_segment("amax", _lowest),
    segment_min=_segment("amin", _highest))


def _register_dataclass(cls=None, **_):
    return cls if cls is not None else (lambda c: c)


jax = types.SimpleNamespace(
    lax=lax, ops=ops, jit=jit, Array=Array,
    tree_util=types.SimpleNamespace(register_dataclass=_register_dataclass))
