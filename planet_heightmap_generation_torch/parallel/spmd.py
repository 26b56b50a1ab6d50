"""The split runtime of ``PlanetEngine(mesh=)``: one thread per shard, each
running the unchanged stage functions on its window, and the collectives
where the windows meet.

The JAX package splits its fused programs with a ``NamedSharding`` over
the ``cells`` axis and lets XLA's SPMD partitioner insert the halo
permutes, all-gathers and psums. The port has no partitioner, so the
split is written out at the primitive layer instead of in the stages:

- :func:`run` starts one thread per shard of a
  :class:`~.windows.WindowLayout`; each runs the same function on its own
  window graph and tensors (parallel/windows.py ``window_graphs``), under
  its card's device context. The shards take turns, one running at a
  time from one collective to the next (:class:`Split`).
- Every point where a window meets the others is a *collective*: every
  shard arrives with its value, one leader (shard 0) runs
  the list-form code of parallel/windows.py and parallel/loops.py on all
  windows at once, and every shard leaves with its part of the result:

  ========================  ============================================
  :func:`fresh`             the halo and slot rows exchanged (before a
                            neighbour read: ``band_shift``, remainder and
                            ``nbr_idx`` gathers)
  :func:`launch`            a kernel loop by its split route
                            (``loops.ROUTES``)
  :func:`gathered`          a call on gathered whole arrays, the same call
                            as the single path, its result split back
                            (label tables, sorts, pointer loops, float
                            sums over cells)
  :func:`flag_any`          a loop's stop, taken together
  ========================  ============================================

- :func:`arange`, :func:`total` and :func:`global_index` give the global
  cell indices, the global cell count and the global index of a window
  position, where the stages index by cell (:func:`window_index`: the
  indices for a kernel, None off a split).

Without a split (the single-device path) every one of these returns at
once: ``fresh(x)`` is ``x``, ``launch(name, f, *a)`` is ``f(*a)``,
``gathered(f, *a)`` is ``f(*a)``, ``arange`` is ``torch.arange``. The
stages' arithmetic exists once.

Every collective has a timeout (:data:`TIMEOUT`, or :func:`run`'s) and a
call-site tag: where a timeout runs out, two shards arrive
from different sites, or a shard fails, every shard raises
:class:`SplitError` naming the shards and their sites, and :func:`run`
re-raises the first shard's own error. A collective never hangs.

An exchange is memoised per tensor: a tensor exchanged and not written
since (its ``_version``) is not exchanged again, so a field read by 32
band shifts is exchanged once. Halo rows that no exchange has refreshed
hold stale values; chunk rows always hold the single path's values.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, Sequence

import torch

from ..pipeline import timing

# seconds a shard waits for its turn before the split raises
TIMEOUT = 300.0

_TLS = threading.local()


class SplitError(RuntimeError):
    """A collective of a split that could not complete: a timeout, shards
    at different call sites, or another shard's failure."""


@contextlib.contextmanager
def _suspended():
    """The calling thread off its split (the leader running list-form code
    on every window, or a gathered call on whole arrays)."""
    held = getattr(_TLS, "shard", None)
    _TLS.shard = None
    try:
        yield
    finally:
        _TLS.shard = held


class Split:
    """The shared state of one split run over ``layout``: the turn, the
    shards' deposited values, the leader's result, the exchange memo and
    the counters (``stats``; ``leader_s`` the host seconds the leader spent
    in each kind of collective).

    The shards take turns: one thread runs at a time, shard c from one
    collective to the next, then shard c + 1; after the last shard has
    deposited its value the leader (shard 0) runs the collective and
    goes on. So the threads never contend for the interpreter (four
    threads issuing small torch ops at once ran the split generate 2.9×
    slower on one H100 than in turn), and the host work is the shards'
    work in sequence."""

    def __init__(self, layout, timeout: float):
        self.layout = layout
        self.n = layout.n_shards
        self.timeout = float(timeout)
        self._cond = threading.Condition()
        self._turn = 0
        self._broken = None
        self.timed_out = None        # the timeout that broke the split
        self._slots = [None] * self.n
        self._sites = ["start"] * self.n
        self._out = None
        self._memo = [dict() for _ in range(self.n)]
        self.stats = dict(collectives=0, exchanges=0, launches=0,
                          gathered_calls=0, gathered_bytes=0, leader_s={})

    # ── the turn ─────────────────────────────────────────────────────
    def _where(self) -> str:
        return ", ".join(f"shard {i} at {s!r}"
                         for i, s in enumerate(self._sites))

    def wait_turn(self, c: int, site: str) -> None:
        """Block until it is shard ``c``'s turn; raise :class:`SplitError`
        after ``timeout`` seconds or once the split is broken."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._turn == c or self._broken is not None,
                self.timeout)
            if self._broken is not None:
                raise SplitError(f"split collective {site!r} on shard {c}: "
                                 f"{self._broken}; shards at: "
                                 f"{self._where()}")
            if not ok:
                self._broken = (f"shard {c} waited more than "
                                f"{self.timeout:g} s at {site!r}")
                self.timed_out = SplitError(
                    f"split collective {site!r} on shard {c} did not "
                    f"complete within {self.timeout:g} s; shards at: "
                    f"{self._where()}")
                self._cond.notify_all()
                raise self.timed_out

    def pass_turn(self, c: int) -> None:
        """Shard ``c`` hands the turn to the next shard."""
        with self._cond:
            self._turn = (c + 1) % self.n
            self._cond.notify_all()

    def abort(self, reason: str) -> None:
        """Break the split (a shard failed): every waiting shard raises."""
        with self._cond:
            if self._broken is None:
                self._broken = reason
            self._cond.notify_all()

    # ── the collective ───────────────────────────────────────────────
    def collective(self, c: int, site: str, value, leader: Callable):
        """Deposit ``value`` at ``site`` and hand on the turn; once every
        shard has deposited, the leader runs ``leader(values)`` (a list,
        one per shard, in shard order) off the split, which returns one
        result per shard; shard ``c`` gets its own when its turn comes
        back."""
        self._sites[c] = site
        self._slots[c] = value
        self.pass_turn(c)
        self.wait_turn(c, site)
        if c == 0:
            try:
                if len(set(self._sites)) != 1:
                    raise SplitError("split shards diverged: "
                                     + self._where())
                t0 = time.perf_counter()
                with _suspended():
                    self._out = (True, leader(list(self._slots)))
                self.stats["collectives"] += 1
                kind = site.split("[")[0]
                spent = self.stats["leader_s"]
                spent[kind] = spent.get(kind, 0.0) + time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 — every shard raises
                self._out = (False, e)
        ok, res = self._out
        if not ok:
            if c == 0:
                raise res
            raise SplitError(f"split collective {site!r} failed on the "
                             f"leader: {res!r}") from res
        return res[c]

    # ── exchanges ────────────────────────────────────────────────────
    def fresh(self, c: int, x, axis: int):
        axis = axis % x.dim()
        key = (id(x), axis)
        hit = self._memo[c].get(key)
        if hit is not None and hit[0]() is x and hit[1] == x._version:
            return x

        def leader(wins):
            self.layout.exchange(wins, axis)
            self.stats["exchanges"] += 1
            return [None] * self.n

        self.collective(c, f"exchange[{x.dtype}, axis {axis}]", x, leader)
        memo = self._memo[c]
        memo[key] = (weakref.ref(x, lambda _, k=key: memo.pop(k, None)),
                     x._version)
        return x

    # ── gathered calls ───────────────────────────────────────────────
    def gathered(self, c: int, fn: Callable, cells: Sequence, kw: dict):
        lay = self.layout

        def leader(vals):
            whole = [lay.gather([v[i] for v in vals])
                     if torch.is_tensor(x) else x
                     for i, x in enumerate(vals[0])]
            nbytes = sum(w.numel() * w.element_size() for w in whole
                         if torch.is_tensor(w))
            out = fn(*whole, **kw)
            parts = [lay.place(out, s) for s in range(self.n)]
            nbytes += _nbytes(out)
            self.stats["gathered_calls"] += 1
            self.stats["gathered_bytes"] += nbytes
            return parts

        name = getattr(fn, "__qualname__", type(fn).__name__)
        return self.collective(c, f"gathered {name}", tuple(cells), leader)

    # ── kernel routes and stops ──────────────────────────────────────
    def launch(self, c: int, name: str, args: tuple):
        from . import loops

        route = loops.ROUTES[name]

        def leader(vals):
            self.stats["launches"] += 1
            return route(self.layout, vals)

        return self.collective(c, f"launch {name}", args, leader)

    def flag_any(self, c: int, flag) -> bool:
        dev = self.layout.devices[0]
        return self.collective(
            c, "flag", flag,
            lambda fl: [bool(torch.stack([f.reshape(()).to(dev)
                                          for f in fl]).any())] * self.n)

    def index(self, c: int):
        """The global cell index of each position of shard ``c``'s window."""
        return self.layout._t(c, "index")


def _nbytes(out) -> int:
    if torch.is_tensor(out):
        return out.numel() * out.element_size()
    if isinstance(out, (tuple, list)):
        return sum(_nbytes(o) for o in out)
    if isinstance(out, dict):
        return sum(_nbytes(o) for o in out.values())
    return 0


# ── the primitives (each a no-op off a split) ────────────────────────────

def fresh(x, axis: int = 0):
    """``x`` with its halo and slot rows holding their owners' values along
    the cell ``axis`` (an exchange, in place, unless ``x`` was exchanged
    and not written since); ``x`` itself off a split."""
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        return x
    return sh[0].fresh(sh[1], x, axis)


def launch(name: str, single: Callable, *args):
    """``single(*args)`` (a kernel wrapper of ops/sweep_cuda.py); on a
    split, the loop ``name`` by its split route over every shard's
    arguments (``loops.ROUTES[name]``), with the single call's result
    form."""
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        return single(*args)
    return sh[0].launch(sh[1], name, args)


def gathered(fn: Callable, *cells, **kw):
    """``fn(*cells, **kw)``; on a split, ``fn`` runs once, on the leader's
    device, over the whole ``cells`` tensors gathered from every shard's
    chunk rows (None and non-tensor values pass as the leader's), and each
    shard gets the result's ``[NP]``-leading tensors as its window and
    every other value whole. ``kw`` are the leader's."""
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        return fn(*cells, **kw)
    return sh[0].gathered(sh[1], fn, cells, kw)


def flag_any(flag) -> bool:
    """Whether the change flag (an int [1] device tensor, or a loop's bool
    stop test) is set: one host read; on a split, whether any shard's is.
    Each call counts one read on the calling thread's current timer
    (pipeline/timing.py)."""
    timing.count_read()
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        return int(flag.item()) != 0
    return sh[0].flag_any(sh[1], flag)


def arange(n: int, dtype=torch.int64, device=None):
    """``torch.arange(n)``, the cells' indices; on a split, the global
    index of each window position (``n`` is the window's length)."""
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        return torch.arange(n, dtype=dtype, device=device)
    idx = sh[0].index(sh[1])
    if idx.shape[0] != n:
        raise ValueError(f"split arange: {n} rows, the window has "
                         f"{idx.shape[0]}")
    return idx.to(dtype=dtype, device=device)


def window_index(n: int, device=None):
    """On a split, the global cell index (int32) of each position of the
    window (``n`` its length), as :func:`arange` gives it; None off a
    split, where each position is its own index."""
    if getattr(_TLS, "shard", None) is None:
        return None
    return arange(n, torch.int32, device)


def total(n: int) -> int:
    """The cell count ``n``; on a split, the whole planet's padded count
    (``n`` is the window's length): the sink and non-member label."""
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        return n
    return sh[0].layout.n_padded


def global_index(idx):
    """Window positions ``idx`` as global cell indices (int64); ``idx``
    itself off a split."""
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        return idx
    return sh[0].index(sh[1])[idx.long()]


def run(layout, fn: Callable, shard_args: Sequence, timeout=None):
    """Run ``fn(c, *shard_args[c])`` on one thread per shard of ``layout``,
    each under its device's context with the split active; a collective
    waits at most ``timeout`` seconds (default :data:`TIMEOUT`). Returns
    (results in shard order, the split's ``stats``). A shard's error is
    re-raised here after every thread has ended (the others leave their
    collectives through :class:`SplitError`); where none failed of its
    own, the timeout that broke the split, whichever shard's thread it
    ended first."""
    split = Split(layout, TIMEOUT if timeout is None else timeout)
    n = split.n
    results, errors = [None] * n, [None] * n

    def body(c):
        _TLS.shard = (split, c)
        dev = layout.devices[c]
        try:
            split.wait_turn(c, "start")
            ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                results[c] = fn(c, *shard_args[c])
                split.collective(c, "end", None, lambda v: [None] * n)
            split.pass_turn(c)
        except BaseException as e:  # noqa: BLE001 — re-raised by run
            errors[c] = e
            split.abort(f"shard {c} failed: {e!r}")
        finally:
            _TLS.shard = None

    threads = [threading.Thread(target=body, args=(c,), daemon=True,
                                name=f"split-shard-{c}") for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = ([e for e in errors if e is not None
              and not isinstance(e, SplitError)]
             or [e for e in (split.timed_out,) if e is not None]
             or [e for e in errors if e is not None])
    if first:
        raise first[0]
    return results, split.stats
