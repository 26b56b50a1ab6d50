"""Hand-written CUDA kernels for the banded neighbour sweeps and the
pointer-doubling sums, and their plain-torch versions.

Eight kernels (csrc/sweeps.cu), each running a whole loop in ONE
cooperative launch (grid barriers inside, loop count in device memory,
nothing read back to the host):

==============  ========================================================
``bfs_relax``   min-plus distance BFS to its fixpoint or cap
``stress``      gated argmax stress propagation with an sf payload
``warp``        nearest-candidate propagation of the terrain domain warp
``flood``       priority-flood ε-fill surface relaxation
``smooth``      Laplacian smoothing passes (plain, masked, frozen cells)
``shadow``      rain-shadow hops (wind-aligned weighted min / max)
``components``  min-label connected components: sweep, hook, two jumps
``accumulate``  pointer-doubling sums ``s ← s + Σ_{p[i]=t} s[i]``,
                ``p ← p[p]``, floats added in source order
==============  ========================================================

``bfs_relax``, ``flood_relax``, ``stress_relax``, ``warp_relax`` and
``components_relax`` run to their fixpoint or cap (device-side change
flag), ``shadow_relax`` its fixed number of hops, each returning ``(state,
sweeps)`` with ``sweeps`` an int32 [1] device tensor; ``smooth_relax``
runs a fixed number of passes and returns the state;
``accumulate_relax`` returns ``(s, rounds)`` and :func:`ordered_sum` is
its one-round form (the bin sums). One sweep of each relax loop exists
only as a plain version (``<name>_sweep_plain``), the step of the loops'
oracles.

Every sweep wrapper takes the state as [F, NP] float32 planes, the band
bits as one int32 word per cell (bit d = band d present, the packed form
of ``band_mask``) and the band offsets as a tuple. A wrapper given CPU
tensors runs the plain-torch version; given CUDA tensors it launches its
kernel (building the library on first use) or raises. There is no
fallback between the two.

The shared library is compiled with ``nvcc`` from ``csrc/sweeps.cu`` into
``_build/`` beside this package at first use, and rebuilt when the source
is newer than the library. ``LAUNCHES`` counts launches per kernel, and
:func:`sweeps_run` the sweeps (ε-fill: rounds; rain shadow: hops;
components: steps; accumulate: rounds) that the launches other than
smoothing ran; the plain versions never count.

Remainder edges (~0.5 % of edges off the bands) come as CSR rows of the
receiving cell in edge order (``rem_ptr`` int32 [NP+1], ``rem_nbr`` int32
[M], from ops/banded.py ``rem_csr``). The relax kernels walk them
in-kernel after the bands (a sum keeps the jnp order; a min or max is
order-free; stress keeps the jnp's tie rule); their plain versions walk
the same rows.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sweeps.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(_BUILD_DIR, "sweeps.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

LAUNCHES = {"bfs_relax": 0, "stress": 0, "warp": 0, "flood": 0,
            "smooth": 0, "shadow": 0, "components": 0, "accumulate": 0}
# ε-fill sweeps per barrier round on the staged chunk (BFS always runs 1)
FLOOD_INNER = 4

INF = float("inf")

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # state, ocean, bits, rem_ptr, rem_nbr, rem_gate, m, out, tmp, ctl,
    # total, np, ng, offs, n_offs, decay, sub_decay, cap, stream
    "stress_relax": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P,
                     _I, _F, _F, _I, _P],
    # state, w, bits, rem_ptr, rem_nbr, m, rcand, out, tmp, ctl, total, np,
    # offs, n_offs, cap, stream
    "warp_relax": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I,
                   _I, _P],
    # cur, cost, bits, rem_ptr, rem_nbr, m, out, tmp, ctl, total, np, nf,
    # offs, n_offs, cap, stream
    "bfs_relax": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I,
                  _I, _P],
    # surf, inland, elev_baked, bits, rem_ptr, rem_nbr, m, out, tmp, ctl,
    # total, np, offs, n_offs, big, eps, inner, stream
    "flood_relax": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I,
                    _F, _F, _I, _P],
    # field, c, gate, upd, bits, rem_ptr, rem_nbr, m, out, tmp, ctl, np,
    # nf, offs, n_offs, passes, stream
    "smooth_relax": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P,
                     _I, _I, _P],
    # state, aux, land, bits, rem_ptr, rem_nbr, m, out, tmp, ctl, total,
    # lands, wts, slots, np, offs, n_offs, retain_s, retain_w, shadow_hops,
    # windward_hops, stream
    "shadow_relax": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                     _I, _P, _I, _F, _F, _I, _I, _P],
    # lab, member, bits, rem_ptr, rem_nbr, m, out, nxt, hook, jmp, ctl,
    # total, np, offs, n_offs, stream
    "components_relax": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                         _P, _I, _P],
    # s, p, p64, k, n_out, nf, is_int, rounds, loop, stop_at_sink, out, tmp,
    # pbuf, cnt, offl, cur, list, vbuf, bsum, ctl, total, stream
    "accumulate": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                   _P, _P, _P, _P, _P, _P, _P, _P],
    # out [max_plans, PLAN_FIELDS] int32, max_plans
    "relax_plans": [_P, _I],
}


# per CUDA device: int32 [7] running sweep totals of the bfs / flood /
# stress / warp / rain-shadow / components / accumulate launches, added to
# by the kernels themselves
_SWEEP_TOTALS: dict = {}
_RELAX_SLOT = {"bfs_relax": 0, "flood": 1, "stress": 2, "warp": 3,
               "shadow": 4, "components": 5, "accumulate": 6}
# the most fields one smoothing launch carries (csrc kMaxSmoothFields)
SMOOTH_MAX_FIELDS = 4
# the most value columns one accumulate launch carries (csrc kMaxSumFields)
SUM_MAX_FIELDS = 4
# the chunk totals an accumulate launch keeps (csrc kMaxAccGrid)
ACC_MAX_GRID = 1024
# rain-shadow edge weights stored per land cell (the mesh degree is at
# most 8; a cell with more edges recomputes its weights every hop)
SHADOW_SLOTS = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for t in _SWEEP_TOTALS.values():
        t.zero_()


def sweeps_run() -> dict:
    """Sweeps (ε-fill: barrier rounds; rain shadow: hops; components:
    steps; accumulate: rounds) run by the launches other than smoothing
    since the last :func:`reset_launches`.
    Reads the device counters (a host sync): for measurement, never on the
    path."""
    out = {k: 0 for k in _RELAX_SLOT}
    for t in _SWEEP_TOTALS.values():
        for k, slot in _RELAX_SLOT.items():
            out[k] += int(t[slot])
    return out


# the staged kernels as csrc relax_plans() numbers them, and the fields of
# one plan row (csrc kPlanSlots plans at most)
PLAN_KERNELS = ("bfs_relax", "flood", "stress", "warp", "smooth", "shadow",
                "components")
PLAN_FIELDS = ("kernel", "np", "groups", "windows", "H", "T", "T_free",
               "grid", "smem_bytes")
PLAN_SLOTS = 32


def decode_plans(rows) -> list:
    """Plan dicts from relax_plans() rows: the kernel's name, NP, item
    groups, windows per item, H, T, T before the window cap (``T_free``),
    grid, dynamic shared bytes, and ``capped`` (the cap bound T)."""
    out = []
    for row in rows:
        plan = dict(zip(PLAN_FIELDS, (int(v) for v in row)))
        plan["kernel"] = PLAN_KERNELS[plan["kernel"]]
        plan["capped"] = plan["T"] < plan["T_free"]
        out.append(plan)
    return out


def relax_plans() -> list:
    """The staged kernels' cached launch plans (the last 32 shapes
    launched), read back from the library: for measurement, never on the
    path."""
    buf = (ctypes.c_int * (PLAN_SLOTS * len(PLAN_FIELDS)))()
    n = _kernel("relax_plans")(ctypes.cast(buf, ctypes.c_void_p), PLAN_SLOTS)
    k = len(PLAN_FIELDS)
    return decode_plans([buf[i * k:(i + 1) * k] for i in range(n)])


def _sweep_total(name: str, device):
    t = _SWEEP_TOTALS.get(device)
    if t is None:
        t = torch.zeros(len(_RELAX_SLOT), dtype=torch.int32,
                        device=device)
        _SWEEP_TOTALS[device] = t
    return t[_RELAX_SLOT[name]:]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA sweep kernels are built from "
        f"{SOURCE} with the CUDA toolkit")


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source. Returns nvcc's report (ptxas register/spill lines) when it
    compiled, "" when the library was up to date."""
    with _LOCK:
        if (os.path.exists(LIBRARY)
                and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
            return ""
        nvcc = _nvcc()
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, LIBRARY)
        return proc.stdout + proc.stderr


def _kernel(name: str):
    """The ctypes entry point ``name``, building and loading the library
    on first use. Raises when the toolkit or the library is unavailable."""
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        for fn, args in _ARGTYPES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return getattr(_LIB, name)


def _on_cpu(x) -> bool:
    """Route: True → plain version, False → CUDA kernel; other devices
    are refused."""
    kind = x.device.type
    if kind == "cpu":
        return True
    if kind == "cuda":
        return False
    raise ValueError(f"sweep kernels take cpu or cuda tensors, not {kind}")


def _check(bits, flag, *planes, bit_rows=None):
    """Raise unless a kernel can read its inputs safely: ``bits`` is a
    contiguous int32 [NP] ([bit_rows, NP] where given) with NP a multiple
    of 4, every (tensor, rows) of ``planes`` a contiguous, 16-byte aligned
    float32 [rows, NP] ([*rows, NP] for a tuple, [NP] where rows is None) on
    the same device (the staged kernels load planes as float4 words), and
    ``flag`` None or an int32 tensor there."""
    dev, npad = bits.device, bits.shape[-1]
    want_bits = (npad,) if bit_rows is None else (bit_rows, npad)
    if (bits.dtype != torch.int32 or tuple(bits.shape) != want_bits
            or not bits.is_contiguous()):
        raise ValueError(f"band bits must be a contiguous int32 {want_bits} "
                         "tensor")
    if npad % 4:
        raise ValueError(f"NP must be a multiple of 4, got {npad}")
    for t, rows in planes:
        want = ((npad,) if rows is None else (*rows, npad)
                if isinstance(rows, tuple) else (rows, npad))
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"sweep kernel input must be contiguous, 16-byte aligned "
                f"float32 {want} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if flag is not None and (flag.device != dev or flag.dtype != torch.int32
                             or flag.numel() < 1):
        raise ValueError("change flag must be an int32 tensor on the "
                         "inputs' device")


def _check_csr(bits, rem_ptr, rem_nbr, gate=None, gate_rows=None):
    """Raise unless the remainder CSR is contiguous int32 on the bits'
    device, ``rem_ptr`` [NP+1] and ``rem_nbr`` 1-D (the kernels clamp
    row bounds to [0, M] and skip columns outside [0, NP)), and ``gate``
    (where given) a contiguous uint8 [gate_rows, M] there."""
    dev, npad = bits.device, bits.shape[-1]
    for t, want in ((rem_ptr, (npad + 1,)), (rem_nbr, None)):
        if (t.device != dev or t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous()
                or (want is not None and tuple(t.shape) != want)):
            raise ValueError("remainder CSR must be contiguous int32 "
                             f"rem_ptr [{npad + 1}] and rem_nbr [M] on {dev}")
    if gate is not None:
        want = (gate_rows, rem_nbr.shape[0])
        if (gate.device != dev or gate.dtype != torch.uint8
                or tuple(gate.shape) != want or not gate.is_contiguous()):
            raise ValueError(f"remainder gate must be a contiguous uint8 "
                             f"{want} tensor on {dev}")


_OFFS_CACHE: dict = {}


def _offs(band_off) -> tuple:
    key = tuple(int(o) for o in band_off)
    arr = _OFFS_CACHE.get(key)
    if arr is None:
        if len(key) > 32:
            raise ValueError("at most 32 bands")
        arr = (ctypes.c_int * max(1, len(key)))(*key)
        _OFFS_CACHE[key] = arr
    return ctypes.cast(arr, ctypes.c_void_p), len(key)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(fn, counter: str, *args):
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")
    LAUNCHES[counter] += 1


def _bit(bits, d: int):
    return ((bits >> d) & 1).bool()


def _shift(x, off: int):
    """x[..., (i + off) mod NP] — jnp.roll semantics along the cell axis."""
    return torch.roll(x, -int(off), dims=-1)


def _or_flag(flag, changed) -> None:
    if flag is not None:
        flag |= changed.to(torch.int32)


# ── 1. BFS (one sweep, plain: the relax and components loops' step) ──

def bfs_sweep_plain(cur, cost, bits, band_off, flag=None):
    """One min-plus sweep over [F, NP] planes:
    ``out = min(cur, min_{bands set} cur[:, i+off] + cost)``."""
    best = torch.full_like(cur, float("inf"))
    for d, off in enumerate(band_off):
        best = torch.minimum(
            best, torch.where(_bit(bits, d), _shift(cur, off), float("inf")))
    out = torch.minimum(cur, best + cost)
    _or_flag(flag, (out != cur).any())
    return out


# ── 2. stress propagation ────────────────────────────────────────────

def stress_relax_plain(state, ocean, bits, band_off, rem_ptr, rem_nbr,
                       rem_gate, decay: float, sub_decay: float, cap: int):
    """The joint loop of :func:`stress_relax` in plain torch."""
    gate = rem_gate.bool()
    slots = list(_rem_slots(rem_ptr, rem_nbr))

    def step(x):
        st, sf, act = x[:, 0], x[:, 1], x[:, 2]
        prop = st * torch.where(sf > 0.5, sub_decay, decay)
        key = torch.where((act > 0) & (ocean <= 0) & (prop >= 0.005), prop,
                          float("-inf"))
        best = torch.full_like(st, float("-inf"))
        bsf = torch.zeros_like(sf)
        for d, off in enumerate(band_off):
            k = torch.where(_bit(bits, d), _shift(key, off), float("-inf"))
            u = k > best
            best = torch.where(u, k, best)
            bsf = torch.where(u, _shift(sf, off), bsf)
        w = torch.full_like(st, float("-inf"))
        wsf = torch.full_like(sf, float("-inf"))
        for has, e, j in slots:
            ok = has & gate[:, e]
            kj, sj = key[:, j], sf[:, j]
            gt = ok & (kj > w)
            tie = ok & (kj == w) & (sj > wsf)
            w = torch.where(gt, kj, w)
            wsf = torch.where(gt | tie, sj, wsf)
        u = w > best
        best = torch.where(u, w, best)
        bsf = torch.where(u, wsf, bsf)
        upd = best > st
        return torch.stack([torch.where(upd, best, st),
                            torch.where(upd, bsf, sf),
                            torch.where(upd, 1.0, act)], 1)

    return _relax_plain(step, state, int(cap))


def stress_relax(state, ocean, bits, band_off, rem_ptr, rem_nbr, rem_gate,
                 decay: float, sub_decay: float, cap: int):
    """G stress layers relaxed together, one Jacobi sweep of every layer a
    step, until no layer changed or ``cap`` sweeps ran (<= 0: no cap): the
    loop of ``_propagate_stress_jnp``. ``state`` [G, 3, NP] holds st, sf
    and act (0/1) per layer; ``ocean`` [G, NP] is 0/1, ``bits`` [G, NP]
    the band bits of each layer's gate and ``rem_gate`` [G, M] uint8 the
    remainder gates in CSR order (aligned with ``rem_nbr``). A cell sends
    ``st · (sf > 0.5 ? sub_decay : decay)`` where it is active, not ocean
    and that is >= 0.005. Per sweep a cell takes the first strict maximum
    over its gated band neighbours (band order), then the largest key over
    its gated remainder edges, the largest sf among the edges holding it,
    if that is larger; it adopts the result (sf riding along, act = 1) if
    it beats st. Returns (state, sweeps)."""
    if _on_cpu(state):
        return stress_relax_plain(state, ocean, bits, band_off, rem_ptr,
                                  rem_nbr, rem_gate, decay, sub_decay, cap)
    fn = _kernel("stress_relax")
    g = state.shape[0]
    _check(bits, None, (state, (g, 3)), (ocean, g), bit_rows=g)
    _check_csr(bits, rem_ptr, rem_nbr, rem_gate, g)
    out, tmp = torch.empty_like(state), torch.empty_like(state)
    ctl = torch.zeros(4, dtype=torch.int32, device=state.device)
    offs, nd = _offs(band_off)
    _launch(fn, "stress", _ptr(state), _ptr(ocean), _ptr(bits),
            _ptr(rem_ptr), _ptr(rem_nbr), _ptr(rem_gate), rem_nbr.shape[0],
            _ptr(out), _ptr(tmp), _ptr(ctl),
            _ptr(_sweep_total("stress", state.device)), bits.shape[1], g,
            offs, nd, float(decay), float(sub_decay), int(cap))
    return out, ctl[3:]


# ── 3. terrain warp ──────────────────────────────────────────────────

def dist2(p, w):
    """Squared distance of [3, N] points to [3, N] targets, summed x, y, z
    in that order (the kernel's order)."""
    d = p - w
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def warp_sweep_plain(state, w, bits, band_off, flag=None):
    best = dist2(state[1:4], w)
    out = state
    for d, off in enumerate(band_off):
        cand = _shift(state, off)
        cd = dist2(cand[1:4], w)
        u = _bit(bits, d) & (cd < best)
        best = torch.where(u, cd, best)
        out = torch.where(u, cand, out)
    _or_flag(flag, (out[0] != state[0]).any())
    return out.clone() if out is state else out


def warp_remainder_plain(new, w, rem_ptr, rem_nbr):
    """The remainder phase of a warp sweep on the band phase's output
    ``new``: per cell, ``wmin`` = the least ``dist2(new_j, w_i)`` over its
    remainder row and, among the edges at ``wmin`` with a finite distance,
    the largest value of each plane separately; the cell takes that pick
    where ``wmin < dist2(new_i, w_i)``. Returns (state, taken [NP] bool)."""
    rows = [(has, j, torch.where(has, dist2(new[1:4, j], w), INF))
            for has, j in _rem_rows(rem_ptr, rem_nbr)]
    wmin = torch.full_like(new[0], INF)
    for _, _, cd in rows:
        wmin = torch.minimum(wmin, cd)
    pick = torch.full_like(new, -INF)
    for has, j, cd in rows:
        win = has & (cd == wmin) & torch.isfinite(cd)
        pick = torch.where(win, torch.maximum(pick, new[:, j]), pick)
    taken = wmin < dist2(new[1:4], w)
    return torch.where(taken, pick, new), taken


def warp_relax_plain(state, w, bits, band_off, rem_ptr, rem_nbr, cap: int):
    """The loop of :func:`warp_relax` in plain torch."""
    sweeps = 0
    while sweeps < int(cap):
        new = warp_sweep_plain(state, w, bits, band_off)
        changed = bool((new[0] != state[0]).any())
        state, taken = warp_remainder_plain(new, w, rem_ptr, rem_nbr)
        sweeps += 1
        if not (changed or bool(taken.any())):
            break
    return state, torch.tensor([sweeps], dtype=torch.int32)


def warp_relax(state, w, bits, band_off, rem_ptr, rem_nbr, cap: int):
    """Nearest-candidate sweeps over the [4, NP] state (source index,
    source xyz) toward the [3, NP] targets ``w``, until a sweep changes
    nothing or ``cap`` sweeps ran (< 1: none). A sweep is the band phase
    (:func:`warp_sweep_plain`) and then the remainder phase
    (:func:`warp_remainder_plain`) on its output; it changed something when
    an index changed in the band phase or a cell took a remainder pick.
    Returns (state, sweeps)."""
    if _on_cpu(state):
        return warp_relax_plain(state, w, bits, band_off, rem_ptr, rem_nbr,
                                cap)
    fn = _kernel("warp_relax")
    _check(bits, None, (state, 4), (w, 3))
    _check_csr(bits, rem_ptr, rem_nbr)
    if int(cap) < 1:
        return state.clone(), torch.zeros(1, dtype=torch.int32,
                                          device=state.device)
    out, tmp = torch.empty_like(state), torch.empty_like(state)
    # each remainder edge's neighbour candidate, recomputed every sweep
    rcand = torch.empty((max(1, rem_nbr.shape[0]), 4), dtype=torch.float32,
                        device=state.device)
    ctl = torch.zeros(4, dtype=torch.int32, device=state.device)
    offs, nd = _offs(band_off)
    _launch(fn, "warp", _ptr(state), _ptr(w), _ptr(bits), _ptr(rem_ptr),
            _ptr(rem_nbr), rem_nbr.shape[0], _ptr(rcand), _ptr(out),
            _ptr(tmp), _ptr(ctl), _ptr(_sweep_total("warp", state.device)),
            state.shape[1], offs, nd, int(cap))
    return out, ctl[3:]


# ── 4. ε-fill (one sweep, plain: the relax loop's oracle) ──────────

def flood_sweep_plain(surf, inland, elev_baked, bits, band_off, big: float,
                      eps: float, flag=None):
    masked = torch.where(inland > 0, big, surf)
    best = torch.full_like(surf, float("inf"))
    for d, off in enumerate(band_off):
        best = torch.minimum(
            best, torch.where(_bit(bits, d), _shift(masked, off),
                              float("inf")))
    out = torch.minimum(surf, torch.maximum(elev_baked, best + eps))
    _or_flag(flag, (out != surf).any())
    return out


# ── remainder rows for the plain versions ───────────────────────────

def _rem_slots(rem_ptr, rem_nbr):
    """Yield (has, e, j) per slot of the CSR rows, in edge order: ``has``
    [NP] bool says whether a cell has an edge in this slot, ``e`` [NP]
    int64 is that edge's CSR index (clamped into [0, M) where it has
    none), ``j`` [NP] int64 its neighbour (0 where it has none)."""
    start, end = rem_ptr[:-1].long(), rem_ptr[1:].long()
    m = rem_nbr.shape[0]
    if m == 0:
        return
    nbr = rem_nbr.long()
    for k in range(int((end - start).max())):
        idx = start + k
        has = idx < end
        e = idx.clamp(max=m - 1)
        yield has, e, torch.where(has, nbr[e], 0)


def _rem_rows(rem_ptr, rem_nbr):
    """(has, j) of :func:`_rem_slots`."""
    for has, _, j in _rem_slots(rem_ptr, rem_nbr):
        yield has, j


def rem_min_plain(x, rem_ptr, rem_nbr):
    """Per cell, the min of ``x[..., j]`` over its remainder row (+inf
    where the row is empty); ``x`` is [NP] or [F, NP]."""
    best = torch.full_like(x, float("inf"))
    for has, j in _rem_rows(rem_ptr, rem_nbr):
        best = torch.where(has, torch.minimum(best, x[..., j]), best)
    return best


# ── relax loops: BFS and ε-fill to their fixpoint in one launch ──────

def _relax_plain(step, state, cap: int):
    """Run ``state = step(state)`` until a sweep changes nothing or ``cap``
    sweeps ran (cap <= 0: no cap). Returns (state, sweeps int32 [1])."""
    sweeps = 0
    while cap <= 0 or sweeps < cap:
        new = step(state)
        sweeps += 1
        done = torch.equal(new, state)
        state = new
        if done:
            break
    return state, torch.tensor([sweeps], dtype=torch.int32)


def bfs_relax_plain(cur, cost, bits, band_off, rem_ptr, rem_nbr, cap: int = 0):
    def step(x):
        out = bfs_sweep_plain(x, cost, bits, band_off)
        return torch.minimum(out, rem_min_plain(x, rem_ptr, rem_nbr) + cost)

    return _relax_plain(step, cur, int(cap))


def bfs_relax(cur, cost, bits, band_off, rem_ptr, rem_nbr, cap: int = 0):
    """Min-plus sweeps over [F, NP] planes, the remainder rows included,
    until a sweep changes nothing or ``cap`` sweeps ran (<= 0: no cap); each
    sweep is one Jacobi iteration of the jnp loop. Returns (state,
    sweeps)."""
    if _on_cpu(cur):
        return bfs_relax_plain(cur, cost, bits, band_off, rem_ptr, rem_nbr,
                               cap)
    fn = _kernel("bfs_relax")
    f = cur.shape[0] if cur.dim() == 2 else -1
    _check(bits, None, (cur, f), (cost, f))
    _check_csr(bits, rem_ptr, rem_nbr)
    out, tmp = torch.empty_like(cur), torch.empty_like(cur)
    ctl = torch.zeros(4, dtype=torch.int32, device=cur.device)
    offs, nd = _offs(band_off)
    _launch(fn, "bfs_relax", _ptr(cur), _ptr(cost), _ptr(bits),
            _ptr(rem_ptr), _ptr(rem_nbr), rem_nbr.shape[0], _ptr(out),
            _ptr(tmp), _ptr(ctl), _ptr(_sweep_total("bfs_relax", cur.device)),
            bits.shape[0], f, offs, nd, int(cap))
    return out, ctl[3:]


def flood_relax_plain(surf, inland, elev_baked, bits, band_off, rem_ptr,
                      rem_nbr, big: float, eps: float):
    """Jacobi sweeps to the fixpoint; the count returned is sweeps."""
    def step(x):
        out = flood_sweep_plain(x, inland, elev_baked, bits, band_off, big,
                                eps)
        rem = rem_min_plain(torch.where(inland > 0, big, x), rem_ptr,
                            rem_nbr)
        return torch.minimum(out, torch.maximum(elev_baked, rem + eps))

    return _relax_plain(step, surf, 0)


def flood_relax(surf, inland, elev_baked, bits, band_off, rem_ptr, rem_nbr,
                big: float, eps: float):
    """The ε-fill over the [NP] surface to its fixpoint, the remainder rows
    included. The kernel runs ``FLOOD_INNER`` sweeps on each staged chunk
    per barrier round; the fixpoint, and so the surface, is the Jacobi
    loop's. Returns (surface, rounds)."""
    return _flood_relax(surf, inland, elev_baked, bits, band_off, rem_ptr,
                        rem_nbr, big, eps, FLOOD_INNER)


def _flood_relax(surf, inland, elev_baked, bits, band_off, rem_ptr, rem_nbr,
                 big: float, eps: float, inner: int):
    """:func:`flood_relax` at ``inner`` sweeps per barrier round (the
    smoke script times other counts against ``FLOOD_INNER``)."""
    if _on_cpu(surf):
        return flood_relax_plain(surf, inland, elev_baked, bits, band_off,
                                 rem_ptr, rem_nbr, big, eps)
    fn = _kernel("flood_relax")
    _check(bits, None, (surf, None), (inland, None), (elev_baked, None))
    _check_csr(bits, rem_ptr, rem_nbr)
    if int(inner) < 1:
        raise ValueError("inner sweeps must be >= 1")
    out, tmp = torch.empty_like(surf), torch.empty_like(surf)
    ctl = torch.zeros(4, dtype=torch.int32, device=surf.device)
    offs, nd = _offs(band_off)
    _launch(fn, "flood", _ptr(surf), _ptr(inland), _ptr(elev_baked),
            _ptr(bits), _ptr(rem_ptr), _ptr(rem_nbr), rem_nbr.shape[0],
            _ptr(out), _ptr(tmp), _ptr(ctl),
            _ptr(_sweep_total("flood", surf.device)), surf.shape[0], offs, nd,
            float(big), float(eps), int(inner))
    return out, ctl[3:]


# ── 5. Laplacian smoothing ───────────────────────────────────────────

def smooth_sweep_plain(field, c, bits, band_off, rem_ptr, rem_nbr,
                       gate=None, upd=None):
    """One pass of :func:`smooth_relax`."""
    gate_b = None if gate is None else gate > 0
    s = torch.zeros_like(field)
    for d, off in enumerate(band_off):
        ok = _bit(bits, d)
        if gate_b is not None:
            ok = ok & _shift(gate_b, off)
        s = torch.where(ok, s + _shift(field, off), s)
    for has, j in _rem_rows(rem_ptr, rem_nbr):
        ok = has if gate_b is None else has & gate_b[j]
        s = torch.where(ok, s + field[:, j], s)
    out = (field + s) / c
    return out if upd is None else torch.where(upd > 0, out, field)


def smooth_relax_plain(field, c, bits, band_off, rem_ptr, rem_nbr,
                       passes: int, gate=None, upd=None):
    for _ in range(int(passes)):
        field = smooth_sweep_plain(field, c, bits, band_off, rem_ptr, rem_nbr,
                                   gate, upd)
    return field


def smooth_relax(field, c, bits, band_off, rem_ptr, rem_nbr, passes: int,
                 gate=None, upd=None):
    """``passes`` (>= 1) Laplacian passes over [F, NP] planes, each
    ``(f + Σ_nbr f) / c``, in one launch (F <= ``SMOOTH_MAX_FIELDS`` on
    the card). ``gate`` [NP] (0/1 f32): only neighbours with gate > 0
    contribute; ``upd`` [NP] (0/1 f32): only cells with upd > 0 update,
    the others pass through. ``c`` [NP] is 1 + the (gated) neighbour
    count. Returns the planes."""
    if int(passes) < 1:
        raise ValueError(f"smoothing takes at least one pass, got {passes}")
    if _on_cpu(field):
        return smooth_relax_plain(field, c, bits, band_off, rem_ptr, rem_nbr,
                                  passes, gate, upd)
    fn = _kernel("smooth_relax")
    f = field.shape[0]
    if field.dim() != 2 or not 1 <= f <= SMOOTH_MAX_FIELDS:
        raise ValueError(f"smoothing takes [F, NP] planes with 1 <= F <= "
                         f"{SMOOTH_MAX_FIELDS} on the card, got "
                         f"{tuple(field.shape)}")
    _check(bits, None, (field, f), (c, None),
           *((t, None) for t in (gate, upd) if t is not None))
    _check_csr(bits, rem_ptr, rem_nbr)
    out, tmp = torch.empty_like(field), torch.empty_like(field)
    ctl = torch.zeros(4, dtype=torch.int32, device=field.device)
    offs, nd = _offs(band_off)
    _launch(fn, "smooth", _ptr(field), _ptr(c), _ptr(gate), _ptr(upd),
            _ptr(bits), _ptr(rem_ptr), _ptr(rem_nbr), rem_nbr.shape[0],
            _ptr(out), _ptr(tmp), _ptr(ctl), bits.shape[0], f, offs, nd,
            int(passes))
    return out


# ── 6. rain-shadow hop ───────────────────────────────────────────────

def _dot3(a, b):
    """Σ_c a[c]·b[c] over [3, N] planes, x, y, z in that order."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def shadow_sweep_plain(state, aux, land, bits, band_off, rem_ptr, rem_nbr,
                       retain_s: float, retain_w: float):
    pos, wsi, wwi = aux[0:3], aux[3:6], aux[6:9]
    sgn = torch.tensor([-1.0, -1.0, 1.0, 1.0], device=state.device)[:, None]
    retain = torch.tensor([retain_s, retain_s, retain_w, retain_w],
                          dtype=torch.float32, device=state.device)[:, None]
    is_land = land > 0
    wsum = torch.zeros_like(state)
    wacc = torch.zeros_like(state)

    def visit(ok, a_j, vals):
        nonlocal wsum, wacc
        d = a_j[0:3] - pos
        nd = -d
        w = torch.stack([_dot3(a_j[3:6], nd), _dot3(a_j[6:9], nd),
                         _dot3(wsi, d), _dot3(wwi, d)])
        use = ok & is_land & (w > 0) & (vals * sgn > 0)
        wsum = torch.where(use, wsum + w, wsum)
        wacc = torch.where(use, wacc + w * vals, wacc)

    for d, off in enumerate(band_off):
        visit(_bit(bits, d), _shift(aux, off), _shift(state, off))
    for has, j in _rem_rows(rem_ptr, rem_nbr):
        visit(has, aux[:, j], state[:, j])
    carried = wacc / torch.clamp(wsum, min=1e-20) * retain
    ext = torch.where(sgn < 0, torch.minimum(state, carried),
                      torch.maximum(state, carried))
    return torch.where(wsum > 0, ext, state)


def shadow_relax_plain(state, aux, land, bits, band_off, rem_ptr, rem_nbr,
                       retain_s: float, retain_w: float, shadow_hops: int,
                       windward_hops: int):
    """The hops of :func:`shadow_relax` in plain torch."""
    windward = torch.tensor([False, False, True, True],
                            device=state.device)[:, None]
    hops = max(int(shadow_hops), int(windward_hops), 0)
    for i in range(hops):
        new = shadow_sweep_plain(state, aux, land, bits, band_off, rem_ptr,
                                 rem_nbr, retain_s, retain_w)
        if i >= windward_hops:
            new = torch.where(windward, state, new)
        if i >= shadow_hops:
            new = torch.where(windward, new, state)
        state = new
    return state, torch.tensor([hops], dtype=torch.int32)


def shadow_relax(state, aux, land, bits, band_off, rem_ptr, rem_nbr,
                 retain_s: float, retain_w: float, shadow_hops: int,
                 windward_hops: int):
    """``max(shadow_hops, windward_hops)`` rain-shadow hops over the
    [4, NP] state {shadow, windward} × {summer, winter} in one launch; hop
    i updates the shadow columns while i < ``shadow_hops`` and the windward
    columns while i < ``windward_hops``. ``aux`` [9, NP] holds position,
    summer wind and winter wind (xyz each), ``land`` [NP] 0/1 gates the
    receiving cell. The kernel computes each edge's wind weights on the
    first hop, stores them and reads them back on the others. Returns
    (state, hops), ``hops`` the count the kernel ran (int32 [1])."""
    if _on_cpu(state):
        return shadow_relax_plain(state, aux, land, bits, band_off, rem_ptr,
                                  rem_nbr, retain_s, retain_w, shadow_hops,
                                  windward_hops)
    fn = _kernel("shadow_relax")
    _check(bits, None, (state, 4), (aux, 9), (land, None))
    _check_csr(bits, rem_ptr, rem_nbr)
    if max(int(shadow_hops), int(windward_hops)) < 1:
        return state.clone(), torch.zeros(1, dtype=torch.int32,
                                          device=state.device)
    np_ = state.shape[1]
    out, tmp = torch.empty_like(state), torch.empty_like(state)
    ctl = torch.zeros(4, dtype=torch.int32, device=state.device)
    # the land cells as the first hop lists them, then their count
    lands = torch.zeros(np_ + 1, dtype=torch.int32, device=state.device)
    wts = torch.empty((SHADOW_SLOTS, np_, 4), dtype=torch.float32,
                      device=state.device)
    offs, nd = _offs(band_off)
    _launch(fn, "shadow", _ptr(state), _ptr(aux), _ptr(land), _ptr(bits),
            _ptr(rem_ptr), _ptr(rem_nbr), rem_nbr.shape[0], _ptr(out),
            _ptr(tmp), _ptr(ctl), _ptr(_sweep_total("shadow", state.device)),
            _ptr(lands), _ptr(wts), SHADOW_SLOTS,
            np_, offs, nd, float(retain_s), float(retain_w),
            int(shadow_hops), int(windward_hops))
    return out, ctl[3:]


# ── 7. connected components ─────────────────────────────────────────

def components_relax_plain(lab, member, bits, band_off, rem_ptr, rem_nbr):
    """The loop of :func:`components_relax` in plain torch."""
    n = lab.shape[0]
    zero = torch.zeros((1, n), dtype=torch.float32, device=lab.device)
    keep = None if member is None else member > 0
    members = None if keep is None else torch.nonzero(keep).flatten()
    prev, steps = lab, 0
    while True:
        new = bfs_sweep_plain(prev[None], zero, bits, band_off)[0]
        new = torch.minimum(new, rem_min_plain(prev, rem_ptr, rem_nbr))
        if members is None:
            new = new.scatter_reduce(0, prev.long(), new, "amin")
        else:
            new = new.scatter_reduce(0, prev[members].long(), new[members],
                                     "amin")
        for _ in range(2):
            jumped = new[new.long().clamp(0, n - 1)]
            new = jumped if keep is None else torch.where(keep, jumped, new)
        steps += 1
        done = torch.equal(new, prev)
        prev = new
        if done:
            break
    return prev, torch.tensor([steps], dtype=torch.int32)


def components_relax(lab, member, bits, band_off, rem_ptr, rem_nbr):
    """Min-label connected components over [NP] float32 cell-index labels
    (NP at non-members, exact below 2^24), until a step changes nothing.
    A step is one iteration of the JAX components loop: a min-label sweep
    over the gated band ``bits`` and the gated remainder edges (CSR rows of
    the receiving cell; ungated edges may follow past ``rem_ptr[NP]``),
    then hooking (each member mins its new label into its previous
    parent's slot), then two pointer jumps (``lab[clamp(lab, 0, NP-1)]``)
    of the members. ``member`` is a uint8 [NP] mask, or None when every
    cell is a member. Returns (labels, steps)."""
    if _on_cpu(lab):
        return components_relax_plain(lab, member, bits, band_off, rem_ptr,
                                      rem_nbr)
    fn = _kernel("components_relax")
    _check(bits, None, (lab, None))
    _check_csr(bits, rem_ptr, rem_nbr)
    if member is not None and (
            member.device != lab.device or member.dtype != torch.uint8
            or tuple(member.shape) != tuple(lab.shape)
            or not member.is_contiguous()):
        raise ValueError("components: member must be a contiguous uint8 "
                         f"{tuple(lab.shape)} tensor on {lab.device}")
    np_ = lab.shape[0]
    # out, then the sweep, hook and jump buffers
    buf = torch.empty((4, np_), dtype=torch.float32, device=lab.device)
    ctl = torch.zeros(4, dtype=torch.int32, device=lab.device)
    offs, nd = _offs(band_off)
    _launch(fn, "components", _ptr(lab), _ptr(member), _ptr(bits),
            _ptr(rem_ptr), _ptr(rem_nbr), rem_nbr.shape[0], _ptr(buf[0]),
            _ptr(buf[1]), _ptr(buf[2]), _ptr(buf[3]), _ptr(ctl),
            _ptr(_sweep_total("components", lab.device)), np_, offs, nd)
    return buf[0], ctl[3:]


# ── 8. pointer-doubling accumulate (replaces float scatter-adds) ──────

def ordered_sum_plain(n_out: int, idx, vals):
    """:func:`ordered_sum` in plain torch: ``index_add`` onto zeros, which
    adds in ascending source index on the CPU; every index at or past
    ``n_out`` goes to one spare slot that is cut off."""
    idx = idx.long()
    idx = torch.where(idx >= n_out, n_out, idx)
    out = torch.zeros((n_out + 1, *vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add(0, idx, vals)[:n_out]


def accumulate_relax_plain(s, p, rounds: int, stop_at_sink: bool = True):
    """The loop of :func:`accumulate_relax` in plain torch: the body of the
    JAX pointer-doubling loops, one :func:`ordered_sum_plain` a round
    (int32 counts: an ``index_add``, exact in any order)."""
    n = s.shape[0]
    p = p.long()
    ran = 0
    for r in range(int(rounds)):
        if not bool((p != n).any()) and (stop_at_sink or r > 0):
            break
        if s.dtype == torch.int32:
            added = torch.zeros(n + 1, dtype=torch.int32,
                                device=s.device).index_add(0, p, s)[:n]
        else:
            added = ordered_sum_plain(n, p, s)
        s = s + added
        p = torch.cat([p, p.new_tensor([n])])[p]
        ran += 1
    return s, torch.tensor([ran], dtype=torch.int32)


def _check_acc(s, p, k: int):
    """Raise unless the accumulate kernel can read its inputs: ``p`` a
    contiguous 1-D int32 or int64 tensor of ``k`` entries on the values'
    device, ``s`` a contiguous float32 [K] or [K, F] (F <=
    ``SUM_MAX_FIELDS``) or int32 [K], and K below 2^31 - 1."""
    if (p.dtype not in (torch.int32, torch.int64) or p.dim() != 1
            or p.shape[0] != k or p.device != s.device
            or not p.is_contiguous()):
        raise ValueError("accumulate: targets must be a contiguous 1-D int32 "
                         f"or int64 [{k}] tensor on {s.device}")
    floats = s.dtype == torch.float32 and (
        s.dim() == 1 or (s.dim() == 2 and 1 <= s.shape[1] <= SUM_MAX_FIELDS))
    counts = s.dtype == torch.int32 and s.dim() == 1
    if not (floats or counts) or not s.is_contiguous():
        raise ValueError(
            f"accumulate: values must be a contiguous float32 [K] or [K, F <= "
            f"{SUM_MAX_FIELDS}] or int32 [K] tensor, got {s.dtype} "
            f"{tuple(s.shape)}")
    if not 0 <= k < 2 ** 31 - 1:
        raise ValueError(f"accumulate: {k} entries out of range")


def _accumulate(fn, s, p, n_out: int, rounds: int, loop: bool,
                stop_at_sink: bool):
    """One launch ``fn`` of the accumulate kernel; returns (out, rounds)."""
    k = s.shape[0]
    nf = 1 if s.dim() == 1 else s.shape[1]
    counts = s.dtype == torch.int32
    dev = s.device
    out = torch.empty((n_out, *s.shape[1:]), dtype=s.dtype, device=dev)
    tmp = torch.empty_like(s) if loop else None
    # zeroed: the two count buffers (int: the sums), the cursors, ctl
    zeros = torch.zeros(3 * n_out + 4, dtype=torch.int32, device=dev)
    # row offsets, the rows, the chunk totals and the two pointer buffers
    work = torch.empty(n_out + 3 * k + ACC_MAX_GRID, dtype=torch.int32,
                       device=dev)
    cnt, cur, ctl = (zeros[:2 * n_out], zeros[2 * n_out:3 * n_out],
                     zeros[3 * n_out:])
    offl, lst = work[:n_out], work[n_out:n_out + k]
    pbuf, bsum = work[n_out + k:n_out + 3 * k], work[n_out + 3 * k:]
    # the long rows' values, each in its ranked slot
    vbuf = None if counts else torch.empty(k * nf, dtype=torch.float32,
                                           device=dev)
    _launch(fn, "accumulate", _ptr(s), _ptr(p), int(p.dtype == torch.int64),
            k, n_out, nf, int(counts), int(rounds), int(loop),
            int(stop_at_sink), _ptr(out), _ptr(tmp), _ptr(pbuf), _ptr(cnt),
            _ptr(offl), _ptr(cur), _ptr(lst), _ptr(vbuf), _ptr(bsum),
            _ptr(ctl), _ptr(_sweep_total("accumulate", dev)))
    return out, ctl[3:]


def accumulate_relax(s, p, rounds: int, stop_at_sink: bool = True):
    """The pointer-doubling loop over N cells with the sink at N: per round
    ``added[t]`` = the sum of ``s[i]`` over the i with ``p[i] == t`` (t <
    N, added from 0 in ascending i: the CPU ``index_add``'s order, so its
    bits), then ``s ← s + added`` and ``p ← p[p]`` (the sink maps to
    itself and is never summed). ``s`` is float32 [N] or [N, F] (F <=
    ``SUM_MAX_FIELDS`` on the card) or int32 [N] (counts, exact in any
    order); ``p`` int32 or int64 [N] in [0, N]. At most ``rounds`` rounds;
    the loop stops before a round in which no pointer is off the sink
    when ``stop_at_sink`` (the JAX loops' cond), and otherwise once a round
    has run (the later rounds would add +0.0 to values that hold no -0.0,
    changing nothing). On the card the whole loop is one launch with no
    host sync. Returns (s, rounds run)."""
    if _on_cpu(s):
        return accumulate_relax_plain(s, p, rounds, stop_at_sink)
    fn = _kernel("accumulate")
    _check_acc(s, p, s.shape[0])
    if s.shape[0] == 0:
        return s.clone(), torch.zeros(1, dtype=torch.int32, device=s.device)
    return _accumulate(fn, s, p, s.shape[0], max(int(rounds), 0), True,
                       stop_at_sink)


def _check_sum(n_out: int, idx, vals):
    """Raise unless the one-round sum can read its inputs: ``idx`` a 1-D
    int32 or int64 tensor of K entries on the values' device, ``vals`` a
    contiguous float32 [K] or [K, F] (F <= ``SUM_MAX_FIELDS``) and
    ``n_out`` in [0, 2^31 - 1)."""
    k = idx.shape[0] if idx.dim() == 1 else -1
    if (idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1
            or idx.device != vals.device):
        raise ValueError("ordered sum: idx must be a 1-D int32 or int64 "
                         f"tensor on {vals.device}")
    if (vals.dtype != torch.float32 or not vals.is_contiguous()
            or vals.shape[0] != k or vals.dim() not in (1, 2)
            or (vals.dim() == 2 and not 1 <= vals.shape[1] <= SUM_MAX_FIELDS)):
        raise ValueError(
            f"ordered sum: vals must be a contiguous float32 [{k}] or "
            f"[{k}, F <= {SUM_MAX_FIELDS}] tensor, got {vals.dtype} "
            f"{tuple(vals.shape)}")
    if not 0 <= int(n_out) < 2 ** 31 - 1:
        raise ValueError(f"ordered sum: n_out {n_out} out of range")


def ordered_sum(n_out: int, idx, vals):
    """``out[t]`` = the sum of ``vals[i]`` over the i with ``idx[i] == t``,
    added from 0 in ascending i, for t < ``n_out`` ([n_out] or [n_out, F]
    like ``vals``); entries with ``idx >= n_out`` are skipped. On the card:
    one round of the accumulate kernel (:func:`accumulate_relax`'s launch
    without the loop), so the sum has the CPU's bits and never walks the
    entries past ``n_out``."""
    if _on_cpu(vals):
        return ordered_sum_plain(n_out, idx, vals)
    fn = _kernel("accumulate")
    _check_sum(n_out, idx, vals)
    if int(n_out) == 0:
        return vals.new_zeros((0, *vals.shape[1:]))
    return _accumulate(fn, vals, idx.contiguous(), int(n_out), 1, False,
                       False)[0]
