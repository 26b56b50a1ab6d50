"""Multi-device scaling — a cells × seed split of the terrain step, the
port of the JAX package's ``parallel/sharding.py``.

The JAX package places each ``[N]``-leading array with a ``NamedSharding``
and XLA's SPMD partitioner inserts the collectives. The port's kernels
run whole loops in one launch over whole planes, so its split is explicit
(parallel/windows.py): windows with a halo of the largest band offset and
remainder slots, filled from their owners by an exchange.

The mesh is single-controller, as JAX's ``Mesh`` is: one process holds a
``seed`` × ``cells`` grid of ``torch.device``s. A device may appear more
than once, where the caller lists it so (``["cpu"] * 8`` in the tests,
``["cuda:0"] * 4`` on one card). Without ``devices`` the mesh takes the
visible CUDA devices.

- **Seeds** split over ``seed``: each seed group runs its seeds in turn
  (the JAX package ``vmap``s them; the port has no ``vmap`` over its
  hand-written kernels).
- **Cells** split over ``cells``: each seed's step is one run of the
  split runtime (parallel/spmd.py) over the row's window layout, every
  shard calling the unchanged :func:`terrain_step` on its window. Its
  neighbour reads exchange first, its pointer loops and global mean run
  on gathered whole arrays with the single-device call, so the split
  step equals the single-device step bit for bit on the same device
  type.

JAX's ``no_persistent_cache`` guards its compile cache, which the port
does not have. :func:`shard_fused_args` places the engine's arguments for
``PlanetEngine(mesh=)``, whose split generate runs the unchanged stages on
each shard's window through the same runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..erosion.fluvial import (flow_accumulation, steepest_receivers,
                               stream_power_solve)
from ..erosion.smooth import smooth_elevation
from ..erosion.thermal import thermal_step
from ..ops.banded import band_nbr_dist
from ..ops.noise import Tables, fbm
from . import spmd
from .windows import CellShards, WindowLayout, _norm_device


@dataclasses.dataclass(frozen=True, eq=False)
class CellsMesh:
    """A ``seed`` × ``cells`` grid of devices (``devices[r][c]``). It keeps
    the window layouts built on it, one per (seed row, graph)."""

    devices: tuple
    axis_names: tuple
    _layouts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return {"seed": len(self.devices), "cells": len(self.devices[0])}

    def layout(self, row: int, n_padded: int, band_off, rem_src=None,
               rem_dst=None) -> WindowLayout:
        """The window layout of seed row ``row`` for a graph of
        ``n_padded`` cells, built once per (row, graph tensors)."""
        key = (row, int(n_padded), tuple(int(o) for o in band_off),
               id(rem_src), id(rem_dst))
        hit = self._layouts.get(key)
        if hit is None:
            # the edge tensors stay referenced, so their ids stay theirs
            hit = (rem_src, rem_dst, WindowLayout(
                self.devices[row], n_padded, band_off,
                None if rem_src is None else _tensor(rem_src),
                None if rem_dst is None else _tensor(rem_dst)))
            self._layouts[key] = hit
        return hit[2]


def _devices(n_devices: Optional[int], devices: Optional[Sequence]) -> list:
    """``n_devices`` of ``devices`` (the visible CUDA devices by
    default). Asking for more than the list holds raises: the port takes
    no other backend in their place."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_norm_device(d) for d in devices]
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1 or len(devs) < n:
        raise ValueError(f"a mesh of {n} devices needs as many, got "
                         f"{len(devs)}: {[str(d) for d in devs]}")
    return devs[:n]


def make_planet_mesh(n_devices: Optional[int] = None, seed_parallel: int = 1,
                     devices: Optional[Sequence] = None) -> CellsMesh:
    """Device mesh with ('seed', 'cells') axes. ``seed_parallel`` rows run
    independent planets; each row splits the cell dimension. Where the JAX
    package falls back to the virtual CPU backend when the default backend
    has too few devices, this raises: a mesh never runs on a device its
    caller did not list. ``seed_parallel`` must divide ``n_devices``."""
    devs = _devices(n_devices, devices)
    sp = int(seed_parallel)
    if sp < 1 or len(devs) % sp:
        raise ValueError(f"seed_parallel {seed_parallel} does not divide "
                         f"{len(devs)} devices")
    per = len(devs) // sp
    grid = tuple(tuple(devs[r * per:(r + 1) * per]) for r in range(sp))
    return CellsMesh(grid, ("seed", "cells"))


def cells_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> CellsMesh:
    """One-row mesh with a single 'cells' axis: the split of one planet's
    cells over the devices (raises, as :func:`make_planet_mesh`, where
    the list is too short)."""
    return CellsMesh((tuple(_devices(n_devices, devices)),), ("cells",))


@dataclasses.dataclass
class MeshShards:
    """A value split over a whole mesh: one :class:`CellShards` per seed
    row, holding that row's seed group (``batched``) or a replica."""

    rows: tuple
    batched: bool


def _tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def shard_cells(mesh: CellsMesh, *arrays, batched: bool = False,
                bands=None):
    """Place [N] / [N, K] arrays (or [B, N, ...] when ``batched``) with the
    cell dimension split over the 'cells' axis (and the batch over 'seed';
    B must divide into the seed rows): a :class:`MeshShards` per array.
    ``bands`` = (band_off, band_mask, rem_src, rem_dst) gives the windows
    their halo and remainder slots (parallel/windows.py); without it each
    shard holds its chunk alone."""
    out = []
    for a in arrays:
        a = _tensor(a)
        axis = 1 if batched else 0
        rows = []
        for r in range(len(mesh.devices)):
            lay = _layout(mesh, r, a.shape[axis], bands)
            part = a
            if batched:
                if a.shape[0] % len(mesh.devices):
                    raise ValueError(f"a batch of {a.shape[0]} does not "
                                     f"split over {len(mesh.devices)} seed "
                                     "rows")
                part = a.chunk(len(mesh.devices), 0)[r]
            rows.append(CellShards(lay, lay.split(part, axis), axis))
        out.append(MeshShards(tuple(rows), batched))
    return out if len(out) > 1 else out[0]


def _layout(mesh, row, n_padded, bands):
    if bands is None:
        return mesh.layout(row, n_padded, ())
    band_off, _, rem_src, rem_dst = bands
    return mesh.layout(row, n_padded, band_off, rem_src, rem_dst)


def replicate(mesh: CellsMesh, *arrays):
    """Every device of the mesh holds the whole array: per array a tuple
    of one tensor per device (row-major), one copy per distinct device."""
    out = []
    for a in arrays:
        a = _tensor(a)
        copies = {}
        for d in (d for row in mesh.devices for d in row):
            if str(d) not in copies:
                copies[str(d)] = a.to(d)
        out.append(tuple(copies[str(d)] for row in mesh.devices for d in row))
    return out if len(out) > 1 else out[0]


def gather_cells(x, device=None):
    """The whole tensor of a split value, in cell (and seed) order, on
    ``device`` (the first shard's device by default)."""
    if isinstance(x, CellShards):
        return x.gather(device)
    if not x.batched:
        return x.rows[0].gather(device)
    dev = x.rows[0].layout.devices[0] if device is None else device
    return torch.cat([r.gather(dev) for r in x.rows], 0)


def shard_fused_args(mesh: CellsMesh, setup):
    """Place a ``PlanetSetup`` (pipeline/engine.py) on the mesh's first
    row of devices for the split generate, as the JAX ``shard_fused_args``
    places the fused program's arguments: every tensor with an ``[NP]``
    leading axis splits over ``cells`` (the graph becomes each shard's
    window graph, ``WindowLayout.window_graphs``), every other tensor is
    replicated onto each shard's device (plate and super-plate tables,
    hotspot domes, noise tables, the projection's coarse tables); host
    values are shared. Returns (the row's :class:`WindowLayout`, one
    setup per shard)."""
    g = setup.g
    lay = mesh.layout(0, g.n_padded, g.band_off, g.rem_src, g.rem_dst)
    graphs = lay.window_graphs(g)
    out = [dataclasses.replace(
        setup, g=graphs[c], domes=lay.place(setup.domes, c),
        noise_pack=lay.place(setup.noise_pack, c),
        warp_t=lay.place(setup.warp_t, c),
        projection=lay.place(setup.projection, c),
        plate_arrays=lay.place(setup.plate_arrays, c),
        super_arrays=lay.place(setup.super_arrays, c))
        for c in range(lay.n_shards)]
    return lay, out


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def terrain_step(elev, pos, band_mask, rem_src, rem_dst, valid, perm, pm12,
                 band_off):
    """One full terrain step — the framework's 'training step' analog: fbm
    tectonic forcing, then one composite erosion iteration with the
    production functions (banded steepest-receiver routing, flow
    accumulation and the Braun-Willett affine solve through the accumulate
    kernel on the card, talus thermal transport, bilateral smoothing),
    closed by a global mean correction. On the device of ``elev``;
    ``rem_src`` / ``rem_dst`` are the real remainder edges (DeviceGraph's),
    ``perm`` / ``pm12`` a [512] noise table pair. Mirrors one iteration of
    erodeComposite (reference js/terrain-post.js:369-707). Runs unchanged
    on a window of a cells split (parallel/spmd.py)."""
    dev = elev.device
    t = Tables(_tensor(perm).to(dev).long(), _tensor(pm12).to(dev).long())
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    uplift = fbm(t, x * 4, y * 4, z * 4, 4) * 0.05
    e = elev + torch.where(valid, uplift, 0.0)
    is_ocean = (e <= 0) & valid

    band_dist = band_nbr_dist(pos, band_off, band_mask)
    rem_dist = torch.linalg.vector_norm(pos[rem_src] - pos[rem_dst],
                                        dim=1).to(torch.float32)

    # hydraulic: route → accumulate → implicit stream-power solve
    rcv, dist, is_pit = steepest_receivers(
        e, is_ocean, valid, band_off, band_mask, band_dist, rem_src, rem_dst,
        rem_dist)
    e = spmd.gathered(_fluvial, e, is_ocean, valid, rcv, dist, is_pit)

    # thermal talus transport + ridge-preserving bilateral smooth
    e = thermal_step(e, is_ocean, valid, band_off, band_mask, band_dist,
                     rem_src, rem_dst, rem_dist, 0.8, 0.15)
    e = smooth_elevation(e, is_ocean, valid, band_off, band_mask, rem_src,
                         rem_dst, 1, _f32(0.3, dev))
    mean = spmd.gathered(_mean_land, e, valid)
    return (e - 0.01 * mean).to(torch.float32)


def _fluvial(e, is_ocean, valid, rcv, dist, is_pit):
    """Flow accumulation and the stream-power solve on whole arrays."""
    dev = e.device
    land = (~is_ocean) & valid
    flow = flow_accumulation(land, rcv, is_pit, rounds=12)
    return stream_power_solve(e, is_ocean, valid, rcv, dist, is_pit, flow,
                              _f32(3e-4, dev), _f32(0.5, dev),
                              _f32(1.0, dev), rounds=12)


def _mean_land(e, valid):
    """The global reduction: mean elevation over the valid cells."""
    return torch.sum(torch.where(valid, e, 0.0)) / torch.clamp(
        torch.sum(valid), min=1)


def _window_step(c, *args):
    """Shard ``c``'s :func:`terrain_step`, its halo and slots exchanged."""
    return spmd.fresh(terrain_step(*args))


def batched_terrain_step(mesh: CellsMesh, band_off: tuple):
    """:func:`terrain_step` over a seed batch on the ('seed', 'cells') mesh
    — the multi-chip 'training step' equivalent. Returns
    ``step(elev [B, NP], pos, band_mask, rem_src, rem_dst, valid,
    perm [B, 512], pm12 [B, 512])`` → a batched :class:`MeshShards`
    [B, NP] (seeds over 'seed', cells over 'cells', as JAX's
    ``out_shardings``). It places its arguments as JAX's ``in_shardings``
    do: elevation split over both axes, positions, band masks and validity
    over 'cells', the remainder edges replicated (they build the window
    layout), the noise tables over 'seed'. Each seed group runs its seeds
    in turn, each seed one :func:`spmd.run` over its row's windows."""
    band_off = tuple(int(o) for o in band_off)
    rows = len(mesh.devices)

    def step(elev, pos, band_mask, rem_src, rem_dst, valid, perm, pm12):
        elev, perm, pm12 = _tensor(elev), _tensor(perm), _tensor(pm12)
        b, npd = elev.shape
        if b % rows:
            raise ValueError(f"a batch of {b} does not split over {rows} "
                             "seed rows")
        per = b // rows
        bands = (band_off, None, rem_src, rem_dst)
        out = []
        for r in range(rows):
            lay = _layout(mesh, r, npd, bands)
            graph = list(zip(lay.split(_tensor(pos)),
                             lay.band_mask(_tensor(band_mask)), lay.edges(),
                             lay.split(_tensor(valid)), lay.devices))
            seeds = []
            for k in range(r * per, (r + 1) * per):
                args = [(e, p, m, *edges, v, perm[k].to(d), pm12[k].to(d),
                         band_off)
                        for e, (p, m, edges, v, d)
                        in zip(lay.split(elev[k]), graph)]
                seeds.append(spmd.run(lay, _window_step, args)[0])
            out.append(CellShards(lay, [torch.stack([s[c] for s in seeds])
                                        for c in range(lay.n_shards)], 1))
        return MeshShards(tuple(out), True)

    return step
