"""The planet engine — a retained-state worker on a CUDA device.

Commands (the worker protocol's five, js/planet-worker.js:944-954):
``generate``, ``reapply``, ``edit_recompute``, ``compute_climate`` and
``import_heightmap``. State is retained between commands (mesh, pre-post
elevation, plates, cached wind and ocean) so a recompute resumes
mid-pipeline; ``save_session`` / ``load_session`` put that state on disk
in the JAX package's npz format, so a session written by either package
loads in the other.

One eager path: host prologue (mesh, coarse tectonics, super plates,
hotspot domes, noise tables) in numpy and native C++, then plate
projection → smoothing and reconnection → elevation → erosion → climate
(coast fields, wind, ocean currents, precipitation, temperature, Köppen)
in torch, with the banded sweep loops in the CUDA kernels of
ops/sweep_cuda.py. Climate runs when ``skip_climate`` is False, or None
at ≤ ``AUTO_CLIMATE_THRESHOLD`` cells, as in the reference. ``generate``
and ``reapply`` catch an exception of the climate stack into
``PlanetResult.error`` and return the terrain; the other commands let it
propagate, as the JAX engine does.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
import traceback
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import GenerationParams, AUTO_CLIMATE_THRESHOLD
from ..mesh.build import SphereGraph, build_sphere, mesh_threads
from ..mesh.device import DeviceGraph, to_device
from ..ops.rng import ParkMiller
from ..ops.noise import make_perm_tables, tables, tables_from_numpy
from ..ops.graph import majority_smooth
from ..ops.banded import connected_components_gated, flood_assign_banded
from ..tectonics.coarse import (CoarsePlates, generate_coarse_plates,
                                assign_plate_densities, project_kernel,
                                project_points_host, projection_from_numpy,
                                projection_host)
from ..tectonics.plates import PlateSet
from ..tectonics.super_plates import build_super_plates
from ..elevation.assemble import assign_elevation, ELEVATION_TABLE_OFFSETS
from ..elevation.hotspots import build_domes
from ..erosion.composite import run_post_processing
from ..climate import (compute_wind, compute_ocean_currents,
                       compute_precipitation, compute_temperature,
                       classify_koppen)
from ..climate.wind import climate_coast_fields
from ..parallel import spmd
from . import timing
from .timing import StageTimer

MAX_SUPER = 32
# Above this many cells the JAX engine leaves its fused program for the
# staged one, which it never splits (JAX pipeline/engine.py:167); the
# port's generate splits over a mesh only at or below it, as JAX does.
FUSED_MAX_CELLS = 3_000_000


@dataclasses.dataclass
class PlanetResult:
    """The 'done' message equivalent (js/planet-worker.js:299-325)."""

    graph: SphereGraph
    params: GenerationParams
    r_plate: torch.Tensor
    plate_seeds: np.ndarray
    plate_is_ocean: np.ndarray
    plate_density: np.ndarray
    pre_post_elevation: torch.Tensor
    elevation: torch.Tensor
    t_elevation: torch.Tensor
    stress: torch.Tensor
    mountain_mask: torch.Tensor
    coastline_mask: torch.Tensor
    ocean_seed_mask: torch.Tensor
    climate: Optional[Dict]
    debug: Dict
    timing: StageTimer
    # degraded result (js/generate.js:246-308): a later stage failed but
    # the terrain is usable — dict(stage=..., message=..., stack=...)
    error: Optional[Dict] = None

    def _elev_np(self) -> np.ndarray:
        e = self.elevation[: self.graph.n_cells]
        # a lean batch result (parallel/batch.py) keeps numpy elevation
        return e.cpu().numpy() if torch.is_tensor(e) else np.asarray(e)

    @property
    def land_fraction(self) -> float:
        return float((self._elev_np() > 0).mean())

    def diagnostics(self) -> Dict:
        """NaN / land-fraction checks (js/generate.js:317-330)."""
        e = self._elev_np()
        return dict(
            nan_count=int(np.isnan(e).sum()),
            land_fraction=float((e > 0).mean()),
            min=float(np.nanmin(e)), max=float(np.nanmax(e)),
        )


def smooth_and_reconnect(g: DeviceGraph, r_plate, num_p: int,
                         num_passes: int = 3):
    """Hi-res plate smoothing + reconnection (the reference runs
    smoothAndReconnectPlates on the projected map, js/planet-worker.js:173):
    majority smoothing, then every plate keeps its largest connected piece
    (ties toward the smallest component label) and the other pieces are
    flood-assigned from their neighbours."""
    n = g.n_padded
    protect = torch.zeros(n, dtype=torch.bool, device=g.device)
    r_plate = majority_smooth(r_plate, g.nbr_idx, g.nbr_mask, protect,
                              num_passes=num_passes)

    labels = connected_components_gated(r_plate, *g.bands).long()
    in_main = spmd.gathered(_largest_pieces, labels, r_plate, g.valid,
                            num_p=num_p)
    val, _ = flood_assign_banded(r_plate.to(torch.int32), in_main, *g.bands)
    return torch.where(g.valid, val, r_plate).to(torch.int32)


def _largest_pieces(labels, r_plate, valid, num_p: int):
    """The cells of each plate's largest connected piece (component
    labels are cell indices; ties toward the smallest label)."""
    n = labels.shape[0]
    rp = r_plate.long()
    sizes = torch.zeros(n, dtype=torch.int64, device=labels.device).index_add(
        0, labels, valid.to(torch.int64))
    comp_size = sizes[labels]
    imin = torch.iinfo(torch.int64).min
    max_per_plate = torch.full((num_p,), imin, dtype=torch.int64,
                               device=labels.device).scatter_reduce(
        0, rp, torch.where(valid, comp_size, 0), "amax")
    is_max = comp_size == max_per_plate[rp]
    min_tied = torch.full((num_p,), torch.iinfo(torch.int64).max,
                          dtype=torch.int64,
                          device=labels.device).scatter_reduce(
        0, rp, torch.where(is_max & valid, labels, n), "amin")
    return is_max & (labels == min_tied[rp]) & valid


@dataclasses.dataclass
class PlanetSetup:
    """Everything the device pipeline needs, built on host for one seed."""

    params: GenerationParams
    graph: SphereGraph
    g: DeviceGraph
    coarse: CoarsePlates
    plates: PlateSet
    original_is_ocean: np.ndarray
    super_sp: object
    domes: Dict[str, torch.Tensor]
    noise_pack: Dict
    warp_t: object
    projection: tuple
    plate_arrays: tuple
    super_arrays: Optional[tuple]


def plate_arrays(plates, device):
    """(is_ocean, pole, omega, density) of the plates as tensors."""
    return (torch.as_tensor(plates.is_ocean, device=device),
            torch.as_tensor(plates.pole.astype(np.float32), device=device),
            torch.as_tensor(plates.omega.astype(np.float32), device=device),
            torch.as_tensor(plates.density.astype(np.float32), device=device))


def super_arrays(super_sp, device, max_super: int = MAX_SUPER):
    """(plate_to_super, is_ocean, pole, omega, density) of the super
    plates, padded to ``max_super`` inert rows (zero angular velocity,
    mapped to by no plate); None without super plates."""
    if super_sp is None:
        return None
    so = super_sp.is_ocean
    spo = super_sp.pole.astype(np.float32)
    som = super_sp.omega.astype(np.float32)
    sd = super_sp.density.astype(np.float32)
    pad = max_super - len(so)
    if pad > 0:
        so = np.concatenate([so, np.zeros(pad, bool)])
        spo = np.concatenate(
            [spo, np.tile([[0.0, 1.0, 0.0]], (pad, 1))]).astype(np.float32)
        som = np.concatenate([som, np.zeros(pad, np.float32)])
        sd = np.concatenate([sd, np.full(pad, 2.7, np.float32)])
    return tuple(torch.as_tensor(a, device=device) for a in (
        super_sp.plate_to_super.astype(np.int32), so, spo, som, sd))


def host_prologue_np(graph: SphereGraph, coarse: CoarsePlates, plates,
                     seed: int, num_plates: int):
    """The seed's dome and noise half of the prologue on the host: hotspot
    domes (plate lookup through the host coarse-grid projection), the
    elevation noise tables and the warp tables, as numpy. Returns (domes,
    elevation tables, warp tables); the tables as (perm, pm12) pairs."""
    def plate_of(center: int) -> int:
        return int(project_points_host(
            coarse, seed, num_plates, graph.pos[center])[0])

    domes = build_domes(seed, graph.pos, plate_of, plates.pole,
                        plates.omega, plates.is_ocean, graph.n_cells)
    elev_t = {k: make_perm_tables(seed + o)
              for k, o in ELEVATION_TABLE_OFFSETS.items()}
    return domes, elev_t, make_perm_tables(seed + 9999)


def upload_prologue(prologue, device):
    """:func:`host_prologue_np`'s arrays as tensors on ``device``.
    Returns (domes, noise_pack, warp_t)."""
    domes, elev_t, warp_t = prologue
    return ({k: torch.as_tensor(v, device=device) for k, v in domes.items()},
            {k: tables_from_numpy(*v, device) for k, v in elev_t.items()},
            tables_from_numpy(*warp_t, device))


def host_prologue(graph: SphereGraph, coarse: CoarsePlates, plates, seed: int,
                  num_plates: int, device):
    """:func:`host_prologue_np` uploaded to ``device``. Returns (domes,
    noise_pack, warp_t)."""
    return upload_prologue(
        host_prologue_np(graph, coarse, plates, seed, num_plates), device)


@dataclasses.dataclass
class HostProducts:
    """The host half of one seed's prologue after the mesh, numpy only:
    the coarse tectonics (toggles applied), super plates, the dome and
    noise arrays (:func:`host_prologue_np`) and the projection inputs
    (``projection_host``)."""

    coarse: CoarsePlates
    plates: PlateSet
    original_is_ocean: np.ndarray
    super_sp: object
    prologue: tuple
    projection: tuple


def host_products(params: GenerationParams, graph: SphereGraph,
                  timer: StageTimer) -> HostProducts:
    """Coarse tectonics, super plates, hotspot domes and noise tables on
    the host; touches no device."""
    seed = params.seed
    with timer.stage("Coarse plates"):
        coarse = generate_coarse_plates(
            seed, params.n_plates, params.num_continents,
            params.continent_size_variety, params.land_coverage)
    plates = coarse.plates
    original_is_ocean = plates.is_ocean.copy()
    for i in params.toggled_indices:
        if i < plates.num_plates:
            plates.is_ocean[i] = not plates.is_ocean[i]
    assign_plate_densities(plates)

    super_sp = None
    if params.n_plates >= 8:
        with timer.stage("Super plates"):
            super_sp = build_super_plates(coarse.graph, coarse.r_plate,
                                          plates)

    with timer.stage("Hotspot domes + noise tables"):
        prologue = host_prologue_np(graph, coarse, plates, seed,
                                    params.n_plates)
        projection = projection_host(coarse, seed, params.n_plates)
    return HostProducts(coarse=coarse, plates=plates,
                        original_is_ocean=original_is_ocean,
                        super_sp=super_sp, prologue=prologue,
                        projection=projection)


# ── mesh prefetch ────────────────────────────────────────────────────
# The host mesh build (native Delaunay, adjacency, banded packing) is the
# largest serial part of a generate past 1M cells. The mesh is a pure
# function of (n_cells, jitter, seed), so a sweep of seeds can build the
# next seed's host products on a daemon thread while the current seed runs
# (the native mesh code releases the GIL during its C calls). The thread
# builds numpy products only and never touches the device: every upload
# stays in ``host_setup`` on the caller's thread. ``host_setup`` adopts an
# entry whose key matches; unclaimed entries are dropped on the next
# prefetch to bound host memory (~400 MB per 4M-cell graph).

_MESH_PREFETCH: Dict = {}
_MESH_LOCK = threading.Lock()


def _prefetch_key(params: GenerationParams):
    return params.replace(skip_climate=None)


def prefetch_mesh(params: GenerationParams) -> None:
    """Start building the host prologue of ``params`` on a daemon thread:
    always the mesh and its banded packing; for params without plate
    toggles also the coarse tectonics, super plates, hotspot domes, noise
    tables and projection inputs (:func:`host_products`). Toggled params
    prefetch the mesh only, as in the JAX package."""
    key = _prefetch_key(params)
    with _MESH_LOCK:
        if key in _MESH_PREFETCH:
            return
        for k in [k for k in _MESH_PREFETCH if k != key]:
            _MESH_PREFETCH.pop(k, None)
        holder: Dict = {}
        _MESH_PREFETCH[key] = holder

    def build():
        try:
            # one thread fewer than the host's cores: one stays with the
            # thread that drives the card
            graph = build_sphere(params.n_cells, params.jitter,
                                 rng=ParkMiller(params.seed),
                                 threads=mesh_threads(params.n_cells) - 1)
            _ = graph.banded_packed
            holder["graph"] = graph
            if not params.toggled_indices:
                holder["products"] = host_products(
                    params, graph, StageTimer(sync_enabled=False))
        except Exception as e:  # noqa: BLE001 — reported on adoption
            holder["error"] = e

    t = threading.Thread(target=build, daemon=True, name="prefetch-mesh")
    holder["thread"] = t
    t.start()


def _take_prefetched_mesh(params: GenerationParams):
    """(graph | None, HostProducts | None) of a prefetch of ``params``,
    joining its thread if it is still running: whatever the thread
    finished, as in the JAX package. A build that failed is reported with
    a warning and yields ``(None, None)`` where the mesh itself failed, so
    ``host_setup`` builds again on the caller's thread and a deterministic
    error surfaces from that build."""
    with _MESH_LOCK:
        holder = _MESH_PREFETCH.pop(_prefetch_key(params), None)
    if holder is None:
        return None, None
    holder["thread"].join()
    if "error" in holder:
        warnings.warn(
            f"the mesh prefetch of seed {params.seed} ({params.n_cells} "
            f"cells) failed and is rebuilt: {holder['error']!r}",
            RuntimeWarning, stacklevel=3)
    return holder.get("graph"), holder.get("products")


def host_setup(params: GenerationParams, device, timer: StageTimer,
               prog: Callable) -> PlanetSetup:
    """The host prologue: mesh, coarse tectonics, super plates, hotspot
    domes, noise tables (adopted from :func:`prefetch_mesh` when one
    matches) — and their upload to ``device``."""
    prog(0, "Shaping the world…")
    graph, host = _take_prefetched_mesh(params)
    with timer.stage("Sphere mesh + upload", sync=True):
        if graph is None:
            graph = build_sphere(params.n_cells, params.jitter,
                                 rng=ParkMiller(params.seed))
        with timing.span("Mesh: band census + pack"):
            _ = graph.banded_packed
        with timing.span("Mesh: upload"):
            g = to_device(graph, device)

    prog(10, "Generating coarse plates…")
    if host is None:
        host = host_products(params, graph, timer)
    with timer.stage("Upload plates, domes + noise tables", sync=True):
        domes, noise_pack, warp_t = upload_prologue(host.prologue, device)
        projection = projection_from_numpy(*host.projection, device)
        p_arrays = plate_arrays(host.plates, device)
        s_arrays = super_arrays(host.super_sp, device)

    return PlanetSetup(
        params=params, graph=graph, g=g, coarse=host.coarse,
        plates=host.plates, original_is_ocean=host.original_is_ocean,
        super_sp=host.super_sp, domes=domes, noise_pack=noise_pack,
        warp_t=warp_t, projection=projection, plate_arrays=p_arrays,
        super_arrays=s_arrays)


_TRANSFER_PRIMED = False


def prime_device_transfer(device) -> None:
    """Once per process, start a daemon thread that initialises the CUDA
    context of ``device`` and makes one 1 MB device→host copy, so the
    card's first-use cost overlaps the host mesh build. A no-op on the
    CPU; it never selects a device the caller did not pass."""
    global _TRANSFER_PRIMED
    device = torch.device(device)
    if device.type != "cuda" or _TRANSFER_PRIMED:
        return
    _TRANSFER_PRIMED = True

    def go():
        try:
            torch.arange(262_144, dtype=torch.float32, device=device).cpu()
        except Exception:  # noqa: BLE001 — the caller's first use reports it
            pass

    threading.Thread(target=go, daemon=True, name="prime-d2h").start()


def _norm_device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "PlanetEngine runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain-torch path explicitly")
    return dev


def _no_progress(pct, label):
    pass


def _skip_climate(params: GenerationParams) -> bool:
    if params.skip_climate is None:
        return params.n_cells > AUTO_CLIMATE_THRESHOLD
    return params.skip_climate


def _nominal_edge(graph: SphereGraph) -> float:
    """π/√N, the neighbour spacing the engines pass to the post stage."""
    return math.pi / math.sqrt(graph.n_cells)


def _elevation_kw(sup, r_plate) -> Dict:
    if sup is None:
        return {}
    pts, so, spo, som, sd = sup
    return dict(r_super_plate=pts[r_plate.long()], super_is_ocean=so,
                super_pole=spo, super_omega=som, super_density=sd)


def triangle_elevations(elevation, graph: SphereGraph):
    """Each triangle's mean elevation, its vertices summed in ascending
    index order: the same value whichever vertex a triangle's row starts
    at (the serial and the chunked mesh builds rotate triangles
    differently)."""
    tris = torch.as_tensor(graph.triangles.astype(np.int64),
                           device=elevation.device)
    return elevation[tris.sort(dim=1).values].mean(dim=1)


class PlanetEngine:
    """Generates planets on ``device`` (default ``"cuda"``; there is no
    silent fallback to the CPU — pass ``device="cpu"`` to ask for it) and
    keeps the last planet's state for the other commands.

    ``timing=True`` (default: ``PLANET_TIMING=1``) synchronizes the device
    after every stage for true per-stage times; otherwise a command
    enqueues its device work without stage syncs and synchronizes once,
    at its end. The mode changes no result.

    ``mesh`` (``parallel.cells_mesh``): ``generate`` splits its device
    pipeline, terrain and climate, over the mesh's first row of devices
    (the JAX engine's sharded fused branch; not in timing mode and not
    above ``FUSED_MAX_CELLS`` cells, which run unsplit as in JAX), and
    gathers every product and the retained state to ``device``, so the
    other commands run unsplit. ``device`` is then None (the mesh's first
    device) or that device; any other raises."""

    def __init__(self, device=None, timing: Optional[bool] = None,
                 mesh=None):
        if mesh is not None:
            first = mesh.devices[0][0]
            if device is None:
                device = first
            elif _norm_device(device) != first:
                raise ValueError(
                    f"PlanetEngine(device={device!r}) with a mesh must run "
                    f"on the mesh's first device, {first}")
        self.device = _resolve_device(device)
        if timing is None:
            timing = os.environ.get("PLANET_TIMING", "0") == "1"
        self._timing = bool(timing)
        self._mesh = mesh
        self.split_stats: Optional[dict] = None
        self._w: Optional[dict] = None
        prime_device_transfer(self.device)

    def _timer(self) -> StageTimer:
        return StageTimer(sync_enabled=self._timing)

    def _finish(self, timer: StageTimer, params=None, kind=None) -> None:
        """The end of a command: one device sync (the only one outside
        timing mode), the total frozen, the perf record written."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timer.stop()
        if kind is not None:
            self._maybe_log_perf(params, timer, kind)

    def reset(self) -> None:
        """Drop the retained state (and its device memory)."""
        self._w = None

    # ── session persistence ──────────────────────────────────────────
    def save_session(self, path: str) -> None:
        """Write the retained state that cannot be derived from the params
        (pre-post elevation, hotspot, plate map, final elevation, masks,
        plate ocean flags and the params) to an npz in the JAX package's
        format; the rest is replayed by ``host_setup`` on load."""
        if self._w is None:
            raise RuntimeError("No retained state to save")
        w = self._w

        def host(x, dtype):
            return np.asarray(x.cpu().numpy() if torch.is_tensor(x) else x,
                              dtype)

        out = dict(
            params_json=np.str_(json.dumps(dataclasses.asdict(w["params"]))),
            pre_post=host(w["pre_post"], np.float32),
            r_plate=host(w["r_plate"], np.int32),
            elevation_final=host(w["elevation_final"], np.float32),
            stress=host(w["stress"], np.float32),
            mountain=host(w["mountain"], bool),
            coastline=host(w["coastline"], bool),
            ocean_seeds=host(w["ocean_seeds"], bool),
            plate_is_ocean=host(w["plates"].is_ocean, bool),
        )
        if w.get("hotspot") is not None:
            out["hotspot"] = host(w["hotspot"], np.float32)
        np.savez_compressed(path, **out)

    @classmethod
    def load_session(cls, path: str, device=None,
                     timing: Optional[bool] = None,
                     mesh=None) -> "PlanetEngine":
        """An engine with the retained state of a ``save_session`` file
        (of either package): ``host_setup`` replays the prologue, the
        stored arrays fill in the generate products. ``mesh`` is kept for
        the engine's later generates, as in JAX."""
        data = np.load(path)
        pd = json.loads(str(data["params_json"]))
        pd["toggled_indices"] = tuple(pd.get("toggled_indices", ()))
        params = GenerationParams(**pd)

        eng = cls(device=device, timing=timing, mesh=mesh)
        dev = eng.device
        s = host_setup(params, dev, StageTimer(sync_enabled=False),
                       _no_progress)
        s.plates.is_ocean = np.asarray(data["plate_is_ocean"], bool)
        assign_plate_densities(s.plates)

        def t(key, dtype):
            return torch.as_tensor(np.asarray(data[key], dtype), device=dev)

        eng._w = dict(
            graph=s.graph, g=s.g, params=params, seed=params.seed,
            coarse=s.coarse, r_plate=t("r_plate", np.int32), plates=s.plates,
            super_sp=s.super_sp, original_is_ocean=s.original_is_ocean,
            noise_pack=s.noise_pack, warp_t=s.warp_t,
            pre_post=t("pre_post", np.float32),
            elevation_final=t("elevation_final", np.float32),
            mountain=t("mountain", bool), coastline=t("coastline", bool),
            ocean_seeds=t("ocean_seeds", bool), stress=t("stress", np.float32),
            hotspot=(t("hotspot", np.float32) if "hotspot" in data.files
                     else None),
            cached_wind=None, cached_ocean=None,
        )
        return eng

    def _maybe_log_perf(self, params, timer, kind: str) -> None:
        """Append a per-run timing record to PLANET_PERF_LOG (jsonl), the
        JAX engine's record: the persisted form of the reference's per-run
        timing tables (js/generate.js:334-368)."""
        path = os.environ.get("PLANET_PERF_LOG")
        if not path:
            return
        try:
            rec = dict(
                t=round(time.time(), 3), kind=kind, n_cells=params.n_cells,
                seed=params.seed, fused=not self._timing,
                total_ms=round(timer.total_ms, 1),
                stages={k: round(v, 2) for k, v in timer.totals().items()})
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass

    # ── climate ──────────────────────────────────────────────────────
    def _run_climate(self, g, elevation, plate_is_ocean, r_plate, seed,
                     params, timer, prog, debug) -> Dict:
        prog(80, "Simulating climate…")
        return climate_stack(g, elevation, plate_is_ocean, r_plate,
                             tables(seed, g.device), params, timer, debug)

    def _climate_seam(self, *args):
        """(climate, error): the climate stack, with an exception it raises
        turned into the degraded-result envelope (no climate)."""
        try:
            return self._run_climate(*args), None
        except Exception as e:  # noqa: BLE001 — resilience seam
            return None, dict(stage="climate", message=str(e),
                              stack=traceback.format_exc())

    # ── generate ─────────────────────────────────────────────────────
    def _splits(self, params: GenerationParams) -> bool:
        """Whether ``generate`` runs split over the mesh: where JAX shards,
        on its fused branch (not in timing mode, at most
        ``FUSED_MAX_CELLS`` cells)."""
        return (self._mesh is not None and not self._timing
                and params.n_cells <= FUSED_MAX_CELLS)

    def generate(self, params: GenerationParams,
                 on_progress: Optional[Callable] = None) -> PlanetResult:
        """The reference generate (js/planet-worker.js:136-339). With a
        mesh (and where :meth:`_splits`), the device pipeline runs split
        over its cells windows and every product is gathered to
        ``device``."""
        timer = self._timer()
        with timing.current(timer):
            prog = on_progress or _no_progress
            s = host_setup(params, self.device, timer, prog)
            self.split_stats = None
            if self._splits(params):
                out = self._split_pipeline(s, params, timer, prog)
            else:
                out = self._device_pipeline(s, params, timer, prog)
            elev_res, climate = out["elev"], out["climate"]
            r_plate, elevation, debug = out["r_plate"], out["elevation"], \
                out["debug"]

            self._w = dict(
                graph=s.graph, g=s.g, params=params, seed=params.seed,
                coarse=s.coarse, r_plate=r_plate, plates=s.plates,
                super_sp=s.super_sp, original_is_ocean=s.original_is_ocean,
                noise_pack=s.noise_pack, warp_t=s.warp_t,
                pre_post=elev_res.elevation, elevation_final=elevation,
                mountain=elev_res.mountain, coastline=elev_res.coastline,
                ocean_seeds=elev_res.ocean_seeds, stress=elev_res.stress,
                hotspot=debug.get("hotspot"),
                cached_wind=(climate or {}).get("wind"),
                cached_ocean=(climate or {}).get("ocean"),
            )
            self._finish(timer, params, "generate")
        return PlanetResult(
            graph=s.graph, params=params, r_plate=r_plate,
            plate_seeds=s.plates.seeds, plate_is_ocean=s.plates.is_ocean,
            plate_density=s.plates.density,
            pre_post_elevation=elev_res.elevation, elevation=elevation,
            t_elevation=out["t_elev"], stress=elev_res.stress,
            mountain_mask=elev_res.mountain,
            coastline_mask=elev_res.coastline,
            ocean_seed_mask=elev_res.ocean_seeds,
            climate=climate, debug=debug, timing=timer, error=out["error"])

    def _device_pipeline(self, s: PlanetSetup, params: GenerationParams,
                         timer: StageTimer, prog: Callable,
                         triangles: bool = True) -> Dict:
        """Projection → smoothing and reconnection → elevation → erosion →
        (triangle elevations) → climate on ``s.g``: the whole graph, or one
        window of a split. Returns the products as a dict."""
        g = s.g
        p_ocean, p_pole, p_omega, p_dens = s.plate_arrays

        prog(20, "Projecting plates…")
        with timer.stage("Project plates", sync=True):
            perm, pm12, amp, bins_idx, bins_mask, bins_pts, cplate = \
                s.projection
            r_plate = project_kernel(
                g.pos, perm, pm12, amp, bins_idx, bins_mask, bins_pts,
                cplate, s.coarse.bins.n_lat, s.coarse.bins.n_lon)

        prog(25, "Smoothing boundaries…")
        with timer.stage("Smooth + reconnect plates", sync=True):
            r_plate = smooth_and_reconnect(g, r_plate, s.plates.num_plates)

        prog(35, "Raising mountains…")
        with timer.stage("Elevation", sync=True):
            elev_res = assign_elevation(
                g, r_plate, p_ocean, p_pole, p_omega, p_dens,
                seed=params.seed, noise_mag=params.roughness,
                spread=params.spread, noise_pack=s.noise_pack,
                domes=s.domes, **_elevation_kw(s.super_arrays, r_plate))

        prog(60, "Eroding terrain…")
        with timer.stage("Terrain post-processing", sync=True):
            elevation, erosion_delta = run_post_processing(
                g, elev_res.elevation, params.seed,
                dataclasses.asdict(params),
                hotspot=elev_res.debug.get("hotspot"),
                avg_edge=_nominal_edge(s.graph), warp_t=s.warp_t)

        t_elev = None
        if triangles:
            with timer.stage("Triangle elevations", sync=True):
                t_elev = triangle_elevations(elevation, s.graph)

        debug = dict(elev_res.debug)
        debug["erosionDelta"] = erosion_delta
        climate = stage_error = None
        if not _skip_climate(params):
            climate, stage_error = self._climate_seam(
                g, elevation, p_ocean, r_plate, params.seed, params, timer,
                prog, debug)
        return dict(r_plate=r_plate, elev=elev_res, elevation=elevation,
                    t_elev=t_elev, debug=debug, climate=climate,
                    error=stage_error)

    def _split_pipeline(self, s: PlanetSetup, params: GenerationParams,
                        timer: StageTimer, prog: Callable) -> Dict:
        """:meth:`_device_pipeline` split over the mesh's cells windows
        (parallel/spmd.py): one thread per shard runs it on its window
        graph and its copies of the tables (``shard_fused_args``); the
        products are gathered to ``device``, where the triangle elevations
        are taken. ``split_stats`` keeps the split's counts."""
        from ..parallel.sharding import shard_fused_args

        with timer.stage("Split placement", sync=True):
            lay, shards = shard_fused_args(self._mesh, s)
        exchanges = lay.exchanges

        def shard(c, sc):
            # shard 0 records into the command's timer, the others into
            # their own; each thread's reads count on its timer
            t = timer if c == 0 else StageTimer(sync_enabled=False)
            with timing.current(t):
                return self._device_pipeline(
                    sc, params, t, prog if c == 0 else _no_progress,
                    triangles=False)

        parts, stats = spmd.run(lay, shard, [(sc,) for sc in shards])
        with timer.stage("Split gather", sync=True):
            out = lay.gather_tree(parts, self.device)
            out["t_elev"] = triangle_elevations(out["elevation"], s.graph)
        self.split_stats = dict(stats, exchanges=lay.exchanges - exchanges,
                                shards=lay.n_shards)
        return out

    # ── reapply (sculpting) ──────────────────────────────────────────
    def reapply(self, sculpt: Optional[dict] = None,
                skip_climate: bool = False,
                on_progress: Optional[Callable] = None) -> PlanetResult:
        """Re-run post-processing from the retained pre-post elevation
        (js/planet-worker.js:341-440), with ``sculpt`` slider changes."""
        if self._w is None:
            raise RuntimeError("No retained state for reapply")
        w = self._w
        timer = self._timer()
        with timing.current(timer):
            prog = on_progress or _no_progress
            params = w["params"]
            if sculpt:
                params = params.replace(**sculpt)
                w["params"] = params
            g, graph = w["g"], w["graph"]

            prog(20, "Eroding terrain…")
            with timer.stage("Terrain post-processing", sync=True):
                elevation, erosion_delta = run_post_processing(
                    g, w["pre_post"], w["seed"], dataclasses.asdict(params),
                    hotspot=w["hotspot"], avg_edge=_nominal_edge(graph),
                    warp_t=w.get("warp_t"))
            debug = dict(erosionDelta=erosion_delta)
            climate = stage_error = None
            if not skip_climate:
                climate, stage_error = self._climate_seam(
                    g, elevation, torch.as_tensor(w["plates"].is_ocean,
                                                  device=g.device),
                    w["r_plate"], w["seed"], params, timer, prog, debug)
            with timer.stage("Triangle elevations", sync=True):
                t_elev = triangle_elevations(elevation, graph)

            w["elevation_final"] = elevation
            w["cached_wind"] = (climate or {}).get("wind")
            w["cached_ocean"] = (climate or {}).get("ocean")
            self._finish(timer, params, "reapply")
        return PlanetResult(
            graph=graph, params=params, r_plate=w["r_plate"],
            plate_seeds=w["plates"].seeds,
            plate_is_ocean=w["plates"].is_ocean,
            plate_density=w["plates"].density,
            pre_post_elevation=w["pre_post"], elevation=elevation,
            t_elevation=t_elev, stress=w["stress"],
            mountain_mask=w["mountain"], coastline_mask=w["coastline"],
            ocean_seed_mask=w["ocean_seeds"],
            climate=climate, debug=debug, timing=timer, error=stage_error)

    # ── edit recompute (plate ocean/land toggles) ────────────────────
    def edit_recompute(self, toggled_indices, skip_climate: bool = False,
                       on_progress: Optional[Callable] = None
                       ) -> PlanetResult:
        """Re-run elevation → post → climate with plates toggled between
        ocean and land (js/planet-worker.js:442-577). Toggles apply to the
        generate's own ocean flags on every call, so edits do not drift."""
        if self._w is None:
            raise RuntimeError("No retained state for edit_recompute")
        w = self._w
        timer = self._timer()
        with timing.current(timer):
            prog = on_progress or _no_progress
            params = w["params"]
            graph, g, seed = w["graph"], w["g"], w["seed"]
            plates = w["plates"]

            plates.is_ocean = w["original_is_ocean"].copy()
            for i in toggled_indices:
                if i < plates.num_plates:
                    plates.is_ocean[i] = not plates.is_ocean[i]
            assign_plate_densities(plates)

            super_sp = None
            coarse = w.get("coarse")
            if plates.num_plates >= 8:
                with timer.stage("Super plates"):
                    if coarse is not None:
                        super_sp = build_super_plates(coarse.graph,
                                                      coarse.r_plate, plates)
                    else:   # imported planets have no coarse map
                        super_sp = build_super_plates(
                            graph, w["r_plate"][: graph.n_cells].cpu().numpy(),
                            plates)
            w["super_sp"] = super_sp

            # toggled ocean/land flips the hotspots' ocean boosts → new domes
            domes = noise_pack = None
            if coarse is not None:
                with timer.stage("Hotspot domes", sync=True):
                    domes, noise_pack, _ = host_prologue(
                        graph, coarse, plates, seed, params.n_plates, g.device)
                    w["noise_pack"] = noise_pack

            prog(0, "Rebuilding elevation…")
            p_ocean, p_pole, p_omega, p_dens = plate_arrays(plates, g.device)
            with timer.stage("Elevation", sync=True):
                elev_res = assign_elevation(
                    g, w["r_plate"], p_ocean, p_pole, p_omega, p_dens,
                    seed=seed, noise_mag=params.roughness,
                    spread=params.spread,
                    noise_pack=noise_pack, domes=domes,
                    **_elevation_kw(super_arrays(super_sp, g.device),
                                    w["r_plate"]))
            pre_post = elev_res.elevation

            prog(50, "Eroding terrain…")
            with timer.stage("Terrain post-processing", sync=True):
                elevation, erosion_delta = run_post_processing(
                    g, pre_post, seed, dataclasses.asdict(params),
                    hotspot=elev_res.debug.get("hotspot"),
                    avg_edge=_nominal_edge(graph), warp_t=w.get("warp_t"))
            debug = dict(elev_res.debug)
            debug["erosionDelta"] = erosion_delta

            climate = None
            if not skip_climate:
                climate = self._run_climate(
                    g, elevation, p_ocean, w["r_plate"], seed, params, timer,
                    prog, debug)
            with timer.stage("Triangle elevations", sync=True):
                t_elev = triangle_elevations(elevation, graph)

            w["cached_wind"] = (climate or {}).get("wind")
            w["cached_ocean"] = (climate or {}).get("ocean")
            w.update(pre_post=pre_post, elevation_final=elevation,
                     mountain=elev_res.mountain, coastline=elev_res.coastline,
                     ocean_seeds=elev_res.ocean_seeds, stress=elev_res.stress,
                     hotspot=debug.get("hotspot"))
            self._finish(timer, params, "edit_recompute")
        return PlanetResult(
            graph=graph, params=params, r_plate=w["r_plate"],
            plate_seeds=plates.seeds, plate_is_ocean=plates.is_ocean,
            plate_density=plates.density,
            pre_post_elevation=pre_post, elevation=elevation,
            t_elevation=t_elev, stress=elev_res.stress,
            mountain_mask=elev_res.mountain,
            coastline_mask=elev_res.coastline,
            ocean_seed_mask=elev_res.ocean_seeds,
            climate=climate, debug=debug, timing=timer)

    # ── deferred climate ─────────────────────────────────────────────
    def compute_climate(self, temperature_offset: Optional[float] = None,
                        precipitation_offset: Optional[float] = None,
                        on_progress: Optional[Callable] = None) -> Dict:
        """Climate from the retained final elevation, reusing the cached
        wind and ocean currents when only the offsets changed
        (js/planet-worker.js:579-677). Returns the climate dict with the
        ``timing`` of this call."""
        if self._w is None:
            raise RuntimeError("No retained state for compute_climate")
        w = self._w
        timer = self._timer()
        with timing.current(timer):
            prog = on_progress or _no_progress
            params = w["params"]
            if temperature_offset is not None:
                params = params.replace(temperature_offset=temperature_offset)
            if precipitation_offset is not None:
                params = params.replace(
                    precipitation_offset=precipitation_offset)
            w["params"] = params

            g = w["g"]
            elevation = w["elevation_final"]
            wind, ocean = w.get("cached_wind"), w.get("cached_ocean")
            if wind is None or ocean is None:
                prog(0, "Simulating wind patterns…")
                wind, ocean = climate_wind_ocean(
                    g, elevation,
                    torch.as_tensor(w["plates"].is_ocean, device=g.device),
                    w["r_plate"], tables(w["seed"], g.device), timer)
                w["cached_wind"], w["cached_ocean"] = wind, ocean
            prog(50, "Computing precipitation…")
            precip, temp, koppen = climate_rest(g, elevation, wind, ocean,
                                                params, timer)
            prog(95, "Done")
            self._finish(timer)
        return dict(wind=wind, ocean=ocean, precip=precip, temp=temp,
                    koppen=koppen, timing=timer)

    # ── heightmap import ─────────────────────────────────────────────
    def import_heightmap(self, grayscale: np.ndarray, img_w: int, img_h: int,
                         params: GenerationParams,
                         on_progress: Optional[Callable] = None
                         ) -> PlanetResult:
        """Equirect grayscale → mesh sampling → post → synthetic plates →
        climate (js/planet-worker.js:679-942)."""
        timer = self._timer()
        with timing.current(timer):
            prog = on_progress or _no_progress
            seed = params.seed

            prog(0, "Building sphere mesh…")
            with timer.stage("Sphere mesh", sync=True):
                graph = build_sphere(params.n_cells, params.jitter,
                                     rng=ParkMiller(seed))
                g = to_device(graph, self.device)

            prog(20, "Sampling heightmap…")
            with timer.stage("Sample heightmap", sync=True):
                image = torch.as_tensor(
                    np.asarray(grayscale, np.float32).reshape(img_h, img_w),
                    device=self.device)
                pre_post = sample_heightmap(g, image)

            prog(35, "Processing terrain…")
            with timer.stage("Terrain post-processing", sync=True):
                elevation, erosion_delta = run_post_processing(
                    g, pre_post, seed, dataclasses.asdict(params))

            prog(50, "Deriving plates…")
            with timer.stage("Synthetic plates", sync=True):
                r_plate, plates = derive_synthetic_plates(g, elevation)

            # seed masks (js/planet-worker.js:812-831)
            is_ocean = (elevation <= 0) & g.valid
            mountain_mask = (elevation > 0.5) & g.valid
            coastline_mask = (elevation > 0) & g.valid & torch.any(
                is_ocean[g.nbr_idx] & g.nbr_mask, dim=1)

            debug = dict(erosionDelta=erosion_delta)
            climate = None
            if not _skip_climate(params):
                climate = self._run_climate(
                    g, elevation, torch.as_tensor(plates.is_ocean,
                                                  device=g.device),
                    r_plate, seed, params, timer, prog, debug)
            with timer.stage("Triangle elevations", sync=True):
                t_elev = triangle_elevations(elevation, graph)

            stress = torch.zeros(g.n_padded, dtype=torch.float32,
                                 device=g.device)
            self._w = dict(
                graph=graph, g=g, params=params, seed=seed, r_plate=r_plate,
                plates=plates, super_sp=None,
                original_is_ocean=plates.is_ocean.copy(),
                pre_post=pre_post, elevation_final=elevation,
                mountain=mountain_mask, coastline=coastline_mask,
                ocean_seeds=is_ocean, stress=stress, hotspot=None,
                cached_wind=(climate or {}).get("wind"),
                cached_ocean=(climate or {}).get("ocean"),
            )
            self._finish(timer, params, "import_heightmap")
        return PlanetResult(
            graph=graph, params=params, r_plate=r_plate,
            plate_seeds=plates.seeds, plate_is_ocean=plates.is_ocean,
            plate_density=plates.density,
            pre_post_elevation=pre_post, elevation=elevation,
            t_elevation=t_elev, stress=stress,
            mountain_mask=mountain_mask, coastline_mask=coastline_mask,
            ocean_seed_mask=is_ocean,
            climate=climate, debug=debug, timing=timer)


def grayscale_to_elevation(gray):
    """Inverse of the renderer's 6·t² height curve: v < 1 → −0.5 ocean
    floor, else sqrt((v − 1)/254) (js/planet-worker.js:705-708)."""
    return torch.where(gray < 1, -0.5,
                       torch.sqrt(torch.clamp(gray - 1, min=0.0) / 254.0))


def sample_heightmap(g: DeviceGraph, image):
    """Bilinear equirect sampling of the [H, W] grayscale ``image`` at
    every cell, through the inverse height curve
    (js/planet-worker.js:682-727)."""
    img_h, img_w = image.shape
    x, y, z = g.pos[:, 0], g.pos[:, 1], g.pos[:, 2]
    lat = torch.asin(torch.clamp(y, -1.0, 1.0))
    lon = torch.atan2(x, z)
    px = (lon / math.pi + 1) * 0.5 * img_w
    py = torch.clamp((0.5 - lat / math.pi) * img_h, 0, img_h - 1)
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    x1 = (x0 + 1) % img_w
    y1 = torch.clamp(y0 + 1, max=img_h - 1)
    x0m = ((x0 % img_w) + img_w) % img_w
    fx = px - torch.floor(px)
    fy = py - torch.floor(py)
    v00 = image[y0, x0m]
    v10 = image[y0, x1]
    v01 = image[y1, x0m]
    v11 = image[y1, x1]
    gray = (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
            + v01 * (1 - fx) * fy + v11 * fx * fy)
    return torch.where(g.valid, grayscale_to_elevation(gray),
                       0.0).to(torch.float32)


def derive_synthetic_plates(g: DeviceGraph, elevation):
    """Connected land and ocean components as zero-velocity plates
    (js/planet-worker.js:733-769). Returns (r_plate [NP] int32, PlateSet)."""
    is_ocean = (elevation <= 0) & g.valid
    labels = connected_components_gated(is_ocean.to(torch.int32), *g.bands)
    n = g.n_cells
    uniq, r_plate_np = np.unique(labels[:n].cpu().numpy(),
                                 return_inverse=True)
    p = len(uniq)
    r_plate_full = np.zeros(g.n_padded, np.int32)
    r_plate_full[:n] = r_plate_np
    plate_ocean = np.zeros(p, bool)
    plate_ocean[r_plate_np] = is_ocean[:n].cpu().numpy()  # uniform per piece
    plates = PlateSet(
        seeds=uniq.astype(np.int32),
        pole=np.tile([[0.0, 1.0, 0.0]], (p, 1)),
        omega=np.zeros(p),
        is_ocean=plate_ocean,
        density=np.full(p, 2.7),
        density_land=np.full(p, 2.7),
        density_ocean=np.full(p, 3.2),
    )
    return torch.as_tensor(r_plate_full, device=g.device), plates


def climate_wind_ocean(g: DeviceGraph, elevation, plate_is_ocean, r_plate,
                       climate_t, timer: StageTimer):
    """The merged 5-field coast BFS, wind and ocean currents on the final
    elevation (the first half of the JAX package's pipeline/fused.py
    ``_climate_stack``). Returns (wind, ocean)."""
    with timer.stage("Climate: coast fields", sync=True):
        d5, aux = climate_coast_fields(g, elevation, plate_is_ocean, r_plate)
    with timer.stage("Climate: wind", sync=True):
        wind = compute_wind(g, elevation, plate_is_ocean, r_plate, climate_t,
                            coast_d=d5[:, :2], gf=aux["gf"],
                            is_land=aux["is_land"],
                            plate_land=aux["plate_land"])
    with timer.stage("Climate: ocean currents", sync=True):
        ocean = compute_ocean_currents(g, elevation, wind, coast_d=d5[:, 2:])
    return wind, ocean


def climate_rest(g: DeviceGraph, elevation, wind, ocean,
                 params: GenerationParams, timer: StageTimer):
    """Precipitation, temperature and Köppen from the wind and ocean
    currents, at the params' offsets. Returns (precip, temp, koppen)."""
    with timer.stage("Climate: precipitation", sync=True):
        precip = compute_precipitation(g, elevation, wind, ocean,
                                       params.precipitation_offset,
                                       params.land_coverage)
    with timer.stage("Climate: temperature", sync=True):
        temp = compute_temperature(g, elevation, wind, ocean, precip,
                                   params.temperature_offset)
    with timer.stage("Climate: Köppen", sync=True):
        koppen = classify_koppen(
            elevation, temp["r_temperature_summer"],
            temp["r_temperature_winter"], precip["r_precip_summer"],
            precip["r_precip_winter"])
    return precip, temp, koppen


def climate_stack(g: DeviceGraph, elevation, plate_is_ocean, r_plate,
                  climate_t, params: GenerationParams, timer: StageTimer,
                  debug: Dict) -> Dict:
    """Wind → ocean → precipitation → temperature → Köppen on the final
    elevation, after the merged 5-field coast BFS (the JAX package's
    pipeline/fused.py ``_climate_stack``). Returns the climate dict and
    adds the climate debug layers to ``debug``."""
    wind, ocean = climate_wind_ocean(g, elevation, plate_is_ocean, r_plate,
                                     climate_t, timer)
    precip, temp, koppen = climate_rest(g, elevation, wind, ocean, params,
                                        timer)
    debug.update(
        pressureSummer=wind["r_pressure_summer"],
        pressureWinter=wind["r_pressure_winter"],
        windSpeedSummer=wind["r_wind_speed_summer"],
        windSpeedWinter=wind["r_wind_speed_winter"],
        continentality=wind["r_continentality"],
        precipSummer=precip["r_precip_summer"],
        precipWinter=precip["r_precip_winter"],
        rainShadowSummer=precip["r_rainshadow_summer"],
        rainShadowWinter=precip["r_rainshadow_winter"],
        tempSummer=temp["r_temperature_summer"],
        tempWinter=temp["r_temperature_winter"],
        koppen=koppen,
    )
    return dict(wind=wind, ocean=ocean, precip=precip, temp=temp,
                koppen=koppen)
