"""Multi-seed batch sweeps — BASELINE config 5 (N-cell × S-seed batches).

The reference generates one planet at a time in its single Web Worker; a
seed sweep is S sequential full runs. The port does the same on one
device: the seeds run one after another through one ``PlanetEngine``
(each generate already keeps the card busy with one launch per sweep
loop; there is no ``vmap``). ``lean=True`` keeps only each seed's
elevation, on the host, and frees the seed's device tensors before the
next one starts, so a sweep's device memory is one planet's whatever the
seed count.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import GenerationParams
from ..pipeline.engine import PlanetEngine, PlanetResult


def _engine(devices: Optional[Sequence], engine: Optional[PlanetEngine]
            ) -> PlanetEngine:
    """The engine the seeds run on: ``engine``, or a new one on the first
    device of ``devices`` (default the card). The JAX package accepts any
    device list and runs on its default device; the port's analogue is
    the list's first device, so it never runs on a device the caller did
    not list."""
    if engine is not None:
        return engine
    devices = list(devices or [])
    return PlanetEngine(device=devices[0] if devices else None)


def generate_batch(params: GenerationParams, seeds: Sequence[int],
                   devices: Optional[Sequence] = None,
                   on_progress: Optional[Callable] = None,
                   engine: Optional[PlanetEngine] = None,
                   vmap_chunk: int = 0,
                   lean: bool = False,
                   ) -> List[PlanetResult]:
    """Run the full generation pipeline for every seed in ``seeds``.

    ``params.seed`` is ignored; each run uses ``params.replace(seed=s)``,
    one after another on ``engine`` (or a new engine on the first device
    of ``devices``, default the card), so every result equals
    ``engine.generate`` of its seed. ``vmap_chunk`` is accepted for the
    JAX package's signature and changes nothing: there is no vmap.

    ``lean=True`` keeps only the elevation per result — fetched to HOST
    memory as numpy, with every other device output dropped (and the
    engine's retained state reset) before the next seed runs; the stage
    timer stays (``timing.total_ms`` is the seed's generate wall). A retained
    full result pins ~30 debug/climate [N] device tensors (~0.5 GB at 4M
    cells), so large sweeps (bench config 5) must run lean.

    ``on_progress(seed_index, pct, label)`` mirrors the worker progress
    protocol per seed.
    """
    del vmap_chunk
    eng = _engine(devices, engine)
    prog = on_progress or (lambda i, pct, label: None)
    results: List[PlanetResult] = []
    for i, s in enumerate(seeds):
        res = eng.generate(params.replace(seed=int(s)),
                           lambda pct, label, _i=i: prog(_i, pct, label))
        if lean:
            res = _lean(res)
            eng.reset()
        results.append(res)
    return results


def _lean(res: PlanetResult) -> PlanetResult:
    """The elevation on the host, the host prologue's plate arrays and the
    stage timer (its table and the generate's frozen total); nothing that
    holds device memory."""
    return PlanetResult(
        graph=res.graph, params=res.params, r_plate=None,
        plate_seeds=res.plate_seeds, plate_is_ocean=res.plate_is_ocean,
        plate_density=res.plate_density,
        pre_post_elevation=None,
        elevation=res.elevation.cpu().numpy(),
        t_elevation=None, stress=None, mountain_mask=None,
        coastline_mask=None, ocean_seed_mask=None,
        climate=None, debug={}, timing=res.timing, error=res.error)


def sweep_heightmaps(params: GenerationParams, seeds: Sequence[int],
                     width: int = 8192,
                     devices: Optional[Sequence] = None
                     ) -> Iterator[Tuple[int, PlanetResult, np.ndarray]]:
    """Config-5 workload: S full generations (lean) + an equirect heightmap
    export each, on the first device of ``devices`` (default the card). With
    ``jitter=0`` the mesh is seed-independent, so ONE rasterized cell-id
    map is shared by every seed's export (the reference's exportMapBatch
    geometry sharing, js/planet-mesh.js:1965-2180); jittered meshes differ
    per seed and rasterize individually. Yields (seed, result, image)."""
    from ..api.export import export_map, rasterize_cell_ids
    from ..mesh.device import to_device

    eng = _engine(devices, None)
    results = generate_batch(params, seeds, engine=eng, lean=True)
    shared_ids = None
    for s, res in zip(seeds, results):
        g = to_device(res.graph, eng.device)
        if params.jitter == 0:
            if shared_ids is None:
                shared_ids = rasterize_cell_ids(g, width // 2, width)
            ids = shared_ids
        else:
            ids = None
        img = export_map(g, res.elevation, "heightmap",
                         height=width // 2, width=width, cell_ids=ids)
        yield int(s), res, img
