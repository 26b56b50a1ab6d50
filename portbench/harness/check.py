"""The comparison that decides ``correct``: the program's answers against
the plain reference (``portbench/reference``), stage by stage.

The reference builds the mesh and the coarse plates from the same
``GenerationParams`` (with the JAX package's host C++, its definition of
the Delaunay mesh and the plate fill), then recomputes each later stage from the
program's products of the stage before it: the plates of each cell from
the params, the elevation before erosion from the program's plates, the
elevation after post-processing from the program's elevation before it,
and the climate from the program's final elevation. The planet is
chaotic (a tie broken the other way upstream moves whole basins
downstream), so only a stage run on the same input can be held to its
answer cell by cell. The configuration's ``"reference"`` key chooses
where the reference runs (``REFERENCES``): on NumPy, the default, the
stages run at once, each in a host process of its own; on PyTorch they
run in turn in one process of their own (on the card: its own CUDA
context, started after the program's state is freed), on one
``ReferenceEngine``. Each number is the worst over the answers compared:

- ``mesh_rows_off``: the real cells whose set of neighbours differs;
- ``plate_off_pct``: the share of cells on another plate;
- ``pre_post_p90``, ``elev_p90``, ``climate_p90``: the 90th percentile
  over the cells (the climate's six fields together) of
  |program - reference| / (1 + |reference|), for the elevation before
  and after post-processing and the climate;
- ``koppen_off_pct``: the share of cells in another Köppen class.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

PRECIP = ("r_precip_summer", "r_precip_winter", "r_rainshadow_summer",
          "r_rainshadow_winter")
TEMP = ("r_temperature_summer", "r_temperature_winter")

# the numbers compared, in the order they are printed
NUMBERS = ("mesh_rows_off", "plate_off_pct", "pre_post_p90", "elev_p90",
           "climate_p90", "koppen_off_pct")

# the values of a configuration's "reference" key: the array library the
# reference runs on and its device ("torch-cpu" stands in for the card in
# the CPU tests)
REFERENCES = {"numpy": ("numpy", None), "torch-cuda": ("torch", "cuda"),
              "torch-cpu": ("torch", "cpu")}

# each stage of the check and the products of the answer it reads
STAGES = {"plates": ("nbr_idx", "r_plate"),
          "elevation": ("r_plate", "pre_post"),
          "post": ("pre_post", "elevation"),
          "climate": ("r_plate", "elevation", "climate")}


def _np(x):
    """A tensor or array on the host as NumPy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _climate(cl):
    if cl is None:
        return None
    return dict(fields=np.stack([_np(cl["precip"][k]) for k in PRECIP] +
                                [_np(cl["temp"][k]) for k in TEMP]),
                koppen=_np(cl["koppen"]))


def products(n_cells: int, nbr_idx, r_plate, pre_post, elevation,
             climate) -> dict:
    """The compared products of one answer on the host (padded arrays;
    ``climate`` None or a dict with ``precip`` and ``temp`` dicts of
    fields and ``koppen``)."""
    return dict(n_cells=int(n_cells), nbr_idx=_np(nbr_idx)[:n_cells].copy(),
                r_plate=_np(r_plate).copy(), pre_post=_np(pre_post).copy(),
                elevation=_np(elevation).copy(), climate=_climate(climate))


def result_products(res) -> dict:
    """:func:`products` of a program ``PlanetResult``."""
    return products(res.graph.n_cells, res.graph.nbr_idx, res.r_plate,
                    res.pre_post_elevation, res.elevation, res.climate)


def reference_products(ans: dict) -> dict:
    """:func:`products` of a ``ReferenceEngine`` answer."""
    return products(ans["n_cells"], ans["nbr_idx"], ans["r_plate"],
                    ans["pre_post"], ans["elevation"], ans["climate"])


def _rel_q(prog, ref, n: int, q: float) -> float:
    """The ``q``-th percentile of |prog - ref| / (1 + |ref|) over the
    real cells (NaN anywhere reads infinite)."""
    p = np.asarray(prog, np.float64)[..., :n]
    r = np.asarray(ref, np.float64)[..., :n]
    if p.shape != r.shape:
        return float("inf")
    d = np.abs(p - r) / (1.0 + np.abs(r))
    if not np.isfinite(d).all():
        return float("inf")
    return float(np.percentile(d, q))


def _off_pct(prog, ref, n: int) -> float:
    p, r = np.asarray(prog)[:n], np.asarray(ref)[:n]
    if p.shape != r.shape:
        return 100.0
    return 100.0 * float((p != r).mean())


def _rows_off(prog_nbr, graph) -> int:
    """The real cells whose neighbour set differs from the reference
    mesh's (padding slots point at the cell itself)."""
    n = graph.n_cells
    ref = np.sort(np.where(graph.nbr_mask, graph.nbr_idx,
                           np.arange(len(graph.nbr_idx))[:, None])[:n], 1)
    prog = np.sort(np.asarray(prog_nbr), 1)
    if prog.shape != ref.shape:
        return max(len(prog), len(ref))
    return int((prog != ref).any(1).sum())


def reference_of(cfg: dict) -> str:
    """The reference a configuration file names (NumPy where it names
    none)."""
    name = cfg.get("reference", "numpy")
    if name not in REFERENCES:
        raise ValueError(f"no reference {name!r}; one of {list(REFERENCES)}")
    return name


def stage(params: dict, sliders, name: str, prog: dict) -> dict:
    """One stage of the check of one answer, in a process of its own:
    the reference of ``params`` recomputes stage ``name`` from the
    answer's products ``prog`` (those of ``STAGES[name]`` and
    ``n_cells``) and returns its numbers."""
    from portbench.reference import GenerationParams, ReferenceEngine

    with np.errstate(all="ignore"):      # JAX's arithmetic does not warn
        return _stage(ReferenceEngine(GenerationParams(**params)), sliders,
                      name, prog)


def stages(params: dict, sliders, prog: dict) -> dict:
    """Every stage of the check of one answer in turn, in this process,
    on one ``ReferenceEngine`` of ``params``: the numbers of all. The
    seconds of the engine's set-up and of each stage go to standard
    error."""
    from portbench.reference import GenerationParams, ReferenceEngine

    out, secs = {}, []
    with np.errstate(all="ignore"):
        t = time.perf_counter()
        ref = ReferenceEngine(GenerationParams(**params))
        secs.append(("set-up", time.perf_counter() - t))
        for name in STAGES:
            t = time.perf_counter()
            out.update(_stage(ref, sliders, name, prog))
            secs.append((name, time.perf_counter() - t))
    print("reference stages, s: " + ", ".join(f"{n} {s:.3f}" for n, s in
                                              secs), file=sys.stderr,
          flush=True)
    return out


def _stage(ref, sliders, name: str, prog: dict) -> dict:
    n = prog["n_cells"]
    if name == "plates":
        return dict(mesh_rows_off=_rows_off(prog["nbr_idx"], ref.graph),
                    plate_off_pct=_off_pct(prog["r_plate"], ref.plates(), n))
    if name == "elevation":
        pre_post, _ = ref.elevation(prog["r_plate"])
        return dict(pre_post_p90=_rel_q(prog["pre_post"], pre_post, n, 90))
    if name == "post":
        elev = ref.post(sliders, prog["pre_post"], ref.hotspot())
        return dict(elev_p90=_rel_q(prog["elevation"], elev, n, 90))
    clim = _climate(ref.climate(prog["elevation"], prog["r_plate"]))
    if (clim is None) != (prog["climate"] is None):
        return dict(climate_p90=float("inf"), koppen_off_pct=100.0)
    if clim is None:
        return dict(climate_p90=0.0, koppen_off_pct=0.0)
    return dict(climate_p90=_rel_q(prog["climate"]["fields"], clim["fields"],
                                   n, 90),
                koppen_off_pct=_off_pct(prog["climate"]["koppen"],
                                        clim["koppen"], n))


def _use(lib: str, device) -> None:
    """A worker's start: its reference runs on ``lib`` on ``device``."""
    from portbench.reference import backend

    backend.use(lib, device)


def pool(n_tasks: int, reference: str = "numpy") -> ProcessPoolExecutor:
    """Processes for the reference's tasks, started afresh (``spawn``:
    they hold no copy of the caller's CUDA state), after its native
    libraries are built here once: for NumPy one a task, up to the
    cores; for PyTorch one, which runs them in turn."""
    from portbench.reference import native

    native.build()
    lib, device = REFERENCES[reference]
    ctx = multiprocessing.get_context("spawn")
    if lib == "numpy":
        return ProcessPoolExecutor(max(1, min(n_tasks, os.cpu_count() or 1)),
                                   mp_context=ctx)
    return ProcessPoolExecutor(1, mp_context=ctx, initializer=_use,
                               initargs=(lib, device))


def submit(ex, entry: str, base_params: dict, key: dict, prog: dict,
           reference: str = "numpy"):
    """The futures of the check of one answer in ``pool(...,
    reference)``: ``key`` is the fields a ``generate`` command set, or the
    sliders a ``reapply`` answer was made with."""
    if entry == "generate":
        params, sliders = dict(base_params, **key), None
    elif entry == "reapply":
        params, sliders = base_params, key
    else:
        raise ValueError(f"no reference for the entry {entry!r}")
    if REFERENCES[reference][0] != "numpy":
        reads = {k for r in STAGES.values() for k in r}
        return [ex.submit(stages, params, sliders,
                          dict({k: prog[k] for k in reads},
                               n_cells=prog["n_cells"]))]
    return [ex.submit(stage, params, sliders, name,
                      dict({k: prog[k] for k in reads},
                           n_cells=prog["n_cells"]))
            for name, reads in STAGES.items()]


def numbers(futures) -> dict:
    """The numbers of one answer from the futures of :func:`submit`."""
    out = {}
    for f in futures:
        out.update(f.result())
    return {k: out[k] for k in NUMBERS}


def worst(readings) -> dict:
    """Each number's largest value over the answers compared."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def judge(nums: dict, limits: dict) -> bool:
    """Every number read and at or under its limit (a NaN fails)."""
    return all(nums[k] is not None and nums[k] <= limits[k]
               for k in NUMBERS)


def check(entry: str, base_params: dict, samples,
          reference: str = "numpy") -> dict:
    """The worst numbers of the sampled answers, ``samples`` a list of
    (key, products) pairs (:func:`submit`)."""
    with pool(len(samples) * len(STAGES), reference) as ex:
        futures = [submit(ex, entry, base_params, key, prog, reference)
                   for key, prog in samples]
        return worst([numbers(f) for f in futures])


def control_answers(entry: str, base_params: dict, keys,
                    reference: str = "numpy") -> list:
    """The control in the program's place: the reference with its stage
    products stored in bfloat16 (``ReferenceEngine(lowp=True)``), as
    (key, products) pairs for :func:`check`."""
    return reference_answers(entry, base_params, keys, reference, lowp=True)


def reference_answers(entry: str, base_params: dict, keys,
                      reference: str = "numpy", lowp: bool = False) -> list:
    """The reference's own answers to ``keys`` (the control's with
    ``lowp``), as (key, products) pairs: on NumPy in this process, on
    PyTorch in a process of its own."""
    if REFERENCES[reference][0] == "numpy":
        return answers_here(entry, base_params, keys, lowp)
    with pool(1, reference) as ex:
        return ex.submit(answers_here, entry, base_params, keys,
                         lowp).result()


def answers_here(entry: str, base_params: dict, keys,
                 lowp: bool = False) -> list:
    """:func:`reference_answers` on this process's reference."""
    from portbench.reference import GenerationParams, ReferenceEngine

    with np.errstate(all="ignore"):
        if entry == "generate":
            return [(key, reference_products(ReferenceEngine(
                GenerationParams(**dict(base_params, **key)),
                lowp=lowp).generate())) for key in keys]
        eng = ReferenceEngine(GenerationParams(**base_params), lowp=lowp)
        eng.generate()
        return [(key, reference_products(eng.reapply(key))) for key in keys]
