"""Worker message protocol — command dispatch with structured errors.

The reference's worker wraps every command in try/catch and answers with
``{type:'error', message, stack}`` on failure, or a typed done message on
success (js/planet-worker.js:136-339, 336-338, 944-954). This module is
that protocol surface for embedders, with the JAX package's command and
response names: 5 request commands in, 6 response types out (progress /
done / reapplyDone / editDone / climateDone / error), all plain dicts of
numpy arrays — no exception ever escapes ``dispatch``.
"""

from __future__ import annotations

import traceback
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import GenerationParams
from .engine import PlanetEngine, PlanetResult

COMMANDS = ("generate", "reapply", "editRecompute", "computeClimate",
            "importHeightmap")
RESPONSES = ("progress", "done", "reapplyDone", "editDone", "climateDone",
             "error")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _climate_arrays(cl: Dict, n: int) -> Dict:
    out = dict(koppen=_np(cl["koppen"])[:n])
    for s in ("summer", "winter"):
        out[f"temperature_{s}"] = _np(cl["temp"][f"r_temperature_{s}"])[:n]
        out[f"precip_{s}"] = _np(cl["precip"][f"r_precip_{s}"])[:n]
    return out


def _result_payload(result: PlanetResult) -> Dict:
    """The 'done' payload: per-cell arrays trimmed to real cells, on the
    host — the transferable-buffer equivalent
    (js/planet-worker.js:299-334)."""
    n = result.graph.n_cells
    out = dict(
        elevation=_np(result.elevation)[:n],
        pre_post_elevation=_np(result.pre_post_elevation)[:n],
        r_plate=_np(result.r_plate)[:n],
        stress=_np(result.stress)[:n],
        plate_is_ocean=_np(result.plate_is_ocean),
        t_elevation=_np(result.t_elevation),
        triangles=result.graph.triangles,
        diagnostics=result.diagnostics(),
        timing=[(name, ms) for name, ms in result.timing.stages],
    )
    if result.climate is not None:
        out.update(_climate_arrays(result.climate, n))
    if result.error is not None:
        # degraded result: the terrain is valid, a later stage failed —
        # retry the climate with computeClimate (js/generate.js:246-308)
        out["error"] = dict(result.error)
    return out


class WorkerProtocol:
    """Stateful dispatcher mirroring the reference worker's retained-state
    command loop. ``on_message(response_dict)`` receives every response,
    including progress events."""

    def __init__(self, engine: Optional[PlanetEngine] = None,
                 on_message: Optional[Callable[[Dict], None]] = None):
        self.engine = engine or PlanetEngine()
        self._emit = on_message or (lambda msg: None)

    def dispatch(self, msg: Dict) -> Dict:
        """Handle one request dict ``{"cmd": ..., **payload}``; returns (and
        emits) the response dict. Errors come back as
        ``{"type": "error", "cmd", "message", "stack"}`` — never raised."""
        cmd = msg.get("cmd")
        try:
            if cmd not in COMMANDS:
                raise ValueError(
                    f"unknown command {cmd!r}; expected one of {COMMANDS}")
            resp = getattr(self, "_" + cmd)(msg)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            resp = dict(type="error", cmd=cmd, message=str(e),
                        stack=traceback.format_exc())
        self._emit(resp)
        return resp

    # ── command handlers ─────────────────────────────────────────────
    def _progress_cb(self):
        def cb(pct, label):
            self._emit(dict(type="progress", pct=float(pct),
                            label=str(label)))
        return cb

    @staticmethod
    def _params(msg) -> GenerationParams:
        params = msg.get("params")
        if not isinstance(params, GenerationParams):
            params = GenerationParams(**(params or {}))
        return params

    def _generate(self, msg):
        result = self.engine.generate(self._params(msg),
                                      on_progress=self._progress_cb())
        return dict(type="done", **_result_payload(result))

    def _reapply(self, msg):
        result = self.engine.reapply(
            sculpt=msg.get("sculpt"),
            skip_climate=bool(msg.get("skipClimate", False)),
            on_progress=self._progress_cb())
        return dict(type="reapplyDone", **_result_payload(result))

    def _editRecompute(self, msg):  # noqa: N802 — protocol name
        result = self.engine.edit_recompute(
            tuple(msg.get("toggledIndices", ())),
            skip_climate=bool(msg.get("skipClimate", False)),
            on_progress=self._progress_cb())
        return dict(type="editDone", **_result_payload(result))

    def _computeClimate(self, msg):  # noqa: N802
        cl = self.engine.compute_climate(
            temperature_offset=msg.get("temperatureOffset"),
            precipitation_offset=msg.get("precipitationOffset"),
            on_progress=self._progress_cb())
        n = self.engine._w["graph"].n_cells
        return dict(type="climateDone", **_climate_arrays(cl, n))

    def _importHeightmap(self, msg):  # noqa: N802
        gray = np.asarray(msg["grayscale"], np.float32)
        result = self.engine.import_heightmap(
            gray.ravel(), int(msg["width"]), int(msg["height"]),
            self._params(msg), on_progress=self._progress_cb())
        return dict(type="done", **_result_payload(result))
