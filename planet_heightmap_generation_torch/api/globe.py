"""Renderer bridge — per-halfedge globe geometry buffers + self-contained
WebGL viewer export.

Re-design of the reference's buildMesh (js/planet-mesh.js:620-836): one
triangle per half-edge — (inner triangle center, outer triangle center,
region point) — with radial displacement ``1 + elev*0.04`` (ocean depth
damped x0.3) and per-vertex colors from any inspect layer. The reference
uploads these to Three.js; here they are plain typed buffers any frontend
can consume, plus ``export_globe`` which writes a dependency-free WebGL2
HTML viewer (viewer/globe.html of this package) next to the binary — open
it in a browser and drag to orbit, wheel to zoom (js/scene.js:7-175's
camera analog). The halfedge twin pairing stays in numpy.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np

from ..interop import to_numpy

OCEAN_DEPTH_SCALE = 0.3
DISPLACE = 0.04  # js/planet-mesh.js globe displacement scale


def _halfedge_triangles(triangles: np.ndarray, n_total: int):
    """For each directed edge (a→b) of the triangulation: the triangle
    containing it (inner) and the one containing (b→a) (outer)."""
    t = len(triangles)
    a = triangles[:, 0].astype(np.int64)
    b = triangles[:, 1].astype(np.int64)
    c = triangles[:, 2].astype(np.int64)
    src = np.concatenate([a, b, c])
    dst = np.concatenate([b, c, a])
    tri_id = np.tile(np.arange(t, dtype=np.int32), 3)

    key = src * n_total + dst
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]

    rev = dst * n_total + src
    pos = np.searchsorted(key_sorted, rev)
    pos = np.clip(pos, 0, len(key_sorted) - 1)
    has_twin = key_sorted[pos] == rev
    outer = np.where(has_twin, tri_id[order][pos], tri_id)
    return src.astype(np.int32), dst.astype(np.int32), tri_id, \
        outer.astype(np.int32), has_twin


def _displace(elev):
    e = np.asarray(elev, np.float32)
    return 1.0 + DISPLACE * np.where(e > 0, e, e * OCEAN_DEPTH_SCALE)


def build_globe_geometry(result, layer: str = "terrain",
                         colors: Optional[np.ndarray] = None) -> Dict:
    """Typed geometry buffers for the displaced Voronoi globe.

    Returns dict(positions [S,3,3] f32, colors [S,3,3] f32, counts) where S
    = halfedge count (3T). Vertex order per halfedge triangle: inner
    triangle center, outer triangle center, region point — the reference's
    exact decomposition (js/planet-mesh.js:620-720), so its Three.js
    frontend could consume these buffers directly.
    """
    from .layers import layer_color

    graph = result.graph
    n_total = graph.n_cells
    tris = graph.triangles

    if colors is None:
        colors = to_numpy(layer_color(result, layer), np.float32)

    t_pos = graph.t_pos                                  # [T,3]
    t_elev = to_numpy(result.t_elevation, np.float32)  # [T]
    elev = to_numpy(result.elevation, np.float32)

    src, dst, inner_t, outer_t, has_twin = _halfedge_triangles(tris, n_total)
    keep = has_twin  # boundary halfedges (none on a closed sphere) dropped
    src, inner_t, outer_t = src[keep], inner_t[keep], outer_t[keep]

    v_inner = t_pos[inner_t] * _displace(t_elev[inner_t])[:, None]
    v_outer = t_pos[outer_t] * _displace(t_elev[outer_t])[:, None]
    v_region = graph.pos[src] * _displace(elev[src])[:, None]
    positions = np.stack([v_inner, v_outer, v_region], axis=1)  # [S,3,3]

    # winding fix: outward normals (js/planet-mesh.js:724-733)
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    nrm = np.cross(e1, e2)
    inward = np.einsum("sc,sc->s", nrm, graph.pos[src]) < 0
    positions[inward] = positions[inward][:, [0, 2, 1]]

    col = colors[src].astype(np.float32)                  # [S,3]
    col3 = np.repeat(col[:, None, :], 3, axis=1)          # flat per region

    return dict(positions=positions.astype(np.float32), colors=col3,
                num_triangles=len(positions), num_cells=n_total)


_VIEWER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "viewer", "globe.html")


def export_globe(result, out_dir: str, layer="terrain",
                 view: str = "globe") -> str:
    """Write globe geometry (positions f32 + per-layer color u8 buffers +
    a per-cell info block), a manifest, and the self-contained WebGL viewer
    into ``out_dir``. ``layer`` may be one name or a sequence — multiple
    layers share the geometry and the viewer gets a layer dropdown (the
    reference's inspect dropdown, index.html:286-325).

    The per-cell block (unit positions + per-halfedge cell ids + elevation
    + climate fields when present) powers the viewer's map mode, analytical
    max-dot picking and hover info card — the reference's interactive
    equirect map + edit-mode hover (js/planet-mesh.js:200-382,
    js/edit-mode.js:18-163). Returns the viewer HTML path."""
    from .layers import layer_color

    layers = [layer] if isinstance(layer, str) else list(layer)
    geo = build_globe_geometry(result, layers[0])
    os.makedirs(out_dir, exist_ok=True)

    pos = geo["positions"].reshape(-1, 3)
    src, _, inner_t, outer_t, has_twin = _halfedge_triangles(
        result.graph.triangles, result.graph.n_cells)
    src = src[has_twin]

    n = result.graph.n_cells
    with open(os.path.join(out_dir, "globe.bin"), "wb") as f:
        f.write(pos.astype("<f4").tobytes())
        layer_meta = []
        off = int(pos.nbytes)
        for name in layers:
            if name == layers[0]:
                col3 = geo["colors"]
            else:
                c = to_numpy(layer_color(result, name), np.float32)[src]
                col3 = np.repeat(c[:, None, :], 3, axis=1)
            col = np.clip(col3.reshape(-1, 3) * 255 + 0.5,
                          0, 255).astype(np.uint8)
            f.write(col.tobytes())
            layer_meta.append(dict(name=name, offset=off,
                                   nbytes=int(col.nbytes)))
            off += int(col.nbytes)

        # per-cell info block: picking + hover card + map rebuild data
        cells = dict(count=int(n))

        def put(name, arr, dtype):
            nonlocal off
            raw = np.ascontiguousarray(arr.astype(dtype)).tobytes()
            f.write(raw)
            cells[name] = dict(offset=off, nbytes=len(raw))
            off += len(raw)

        put("pos", np.asarray(result.graph.pos[:n]), "<f4")
        put("tri_cell", src, "<i4")           # halfedge → region cell id
        put("elev", to_numpy(result.elevation, np.float32)[:n], "<f4")
        climate = getattr(result, "climate", None)
        if climate:
            temp = climate.get("temp", {})
            precip = climate.get("precip", {})
            for key, blk, nm in (
                    ("r_temperature_summer", temp, "temp_summer"),
                    ("r_temperature_winter", temp, "temp_winter"),
                    ("r_precip_summer", precip, "precip_summer"),
                    ("r_precip_winter", precip, "precip_winter")):
                if key in blk:
                    put(nm, to_numpy(blk[key], np.float32)[:n], "<f4")
            if "koppen" in climate:
                put("koppen", to_numpy(climate["koppen"], np.int64)[:n], "u1")

    manifest = dict(
        vertices=int(len(pos)), layer=layers[0], layers=layer_meta,
        initial_view=view,
        positions_bytes=int(pos.nbytes),
        colors_bytes=layer_meta[0]["nbytes"],
        num_cells=geo["num_cells"], cells=cells,
        koppen_legend=_koppen_legend(),
        total_bytes=off)
    with open(os.path.join(out_dir, "globe.json"), "w") as f:
        json.dump(manifest, f)

    html = os.path.join(out_dir, "globe.html")
    shutil.copyfile(_VIEWER, html)
    return html


def _koppen_legend():
    """Köppen class codes + display colors for the viewer legend
    (reference js/main.js:282-415 legend panel; colors js/koppen.js:19-51)."""
    from ..climate.koppen import KOPPEN_CODES, KOPPEN_COLORS

    return [dict(code=c, color=list(col))
            for c, col in zip(KOPPEN_CODES, KOPPEN_COLORS)]
