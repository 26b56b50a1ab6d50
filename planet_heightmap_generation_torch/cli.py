"""Command-line interface of the PyTorch/CUDA port — mirrors the five
worker commands plus export (SURVEY.md §7 M5: generate / reapply / edit /
climate / import / export), with the JAX package's subcommands, flags,
outputs and exit codes. Every command that computes takes ``--device``
(default ``cuda``); it runs on the CPU only when asked to
(``--device cpu``).

The worker keeps retained state alive between messages
(js/planet-worker.js:104-134); the CLI equivalent is a SESSION file:
``generate --session s.npz`` saves it, and ``reapply`` / ``edit`` /
``climate`` load it, run the corresponding worker command, and save back.

Usage:
    python -m planet_heightmap_generation_torch.cli generate --seed 42 --cells 40000 --out planet.npz --session s.npz
    python -m planet_heightmap_generation_torch.cli generate --code <planet-code> --out planet.npz
    python -m planet_heightmap_generation_torch.cli reapply --session s.npz --smoothing 0.8 --out planet.npz
    python -m planet_heightmap_generation_torch.cli edit --session s.npz --toggle 3,7 --out planet.npz
    python -m planet_heightmap_generation_torch.cli climate --session s.npz --temperature-offset 5 --out climate.npz
    python -m planet_heightmap_generation_torch.cli export --in planet.npz --type heightmap --width 2048 --out map.png
    python -m planet_heightmap_generation_torch.cli import-heightmap --image gray.npy --cells 40000 --out planet.npz
    python -m planet_heightmap_generation_torch.cli code --seed 42 --cells 204000
    python -m planet_heightmap_generation_torch.cli generate --device cpu --cells 2000 --out planet.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .config import GenerationParams
from .interop import to_numpy
from .api.planet_code import encode_planet_code, decode_planet_code


def _params_from_args(args) -> GenerationParams:
    if getattr(args, "code", None):
        d = decode_planet_code(args.code)
        if d is None:
            sys.exit(f"invalid planet code: {args.code}")
        return GenerationParams(
            seed=d["seed"], n_cells=int(d["N"]), jitter=d["jitter"],
            n_plates=int(d["P"]), num_continents=int(d["numContinents"]),
            roughness=d["roughness"], smoothing=d["smoothing"],
            glacial_erosion=d["glacialErosion"],
            hydraulic_erosion=d["hydraulicErosion"],
            thermal_erosion=d["thermalErosion"],
            ridge_sharpening=d["ridgeSharpening"],
            soil_creep=d["soilCreep"], terrain_warp=d["terrainWarp"],
            continent_size_variety=d["continentSizeVariety"],
            temperature_offset=d["temperatureOffset"],
            precipitation_offset=d["precipitationOffset"],
            land_coverage=d["landCoverage"],
            toggled_indices=tuple(d["toggledIndices"]),
            skip_climate=args.skip_climate or None,
        )
    return GenerationParams(
        seed=args.seed, n_cells=args.cells, jitter=args.jitter,
        n_plates=args.plates, num_continents=args.continents,
        roughness=args.roughness, smoothing=args.smoothing,
        glacial_erosion=args.glacial, hydraulic_erosion=args.hydraulic,
        thermal_erosion=args.thermal, ridge_sharpening=args.ridge,
        terrain_warp=args.warp, land_coverage=args.land_coverage,
        skip_climate=args.skip_climate or None,
    )


def _save_result(result, path: str):
    if result.error is not None:
        # the engine degrades to terrain-only on a climate stage error;
        # surface it loudly instead of silently saving a partial planet
        print(f"error: stage failed: {result.error}", file=sys.stderr)
        raise SystemExit(3)
    p = result.params
    out = dict(
        elevation=to_numpy(result.elevation)[: result.graph.n_cells],
        pos=result.graph.pos[: result.graph.n_cells],
        r_plate=to_numpy(result.r_plate)[: result.graph.n_cells],
        plate_is_ocean=result.plate_is_ocean,
        stress=to_numpy(result.stress)[: result.graph.n_cells],
        seed=p.seed,
        n_cells=p.n_cells,
        # mesh-rebuild provenance: export must reconstruct the SAME mesh the
        # planet was generated on — jitter changes every cell position, so a
        # hardcoded default silently misregisters pixels (round-2 verdict #6)
        jitter=p.jitter,
        code=encode_planet_code(
            p.seed, p.n_cells, p.jitter, p.n_plates, p.num_continents,
            p.roughness, p.terrain_warp, p.smoothing, p.glacial_erosion,
            p.hydraulic_erosion, p.thermal_erosion, p.ridge_sharpening,
            p.soil_creep, p.continent_size_variety, p.temperature_offset,
            p.precipitation_offset, p.land_coverage,
            list(p.toggled_indices)),
    )
    if result.climate is not None:
        out["koppen"] = to_numpy(
            result.climate["koppen"])[: result.graph.n_cells]
        for s in ("summer", "winter"):
            out[f"temperature_{s}"] = to_numpy(
                result.climate["temp"][f"r_temperature_{s}"])[: result.graph.n_cells]
            out[f"precip_{s}"] = to_numpy(
                result.climate["precip"][f"r_precip_{s}"])[: result.graph.n_cells]
    np.savez_compressed(path, **out)
    print(f"saved {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="planet_heightmap_generation_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_device(p):
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; "
                            "'cpu' runs the plain-torch path)")

    def add_gen_args(p):
        p.add_argument("--code", help="planet code (overrides sliders)")
        p.add_argument("--seed", type=int, default=42)
        p.add_argument("--cells", type=int, default=204_000)
        p.add_argument("--jitter", type=float, default=0.75)
        p.add_argument("--plates", type=int, default=80)
        p.add_argument("--continents", type=int, default=4)
        p.add_argument("--roughness", type=float, default=0.25)
        p.add_argument("--smoothing", type=float, default=0.3)
        p.add_argument("--glacial", type=float, default=0.0)
        p.add_argument("--hydraulic", type=float, default=0.5)
        p.add_argument("--thermal", type=float, default=0.1)
        p.add_argument("--ridge", type=float, default=0.35)
        p.add_argument("--warp", type=float, default=0.5)
        p.add_argument("--land-coverage", type=float, default=0.3)
        p.add_argument("--skip-climate", action="store_true")
        p.add_argument("--out", default="planet.npz")
        add_device(p)

    g = sub.add_parser("generate", help="full planet generation")
    add_gen_args(g)
    g.add_argument("--session", default=None,
                   help="also save retained worker state for later "
                        "reapply/edit/climate commands")

    # the three retained-state worker commands (js/planet-worker.js:944-954)
    SCULPT_SLIDERS = ("smoothing", "glacial", "hydraulic", "thermal",
                      "ridge", "warp")
    ra = sub.add_parser(
        "reapply", help="re-run erosion post-processing on a saved session "
                        "with changed sculpt sliders")
    ra.add_argument("--session", required=True)
    for s_ in SCULPT_SLIDERS:
        ra.add_argument(f"--{s_}", type=float, default=None)
    ra.add_argument("--skip-climate", action="store_true")
    ra.add_argument("--out", default="planet.npz")
    add_device(ra)

    ed = sub.add_parser(
        "edit", help="toggle plate ocean/land state on a saved session and "
                     "recompute elevation onward")
    ed.add_argument("--session", required=True)
    ed.add_argument("--toggle", required=True,
                    help="comma list of plate indices to flip")
    ed.add_argument("--skip-climate", action="store_true")
    ed.add_argument("--out", default="planet.npz")
    add_device(ed)

    cl = sub.add_parser(
        "climate", help="(re)compute climate on a saved session, optionally "
                        "with new temperature/precipitation offsets")
    cl.add_argument("--session", required=True)
    cl.add_argument("--temperature-offset", type=float, default=None)
    cl.add_argument("--precipitation-offset", type=float, default=None)
    cl.add_argument("--out", default="climate.npz")
    add_device(cl)

    e = sub.add_parser("export", help="equirect map export")
    e.add_argument("--in", dest="infile", required=True)
    e.add_argument("--type", default="heightmap")
    e.add_argument("--width", type=int, default=2048)
    e.add_argument("--out", default="map.png")
    add_device(e)

    i = sub.add_parser("import-heightmap", help="grayscale equirect import")
    add_gen_args(i)
    i.add_argument("--image", required=True,
                   help="equirect heightmap: .png (luminance extracted, "
                        "js/import-main.js:60-63) or .npy grayscale 0-255")

    c = sub.add_parser("code", help="print the planet code for parameters")
    add_gen_args(c)

    s = sub.add_parser("sweep", help="multi-seed batch sweep (config-5 shape)")
    add_gen_args(s)
    s.add_argument("--seeds", default="0-15",
                   help="seed range 'a-b' (inclusive) or comma list")
    s.add_argument("--export-width", type=int, default=0,
                   help="also export a heightmap PNG per seed at this width")

    ins = sub.add_parser("inspect", help="hover-card info at lat/lon")
    add_gen_args(ins)
    ins.add_argument("--lat", type=float, required=True)
    ins.add_argument("--lon", type=float, required=True)

    gl = sub.add_parser(
        "globe", help="generate + export the interactive WebGL globe viewer")
    add_gen_args(gl)
    gl.add_argument("--layer", default="terrain",
                    help="layer name, or comma list for a viewer dropdown")
    gl.add_argument("--dir", dest="out_dir", default="globe_out",
                    help="output directory for globe.html/json/bin")
    gl.add_argument("--view", choices=("globe", "map"), default="globe",
                    help="initial view mode: orbiting globe or the "
                         "interactive equirect map (pan across ±180°, "
                         "'m' toggles at runtime)")

    args = ap.parse_args(argv)

    if args.cmd == "code":
        p = _params_from_args(args)
        print(encode_planet_code(
            p.seed, p.n_cells, p.jitter, p.n_plates, p.num_continents,
            p.roughness, p.terrain_warp, p.smoothing, p.glacial_erosion,
            p.hydraulic_erosion, p.thermal_erosion, p.ridge_sharpening,
            p.soil_creep, p.continent_size_variety, p.temperature_offset,
            p.precipitation_offset, p.land_coverage,
            list(p.toggled_indices)))
        return

    if args.cmd == "generate":
        from .pipeline import PlanetEngine
        params = _params_from_args(args)
        engine = PlanetEngine(device=args.device)
        result = engine.generate(
            params, on_progress=lambda pct, label: print(f"[{pct:3.0f}%] {label}"))
        print(result.timing.table())
        print("mesh build:", result.graph.build_stats)
        print("diagnostics:", result.diagnostics())
        _save_result(result, args.out)
        if args.session:
            engine.save_session(args.session)
            print(f"session saved: {args.session}")
        return

    if args.cmd == "reapply":
        from .pipeline import PlanetEngine
        engine = PlanetEngine.load_session(args.session,
                                           device=args.device)
        sculpt_map = dict(smoothing="smoothing", glacial="glacial_erosion",
                          hydraulic="hydraulic_erosion",
                          thermal="thermal_erosion",
                          ridge="ridge_sharpening", warp="terrain_warp")
        sculpt = {param: getattr(args, flag)
                  for flag, param in sculpt_map.items()
                  if getattr(args, flag) is not None}
        result = engine.reapply(
            sculpt=sculpt or None, skip_climate=args.skip_climate,
            on_progress=lambda pct, label: print(f"[{pct:3.0f}%] {label}"))
        print("diagnostics:", result.diagnostics())
        _save_result(result, args.out)
        engine.save_session(args.session)
        print(f"session updated: {args.session}")
        return

    if args.cmd == "edit":
        from .pipeline import PlanetEngine
        engine = PlanetEngine.load_session(args.session,
                                           device=args.device)
        toggles = [int(x) for x in args.toggle.split(",") if x.strip()]
        result = engine.edit_recompute(
            toggles, skip_climate=args.skip_climate,
            on_progress=lambda pct, label: print(f"[{pct:3.0f}%] {label}"))
        print("diagnostics:", result.diagnostics())
        _save_result(result, args.out)
        engine.save_session(args.session)
        print(f"session updated: {args.session}")
        return

    if args.cmd == "climate":
        from .pipeline import PlanetEngine
        engine = PlanetEngine.load_session(args.session,
                                           device=args.device)
        climate = engine.compute_climate(
            temperature_offset=args.temperature_offset,
            precipitation_offset=args.precipitation_offset,
            on_progress=lambda pct, label: print(f"[{pct:3.0f}%] {label}"))
        n = engine._w["graph"].n_cells
        out = dict(koppen=to_numpy(climate["koppen"])[:n])
        for s_ in ("summer", "winter"):
            out[f"temperature_{s_}"] = to_numpy(
                climate["temp"][f"r_temperature_{s_}"])[:n]
            out[f"precip_{s_}"] = to_numpy(
                climate["precip"][f"r_precip_{s_}"])[:n]
            out[f"wind_speed_{s_}"] = to_numpy(
                climate["wind"][f"r_wind_speed_{s_}"])[:n]
        np.savez_compressed(args.out, **out)
        print(f"saved {args.out}")
        engine.save_session(args.session)
        print(f"session updated: {args.session}")
        return

    if args.cmd == "globe":
        from .pipeline import PlanetEngine
        from .api.globe import export_globe
        params = _params_from_args(args)
        engine = PlanetEngine(device=args.device)
        result = engine.generate(
            params, on_progress=lambda pct, label: print(f"[{pct:3.0f}%] {label}"))
        print("diagnostics:", result.diagnostics())
        layer = args.layer.split(",") if "," in args.layer else args.layer
        html = export_globe(result, args.out_dir, layer=layer,
                            view=args.view)
        print(f"globe viewer written: {html}")
        print(f"serve with: python -m http.server -d {args.out_dir}")
        return

    if args.cmd == "sweep":
        import json
        from .parallel.batch import generate_batch
        from .api.export import export_map, save_png
        from .mesh.device import to_device

        import re
        m = re.fullmatch(r"(-?\d+)-(-?\d+)", args.seeds.strip())
        if m:
            seeds = list(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            seeds = [int(x) for x in args.seeds.split(",")]
        params = _params_from_args(args)
        for i, r in enumerate(generate_batch(params, seeds,
                                             devices=[args.device])):
            d = r.diagnostics()
            print(json.dumps(dict(seed=seeds[i], **d)))
            if args.export_width:
                img = export_map(to_device(r.graph, args.device),
                                 r.elevation, "heightmap",
                                 height=args.export_width // 2,
                                 width=args.export_width)
                save_png(img, f"heightmap_seed{seeds[i]}.png")
        return

    if args.cmd == "inspect":
        import json
        from .pipeline import PlanetEngine
        from .api.picking import nearest_region, cell_info

        params = _params_from_args(args)
        result = PlanetEngine(device=args.device).generate(params)
        cell = nearest_region(result, args.lat, args.lon)
        print(json.dumps(cell_info(result, cell), indent=2))
        return

    if args.cmd == "import-heightmap":
        from .pipeline import PlanetEngine
        from .api.imageio import load_heightmap_gray
        params = _params_from_args(args)
        img = load_heightmap_gray(args.image)
        engine = PlanetEngine(device=args.device)
        result = engine.import_heightmap(
            img.astype(np.float32).ravel(), img.shape[1], img.shape[0], params)
        _save_result(result, args.out)
        return

    if args.cmd == "export":
        from .mesh.build import build_sphere
        from .mesh.device import to_device
        from .api.export import export_map, save_png

        data = np.load(args.infile)
        n = int(data["n_cells"])
        seed = int(data["seed"])
        # rebuild the mesh from the stored seed/cells/jitter (deterministic;
        # same RNG threading as engine.generate — build_sphere seeds
        # ParkMiller(seed) exactly like the engine's rng). Legacy npz files
        # predate the jitter key; they were all generated at the 0.75 default.
        jitter = float(data["jitter"]) if "jitter" in data else 0.75
        graph = build_sphere(n, jitter, seed=float(seed))
        g = to_device(graph, args.device)
        elev = np.zeros(g.n_padded, np.float32)
        elev[: graph.n_cells] = data["elevation"]
        koppen = None
        if "koppen" in data:
            k = np.zeros(g.n_padded, np.int32)
            k[: graph.n_cells] = data["koppen"]
            koppen = torch.as_tensor(k, device=g.device)
        img = export_map(g, torch.as_tensor(elev, device=g.device),
                         args.type,
                         height=args.width // 2, width=args.width,
                         koppen=koppen)
        save_png(img, args.out)
        print(f"saved {args.out}")
        return


if __name__ == "__main__":
    main()
