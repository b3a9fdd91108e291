"""Command-line interface of the port.

    localize    candidate-camera search + PnP pose, written as the
                reference's location CSV (main_v1.py flow); with
                --report / --viz-pass the accuracies and correlations
                CSVs and plots, with --dem the DEM geo-inversion of
                --query pixels, a --json-file boundary and a REPL
    twoview     relative pose of two grayscale images (.npy) through the
                two-view pipeline
    bench       one-line JSON headline benchmark (hypotheses/s), the same
                code as ``python -m ransac_tpu_torch.bench``
    profile     speed-of-light table of the hot kernels and workloads
                (``ransac_tpu_torch.profile``); ``--measure-peaks`` measures
                the card's rooflines first

Run: python -m ransac_tpu_torch.cli localize --help

``--device`` defaults to ``cuda``; asking for CUDA where there is none is
an error (exit code 2), never a quiet run on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def _cuda_missing(device) -> bool:
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {device}: CUDA is not available", file=sys.stderr)
        return True
    return False


def _load_image(path: str):
    """The report's background image: .npy as ``_load_gray`` reads it, any
    other format through PIL where PIL is installed."""
    if path.endswith(".npy"):
        return _load_gray(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit(f"error: --image {path}: only .npy images can be read "
                         f"without PIL ({e})") from e
    import numpy as np

    return np.asarray(Image.open(path))


def _have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def _cmd_localize(args) -> int:
    from ransac_tpu_torch.io.export import write_location_csv
    from ransac_tpu_torch.io.tables import (build_scene, read_camera_locations,
                                            read_points_data)
    from ransac_tpu_torch.pipelines.localize import localize
    from ransac_tpu_torch.utils.config import LocalizeConfig, RansacConfig

    if _cuda_missing(args.device):
        return 2
    feats = read_points_data(
        args.features, args.pixel_x, args.pixel_y, scale=args.scale,
        z_mode=args.z_mode)
    cams = read_camera_locations(args.cameras,
                                 observer_height=args.observer_height)
    scene = build_scene(feats, cams, device=args.device)

    def config(threshold):
        return LocalizeConfig(ransac=RansacConfig(threshold=threshold),
                              grid_code_min=args.grid_code_min,
                              min_pnp_inliers=args.min_pnp_inliers)

    res = localize(scene, (args.width, args.height), config(args.ransacbound),
                   seed=args.seed, use_sweep=args.sweep, device=args.device)
    loc = res.best_location_utm
    print(f"best location: index {res.best_index} "
          f"grid={scene.cameras.grid_codes[res.best_index]} "
          f"utm=({loc[0]:.2f}, {loc[1]:.2f}, {loc[2]:.2f})")
    if res.camera_origin_utm is not None:
        print(f"PnP camera origin (UTM): {res.camera_origin_utm}")
    else:
        print("PnP RANSAC failed or insufficient inliers.")
    if args.output:
        out = args.output.replace(".jpg", "_location.csv")
        if not out.endswith(".csv"):
            out += "_location.csv"
        write_location_csv(out, res.scores_rows)
        print(f"wrote {out}")
    if args.output and (args.report or args.viz_pass is not None):
        _report(args, scene, res, config, feats_all=read_points_data(
            args.features, args.pixel_x, args.pixel_y, scale=args.scale,
            z_mode=args.z_mode, keep_unannotated=True))
    if args.dem and res.camera_origin_utm is not None:
        return _geo_inversion(args, scene, res)
    return 0


def _report(args, scene, res, config, feats_all):
    """--report: the accuracies and correlations CSVs of the winner (the
    unannotated rows forward-projected, main_v1.py:367-383) and its eight
    plots; --viz-pass: the search again at a tight bound (test02.py:468)
    with its location CSV, report CSVs and three dashboards
    (test02.py:160-203).  Plots need matplotlib: without it the CSVs are
    written and the run says so."""
    from ransac_tpu_torch.io.export import write_location_csv
    from ransac_tpu_torch.pipelines.localize import (
        export_best_candidate_report, localize)

    plots = _have_matplotlib()
    if not plots:
        print("matplotlib is not installed: the report's CSVs are written, "
              "its plots are not", file=sys.stderr)
    if args.report:
        img = _load_image(args.image) if args.image else None
        export_best_candidate_report(scene, res, args.output, image=img,
                                     make_plots=plots, all_features=feats_all)
        print(f"wrote accuracies/correlations CSVs{' + diagnostic PNGs' * plots} "
              f"for {args.output}")
    if args.viz_pass is not None:
        res_viz = localize(scene, (args.width, args.height),
                           config(args.viz_pass), seed=args.seed,
                           use_sweep=args.sweep, device=args.device)
        base = args.output.replace(".jpg", "") + "_viz"
        write_location_csv(base + "_location.csv", res_viz.scores_rows)
        acc_rows, corr_rows = export_best_candidate_report(
            scene, res_viz, base + ".jpg", make_plots=False)
        if plots:
            from ransac_tpu_torch import viz

            viz.plot_accuracies(acc_rows, save_to=base + "_accuracies.png")
            viz.plot_correlation_heatmap(corr_rows,
                                         save_to=base + "_correlations.png")
            viz.plot_camera_location_scores(res_viz.scores_rows,
                                            zone=scene.frame.zone,
                                            save_to=base + "_locations.png")
        print(f"wrote tight-threshold viz pass (ransacbound={args.viz_pass}) "
              f"artifacts at {base}_*")


def _geo_inversion(args, scene, res) -> int:
    """--dem: the DEM under the PnP camera (snapped 1.5 m above it,
    main_v1.py:914-915, and bounds-checked, main_v1.py:921-929), then the
    --json-file boundary (boundary_points_geo.csv, output_shapefiles/), the
    --query pixels and, with --interactive, the REPL (main_v1.py:934-958).

    The grid's elevations are centred on the scene frame's anchor z, as the
    camera and the control points are (``io.dem.center_elevations``): the
    JAX package's command keeps them absolute, so its ray corrections and
    its answers' z are off by the anchor's z."""
    import json

    import numpy as np

    from ransac_tpu_torch.io.dem import (center_elevations, load_geotiff,
                                         resample_to_utm)
    from ransac_tpu_torch.io.export import (save_boundary_shapefiles,
                                            write_boundary_csv)
    from ransac_tpu_torch.pipelines.raycast import localized_inverter

    dem = center_elevations(resample_to_utm(
        load_geotiff(args.dem), scene.frame, spacing_m=args.dem_spacing))
    inv = localized_inverter(scene, res, dem, device=args.device)
    if inv is None:
        print("camera origin outside DEM coverage; skipping geo-inversion")
        return 0
    if args.json_file:
        with open(args.json_file, encoding="utf-8") as f:
            data = json.load(f)
        geo, pix = inv.convert_boundary(data)
        write_boundary_csv("boundary_points_geo.csv", geo, pix)
        save_boundary_shapefiles(geo, "output_shapefiles",
                                 data.get("info", {}).get("name", ""))
        print("wrote boundary_points_geo.csv + output_shapefiles/")

    def answer(px, py):
        utm, hit = inv.pixel_to_geo(np.array([[px, py]]))
        if hit[0]:
            print(f"pixel ({px:.0f},{py:.0f}) -> "
                  f"E={utm[0, 0]:.2f} N={utm[0, 1]:.2f} z={utm[0, 2]:.2f}")
        else:
            print(f"pixel ({px:.0f},{py:.0f}) -> no DEM intersection")

    for q in args.query:
        px, py = (float(v) for v in q.split(","))
        answer(px, py)
    while args.interactive:
        try:
            line = input("pixel x,y (or 'exit'): ").strip()
        except EOFError:
            break
        if line.lower() == "exit":
            break
        parts = line.replace(" ", "").replace("\uff0c", ",").split(",")
        if len(parts) != 2:
            print("format: 755,975")
            continue
        try:
            answer(float(parts[0]), float(parts[1]))
        except ValueError as e:
            print(f"bad input: {e}")
    return 0


def _load_gray(path: str):
    """A grayscale image from a .npy file: [H, W] (or [H, W, C], averaged)
    float values in [0, 1], or integers scaled by 1/255."""
    import numpy as np

    img = np.load(path)
    if img.ndim == 3:
        img = img.mean(-1)
    if np.issubdtype(img.dtype, np.integer):
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def _cmd_twoview(args) -> int:
    import numpy as np

    from ransac_tpu_torch.pipelines.twoview import two_view_pipeline
    from ransac_tpu_torch.utils.config import TwoViewConfig

    if _cuda_missing(args.device):
        return 2
    img1, img2 = _load_gray(args.image1), _load_gray(args.image2)
    if args.intrinsics:
        K = np.loadtxt(args.intrinsics).reshape(3, 3)
    else:  # the JAX package's default camera
        f = 1.2 * max(img1.shape)
        K = np.array([[f, 0, img1.shape[1] / 2],
                      [0, f, img1.shape[0] / 2], [0, 0, 1.0]])
    res = two_view_pipeline(img1, img2, K, TwoViewConfig(
        max_keypoints=args.max_keypoints), device=args.device)
    print(f"matches: {len(res.matches)}  inliers: {int(res.inliers.sum())}  "
          f"cheiral: {res.n_cheiral}")
    print("R:", np.array2string(res.R, precision=4))
    print("t:", np.array2string(res.t, precision=4))
    if args.out:
        np.savez(args.out, **res.__dict__)
        print(f"wrote {args.out}")
    return 0


def _cmd_bench(args) -> int:
    from ransac_tpu_torch import bench

    return bench.run_args(args)


def _cmd_profile(args) -> int:
    from ransac_tpu_torch import profile

    return profile.run_args(args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ransac_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("localize", help="candidate search + PnP")
    p.add_argument("--features", required=True)
    p.add_argument("--cameras", required=True)
    p.add_argument("--pixel-x", dest="pixel_x", required=True)
    p.add_argument("--pixel-y", dest="pixel_y", required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--ransacbound", type=float, default=75.0)
    p.add_argument("--grid-code-min", dest="grid_code_min", type=int, default=0)
    p.add_argument("--observer-height", type=float, default=2.0)
    p.add_argument("--z-mode", dest="z_mode", default="elevation",
                   choices=["elevation", "height_plus_elevation"])
    p.add_argument("--min-pnp-inliers", dest="min_pnp_inliers", type=int,
                   default=6, help="PnP inlier guard (main_v1.py:504)")
    p.add_argument("--sweep", action="store_true",
                   help="search through the candidate-sweep CUDA kernel")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--output", default="")
    p.add_argument("--dem", default="", help="GeoTIFF DEM (lon/lat) for the "
                   "pixel -> ground inversion")
    p.add_argument("--dem-spacing", type=float, default=10.0,
                   help="UTM grid spacing of the resampled DEM, m")
    p.add_argument("--json-file", default="",
                   help="ISAT boundary JSON to invert (needs --dem)")
    p.add_argument("--query", nargs="*", default=[],
                   help="pixel queries 'x,y' for geo-inversion")
    p.add_argument("--interactive", action="store_true",
                   help="REPL for pixel->geo queries (needs --dem)")
    p.add_argument("--report", action="store_true",
                   help="write accuracies/correlations CSVs + plots")
    p.add_argument("--viz-pass", dest="viz_pass", type=float, default=None,
                   help="re-run the search at this tight ransacbound and "
                        "draw the dashboards (test02.py:468 uses 5.0)")
    p.add_argument("--image", default="",
                   help="image for the report's overlay (.npy; other formats "
                        "need PIL)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_localize)

    p = sub.add_parser("twoview", help="relative pose of two images")
    p.add_argument("image1", help="grayscale image, .npy")
    p.add_argument("image2", help="grayscale image, .npy")
    p.add_argument("--intrinsics", default="",
                   help="3x3 K as text (default: f = 1.2 max(H, W), centred)")
    p.add_argument("--max-keypoints", dest="max_keypoints", type=int,
                   default=1024)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions and the stage-wise engine)")
    p.add_argument("--out", default="", help="write the result as .npz")
    p.set_defaults(fn=_cmd_twoview)

    from ransac_tpu_torch.bench import add_arguments

    p = sub.add_parser("bench", help="one-line JSON benchmark")
    add_arguments(p)
    p.set_defaults(fn=_cmd_bench)

    from ransac_tpu_torch.profile import add_arguments as add_profile_arguments

    p = sub.add_parser("profile", help="speed-of-light kernel report")
    add_profile_arguments(p)
    p.set_defaults(fn=_cmd_profile)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
