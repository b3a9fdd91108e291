"""Command-line interface of the port.

    localize    candidate-camera search + PnP pose, written as the
                reference's location CSV (main_v1.py flow); with
                --calibration the annotated pixels undistorted first, with
                --report / --viz-pass the accuracies and correlations
                CSVs and plots, with --dem the DEM geo-inversion of
                --query pixels, a --json-file boundary and a REPL
    run         localize for each job of a JSON config (images_info list)
    calibrate   chessboard calibration (Zhang + joint LM) of board images
                (.npy on the device, other formats through PIL), written
                as the .npz that localize --calibration reads
    intrinsics  focal-length / film-format grid search by PnP (testpro-K)
    twoview     relative pose of two grayscale images (.npy) through the
                two-view pipeline
    sfm         incremental SfM (bootstrap, PnP registration, triangulation,
                bundle adjustment) over a track table; --demo F runs the
                multi-frame demo end to end on F rendered frames (front
                end, tracks, SfM, CG BA), --loop on a closed circuit with
                loop closure and a Sim(3) pose graph; under torchrun every
                rank runs the front end, the primary the rest
    ba          bundle adjustment of a BAL problem file (plain or .bz2)
                through the matrix-free Schur-CG solver, its solution
                written back as a BAL file with --out
    bench       one-line JSON headline benchmark (hypotheses/s), the same
                code as ``python -m ransac_tpu_torch.bench``
    profile     speed-of-light table of the hot kernels and workloads
                (``ransac_tpu_torch.profile``); ``--measure-peaks`` measures
                the card's rooflines first; ``--scaling`` / ``--scaling-only``
                the multi-rank scaling harness (``utils.scaling``)

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
    if getattr(args, "calibration", ""):
        _apply_calibration(feats, args.calibration, args.device)
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


def _apply_calibration(feats, calib_path, device):
    """Undistort the annotated feature pixels with a saved calibration, on
    ``device`` (the reference undistorts the whole image before the search,
    testpro.py:954-955; undistorting the annotations is the pipeline's
    equivalent).  Reads the .npz of ``calibrate`` (either package's).
    Returns the calibrated K."""
    import numpy as np
    import torch

    from ransac_tpu_torch.models.calibration import undistort_points

    d = np.load(calib_path, allow_pickle=True)
    K = np.asarray(d["K"], np.float64)
    dist = np.asarray(d["dist"], np.float64)
    annotated = (np.abs(feats.pixels) > 0).any(axis=1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    und = undistort_points(f32(feats.pixels[annotated]), f32(K), f32(dist))
    und = und.cpu().numpy().astype(np.float64)
    shift = float(np.abs(und - feats.pixels[annotated]).max()) if annotated.any() else 0.0
    feats.pixels = feats.pixels.copy()
    feats.pixels[annotated] = und
    print(f"calibration {calib_path}: undistorted {int(annotated.sum())} feature "
          f"pixels (max shift {shift:.2f} px)")
    return K


#: ``run`` job keys (the JAX command's) -> ``localize`` flags.
_RUN_FLAGS = {"features": "--features", "camera_locations": "--cameras",
              "pixel_x": "--pixel-x", "pixel_y": "--pixel-y", "width": "--width",
              "height": "--height", "scale": "--scale", "ransacbound": "--ransacbound",
              "grid_code_min": "--grid-code-min", "observer_height": "--observer-height",
              "z_mode": "--z-mode", "calibration": "--calibration", "output": "--output",
              "dem_file": "--dem", "dem_spacing": "--dem-spacing",
              "json_file": "--json-file", "query": "--query", "seed": "--seed",
              "min_pnp_inliers": "--min-pnp-inliers", "viz_pass": "--viz-pass",
              "image_name": "--image", "sweep": "--sweep", "report": "--report"}
_RUN_SWITCHES = ("sweep", "report")


def _cmd_run(args) -> int:
    """Batch runner: ``localize`` for each job of a JSON config holding an
    images_info-style list (main_v1.py:975-1013), on ``--device``.  Each
    job's keys become ``localize`` flags, parsed by its own parser, so the
    defaults are ``localize``'s."""
    import json

    with open(args.config, encoding="utf-8") as f:
        cfg = json.load(f)
    jobs = cfg if isinstance(cfg, list) else cfg.get("images", [])
    for job in jobs:
        print(f"=== {job.get('image_name', job.get('output', '?'))} ===")
        argv = []
        for key, flag in _RUN_FLAGS.items():
            value = job.get(key)
            if key in _RUN_SWITCHES:
                argv += [flag] * bool(value)
            elif isinstance(value, list):
                argv += [flag, *map(str, value)]
            elif value is not None:
                argv += [flag, str(value)]
        ns = args.localize_parser.parse_args(argv + ["--device", args.device])
        rc = ns.fn(ns)
        if rc:
            return rc
    return 0


def _load_board(path: str, device):
    """A board image as a float32 tensor on ``device``: .npy as
    ``_load_gray`` reads it, other formats through PIL (as the JAX command
    reads them: 8-bit gray values, 0-255)."""
    import numpy as np
    import torch

    if path.endswith(".npy"):
        img = _load_gray(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise SystemExit(f"error: {path}: only .npy boards can be read "
                             f"without PIL ({e})") from e
        img = np.asarray(Image.open(path).convert("L"), np.float32)
    return torch.as_tensor(img, device=device)


def _cmd_calibrate(args) -> int:
    """Chessboard calibration (the reference's calibration-first flow,
    testpro.py:947-956): the inner corners of each board image, Zhang and
    the joint LM on ``--device``, then K, the distortion and the RMS, and
    the .npz that ``localize --calibration`` reads (the JAX command's keys
    and dtypes)."""
    import glob

    import numpy as np
    import torch

    from ransac_tpu_torch.features.chessboard import find_chessboard_corners
    from ransac_tpu_torch.models.calibration import (calibrate_camera,
                                                     checkerboard_object_points)

    if _cuda_missing(args.device):
        return 2
    paths = sorted(p for pat in args.images for p in glob.glob(pat))
    if not paths:
        print("error: no images matched", file=sys.stderr)
        return 2
    views, used, size = [], [], None
    for p in paths:
        img = _load_board(p, args.device)
        if size is None:
            size = tuple(img.shape[:2])
        found, corners = find_chessboard_corners(img, args.cols, args.rows,
                                                 device=args.device)
        if not found:
            print(f"  {p}: corners NOT found, skipping")
            continue
        views.append(corners)
        used.append(p)
        print(f"  {p}: {args.cols}x{args.rows} corners found")
    if len(views) < 3:
        print(f"error: only {len(views)} usable views (need >= 3)", file=sys.stderr)
        return 2
    obj = checkerboard_object_points(args.cols, args.rows, args.square_size)
    res = calibrate_camera(
        torch.as_tensor(obj, dtype=torch.float32, device=args.device),
        torch.as_tensor(np.stack(views), dtype=torch.float32, device=args.device))
    K = res.K.cpu().numpy().astype(np.float64)
    dist = res.dist.cpu().numpy().astype(np.float64)
    rms = float(res.rms)
    print(f"calibrated from {len(views)} views: fx={K[0, 0]:.2f} fy={K[1, 1]:.2f} "
          f"cx={K[0, 2]:.2f} cy={K[1, 2]:.2f}")
    print("distortion [k1 k2 p1 p2 k3]: " + " ".join(f"{d:+.5f}" for d in dist))
    print(f"reprojection RMS: {rms:.4f} px")
    if args.out:
        np.savez(args.out, K=K, dist=dist, rms=rms, height=size[0], width=size[1],
                 views=np.array(used))
        print(f"wrote {args.out}")
    return 0


def _cmd_intrinsics(args) -> int:
    """The focal / film-format grid search (testpro-K flow) on the
    annotated features, centred in their scene frame, on ``--device``."""
    import numpy as np

    from ransac_tpu_torch.io.tables import read_points_data
    from ransac_tpu_torch.ops.geodesy import SceneFrame
    from ransac_tpu_torch.pipelines.intrinsics_search import search_intrinsics

    if _cuda_missing(args.device):
        return 2
    feats = read_points_data(args.features, args.pixel_x, args.pixel_y)
    frame = SceneFrame.from_points(feats.pos3d_utm)
    X = frame.center(feats.pos3d_utm).astype(np.float64)
    known = None
    if args.known_origin:
        e, n, z = (float(v) for v in args.known_origin.split(","))
        known = frame.center(np.array([[e, n, z]]))[0].astype(np.float64)
    res = search_intrinsics(X, feats.pixels, (args.width, args.height),
                            known_origin=known,
                            rank_by="dist" if known is not None else "err",
                            device=args.device)
    print(f"{'rank':>4} {'f(mm)':>6} {'sensor':>10} {'err(px)':>8} "
          f"{'inl':>4} {'dist(m)':>9}")
    for i, c in enumerate(res.candidates[:5]):
        print(f"{i + 1:4d} {c.focal_mm:6.0f} {str(c.sensor_mm):>10} "
              f"{c.mean_err_px:8.2f} {c.n_inliers:4d} {c.dist_to_known:9.1f}")
    print(f"refined mean reprojection error: {res.refined_mean_err_px:.2f} px")
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


def _read_tracks(path: str) -> dict:
    """A track table: .npz with arrays frame [M], track [M], uv [M, 2]; or
    .json mapping "frame,track" -> [u, v]."""
    import json

    import numpy as np

    if path.endswith(".npz"):
        d = np.load(path)
        return {(int(f), int(t)): np.asarray(uv, np.float64)
                for f, t, uv in zip(d["frame"], d["track"], d["uv"])}
    with open(path, encoding="utf-8") as fh:
        raw = json.load(fh)
    tracks = {}
    for k, uv in raw.items():
        f, t = (int(v) for v in k.split(","))
        tracks[(f, t)] = np.asarray(uv, np.float64)
    return tracks


def _cmd_sfm(args) -> int:
    """Incremental SfM over a track table, or the multi-frame demo with
    ``--demo F`` (the JAX command's output lines, .npz and JSON keys)."""
    import numpy as np
    import torch

    from ransac_tpu_torch.ops.rotation import exp_so3
    from ransac_tpu_torch.pipelines.sfm import incremental_sfm

    if _cuda_missing(args.device):
        return 2
    if args.demo:
        import json

        import torch.distributed as dist

        from ransac_tpu_torch.parallel.multihost import (initialize_cluster, is_primary,
                                                         shutdown_cluster)
        from ransac_tpu_torch.pipelines.sfm_demo import run_demo

        # Under torchrun every rank runs the front end; the primary the rest.
        owns = not dist.is_initialized() and initialize_cluster(device=args.device)
        try:
            out = run_demo(frames=args.demo, seed=args.seed, loop=args.loop,
                           device=args.device)
            primary = is_primary()
        finally:
            if owns:
                shutdown_cluster()
        if args.out and primary:
            with open(args.out, "w", encoding="utf-8") as fh:
                json.dump({k: v for k, v in out.items() if k != "report"}, fh, indent=1,
                          default=float)
            print(f"wrote {args.out}")
        return 0
    if not args.tracks or not args.intrinsics:
        print("error: --tracks and --intrinsics are required (or use --demo F)",
              file=sys.stderr)
        return 2
    tracks = _read_tracks(args.tracks)
    K = np.loadtxt(args.intrinsics).reshape(3, 3)
    frames = sorted({f for f, _ in tracks})
    m = incremental_sfm(tracks, K, frames, seed=args.seed, device=args.device)
    print(f"registered {len(m.camera_poses)}/{len(frames)} frames, "
          f"{len(m.points)} map points")
    for f in sorted(m.camera_poses):
        p = m.camera_poses[f]
        R = exp_so3(torch.tensor(p[:3], dtype=torch.float32)).numpy()
        C = -R.T @ p[3:]
        print(f"  frame {f}: center=({C[0]:.3f}, {C[1]:.3f}, {C[2]:.3f})")
    if args.out:
        np.savez(
            args.out,
            frames=np.array(sorted(m.camera_poses)),
            poses=np.stack([m.camera_poses[f] for f in sorted(m.camera_poses)]),
            track_ids=np.array(sorted(m.points)),
            points=np.stack([m.points[t] for t in sorted(m.points)]),
        )
        print(f"wrote {args.out}")
    return 0


def _cmd_ba(args) -> int:
    """Bundle-adjust a BAL problem file: read with ``io.bal``, solve in
    the flat layout with ``ba.schur_cg.bundle_adjust_cg``, print the
    initial and final cost, write the solved problem with ``--out``."""
    from ransac_tpu_torch.ba.schur_cg import bundle_adjust_cg, flat_from_ba_problem
    from ransac_tpu_torch.io.bal import read_bal, write_bal
    from ransac_tpu_torch.utils.config import BundleAdjustConfig

    if _cuda_missing(args.device):
        return 2
    try:
        problem = read_bal(args.file)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"{args.file}: {len(problem.cameras)} cameras, {len(problem.points)} points, "
          f"{len(problem.obs_cam)} observations")
    res = bundle_adjust_cg(flat_from_ba_problem(problem), BundleAdjustConfig(max_iters=args.iters),
                           cg_iters=args.cg_iters, device=args.device)
    print(f"initial cost {float(res.initial_cost):.9g}")
    print(f"final cost {float(res.cost):.9g} after {int(res.iterations)} LM passes")
    if args.out:
        write_bal(args.out, problem._replace(cameras=res.cameras, points=res.points))
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
    p.add_argument("--calibration", default="",
                   help=".npz from `calibrate`: undistorts the annotated "
                        "feature pixels before the search (the reference's "
                        "calibration-first flow, testpro.py:947-956)")
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
    localize_parser = p

    device_help = ("torch device (default cuda; 'cpu' runs the plain versions "
                   "of the kernels)")
    p = sub.add_parser("run", help="batch config runner (images_info JSON)")
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_run, localize_parser=localize_parser)

    p = sub.add_parser("calibrate",
                       help="chessboard camera calibration (Zhang + LM)")
    p.add_argument("--images", nargs="+", required=True,
                   help="board image paths/globs (.npy grayscale; other "
                        "formats need PIL)")
    p.add_argument("--cols", type=int, default=9,
                   help="inner corners per row (reference board: 9)")
    p.add_argument("--rows", type=int, default=6,
                   help="inner corners per column (reference board: 6)")
    p.add_argument("--square-size", dest="square_size", type=float,
                   default=1.0, help="board square edge length")
    p.add_argument("--out", default="", help="output .npz (K, dist, rms)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_calibrate)

    p = sub.add_parser("intrinsics", help="focal/sensor grid search")
    p.add_argument("--features", required=True)
    p.add_argument("--pixel-x", dest="pixel_x", required=True)
    p.add_argument("--pixel-y", dest="pixel_y", required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--known-origin", default="", help="'E,N,z' UTM")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_intrinsics)

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

    p = sub.add_parser("sfm", help="incremental SfM over a track table")
    p.add_argument("--tracks", default="",
                   help=".npz (frame, track, uv) or .json {\"f,t\": [u, v]}")
    p.add_argument("--intrinsics", default="", help="3x3 K as text")
    p.add_argument("--demo", type=int, default=0, metavar="F",
                   help="run the multi-frame demo on F rendered frames (front end -> "
                        "tracks -> SfM -> CG BA) and print the frames/s table and ATE")
    p.add_argument("--loop", action="store_true",
                   help="with --demo: closed-circuit trajectory, loop-closure detection "
                        "and a Sim(3) pose graph; prints ATE with and without it")
    p.add_argument("--out", default="", help="write frames, poses, track_ids, "
                   "points as .npz (--demo: the metrics as JSON)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda: the fused sweeps; 'cpu' runs "
                        "the stage-wise engine)")
    p.set_defaults(fn=_cmd_sfm)

    from ransac_tpu_torch.utils.config import BundleAdjustConfig

    p = sub.add_parser("ba", help="bundle adjustment of a BAL problem file")
    p.add_argument("file", help="BAL problem (text, or bzip2 text ending in .bz2)")
    p.add_argument("--iters", type=int, default=BundleAdjustConfig().max_iters,
                   help="LM passes at most (default %(default)s)")
    p.add_argument("--cg-iters", dest="cg_iters", type=int, default=24,
                   help="PCG iterations a pass (default %(default)s)")
    p.add_argument("--out", default="", help="write the solved problem as a BAL file "
                   "(.bz2: compressed)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=_cmd_ba)

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
