"""Command-line interface of the port.

    localize    candidate-camera search + PnP pose, written as the
                reference's location CSV (main_v1.py flow)
    bench       one-line JSON headline benchmark (hypotheses/s), the same
                code as ``python -m ransac_tpu_torch.bench``

Run: python -m ransac_tpu_torch.cli localize --help

``--device`` defaults to ``cuda``; asking for CUDA where there is none is
an error (exit code 2), never a quiet run on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_localize(args) -> int:
    import torch

    from ransac_tpu_torch.io.export import write_location_csv
    from ransac_tpu_torch.io.tables import (build_scene, read_camera_locations,
                                            read_points_data)
    from ransac_tpu_torch.pipelines.localize import localize
    from ransac_tpu_torch.utils.config import LocalizeConfig, RansacConfig

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available",
              file=sys.stderr)
        return 2
    feats = read_points_data(
        args.features, args.pixel_x, args.pixel_y, scale=args.scale,
        z_mode=args.z_mode)
    cams = read_camera_locations(args.cameras,
                                 observer_height=args.observer_height)
    scene = build_scene(feats, cams, device=args.device)
    cfg = LocalizeConfig(
        ransac=RansacConfig(threshold=args.ransacbound),
        grid_code_min=args.grid_code_min,
        min_pnp_inliers=args.min_pnp_inliers)
    res = localize(scene, (args.width, args.height), cfg, seed=args.seed,
                   use_sweep=args.sweep, device=args.device)
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
    return 0


def _cmd_bench(args) -> int:
    from ransac_tpu_torch import bench

    return bench.run_args(args)


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
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_localize)

    from ransac_tpu_torch.bench import add_arguments

    p = sub.add_parser("bench", help="one-line JSON benchmark")
    add_arguments(p)
    p.set_defaults(fn=_cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
