"""Command-line interface of the port.

    localize    candidate-camera search + PnP pose, written as the
                reference's location CSV (main_v1.py flow)
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
    import torch

    from ransac_tpu_torch.pipelines.twoview import two_view_pipeline
    from ransac_tpu_torch.utils.config import TwoViewConfig

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available",
              file=sys.stderr)
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
