#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``ransac_tpu_torch``).

Builds the port's CUDA kernels from ``ransac_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version on the card, drives the
``localize`` main path once on both routes at the reference workload's
size (458 candidate cameras x 13 landmarks, every C(13,4) homography
sample, PnP over every C(13,3) sample) on a planted scene, checks the
answer, and times the kernel, its plain version and ``localize``.

    python3 chip_smoke.py            # from the repository root, one GPU

Exits non-zero, and prints no result line, when CUDA is unavailable or
any phase fails.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPLACES = "ransac_tpu/ops/pallas/sweep_multi.py:149"
MSAC_RTOL = 1e-5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(**fields):
    print(json.dumps(fields), flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def load_scene(directory, device, **planted_kw):
    from ransac_tpu_torch.io.synthetic import write_planted_scene
    from ransac_tpu_torch.io.tables import (build_scene, read_camera_locations,
                                            read_points_data)

    ps = write_planted_scene(directory, **planted_kw)
    feats = read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y)
    scene = build_scene(feats, read_camera_locations(ps.cameras_csv),
                        device=device)
    return ps, scene


def sweep_inputs(scene):
    """The sweep's inputs as the main path builds them."""
    from ransac_tpu_torch.ops.projection import east_axis_plane_projection
    from ransac_tpu_torch.pipelines.localize import sweep_sample_table

    pos2, _ = east_axis_plane_projection(scene.pos3d[None], scene.cam_locs)
    idx = sweep_sample_table(scene.pixels.shape[0], scene.device)
    return pos2, scene.pixels, scene.point_mask, idx


def kernel_vs_plain(tmp, thr):
    """Phase 3: kernel against the plain version on the card."""
    import torch

    from ransac_tpu_torch.ops import sweep_multi as sm

    _, s13 = load_scene(os.path.join(tmp, "n13"), "cuda", seed=0)
    _, s16 = load_scene(os.path.join(tmp, "n16"), "cuda", seed=1, n=16)
    base13 = sweep_inputs(s13)
    masked = list(base13)
    masked[2] = base13[2].clone()
    masked[2][[1, 5, 9]] = 0.0
    degenerate = list(base13)
    pix = base13[1].clone()
    step = torch.tensor([37.0, -11.0], device="cuda")
    for k in (1, 2, 3):  # pixels 0..3 collinear: their samples are invalid
        pix[k] = pix[0] + k * step
    degenerate[1] = pix
    cases = {"n13": base13, "n16": sweep_inputs(s16), "n13_masked": masked,
             "n13_degenerate": degenerate}
    max_err = 0.0
    for name, (pos2, dst, mask, idx) in cases.items():
        mk, ck, pk = sm.multi_candidate_sweep(pos2, dst, mask, idx, thr)
        mp, cp, pp = sm.multi_candidate_sweep_ref(pos2, dst, mask, idx, thr)
        torch.cuda.synchronize()
        same_sample = bool((pk == pp).all())
        d_count = float((ck - cp).abs().max())
        rel = float(((mk.double() - mp.double()).abs()
                     / mp.double().abs().clamp(min=1e-30)).max())
        abs_err = float((mk.double() - mp.double()).abs().max())
        n_invalid = int((mp >= 3e38).sum())
        emit(phase="kernel_check", case=name, C=int(pos2.shape[0]),
             n=int(dst.shape[0]), H=int(idx.shape[1]), samples_equal=same_sample,
             max_count_diff=d_count, msac_max_rel_err=rel, msac_max_abs_err=abs_err,
             invalid_candidates=n_invalid)
        check(same_sample, f"{name}: decoded samples differ")
        check(d_count == 0.0, f"{name}: counts differ by {d_count}")
        check(rel <= MSAC_RTOL, f"{name}: MSAC rel err {rel} > {MSAC_RTOL}")
        max_err = max(max_err, abs_err, d_count)
    return base13, cases["n16"], max_err


def time_kernel(inputs, thr):
    """Kernel vs plain version on the same normalized inputs."""
    from ransac_tpu_torch.ops import sweep_multi as sm

    pos2, dst, mask, idx = inputs
    args = sm._normalize(pos2, dst, mask, thr)[:4] + (idx, dst.shape[0])
    return (cuda_ms(lambda: sm._sweep_kernel(*args)),
            cuda_ms(lambda: sm._sweep_plain(*args)))


def read_rows(path):
    with open(path, encoding="utf-8") as f:
        return list(csv.reader(f))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1

    from ransac_tpu_torch import cli
    from ransac_tpu_torch.io.export import write_location_csv
    from ransac_tpu_torch.ops import _build
    from ransac_tpu_torch.ops import sweep_multi as sm
    from ransac_tpu_torch.pipelines.localize import localize
    from ransac_tpu_torch.utils.config import LocalizeConfig

    # 1. Device.
    smi = gpu_name_and_limit()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", gpu=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. Build.
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    emit(phase="build", seconds=build_s, library=lib.name, gpu=smi)

    cfg = LocalizeConfig()
    thr = cfg.ransac.threshold
    with tempfile.TemporaryDirectory() as tmp:
        # 3. Kernel against its plain version.
        in13, in16, max_err = kernel_vs_plain(tmp, thr)

        # 4. Main path, both routes, as `cli localize --device cuda` runs it.
        ps, scene = load_scene(os.path.join(tmp, "main"), "cuda", seed=0)
        sm.LAUNCHES = 0
        results = {}
        for route, use_sweep in (("sweep", True), ("engine", False)):
            res = localize(scene, ps.image_size, cfg, use_sweep=use_sweep,
                           device="cuda")
            out_csv = os.path.join(tmp, f"{route}_location.csv")
            write_location_csv(out_csv, res.scores_rows)
            results[route] = (res, out_csv)
        cli_csv = os.path.join(tmp, "cli.jpg")
        rc = cli.main(["localize", "--features", ps.features_csv,
                       "--cameras", ps.cameras_csv, "--pixel-x", ps.pixel_x,
                       "--pixel-y", ps.pixel_y, "--width", str(ps.image_size[0]),
                       "--height", str(ps.image_size[1]), "--sweep",
                       "--device", "cuda", "--output", cli_csv])
        torch.cuda.synchronize()
        launches = sm.LAUNCHES

        check(rc == 0, f"cli localize exit code {rc}")
        check(launches >= 1, "the sweep route launched no kernel")
        for route, (res, out_csv) in results.items():
            n_pnp = int(res.pnp_inliers.sum()) if res.pnp_inliers is not None else 0
            dist = (float(((res.camera_origin_utm - ps.origin_utm) ** 2).sum() ** 0.5)
                    if res.camera_origin_utm is not None else float("inf"))
            rows = read_rows(out_csv)
            n_cams = scene.cam_locs.shape[0]
            finite = bool(res.err1.shape == res.err2.shape == (n_cams,)
                          and res.homographies.shape == (n_cams, 3, 3)
                          and np.isfinite(res.err1).all()
                          and np.isfinite(res.err2).all()
                          and np.isfinite(res.homographies).all())
            emit(phase="main_path", route=route, best=res.best_index,
                 planted=ps.planted, best_err2=float(res.err2[res.best_index]),
                 pnp_inliers=n_pnp, origin_error_m=dist, csv_rows=len(rows) - 1,
                 finite=finite)
            check(finite, f"{route}: scores or homographies not finite or "
                          f"not of shape [{n_cams}]")
            check(res.best_index == ps.planted,
                  f"{route}: best {res.best_index} != planted {ps.planted}")
            check(n_pnp >= 6, f"{route}: {n_pnp} PnP inliers")
            check(dist <= 2.0, f"{route}: origin {dist} m from the planted camera")
            check(len(rows) - 1 == 458 and rows[0][0] == "location_id",
                  f"{route}: location CSV has {len(rows) - 1} rows")
        sweep, engine = results["sweep"][0], results["engine"][0]
        d_err2 = float(abs(sweep.err2 - engine.err2).max())
        check(d_err2 <= 1e-3, f"routes disagree on err2 by {d_err2}")
        check(len(read_rows(cli_csv.replace(".jpg", "_location.csv"))) == 459,
              "cli location CSV")

        # The card against the CPU (plain versions) on the same scene.
        ref = localize(scene, ps.image_size, cfg, use_sweep=True, device="cpu")
        d2 = float((abs(sweep.err2 - ref.err2) / abs(ref.err2)).max())
        d1 = float((abs(sweep.err1 - ref.err1) / abs(ref.err1)).max())
        same = (ref.best_index == sweep.best_index
                and bool((ref.inlier_masks == sweep.inlier_masks).all())
                and bool((ref.pnp_inliers == sweep.pnp_inliers).all()))
        emit(phase="gpu_vs_cpu", same_decisions=same, err2_max_rel=d2,
             err1_max_rel=d1)
        check(same, "GPU and CPU runs decide differently")
        check(d2 <= 1e-4, f"err2 GPU vs CPU rel {d2}")

        # 5. Times.
        ms13, plain13 = time_kernel(in13, thr)
        ms16, plain16 = time_kernel(in16, thr)
        for shape, (ms, plain) in (("C458_n13_H1024", (ms13, plain13)),
                                   ("C458_n16_H2048", (ms16, plain16))):
            emit(phase="time_kernel", shape=shape, kernel_ms=ms, plain_ms=plain,
                 gpu=smi)
        for route, use_sweep in (("sweep", True), ("engine", False)):
            localize(scene, ps.image_size, cfg, use_sweep=use_sweep, device="cuda")
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                localize(scene, ps.image_size, cfg, use_sweep=use_sweep,
                         device="cuda")
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            emit(phase="time_localize", route=route, median_ms=statistics.median(walls),
                 all_ms=walls, gpu=smi)

    print(json.dumps({"kernels": [{
        "name": "sweep_multi", "route": "cuda",
        "source": "ransac_tpu_torch/csrc/sweep_multi.cu", "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": ms13,
        "plain_ms": plain13}]}))
    print(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
