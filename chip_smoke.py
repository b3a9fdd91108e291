#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``ransac_tpu_torch``).

Builds the port's CUDA kernels from ``ransac_tpu_torch/csrc/`` (one nvcc
per source, in parallel) and prints ptxas's registers and spills, holds
every kernel against its plain PyTorch version on the card, then drives
each main path once, with every kernel's launch count set to 0 just before
it and read just after:

- ``localize`` on both routes at the reference workload's size (458
  candidate cameras x 13 landmarks, every C(13,4) homography sample, PnP
  over every C(13,3) sample) on a planted scene;
- ``ransac_homography_sweep`` on the headline bench problem at 2^22
  hypotheses, and ``ransac_pnp_sweep`` at the reference's PnP budget on
  the planted scene's PnP inputs, each on the card and on the CPU with the
  decisions compared;
- ``bench`` in both modes (its JSON lines are printed as they come);

checks the answers, and times every kernel against its plain version at
the main paths' sizes, holding the two outputs of each timing to the same
exact comparison.

    python3 chip_smoke.py            # from the repository root, one GPU

Exits non-zero, and prints no result line, when CUDA is unavailable or
any phase fails.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import re
import statistics
import sys
import tempfile
import time

MSAC_RTOL = 1e-5
DEVICE = "cuda"
SWEEP_HYP = 1 << 22      # the headline bench's hypotheses per call
PROFILE_HYP = 1 << 20    # `cli profile`'s default (ransac_tpu/cli.py:745)
STAGEWISE_HYP = 1 << 18  # the stagewise bench's hypotheses per call
CHECK_HYP = 1 << 16      # kernel checks
KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "sweep_multi": ("ransac_tpu_torch/csrc/sweep_multi.cu",
                    "ransac_tpu/ops/pallas/sweep_multi.py:149"),
    "homography_ransac_sweep": ("ransac_tpu_torch/csrc/sweep.cu",
                                "ransac_tpu/ops/pallas/sweep.py:245"),
    "homography_scores": ("ransac_tpu_torch/csrc/score.cu",
                          "ransac_tpu/ops/pallas/score.py:79"),
    "pnp_scores": ("ransac_tpu_torch/csrc/score.cu",
                   "ransac_tpu/ops/pallas/score.py:148"),
    "pnp_ransac_sweep": ("ransac_tpu_torch/csrc/sweep_pnp.cu",
                         "ransac_tpu/ops/pallas/sweep_pnp.py:431"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(**fields):
    print(json.dumps(fields), flush=True)


def cuda_ms(fn, warmup=3, reps=20):
    """(median milliseconds of ``fn()`` by CUDA events after warm-up, reps).
    A call that takes over a second gets 3 repetitions after 1 warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 1.0:
        warmup, reps = 0, 3
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
    return statistics.median(times), reps


def device_us(fn, kernel_symbols, reps=10):
    """{symbol: mean device time in microseconds} of the CUDA kernels named
    ``kernel_symbols`` (demangled or mangled), over ``reps`` calls of
    ``fn`` under torch.profiler (None where it records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for symbol in kernel_symbols:
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if re.search(rf"(::|\d){symbol}(\(|E)", ev.key):
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = getattr(ev, "cuda_time_total", 0.0)
                total += t
                count += ev.count
        out[symbol] = total / count if count and total > 0 else None
    return out


# ------------------------------------------------------------ launch counts
def reset_counts():
    from ransac_tpu_torch.ops import score, sweep, sweep_multi, sweep_pnp

    sweep_multi.LAUNCHES = 0
    sweep.LAUNCHES = 0
    sweep_pnp.LAUNCHES = 0
    for k in score.LAUNCHES:
        score.LAUNCHES[k] = 0


def read_counts() -> dict:
    import torch

    from ransac_tpu_torch.ops import score, sweep, sweep_multi, sweep_pnp

    torch.cuda.synchronize()
    return {"sweep_multi": sweep_multi.LAUNCHES,
            "homography_ransac_sweep": sweep.LAUNCHES,
            "homography_scores": score.LAUNCHES["homography_scores"],
            "pnp_scores": score.LAUNCHES["pnp_scores"],
            "pnp_ransac_sweep": sweep_pnp.LAUNCHES}


def ptxas_summary(report: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads, stack}] from
    ``nvcc -Xptxas -v`` output."""
    rows, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"(sweep_multi_kernel|sweep_pnp_kernel|sweep_kernel|"
                             r"sweep_prep_kernel|homography_scores_kernel|"
                             r"pnp_scores_kernel)",
                             m.group(1))
            cur = {"kernel": name.group(1) if name else m.group(1)}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return rows


# ------------------------------------------------------------ inputs
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
    """The candidate sweep's inputs as the main path builds them."""
    from ransac_tpu_torch.ops.projection import east_axis_plane_projection
    from ransac_tpu_torch.pipelines.localize import sweep_sample_table

    pos2, _ = east_axis_plane_projection(scene.pos3d[None], scene.cam_locs)
    idx = sweep_sample_table(scene.pixels.shape[0], scene.device)
    return pos2, scene.pixels, scene.point_mask, idx


def film_K(ps, device):
    """The reference's film camera K at the planted scene's image size."""
    from ransac_tpu_torch.ops.projection import intrinsics_from_physical
    from ransac_tpu_torch.utils.config import LocalizeConfig

    ic = LocalizeConfig().intrinsics
    return intrinsics_from_physical(
        ic.focal_length_mm, ic.sensor_width_mm, ic.sensor_height_mm,
        ps.image_size[0], ps.image_size[1], ic.cx, ic.cy, device=device)


def pnp_inputs(ps, scene):
    """(Xw, pixels, K, mask) of localize's PnP stage, and (pix_n, thr_n, ay)
    of its sweep at the reference's 30 px bound."""
    from ransac_tpu_torch.ops.projection import normalize_pixels

    K = film_K(ps, scene.device)
    pix_n = normalize_pixels(scene.pixels, K)
    # float32 quotients, as ransac_pnp_sweep forms them
    thr_n, ay = float(30.0 / K[0, 0]), float(K[1, 1] / K[0, 0])
    return scene.pos3d, scene.pixels, K, scene.point_mask, pix_n, thr_n, ay


# ------------------------------------------------------------ kernel checks
def compare(kernel, case, out_k, out_p):
    """Emit the agreement of (msac, counts[, packed]) kernel vs plain and
    fail unless samples and counts are equal and MSAC within MSAC_RTOL (NaN
    where both are NaN); return the max abs error (MSAC or count)."""
    import torch

    msac_k, cnt_k = out_k[0].double(), out_k[1].double()
    msac_p, cnt_p = out_p[0].double(), out_p[1].double()
    samples_equal = bool(torch.equal(out_k[2], out_p[2])) if len(out_k) > 2 else None
    d_count = float((cnt_k - cnt_p).abs().max())
    both_nan = torch.isnan(msac_k) & torch.isnan(msac_p)
    nan_same = bool((torch.isnan(msac_k) == torch.isnan(msac_p)).all())
    diff = torch.where(both_nan, 0.0, (msac_k - msac_p).abs())
    abs_err = float(diff.max())
    rel = float(torch.where(both_nan, 0.0, diff / msac_p.abs().clamp(min=1e-30)).max())
    same = (((out_k[0] == out_p[0]) | both_nan) & (out_k[1] == out_p[1]))
    if len(out_k) > 2:
        same &= out_k[2] == out_p[2]
    emit(phase="kernel_check", kernel=kernel, case=case,
         shape=list(out_k[0].shape), samples_equal=samples_equal,
         max_count_diff=d_count, msac_max_rel_err=rel, msac_max_abs_err=abs_err,
         records_equal_fraction=float(same.double().mean()))
    check(samples_equal in (True, None), f"{kernel} {case}: samples differ")
    check(d_count == 0.0, f"{kernel} {case}: counts differ by {d_count}")
    check(nan_same, f"{kernel} {case}: NaN MSAC in one version only")
    check(rel <= MSAC_RTOL, f"{kernel} {case}: MSAC rel err {rel}")
    return max(abs_err, d_count)


def check_sweep_multi(tmp, thr):
    import torch

    from ransac_tpu_torch.ops import sweep_multi as sm

    _, s13 = load_scene(os.path.join(tmp, "n13"), DEVICE, seed=0)
    _, s16 = load_scene(os.path.join(tmp, "n16"), DEVICE, seed=1, n=16)
    base13 = sweep_inputs(s13)
    masked = list(base13)
    masked[2] = base13[2].clone()
    masked[2][[1, 5, 9]] = 0.0
    degenerate = list(base13)
    pix = base13[1].clone()
    step = torch.tensor([37.0, -11.0], device=DEVICE)
    for k in (1, 2, 3):  # pixels 0..3 collinear: their samples are invalid
        pix[k] = pix[0] + k * step
    degenerate[1] = pix
    cases = {"n13": base13, "n16": sweep_inputs(s16), "n13_masked": masked,
             "n13_degenerate": degenerate}
    err = 0.0
    for name, (pos2, dst, mask, idx) in cases.items():
        err = max(err, compare(
            "sweep_multi", name, sm.multi_candidate_sweep(pos2, dst, mask, idx, thr),
            sm.multi_candidate_sweep_ref(pos2, dst, mask, idx, thr)))
    return base13, cases["n16"], err


def sweep_cases(device):
    """Row 2's cases on the bench problem: (src, dst, mask, n_points)."""
    import torch

    from ransac_tpu_torch import bench

    src, dst, mask = bench.problem(device)
    src16, dst16, mask16 = bench.problem(device, n_points=16)
    masked = mask.clone()
    masked[[1, 5, 9]] = 0.0
    coll = src.clone()
    for k in (1, 2, 3):  # points 0..3 collinear: their frames degenerate
        coll[k] = src[0] + k * torch.tensor([0.3, -0.1], device=device)
    return {"n13": (src, dst, mask, None), "n16": (src16, dst16, mask16, None),
            "n13_masked": (src, dst, masked, None),
            "n16_n_points_12": (src16, dst16, mask16, 12),
            "n13_collinear": (coll, dst, mask, None)}


def check_sweep():
    from ransac_tpu_torch.ops import sweep as sw

    err = 0.0
    for name, (src, dst, mask, n_points) in sweep_cases(DEVICE).items():
        for full in (False, True):
            args = (11, src, dst, mask, 75.0, CHECK_HYP)
            err = max(err, compare(
                "homography_ransac_sweep", f"{name}_{'full' if full else 'reduced'}",
                sw.homography_ransac_sweep(*args, n_points=n_points, full_records=full),
                sw.homography_ransac_sweep_ref(*args, n_points=n_points,
                                               full_records=full)))
    return err


def score_models(n_models, device, seed=0):
    """Homographies of random 4-point samples of the bench problem."""
    from ransac_tpu_torch import bench
    from ransac_tpu_torch.ops.homography import dlt_homography_minimal
    from ransac_tpu_torch.utils.prng import generator_for, sample_without_replacement

    src, dst, mask = bench.problem(device)
    idx = sample_without_replacement(generator_for(seed, device=device),
                                     n_models, 4, src.shape[0])
    return dlt_homography_minimal(src[idx], dst[idx])[0], src, dst, mask


def pose_models(n_models, X, pix_n, seed=0):
    """P3P poses [n,12] of random 3-point samples (4 roots each)."""
    import torch

    from ransac_tpu_torch.ops.pnp import p3p_grunert
    from ransac_tpu_torch.utils.prng import generator_for, sample_without_replacement

    idx = sample_without_replacement(generator_for(seed, device=X.device),
                                     n_models // 4, 3, X.shape[0])
    R, t, _ = p3p_grunert(X[idx], pix_n[idx])
    m = torch.cat([R.reshape(-1, 4, 9), t], -1).reshape(-1, 12)
    return torch.nan_to_num(m, nan=0.0, posinf=0.0, neginf=0.0).contiguous()


def check_scores(ps, scene, ps16, scene16):
    from ransac_tpu_torch import bench
    from ransac_tpu_torch.ops import score as sc

    err_h = 0.0
    models, src, dst, mask = score_models(CHECK_HYP, DEVICE)
    src16, dst16, mask16 = bench.problem(DEVICE, n_points=16)
    masked = mask.clone()
    masked[[1, 5, 9]] = 0.0
    for name, args in (("n13", (models, src, dst, mask)),
                       ("n16", (models, src16, dst16, mask16)),
                       ("n13_masked", (models, src, dst, masked))):
        err_h = max(err_h, compare("homography_scores", name,
                                   sc.homography_scores(*args, 75.0),
                                   sc.homography_scores_plain(*args, 75.0)))
    err_p = 0.0
    X, _, _, pmask, pix_n, thr_n, _ = pnp_inputs(ps, scene)
    X16, _, _, pmask16, pix16, _, _ = pnp_inputs(ps16, scene16)
    poses = pose_models(CHECK_HYP, X, pix_n)
    behind = poses.clone()
    behind[::4, 11] = -1e6  # every point behind a quarter of the poses
    pmasked = pmask.clone()
    pmasked[[0, 4, 8]] = 0.0
    for name, args in (("n13", (poses, X, pix_n, pmask)),
                       ("n16", (pose_models(CHECK_HYP, X16, pix16), X16, pix16, pmask16)),
                       ("n13_masked", (poses, X, pix_n, pmasked)),
                       ("n13_behind", (behind, X, pix_n, pmask))):
        err_p = max(err_p, compare("pnp_scores", name,
                                   sc.pnp_scores(*args, thr_n),
                                   sc.pnp_scores_plain(*args, thr_n)))
    return err_h, err_p


def pnp_winners(msac, counts, packed):
    """(packed, msac) of the min-MSAC and (max count, min MSAC) winners over
    block-reduced records."""
    import torch

    a = int(msac[0].argmin())
    cmax = counts[1].max()
    b = int(torch.where(counts[1] == cmax, msac[1], float("inf")).argmin())
    return int(packed[0][a]), int(packed[1][b])


def check_sweep_pnp(ps, scene, ps16, scene16):
    from ransac_tpu_torch.ops import sweep_pnp as sp

    X, _, _, mask, pix_n, thr_n, ay = pnp_inputs(ps, scene)
    X16, _, _, mask16, pix16, _, ay16 = pnp_inputs(ps16, scene16)
    masked = mask.clone()
    masked[[0, 4, 8]] = 0.0
    err = 0.0
    n_hyp = 4 * sp.BLOCK_H
    for name, (Xw, p, m, a) in (("n13", (X, pix_n, mask, 1.0)),
                                ("n16", (X16, pix16, mask16, ay16)),
                                ("n13_masked", (X, pix_n, masked, 1.0)),
                                ("n13_ay_film", (X, pix_n, mask, ay))):
        for full in (False, True):
            args = (13, Xw, p, m, thr_n, n_hyp)
            out_k = sp.pnp_ransac_sweep(*args, full_records=full, block_h=sp.BLOCK_H, ay=a)
            out_p = sp.pnp_ransac_sweep_ref(*args, full_records=full, block_h=sp.BLOCK_H, ay=a)
            err = max(err, compare("pnp_ransac_sweep",
                                   f"{name}_{'full' if full else 'reduced'}",
                                   out_k, out_p))
            if not full:
                wk, wp = pnp_winners(*out_k), pnp_winners(*out_p)
                emit(phase="kernel_check_winners", kernel="pnp_ransac_sweep",
                     case=name, kernel_winners=wk, plain_winners=wp)
                check(wk == wp, f"pnp_ransac_sweep {name}: winners differ")
    return err


# ------------------------------------------------------------ main paths
def sample_set(packed, k):
    return sorted((int(packed) >> (4 * j)) & 15 for j in range(k))


def main_path_homography_sweep():
    """ransac_homography_sweep on the bench problem at 2^22, card vs CPU."""
    import torch

    from ransac_tpu_torch import bench
    from ransac_tpu_torch.models.ransac import ransac_homography_sweep
    from ransac_tpu_torch.ops import homography as hops
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.utils.config import RansacConfig

    cfg = RansacConfig(threshold=75.0, num_hypotheses=SWEEP_HYP)
    results = {}
    for device in (DEVICE, "cpu"):
        src, dst, mask = bench.problem(device)
        reset_counts()
        t0 = time.perf_counter()
        res = ransac_homography_sweep(src, dst, mask, cfg, 0)
        counts = read_counts()
        wall = time.perf_counter() - t0
        packed = sw.homography_ransac_sweep(0, src, dst, mask, 75.0, SWEEP_HYP)[2][0]
        errs = hops.transfer_errors(res.model, src, dst)
        results[device] = (res, sample_set(packed[int(res.best_index)], 4), counts)
        inl = res.inlier_mask.cpu()
        emit(phase="main_path", path="ransac_homography_sweep", device=device,
             n_hyp=res.num_hypotheses, num_inliers=int(res.num_inliers),
             winning_sample=results[device][1], inliers=inl.nonzero().flatten().tolist(),
             max_inlier_transfer_err_px=float(errs.cpu()[inl].max()),
             model_finite=bool(torch.isfinite(res.model).all()), seconds=wall,
             launches=counts if device == DEVICE else None)
        check(int(res.num_inliers) >= 10, f"{device}: {int(res.num_inliers)} inliers")
        check(bool(torch.isfinite(res.model).all()), f"{device}: model not finite")
        check(float(errs.cpu()[inl].max()) <= 75.0, f"{device}: inlier error")
    (gpu, s_gpu, counts), (cpu, s_cpu, _) = results[DEVICE], results["cpu"]
    same = (s_gpu == s_cpu and bool((gpu.inlier_mask.cpu() == cpu.inlier_mask).all())
            and int(gpu.num_inliers) == int(cpu.num_inliers))
    emit(phase="gpu_vs_cpu", path="ransac_homography_sweep", same_decisions=same)
    check(same, "ransac_homography_sweep: card and CPU decide differently")
    check(counts["homography_ransac_sweep"] >= 1, "the sweep kernel was not launched")
    return counts


def main_path_pnp_sweep(ps, scene_gpu, scene_cpu):
    """ransac_pnp_sweep at the reference's PnP budget on localize's PnP
    inputs, card vs CPU."""
    import numpy as np
    import torch

    from ransac_tpu_torch.models.ransac import pnp_pose_from_result, ransac_pnp_sweep
    from ransac_tpu_torch.ops import sweep_pnp as sp
    from ransac_tpu_torch.utils.config import LocalizeConfig

    cfg = LocalizeConfig().pnp_ransac  # 30 px, 5000 -> 8192 in 2 blocks
    results = {}
    for device, scene in ((DEVICE, scene_gpu), ("cpu", scene_cpu)):
        Xw, pixels, K, mask, pix_n, thr_n, ay = pnp_inputs(ps, scene)
        reset_counts()
        t0 = time.perf_counter()
        res = ransac_pnp_sweep(Xw, pixels, K, mask, cfg, 0)
        counts = read_counts()
        wall = time.perf_counter() - t0
        packed = sp.pnp_ransac_sweep(0, Xw, pix_n, mask, thr_n, 8192,
                                     block_h=sp.BLOCK_H, ay=ay)[2][0]
        R, t = (a.cpu().numpy().astype(np.float64) for a in pnp_pose_from_result(res))
        origin = scene.frame.uncenter(-R.T @ t)
        dist = float(np.linalg.norm(origin - ps.origin_utm))
        sample = sample_set(packed[int(res.best_index)], 3)
        results[device] = (res, sample, counts)
        emit(phase="main_path", path="ransac_pnp_sweep", device=device,
             n_hyp=res.num_hypotheses, num_inliers=int(res.num_inliers),
             winning_sample=sample, origin_error_m=dist, seconds=wall,
             model_finite=bool(torch.isfinite(res.model).all()),
             launches=counts if device == DEVICE else None)
        check(res.num_hypotheses == 4 * 8192, f"{device}: budget {res.num_hypotheses}")
        check(int(res.num_inliers) >= 6, f"{device}: {int(res.num_inliers)} PnP inliers")
        check(dist <= 2.0, f"{device}: origin {dist} m from the planted camera")
    (gpu, s_gpu, counts), (cpu, s_cpu, _) = results[DEVICE], results["cpu"]
    same = (s_gpu == s_cpu and bool((gpu.inlier_mask.cpu() == cpu.inlier_mask).all())
            and int(gpu.num_inliers) == int(cpu.num_inliers))
    emit(phase="gpu_vs_cpu", path="ransac_pnp_sweep", same_decisions=same)
    check(same, "ransac_pnp_sweep: card and CPU decide differently")
    check(counts["pnp_ransac_sweep"] >= 1 and counts["pnp_scores"] >= 1,
          "the PnP sweep path did not launch its kernels")
    return counts


def main_path_bench(mode):
    """One bench mode through ransac_tpu_torch.bench.main; its JSON line is
    printed as it comes."""
    from ransac_tpu_torch import bench

    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--mode", mode, "--device", DEVICE])
    counts = read_counts()
    line = buf.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    rec = json.loads(line)
    check(rc == 0, f"bench --mode {mode}: exit code {rc}")
    check(rec["winner_count"] >= 10, f"bench {mode}: winner count {rec['winner_count']}")
    emit(phase="main_path", path=f"bench_{mode}", launches=counts)
    return counts


def main_path_localize(tmp, cfg):
    """localize on both routes and through the CLI, then the card vs the CPU."""
    import numpy as np

    from ransac_tpu_torch import cli
    from ransac_tpu_torch.io.export import write_location_csv
    from ransac_tpu_torch.pipelines.localize import localize

    ps, scene = load_scene(os.path.join(tmp, "main"), DEVICE, seed=0)
    reset_counts()
    results = {}
    for route, use_sweep in (("sweep", True), ("engine", False)):
        res = localize(scene, ps.image_size, cfg, use_sweep=use_sweep, device=DEVICE)
        out_csv = os.path.join(tmp, f"{route}_location.csv")
        write_location_csv(out_csv, res.scores_rows)
        results[route] = (res, out_csv)
    cli_csv = os.path.join(tmp, "cli.jpg")
    rc = cli.main(["localize", "--features", ps.features_csv,
                   "--cameras", ps.cameras_csv, "--pixel-x", ps.pixel_x,
                   "--pixel-y", ps.pixel_y, "--width", str(ps.image_size[0]),
                   "--height", str(ps.image_size[1]), "--sweep",
                   "--device", DEVICE, "--output", cli_csv])
    counts = read_counts()
    emit(phase="main_path", path="localize", launches=counts)
    check(rc == 0, f"cli localize exit code {rc}")
    check(counts["sweep_multi"] >= 1, "the sweep route launched no kernel")
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
        emit(phase="main_path", path="localize", route=route, best=res.best_index,
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

    ref = localize(scene, ps.image_size, cfg, use_sweep=True, device="cpu")
    d2 = float((abs(sweep.err2 - ref.err2) / abs(ref.err2)).max())
    d1 = float((abs(sweep.err1 - ref.err1) / abs(ref.err1)).max())
    same = (ref.best_index == sweep.best_index
            and bool((ref.inlier_masks == sweep.inlier_masks).all())
            and bool((ref.pnp_inliers == sweep.pnp_inliers).all()))
    emit(phase="gpu_vs_cpu", path="localize", same_decisions=same,
         err2_max_rel=d2, err1_max_rel=d1)
    check(same, "GPU and CPU runs decide differently")
    check(d2 <= 1e-4, f"err2 GPU vs CPU rel {d2}")
    return ps, scene, counts


def read_rows(path):
    with open(path, encoding="utf-8") as f:
        return list(csv.reader(f))


# ------------------------------------------------------------ times
def time_kernels(smi, in13, in16, thr, ps, scene):
    """Kernel vs plain version, CUDA events, on the same prepared inputs
    (the wrappers' own preparation is left out of both), at the main
    paths' sizes; the outputs of both are held to ``compare`` as well.
    Returns {name: (kernel ms, plain ms, max abs error)} of each kernel's
    first shape (errors over all its shapes)."""
    import torch

    from ransac_tpu_torch import bench
    from ransac_tpu_torch.ops import score as sc
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_multi as sm
    from ransac_tpu_torch.ops import sweep_pnp as sp

    rows = {}

    symbols = {"sweep_multi": ["sweep_multi_kernel"],
               "homography_ransac_sweep": ["sweep_kernel", "sweep_prep_kernel"],
               "homography_scores": ["homography_scores_kernel"],
               "pnp_scores": ["pnp_scores_kernel"],
               "pnp_ransac_sweep": ["sweep_pnp_kernel"]}

    def record(name, shape, fk, fp, view=lambda out: out):
        """kernel_ms / plain_ms: CUDA events around one call of the kernel's
        wrapper core and of the plain version (host launch gaps included);
        kernel_device_us: the kernel alone, from torch.profiler (row 2:
        the sweep and, apart, its one-block normalizing kernel).  ``view``
        turns an output into (msac, counts[, packed]) for ``compare``."""
        err = compare(name, f"{shape}_timed", view(fk()), view(fp()))
        ms, reps = cuda_ms(fk)
        plain, plain_reps = cuda_ms(fp)
        dev = device_us(fk, symbols[name])
        emit(phase="time_kernel", kernel=name, shape=shape, kernel_ms=ms,
             kernel_device_us=dev[symbols[name][0]],
             **({"prep_kernel_device_us": dev["sweep_prep_kernel"]}
                if "sweep_prep_kernel" in dev else {}),
             plain_ms=plain, kernel_reps=reps,
             plain_reps=plain_reps, gpu=smi)
        first = rows.setdefault(name, (ms, plain, err))
        rows[name] = (first[0], first[1], max(first[2], err))

    for shape, (pos2, dst, mask, idx) in (("C458_n13_H1024", in13),
                                          ("C458_n16_H2048", in16)):
        args = sm._normalize(pos2, dst, mask, thr)[:4] + (idx, dst.shape[0])
        record("sweep_multi", shape, lambda: sm._sweep_kernel(*args),
               lambda: sm._sweep_plain(*args))

    src, dst, mask = bench.problem(DEVICE)
    seeds = sw.draw_seeds(5, 4)
    for n_hyp in (SWEEP_HYP, PROFILE_HYP):
        args = (src, dst, mask, 75.0, seeds, 13, n_hyp, False)
        record("homography_ransac_sweep", f"n13_H2^{n_hyp.bit_length() - 1}",
               lambda: sw._sweep_kernel(*args), lambda: sw._sweep_plain(*args))

    def count_msac(out):
        return out[1], out[0]

    for n_models in (STAGEWISE_HYP, PROFILE_HYP):
        models, s, d, m = score_models(n_models, DEVICE, seed=1)
        s_p, m_p = sc._pad_points(s, m, 2)
        d_p, _ = sc._pad_points(d, m, 2)
        args = (models.reshape(-1, 9).contiguous(), s_p, d_p, m_p, 75.0 * 75.0)
        record("homography_scores", f"n13_H2^{n_models.bit_length() - 1}",
               lambda: sc._h_kernel(*args), lambda: sc._h_plain(*args), count_msac)

    X, _, _, pmask, pix_n, thr_n, ay = pnp_inputs(ps, scene)
    X_p, m_p = sc._pad_points(X, pmask, 3)
    pix_p, _ = sc._pad_points(pix_n, pmask, 2)
    args = (pose_models(PROFILE_HYP, X, pix_n), X_p, pix_p, m_p, sc._thr_sq(thr_n))
    record("pnp_scores", f"n13_H2^{PROFILE_HYP.bit_length() - 1}",
           lambda: sc._pnp_kernel(*args), lambda: sc._pnp_plain(*args), count_msac)

    prep = sp.prepare(X, pix_n, pmask, thr_n, ay)
    n = X.shape[0]
    for n_hyp, shape in ((8192, "n13_H8192_block4096"),
                         (PROFILE_HYP, f"n13_H2^{PROFILE_HYP.bit_length() - 1}_block4096")):
        args = (*prep, sw.draw_seeds(3, 3), n, n, n_hyp, sp.BLOCK_H, False)
        record("pnp_ransac_sweep", shape, lambda: sp._sweep_kernel(*args),
               lambda: sp._sweep_plain(*args),
               lambda out: (out[0][0::2], out[0][1::2], out[1]))
    torch.cuda.synchronize()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1

    from ransac_tpu_torch.bench import gpu_name_and_limit
    from ransac_tpu_torch.ops import _build
    from ransac_tpu_torch.pipelines.localize import localize
    from ransac_tpu_torch.utils.config import LocalizeConfig

    # 1. Device.
    smi = gpu_name_and_limit()
    check(smi is not None, "nvidia-smi did not report the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", gpu=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. Build (one nvcc per source, in parallel), with ptxas's report.
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    emit(phase="build", seconds=time.perf_counter() - t0, library=lib.name,
         gpu=smi, ptxas=ptxas_summary(_build.ptxas_report()))

    cfg = LocalizeConfig()
    thr = cfg.ransac.threshold
    launches = dict.fromkeys(KERNELS, 0)
    max_err = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 3. Every kernel against its plain version on the card.
        in13, in16, max_err["sweep_multi"] = check_sweep_multi(tmp, thr)
        max_err["homography_ransac_sweep"] = check_sweep()
        ps, scene = load_scene(os.path.join(tmp, "pnp13"), DEVICE, seed=0)
        ps16, scene16 = load_scene(os.path.join(tmp, "pnp16"), DEVICE, seed=1, n=16)
        max_err["homography_scores"], max_err["pnp_scores"] = check_scores(
            ps, scene, ps16, scene16)
        max_err["pnp_ransac_sweep"] = check_sweep_pnp(ps, scene, ps16, scene16)

        # 4. The main paths, each with the counts set to 0 just before it.
        ps_main, scene_main, counts = main_path_localize(tmp, cfg)
        launches["sweep_multi"] += counts["sweep_multi"]
        counts = main_path_homography_sweep()
        launches["homography_ransac_sweep"] += counts["homography_ransac_sweep"]
        counts = main_path_pnp_sweep(ps_main, scene_main, scene_main.to("cpu"))
        launches["pnp_ransac_sweep"] += counts["pnp_ransac_sweep"]
        launches["pnp_scores"] += counts["pnp_scores"]
        counts = main_path_bench("sweep")
        launches["homography_ransac_sweep"] += counts["homography_ransac_sweep"]
        counts = main_path_bench("stagewise")
        launches["homography_scores"] += counts["homography_scores"]
        for name, n in launches.items():
            check(n >= 1, f"{name}: no launch on its main path")

        # 5. Times.
        times = time_kernels(smi, in13, in16, thr, ps_main, scene_main)
        for name, (_, _, err) in times.items():
            max_err[name] = max(max_err[name], err)
        for route, use_sweep in (("sweep", True), ("engine", False)):
            localize(scene_main, ps_main.image_size, cfg, use_sweep=use_sweep,
                     device=DEVICE)
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                localize(scene_main, ps_main.image_size, cfg, use_sweep=use_sweep,
                         device=DEVICE)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            emit(phase="time_localize", route=route, median_ms=statistics.median(walls),
                 all_ms=walls, gpu=smi)

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_err[name],
        "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
