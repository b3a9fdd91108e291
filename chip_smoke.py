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
- ``ransac_homography_sweep`` on planted pools of 1024 and 256 points (the
  large-pool sweep, kernel row 6) at 2^20 hypotheses, card vs CPU (the same
  winning sample and inlier mask);
- ``ransac_pnp_sweep`` on planted pools of 512 and 256 points (row 9) at
  the reference's PnP budget, card vs CPU;
- ``two_view_pipeline`` on a rendered 1024 x 1024 pair with the default
  ``TwoViewConfig`` (the fused essential sweep, row 8, on the card), card
  vs CPU, and the random-image ``twoview_frame_1024`` workload of ``cli
  profile`` (frames per second, device idle share from torch.profiler);
- ``cli profile --measure-peaks`` in a process of its own: the roofline
  probes (rows 10 and 11, and the memory read) and every profile row, the
  <= 16-point essential sweep (row 7) among them; its table, peaks and
  launch counts are printed;
- ``localize`` then ``export_best_candidate_report`` (the ``--report``
  CSVs) on the planted scene with 3 unannotated landmarks, held against the
  port's CPU writer; ``cli localize --sweep --report --dem --json-file
  --query`` on that scene and its planted DEM, card vs CPU, with every PnP
  inlier's pixel inverted within 50 m of its landmark and the card's
  marches equal to the CPU's on the same rays; and the three DEM marches
  on 4096 rays of ``tools/bench_raycast.py``'s hit, sky and mixed scenes
  (12 km DEM at 30 m, 10,000 steps): equal to each other and to the CPU
  port, with rays/s, trips, host reads, level-2 scans, kernels (and
  kernels a trip) and the device idle share;
- ``cli calibrate --device cuda`` on 5 boards rendered on the card (8 x 5
  inner corners, 640 x 480, seed 0), card vs CPU, K near the truth; then
  ``localize --calibration`` on a planted scene seen through a lens, the
  planted candidate on both routes; and ``search_intrinsics`` on a planted
  14-point case (f = 180 mm, film 127 x 178 mm), card vs CPU, each with
  its wall, LM passes, kernels, host waits and device idle share;
- bundle adjustment on ``ba.bench``'s scene: the dense Schur
  ``bundle_adjust`` at 32 cameras / 2,000 points / 24,000 observations,
  card vs CPU, and ``bundle_adjust_cg`` against it; the CG at 512 / 20k /
  200k and 512 / 200k / 2M, at cg_tol 0 and with the tolerance exit: ms
  per LM pass, kernels, reads and synchronizes a pass, idle share, peak
  memory;
- the SE(3) and Sim(3) pose graphs of the JAX loop-closure tests, card vs
  CPU; ``cli sfm`` on 32 frames / 2,000 points and on the JAX test's 6
  frames / 80 points (rows 8 and 9, each launch then held against its
  plain version on the inputs that run gave it), the latter and an
  8-frame cut of the former also on the CPU, the same frames registered;
- ``cli sfm --demo 64`` and ``--demo 64 --loop`` (the keyframe front end,
  tracks, SfM, loop closure and the Sim(3) pose graph; every frame
  registered, ATE under 25% of the trajectory, 20% of the circuit; every launch of
  rows 5, 8 and 9 held against its plain version on its own inputs,
  ``closure_edge``'s pixel-match pools among them), and a 16-frame cut on
  the card (profiled) and the CPU, both ATEs within 10%; the table ingest
  through the native reader against the Python path;
- ``parallel/`` (no kernel of its own): 4 spawned ranks under gloo sharing
  the card, then 1 rank under NCCL, each running the candidate-sharded
  search on the padded 460-candidate grid (against ``score_candidates``),
  the 2 x 2 hypothesis-sharded search (against its emulation), dense
  distributed BA at 32 / 96, distributed CG BA at 512 / 200k / 2M (ms a
  pass), both pose graphs and the front end on the 64-frame demo's renders
  (bit for bit), each against its 1-rank sub-mesh, and the two worlds
  against each other; then ``profile --scaling-only`` and ``sfm --demo
  16`` under ``torch.distributed.run --nproc-per-node 4``; a failing or
  hung rank (every collective times out, every world has a deadline)
  fails the run;

checks the answers, and times every kernel against its plain version at
the main paths' sizes, holding the two outputs of each timing to the same
comparison as the kernel's checks: bit for bit, but rows 1-9, whose
kernels round each product-sum once (FMA; all but row 2 in their scores
only) and take MUFU's reciprocal, by the decision-level criteria of
``compare_fused`` (rows 3 and 4: ``score_hold``; row 8 with its pool
order and normalization bit for bit, ``essential_large_hold``); the time
lines of rows 1, 3, 4, 6 and 8 also carry their design (hypotheses a
thread or lanes a hypothesis, registers and spills), rows 6, 8 and 9
their prep times apart, and the scorers' device launches a call are
counted.  The bench's sweep phase also reads the device idle
share over one batch (torch.profiler), whose calls must not wait for the
device, and one profiled ``ransac_pnp_sweep`` call must not wait for the
device before its refit (the refit's own waits are printed, each named by
its enclosing operators).  The LM kernels (row 12, which replaces no TPU
kernel) are held against the plain loop at the engine's refit shapes, the
candidate refit batch and the PnP refit, and timed there, where the loop's
kernels a pass are read too.  The fused refits (row 13, which replaces no
TPU kernel either) are held against their plain refits on the inputs that
``localize``'s two routes, the sweep route's B = 1 refit and ``cli sfm``'s
registrations gave them, and timed at the engine's shapes against the
plain refit on the card (the parent's route); then ``localize``'s kernels,
LM passes and host waits a call.  Each kernel's bound (the least time the card could take: its
operations, a product-sum counted once, over the FP32 rate at the card's
maximum SM clock, or its bytes over the memory rate) is computed from the
shapes of its first timed main-path call, and for the P3P sweeps (rows 5
and 9) from the share of valid (sample, root) pairs of its inputs, which
the plain version reads (``valid_root_share``); the roofline probes'
bound is their work over the data-sheet peak of their unit (FP32 at the
maximum SM clock, TF32 495 TFLOP/s).  The FP32 chains are timed and held against their
plain versions at 256 trips, and alone at the probes' 131072 trips, where
the plain chains would take minutes of small launches.

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
from typing import NamedTuple

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
    "homography_ransac_sweep_large": (
        "ransac_tpu_torch/csrc/sweep_large.cu",
        "ransac_tpu/ops/pallas/sweep_large.py:346"),
    "essential_ransac_sweep_large": (
        "ransac_tpu_torch/csrc/sweep_essential_large.cu",
        "ransac_tpu/ops/pallas/sweep_essential_large.py:344"),
    "pnp_ransac_sweep_large": ("ransac_tpu_torch/csrc/sweep_pnp_large.cu",
                               "ransac_tpu/ops/pallas/sweep_pnp_large.py:334"),
    "essential_ransac_sweep": ("ransac_tpu_torch/csrc/sweep_essential.cu",
                               "ransac_tpu/ops/pallas/sweep_essential.py:298"),
    # Row 10, one kernel body per kind.
    "roofline_fma": ("ransac_tpu_torch/csrc/roofline.cu",
                     "ransac_tpu/ops/pallas/roofline.py:106"),
    "roofline_mixed": ("ransac_tpu_torch/csrc/roofline.cu",
                       "ransac_tpu/ops/pallas/roofline.py:106"),
    "roofline_mxu": ("ransac_tpu_torch/csrc/roofline.cu",
                     "ransac_tpu/ops/pallas/roofline.py:216"),
    # Row 12, the pose LM: the JAX package's LM is plain JAX.
    "lm_pose": ("ransac_tpu_torch/csrc/lm.cu", "none"),
    # Row 13, the engines' whole refits (seed, LM, fallback): the JAX
    # package's refits are plain JAX.
    "refit_homography": ("ransac_tpu_torch/csrc/refit.cu", "none"),
    "refit_pose": ("ransac_tpu_torch/csrc/refit.cu", "none"),
}
LARGE_SWEEP_HYP = 1 << 20   # `cli profile`'s default, the large-pool sweeps' size
PROBE_TRIPS = 131072    # the FP32 probes' trips (ransac_tpu/ops/pallas/roofline.py:179)
PROBE_STEPS = 4096      # the product chain's steps (roofline.py:229)
PROBE_SMALL_TRIPS = 4   # trips of the FP32 chains' checks on two tiles
PROBE_HOLD_TRIPS = 256  # trips where the FP32 chains are held and timed against plain
# "fma" against its plain version after PROBE_HOLD_TRIPS trips (8192 steps):
# a step moves the two chains apart by at most 3 roundings of 2^-24 (the
# plain product's and sum's, the fused one's), a later step carries that
# on without growth in relative terms (x a + b with a, b > 0), and the 7
# sums of the 8 positive chains add at most 14 more: 1.47e-3.
FMA_HOLD_RTOL = (3 * PROBE_HOLD_TRIPS * 32 + 14) * 2.0 ** -24
# The LM kernels against the plain loop, the limits of
# tests/test_torch_lm_kernel.py (its docstring gives the reasons): each
# point's projection and the final cost no further from the float64 loop's
# than LM_SLACK x the float32 loop's distance, plus LM_PX_FLOOR px and
# LM_COST_FLOOR relative.
LM_SLACK, LM_PX_FLOOR, LM_COST_FLOOR = 2.0, 1e-3, 1e-3
LM_PASSES = 10  # the engines' refits
REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


START = time.perf_counter()


def emit(**fields):
    print(json.dumps({**fields, "elapsed_s": time.perf_counter() - START}), flush=True)


def cuda_ms(fn, warmup=3, reps=20, warm=False):
    """(median milliseconds of ``fn()`` by CUDA events after warm-up, reps).
    After one warm-up call (none where the caller has just made one,
    ``warm``), one call is timed: over a second, that call is the reading;
    over a quarter of a second, two more calls join it; otherwise
    ``warmup`` more calls, then ``reps`` timed ones."""
    import torch

    def event_ms():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    if not warm:
        fn()
    torch.cuda.synchronize()
    times = [event_ms()]
    if times[0] > 1000.0:
        return times[0], 1
    if times[0] > 250.0:
        warmup, reps = 0, 3
    else:
        times = []
    for _ in range(warmup):
        fn()
    while len(times) < reps:
        times.append(event_ms())
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
            if re.search(rf"(::|\d){symbol}(\(|E|<|I)", ev.key):
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = getattr(ev, "cuda_time_total", 0.0)
                total += t
                count += ev.count
        out[symbol] = total / count if count and total > 0 else None
    return out


# ------------------------------------------------------------ launch counts
def reset_counts():
    from ransac_tpu_torch.utils.profiling import reset_launch_counts

    reset_launch_counts()


def read_counts() -> dict:
    import torch

    from ransac_tpu_torch.utils.profiling import launch_counts

    torch.cuda.synchronize()
    return launch_counts()


def ptxas_summary(report: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads, stack}] from
    ``nvcc -Xptxas -v`` output."""
    rows, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"\d((?:sweep|homography|pnp|roofline|lm|refit)\w*_kernel)[EI]",
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


class Trace(NamedTuple):
    out: object        # fn()'s result
    wall: float        # s, ending in a synchronize
    kernels: int       # device kernels
    busy: float        # device busy s
    waits: dict        # host waits {name: count}
    by_kernel: dict    # device kernels {name[:60]: count}


def trace_events(prof, wait_names):
    """(device events, device busy s, {host event in ``wait_names``: count},
    {device event name[:60]: [count, ns]}) of a finished torch.profiler
    run, from its raw events: building ``key_averages`` takes minutes on
    10^5 kernels.  Spans of ``record_function`` that the profiler also puts
    on the device's timeline are left out."""
    import torch

    waits = dict.fromkeys(wait_names, 0)
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            row = by_name.setdefault(ev.name()[:60], [0, 0])
            row[0] += 1
            row[1] += ev.duration_ns()
        elif ev.name() in waits:
            waits[ev.name()] += 1
    return (sum(c for c, _ in by_name.values()),
            sum(ns for _, ns in by_name.values()) * 1e-9, waits, by_name)


def profiled(fn) -> Trace:
    """One call of ``fn`` under torch.profiler, ending in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, busy, waits, by_name = trace_events(prof, HOST_WAITS)
    return Trace(out, wall, kernels, busy, {k: n for k, n in waits.items() if n},
                 {k: n for k, (n, _) in by_name.items()})


# ------------------------------------------------------------ inputs
def load_scene(directory, device, **planted_kw):
    from ransac_tpu_torch.io.synthetic import write_planted_scene

    ps = write_planted_scene(directory, **planted_kw)
    return ps, scene_from(ps, device)


def scene_from(ps, device):
    """The localize scene of a planted scene's CSVs, on ``device``."""
    from ransac_tpu_torch.io.tables import (build_scene, read_camera_locations,
                                            read_points_data)

    feats = read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y)
    return build_scene(feats, read_camera_locations(ps.cameras_csv), device=device)


def sweep_inputs(scene):
    """The candidate sweep's inputs as the main path builds them."""
    from ransac_tpu_torch.ops.projection import east_axis_plane_projection
    from ransac_tpu_torch.pipelines.localize import sweep_sample_table

    pos2, _ = east_axis_plane_projection(scene.pos3d[None], scene.cam_locs)
    idx = sweep_sample_table(scene.pixels.shape[0], scene.device)
    return pos2, scene.pixels, scene.point_mask, idx


def film_K(ps, device):
    """The reference's film camera K at the planted scene's image size."""
    import torch

    from ransac_tpu_torch.io import synthetic

    return torch.as_tensor(synthetic.film_K(ps.image_size), dtype=torch.float32,
                           device=device)


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
def compare_fused(kernel, case, full_k, full_p, red_k, red_p, margins=None):
    """Rows 1, 2, 5, 6, 7, 8 and 9, whose kernels round each product-sum
    once (FMA; all but row 2 in their scores only) and take MUFU's
    reciprocal: hold the kernel's full records (msac, counts, packed; rows 5
    and 9 per (sample, root), keyed as their reduced records; rows 6 and 8
    keyed by flat id; row 1 [C, H]) and reduced records of one call to the
    plain version's by the decision-level criteria of ``ops.sweep`` (rows 2,
    6 and 8), ``ops.sweep_pnp`` (rows 5 and 9), ``ops.sweep_essential`` (row
    7) or ``ops.sweep_multi`` (row 1) ``hold_full`` / ``hold_reduced``;
    ``margins(hyp)`` (all but row 7) gives the plain version's distance
    from the cuts of flipped hypotheses.  Emit the fractions and fail on any
    failure; return the max abs error of MSAC (hypotheses valid on both
    sides) and counts."""
    import torch

    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_essential as se
    from ransac_tpu_torch.ops import sweep_multi as sm
    from ransac_tpu_torch.ops import sweep_pnp as sp

    if kernel == "sweep_multi":
        held, held_r = sm.hold(full_k, full_p, red_k, red_p, margins)
        tol = (f"samples and validity equal; a count moves only by its points at the "
               f"inlier cut (|r2 - t| / t <= {sw.COUNT_CUT}); MSAC rtol {sw.MSAC_RTOL} on "
               f">= {sw.MSAC_MOST}, {sw.MSAC_RTOL_ALL} on all; each candidate's winner "
               f"the plain one or a near-tie in the kernel's full records")
    elif kernel in ("homography_ransac_sweep", "homography_ransac_sweep_large",
                    "essential_ransac_sweep_large"):
        held = sw.hold_full(full_k, full_p, margins)
        flipped = held.pop("flipped")
        held_r = sw.hold_reduced(red_k, red_p, full_k, flipped)
        tol = (f"samples equal; validity equal but at a cut (||det| - 1e-7| <= "
               f"{sw.DET_CUT}); a count moves only by its points at the inlier cut "
               f"(|r2 - t| / t <= {sw.COUNT_CUT}); MSAC rtol {sw.MSAC_RTOL} on >= "
               f"{sw.MSAC_MOST}, {sw.MSAC_RTOL_ALL} on all; reduced: count row equal, "
               f"other samples near-ties")
    elif kernel in ("pnp_ransac_sweep", "pnp_ransac_sweep_large"):
        held = sp.hold_full(full_k, full_p, margins)
        flipped = held.pop("flipped")
        held_r = sp.hold_reduced(red_k, red_p, full_k, flipped)
        tol = (f"samples and validity equal; a count moves only by its points at the "
               f"inlier cut (|r2 - t| / t <= {sp.COUNT_CUT}); MSAC rtol {sp.MSAC_RTOL} "
               f"on >= {sp.MSAC_MOST} of the valid pairs, {sp.MSAC_RTOL_ALL} on all; "
               f"the plain winner's count equal; reduced: count row equal, other "
               f"(sample, root) pairs near-ties")
    else:
        held = se.hold_full(full_k, full_p)
        held_r = se.hold_reduced(red_k, red_p)
        tol = (f"samples and validity equal; counts equal on >= {se.COUNTS_MOST}; best "
               f"count and the plain min-MSAC hypothesis' count equal; min MSAC rtol "
               f"{se.MIN_MSAC_RTOL}; reduced: best count, all-invalid records' samples")
    m_k, c_k = full_k[0].double(), full_k[1].double()
    m_p, c_p = full_p[0].double(), full_p[1].double()
    both = (m_k < 3e38) & (m_p < 3e38)
    err = max(float((m_k[both] - m_p[both]).abs().max()) if bool(both.any()) else 0.0,
              float((c_k - c_p).abs().max()))
    fails = held.pop("failures") + held_r.pop("failures")
    emit(phase="kernel_check", kernel=kernel, case=case, shape=list(full_k[0].shape),
         tolerance=tol, **held, reduced=held_r, max_abs_err=err,
         samples_equal=bool(torch.equal(full_k[2], full_p[2])))
    check(not fails, f"{kernel} {case}: {fails}")
    return err


def score_hold(kernel, case, out_k, out_p, margins):
    """Rows 3 and 4 (``kernel``), whose kernels round each product-sum once
    (FMA) and take MUFU's reciprocal: hold their (counts, msac) to the plain
    version's by ``ops.score.hold`` (``margins(hyp)``: the plain version's
    points at the inlier cut of flipped models, ``cut_margins`` or
    ``pose_cut_margins``).  Emit the readings and fail on any failure;
    return the max abs error of MSAC (finite on both sides) and counts."""
    import torch

    from ransac_tpu_torch.ops import score as sc
    from ransac_tpu_torch.ops import sweep as sw

    held = sc.hold(out_k, out_p, margins)
    held.pop("flipped")
    fails = held.pop("failures")
    (c_k, m_k), (c_p, m_p) = ((c.double(), m.double()) for c, m in (out_k, out_p))
    both = torch.isfinite(m_k) & torch.isfinite(m_p)
    err = max(float((m_k[both] - m_p[both]).abs().max()) if bool(both.any()) else 0.0,
              float((c_k - c_p).abs().max()))
    emit(phase="kernel_check", kernel=kernel, case=case,
         shape=list(out_k[0].shape),
         tolerance=(f"counts equal but where points at the inlier cut (|e2 - thr^2| / "
                    f"thr^2 <= {sw.COUNT_CUT}) explain a flip; MSAC rtol {sw.MSAC_RTOL} "
                    f"on >= {sw.MSAC_MOST}, {sw.MSAC_RTOL_ALL} on all; NaN alike"),
         **held, nan_msac=int(torch.isnan(out_p[1]).sum()), max_abs_err=err)
    check(not fails, f"{kernel} {case}: {fails}")
    return err


def sweep_multi_cases(tmp, device):
    """Row 1's check cases: the candidate sweep's inputs (pos2, dst, mask,
    idx) of planted 458-candidate scenes at 13 and 16 points, 13 with three
    points masked, and 13 with pixels 0..3 collinear (their samples are
    invalid)."""
    import torch

    _, s13 = load_scene(os.path.join(tmp, "n13"), device, seed=0)
    _, s16 = load_scene(os.path.join(tmp, "n16"), device, seed=1, n=16)
    base13 = sweep_inputs(s13)
    masked = list(base13)
    masked[2] = base13[2].clone()
    masked[2][[1, 5, 9]] = 0.0
    degenerate = list(base13)
    pix = base13[1].clone()
    step = torch.tensor([37.0, -11.0], device=device)
    for k in (1, 2, 3):
        pix[k] = pix[0] + k * step
    degenerate[1] = pix
    return {"n13": base13, "n16": sweep_inputs(s16), "n13_masked": masked,
            "n13_degenerate": degenerate}


def check_sweep_multi(tmp, thr):
    """Row 1 against its plain version by the decision-level criteria
    (``multi_hold``) on every case of ``sweep_multi_cases``."""
    from ransac_tpu_torch.ops import sweep_multi as sm

    cases = sweep_multi_cases(tmp, DEVICE)
    err = 0.0
    for name, (pos2, dst, mask, idx) in cases.items():
        core = sm._normalize(pos2, dst, mask, thr)[:4] + (idx, dst.shape[0])
        err = max(err, multi_hold(name, core))
    return cases["n13"], cases["n16"], err


def multi_hold(case, core, red=None):
    """compare_fused of row 1: ``ops.sweep_multi``'s ``_sweep_kernel`` and
    ``_sweep_plain`` on the core arguments ``core``, full ([C, H]) and
    per-candidate records (``red``: both, where the caller has them), flips
    explained by ``sweep_multi.cut_margins``; the kernel's full records must
    reduce to its own per-candidate records.  Returns the max abs error."""
    import torch

    from ransac_tpu_torch.ops import sweep_multi as sm

    full_k, full_p = sm._sweep_kernel(*core, True), sm._sweep_plain(*core, True)
    red_k, red_p = red if red else (sm._sweep_kernel(*core), sm._sweep_plain(*core))
    own = sm.reduce_candidates(*full_k)
    check(all(bool(torch.equal(a, b)) for a, b in zip(own, red_k)),
          f"sweep_multi {case}: the kernel's full records do not reduce to its records")
    return compare_fused("sweep_multi", case, full_k, full_p, red_k, red_p,
                         lambda h: sm.cut_margins(*core, h))


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
    """Row 2 against its plain version by the decision-level criteria
    (``compare_fused``), full and reduced records, on every case."""
    from ransac_tpu_torch.ops import sweep as sw

    err = 0.0
    for name, (src, dst, mask, n_points) in sweep_cases(DEVICE).items():
        args = (11, src, dst, mask, 75.0, CHECK_HYP)
        out = {(fn, full): fn(*args, n_points=n_points, full_records=full)
               for fn in (sw.homography_ransac_sweep, sw.homography_ransac_sweep_ref)
               for full in (True, False)}
        plain = (src, dst, mask, 75.0, sw.draw_seeds(11, 4), n_points or src.shape[0],
                 CHECK_HYP)
        k, p = sw.homography_ransac_sweep, sw.homography_ransac_sweep_ref
        err = max(err, compare_fused("homography_ransac_sweep", name, out[k, True],
                                     out[p, True], out[k, False], out[p, False],
                                     lambda h: sw.cut_margins(*plain, h)))
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


def non_finite(models, entries):
    """A copy of models [H, ...] with non-finite entries: every third model
    from the first, second and third of ``entries`` ((flat index, value))
    on; at n < 16 one that meets the padding's zero coordinate gives NaN."""
    m = models.reshape(models.shape[0], -1).clone()
    for k, (i, value) in enumerate(entries):
        m[k::3, i] = value
    return m.reshape(models.shape)


def check_scores(ps, scene, ps16, scene16):
    """Rows 3 and 4 against their plain versions by ``score_hold``; the
    non-finite cases must give NaN MSAC where the plain version does."""
    import torch

    from ransac_tpu_torch import bench
    from ransac_tpu_torch.ops import score as sc

    inf, nan = float("inf"), float("nan")
    err_h = 0.0
    models, src, dst, mask = score_models(CHECK_HYP, DEVICE)
    src16, dst16, mask16 = bench.problem(DEVICE, n_points=16)
    masked = mask.clone()
    masked[[1, 5, 9]] = 0.0
    # h00 meets a zero x, h02 is a translation, h11 a NaN
    bad = non_finite(models, [(0, inf), (2, inf), (4, nan)])
    for name, args in (("n13", (models, src, dst, mask)),
                       ("n16", (models, src16, dst16, mask16)),
                       ("n13_masked", (models, src, dst, masked)),
                       ("n13_non_finite", (bad, src, dst, mask))):
        out_p = sc.homography_scores_plain(*args, 75.0)
        err_h = max(err_h, score_hold(
            "homography_scores", name, sc.homography_scores(*args, 75.0), out_p,
            lambda h, args=args: sc.cut_margins(*args, 75.0, h)))
        if name.endswith("non_finite"):
            check(bool(torch.isnan(out_p[1]).any()), f"homography_scores {name}: no NaN")
    err_p = 0.0
    X, _, _, pmask, pix_n, thr_n, _ = pnp_inputs(ps, scene)
    X16, _, _, pmask16, pix16, _, _ = pnp_inputs(ps16, scene16)
    poses = pose_models(CHECK_HYP, X, pix_n)
    behind = poses.clone()
    behind[::4, 11] = -1e6  # every point behind a quarter of the poses
    pmasked = pmask.clone()
    pmasked[[0, 4, 8]] = 0.0
    # R00 meets a zero X, t0 is a translation, R11 a NaN
    bad = non_finite(poses, [(0, inf), (9, inf), (4, nan)])
    for name, args in (("n13", (poses, X, pix_n, pmask)),
                       ("n16", (pose_models(CHECK_HYP, X16, pix16), X16, pix16, pmask16)),
                       ("n13_masked", (poses, X, pix_n, pmasked)),
                       ("n13_behind", (behind, X, pix_n, pmask)),
                       ("n13_non_finite", (bad, X, pix_n, pmask))):
        out_p = sc.pnp_scores_plain(*args, thr_n)
        err_p = max(err_p, score_hold(
            "pnp_scores", name, sc.pnp_scores(*args, thr_n), out_p,
            lambda h, args=args: sc.pose_cut_margins(*args, thr_n, h)))
        if name.endswith("non_finite"):
            check(bool(torch.isnan(out_p[1]).any()), f"pnp_scores {name}: no NaN")
    return err_h, err_p


def pnp_winners(msac, counts, packed):
    """(packed, msac) of the min-MSAC and (max count, min MSAC) winners over
    block-reduced records."""
    import torch

    a = int(msac[0].argmin())
    cmax = counts[1].max()
    b = int(torch.where(counts[1] == cmax, msac[1], float("inf")).argmin())
    return int(packed[0][a]), int(packed[1][b])


def pnp_hold(kernel, core, case, red=None):
    """compare_fused of a P3P sweep (``kernel``: "pnp_ransac_sweep" or
    "pnp_ransac_sweep_large"): its ``_sweep_kernel`` and ``_sweep_plain``
    on the arguments ``core`` (all but ``full``), full and reduced records
    of one set of inputs (``red``: the two reduced records (msac, counts,
    packed), where the caller has them).  Returns (max abs error, kernel
    reduced records, plain reduced records)."""
    from ransac_tpu_torch.ops import sweep_pnp as sp
    from ransac_tpu_torch.ops import sweep_pnp_large as spl

    ops = spl if kernel == "pnp_ransac_sweep_large" else sp
    n_hyp = core[-2]

    def run(fn, full):
        f, i = fn(*core, full=full)[:2]
        if full:
            return f[:4].reshape(-1), f[4:].reshape(-1), ops.full_keys(i, n_hyp)
        return f[0::2], f[1::2], i.long()
    if red is None:
        red_k, red_p = run(ops._sweep_kernel, False), run(ops._sweep_plain, False)
    else:
        red_k, red_p = ((m, c, i.long()) for m, c, i in red)
    err = compare_fused(kernel, case, run(ops._sweep_kernel, True),
                        run(ops._sweep_plain, True), red_k, red_p,
                        lambda h: ops.cut_margins(*core, h))
    return err, red_k, red_p


def check_sweep_pnp(ps, scene, ps16, scene16):
    """Row 5 against its plain version by the decision-level criteria
    (``compare_fused``), full and reduced records, on every case; the
    winners of the reduced records equal, or the plain one a near-tie."""
    from ransac_tpu_torch.ops import sweep as sw
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
        n = Xw.shape[0]
        core = (*sp.prepare(Xw, p, m, thr_n, a), sw.draw_seeds(13, 3), n, n, n_hyp,
                sp.BLOCK_H)
        e, red_k, red_p = pnp_hold("pnp_ransac_sweep", core, name)
        err = max(err, e)
        wk, wp = pnp_winners(*red_k), pnp_winners(*red_p)
        # Where the min-MSAC winners differ, the plain winner's record is a
        # near-tie of the kernel's winner in the kernel's own records.
        m_k = red_k[0][0]
        near = float(m_k[int(red_p[0][0].argmin())]) <= float(m_k.min()) * (
            1.0 + sp.MSAC_RTOL_ALL)
        emit(phase="kernel_check_winners", kernel="pnp_ransac_sweep",
             case=name, kernel_winners=wk, plain_winners=wp, plain_winner_near_tie=near)
        check(wk[0] == wp[0] or near, f"pnp_ransac_sweep {name}: min-MSAC winners differ")
        check(float(red_k[1][1].max()) == float(red_p[1][1].max()),
              f"pnp_ransac_sweep {name}: best counts differ")
    return err


# ------------------------------------------------------------ main paths
def sample_set(packed, k):
    return sorted((int(packed) >> (4 * j)) & 15 for j in range(k))


def main_path_homography_sweep():
    """ransac_homography_sweep on the bench problem at 2^22, card vs CPU;
    its B = 1 refit (row 13) held (``refit_holds``).  Returns the launch
    counts and the hold's max error."""
    import torch

    from ransac_tpu_torch import bench
    from ransac_tpu_torch.models.ransac import ransac_homography_sweep
    from ransac_tpu_torch.ops import homography as hops
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.utils.config import RansacConfig

    cfg = RansacConfig(threshold=75.0, num_hypotheses=SWEEP_HYP)
    results = {}
    kept = {"refit_homography": []}
    for device in (DEVICE, "cpu"):
        src, dst, mask = bench.problem(device)
        reset_counts()
        t0 = time.perf_counter()
        with refit_inputs_kept({**kept, "refit_pose": []}):
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
    return counts, refit_holds(kept, "ransac_homography_sweep")


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
    pnp_sweep_waits(*pnp_inputs(ps, scene_gpu), cfg, res_gpu=gpu)
    return counts


PNP_WAITS = ("aten::item", "aten::_local_scalar_dense", "cudaStreamSynchronize")


def pnp_sweep_waits(Xw, pixels, K, mask, pix_n, thr_n, ay, cfg, res_gpu):
    """One profiled ``ransac_pnp_sweep`` call (torch.profiler): from its start
    to its refit (the ``ransac.refit`` span), which follows the
    sweep and the re-score's launches, it holds no ``aten::item``,
    ``aten::_local_scalar_dense`` or ``cudaStreamSynchronize``; its result is
    the unprofiled call's.  The threshold and y-scale that the kernels read
    on the card, formed there from K, hold the float32 values that the
    floats ``thr_n`` and ``ay`` (read back from K) give by value."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ransac_tpu_torch.models.ransac import _pnp_threshold_scales, ransac_pnp_sweep
    from ransac_tpu_torch.ops import _build
    from ransac_tpu_torch.ops import score as sc
    from ransac_tpu_torch.ops import sweep_pnp as sp

    fx, ay_card = _pnp_threshold_scales(K, torch.float32)
    *_, thr_sq, ay_t = sp.prepare(Xw, pix_n, mask, cfg.threshold / fx, ay_card)
    check(thr_sq.device == ay_t.device == K.device and float(thr_sq) == sc._thr_sq(thr_n)
          and float(ay_t) == _build.f32_of(ay),
          "the kernels' threshold or y-scale on the card moved from its float32 value")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = ransac_pnp_sweep(Xw, pixels, K, mask, cfg, 0)
        torch.cuda.synchronize()
    events = prof.events()
    refit = [ev for ev in events if ev.name == "ransac.refit"
             and ev.device_type == torch.autograd.DeviceType.CPU]
    check(len(refit) == 1, f"{len(refit)} refit spans in the profiled PnP sweep call")
    start, end = refit[0].time_range.start, refit[0].time_range.end
    before = [ev for ev in events if ev.time_range.start < start]
    waits = {}
    for ev in before:
        if ev.name in PNP_WAITS:
            waits[ev.name] = waits.get(ev.name, 0) + 1
    # The refit's own waits, each named by its enclosing operators.
    in_refit, named = {}, []
    for ev in events:
        if ev.name in PNP_WAITS and start <= ev.time_range.start <= end:
            in_refit[ev.name] = in_refit.get(ev.name, 0) + 1
            chain, p = [], ev.cpu_parent
            while p is not None and len(chain) < 4:
                chain.append(p.name[:48])
                p = p.cpu_parent
            named.append([ev.name] + chain)
    kernels = sorted({ev.name[:48] for ev in events
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and re.search(r"(pnp_scores|sweep_pnp)\w*_kernel", ev.name)})
    same = (torch.equal(res.inlier_mask, res_gpu.inlier_mask)
            and torch.equal(res.raw_model, res_gpu.raw_model))
    emit(phase="pnp_sweep_waits", waits_before_refit=waits, kernels=kernels,
         events_before_refit=len(before), same_result=same, waits_in_refit=in_refit,
         refit_waits_named=named)
    check(not waits, f"ransac_pnp_sweep waits for the device before its refit: {waits}")
    check(same, "the profiled ransac_pnp_sweep call decided otherwise")


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
    if mode == "sweep":
        check(rec["control_vpu_tflops"] > 1.0 and counts["roofline_fma"] >= 1,
              f"bench sweep: control reading {rec['control_vpu_tflops']}")
    emit(phase="main_path", path=f"bench_{mode}", launches=counts)
    return counts


# Host-side calls that wait for the device (or copy to the host) in a trace.
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "aten::item", "aten::_local_scalar_dense")


def bench_idle_share(smi):
    """The device idle share over one batch of the bench's sweep calls
    (``bench.sweep_step``, torch.profiler, as ``time_twoview_frames``), and
    the host-side waits in the trace: the calls hold no ``aten::item`` and
    no ``cudaStreamSynchronize`` (the batch's final synchronize is one
    ``cudaDeviceSynchronize``)."""
    from ransac_tpu_torch import bench

    n_hyp, iters = bench.DEFAULTS["sweep"]
    step = bench.sweep_step(*bench.problem(DEVICE), n_hyp)
    step(0)

    def batch():
        for i in range(iters):
            step(1000 + i)

    _, wall, _, busy_s, waits, by_kernel = profiled(batch)
    emit(phase="bench_idle_share", mode="sweep", calls=iters, n_hyp=n_hyp,
         profiled_wall_s=wall, ms_per_call=wall / iters * 1e3,
         device_busy_ms_per_call=busy_s / iters * 1e3, device_idle_share=1.0 - busy_s / wall,
         device_kernels=by_kernel, host_waits=waits, gpu=smi)
    check(busy_s > 0, "bench idle share: the trace holds no device time")
    # The calls keep their winners on the device: the batch's one wait is
    # its final synchronize (a cudaDeviceSynchronize).
    check(not waits.get("aten::item") and not waits.get("cudaStreamSynchronize"),
          f"bench sweep calls wait for the device: {waits}")
    return 1.0 - busy_s / wall


def main_path_localize(tmp, cfg):
    """localize on both routes and through the CLI, then the card vs the CPU;
    row 13 held on the inputs both routes gave it (``refit_holds``).
    Returns (the planted scene, its card scene, the launch counts, the
    holds' max errors, the engine route's refit calls)."""
    import numpy as np

    from ransac_tpu_torch import cli
    from ransac_tpu_torch.io.export import write_location_csv
    from ransac_tpu_torch.pipelines.localize import localize

    ps, scene = load_scene(os.path.join(tmp, "main"), DEVICE, seed=0)
    reset_counts()
    results = {}
    kept = {"refit_homography": [], "refit_pose": []}
    for route, use_sweep in (("sweep", True), ("engine", False)):
        with refit_inputs_kept(kept):
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
    # The refits of the engine route (kept second): the search's 458 and the PnP's.
    engine_refits = {name: calls[-1:] for name, calls in kept.items()}
    return ps, scene, counts, refit_holds(kept, "localize"), engine_refits


def read_rows(path):
    with open(path, encoding="utf-8") as f:
        return list(csv.reader(f))


# ------------------------------------------------------------ report and DEM
N_UNANNOTATED = 3        # landmarks with pixel (0, 0), forward-projected
REPORT_RTOL = 1e-5
MARCH_RAYS = 4096        # tools/bench_raycast.py's scenes
MARCH_CPU_RAYS = 1024    # the CPU port's subset of them, every fourth ray
MARCH_MAX_STEPS = 10000  # RaycastConfig: 10 km at 1 m
DEM_INLIER_M = 50.0      # a PnP inlier's pixel inverts within this of its landmark


def report_rows(path):
    with open(path, encoding="utf-8-sig") as f:
        return list(csv.reader(f))


def rows_close(a, b, text_cols):
    """(equal header, length and text columns, max relative difference of
    the numbers)."""
    if a[0] != b[0] or len(a) != len(b):
        return False, float("inf")
    worst = 0.0
    for ra, rb in zip(a[1:], b[1:]):
        for k, (x, y) in enumerate(zip(ra, rb)):
            if k in text_cols:
                if x != y:
                    return False, float("inf")
            elif float(x) != float(y):
                worst = max(worst, abs(float(x) - float(y)) / max(abs(float(y)), 1e-30))
    return True, worst


def main_path_report(tmp):
    """localize (sweep route) then export_best_candidate_report(make_plots=
    False) on the planted scene with unannotated landmarks, on the card;
    the port's CPU writer on the same result, and on the CPU's own result."""
    import importlib.util

    from ransac_tpu_torch.io.tables import read_points_data
    from ransac_tpu_torch.pipelines.localize import export_best_candidate_report, localize

    ps, scene = load_scene(os.path.join(tmp, "report"), DEVICE, seed=0,
                           n_unannotated=N_UNANNOTATED)
    feats_all = read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y,
                                 keep_unannotated=True)
    reset_counts()
    t0 = time.perf_counter()
    res = localize(scene, ps.image_size, use_sweep=True, device=DEVICE)
    export_best_candidate_report(scene, res, os.path.join(tmp, "report_gpu.jpg"),
                                 make_plots=False, all_features=feats_all)
    wall = time.perf_counter() - t0
    counts = read_counts()
    scene_cpu = scene.to("cpu")
    export_best_candidate_report(scene_cpu, res, os.path.join(tmp, "report_cpu.jpg"),
                                 make_plots=False, all_features=feats_all)
    res_cpu = localize(scene_cpu, ps.image_size, use_sweep=True, device="cpu")
    export_best_candidate_report(scene_cpu, res_cpu, os.path.join(tmp, "report_own.jpg"),
                                 make_plots=False, all_features=feats_all)
    out = {}
    for kind, cols in (("accuracies", {0, 1, 2}), ("correlations", {0, 1, 8})):
        gpu, cpu, own = (report_rows(os.path.join(tmp, f"report_{k}_{kind}.csv"))
                         for k in ("gpu", "cpu", "own"))
        out[kind] = (len(gpu) - 1, rows_close(gpu, cpu, cols), rows_close(gpu, own, cols))
    acc = report_rows(os.path.join(tmp, "report_gpu_accuracies.csv"))
    projected = all(float(r[7]) != 0.0 and float(r[8]) != 0.0
                    for r in acc[-N_UNANNOTATED:])
    emit(phase="main_path", path="localize_report", seconds=wall, launches=counts,
         best=res.best_index, rows={k: v[0] for k, v in out.items()},
         same_result_max_rel={k: v[1][1] for k, v in out.items()},
         cpu_result_max_rel={k: v[2][1] for k, v in out.items()},
         unannotated_projected=projected,
         matplotlib=importlib.util.find_spec("matplotlib") is not None)
    n = 13 + N_UNANNOTATED
    check(res.best_index == ps.planted and res_cpu.best_index == ps.planted,
          f"report: best {res.best_index} / {res_cpu.best_index}")
    check(out["accuracies"][0] == n and out["correlations"][0] == n * (n - 1) // 2,
          f"report rows {out}")
    for kind, (_, same, own) in out.items():
        check(same[0] and same[1] <= REPORT_RTOL,
              f"{kind}: the card's CSV against the CPU writer's on one result: {same}")
        # The CPU's own localize refits its homography in other roundings.
        check(own[0] and own[1] <= 1e-3, f"{kind}: against the CPU run: {own}")
    check(projected, "report: unannotated rows not forward-projected")
    return counts


def march_stop_steps(pos, origins, dirs):
    import numpy as np

    d = (pos.double() - origins.double()) * dirs.double()
    return np.rint(d.sum(-1).cpu().numpy()).astype(np.int64)


def main_path_dem(tmp):
    """``cli localize --sweep --report --dem --json-file --query`` on the
    planted scene and its planted DEM, on the card and on the CPU; then the
    card's GeoInverter on every landmark's pixel (within DEM_INLIER_M of its
    landmark for the PnP inliers, weighted_factors and none) and, on the
    same rays, the card's marches against the CPU's."""
    import numpy as np
    import torch

    from ransac_tpu_torch import cli
    from ransac_tpu_torch.io.dem import center_elevations, load_geotiff, resample_to_utm
    from ransac_tpu_torch.io.synthetic import boundary_polygon, write_planted_dem
    from ransac_tpu_torch.pipelines import raycast
    from ransac_tpu_torch.pipelines.localize import localize
    from ransac_tpu_torch.utils.config import RaycastConfig

    ps, scene = load_scene(os.path.join(tmp, "dem"), DEVICE, seed=0,
                           n_unannotated=N_UNANNOTATED)
    tif, js = write_planted_dem(os.path.join(tmp, "dem"), ps)
    queries = ["1071,1000", "1071,200"]
    runs = {}
    for device in (DEVICE, "cpu"):
        wd = os.path.join(tmp, f"dem_{device}")
        os.makedirs(wd)
        cwd = os.getcwd()
        buf = io.StringIO()
        reset_counts()
        raycast.reset_counts()
        os.chdir(wd)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["localize", "--features", ps.features_csv,
                               "--cameras", ps.cameras_csv, "--pixel-x", ps.pixel_x,
                               "--pixel-y", ps.pixel_y, "--width", str(ps.image_size[0]),
                               "--height", str(ps.image_size[1]), "--sweep", "--report",
                               "--dem", tif, "--json-file", js, "--query", *queries,
                               "--output", "out.jpg", "--device", device])
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        counts = read_counts() if device == DEVICE else None
        files = sorted(os.listdir(wd)) + sorted(
            os.listdir(os.path.join(wd, "output_shapefiles")))
        answers = [ln for ln in buf.getvalue().splitlines() if ln.startswith("pixel (")]
        runs[device] = (wd, counts)
        emit(phase="main_path", path="localize_dem", device=device, rc=rc, seconds=wall,
             march=dict(raycast.COUNTS), launches=counts, files=files, answers=answers)
        check(rc == 0, f"cli localize --dem on {device}: exit code {rc}")
        check(all(f in files for f in ("out_accuracies.csv", "out_correlations.csv",
                                       "boundary_points_geo.csv",
                                       "background_1_boundary.shp")),
              f"cli localize --dem on {device}: files {files}")
        check(len(answers) == 2 and "E=" in answers[0], f"answers {answers}")
    (wd_g, counts), (wd_c, _) = runs[DEVICE], runs["cpu"]
    check(counts["sweep_multi"] >= 1, "localize --dem --sweep launched no candidate sweep")
    for name, cols in (("out_accuracies.csv", {0, 1, 2}), ("out_correlations.csv", {0, 1, 8})):
        ok, rel = rows_close(report_rows(os.path.join(wd_g, name)),
                             report_rows(os.path.join(wd_c, name)), cols)
        emit(phase="gpu_vs_cpu", path=f"localize_dem_{name}", same_rows=ok, max_rel=rel)
        check(ok and rel <= 1e-3, f"{name}: card against CPU {ok}, {rel}")
    b_g = report_rows(os.path.join(wd_g, "boundary_points_geo.csv"))
    b_c = report_rows(os.path.join(wd_c, "boundary_points_geo.csv"))
    same_pix = [r[:4] for r in b_g] == [r[:4] for r in b_c]
    d_geo = max((max(abs(float(x) - float(y)) for x, y in zip(rg[4:], rc[4:]))
                 for rg, rc in zip(b_g[1:], b_c[1:])), default=float("inf"))
    emit(phase="gpu_vs_cpu", path="localize_dem_boundary", rows=len(b_g) - 1,
         vertices=len(boundary_polygon()), same_pixels=same_pix, geo_max_abs_m=d_geo)
    check(len(b_g) > 3 and same_pix, f"boundary rows {len(b_g) - 1}, same pixels {same_pix}")
    check(d_geo <= 0.05, f"boundary points card against CPU: {d_geo} m")

    # The inverter of that run, on the card and on the CPU.
    res = localize(scene, ps.image_size, use_sweep=True, device=DEVICE)
    dem = center_elevations(resample_to_utm(load_geotiff(tif), scene.frame, 10.0))
    feats = scene.features
    inlier = res.pnp_inliers
    for correction in ("weighted_factors", "none"):
        cfg = RaycastConfig(correction=correction)
        inv_g = raycast.localized_inverter(scene, res, dem, cfg, DEVICE)
        inv_c = raycast.localized_inverter(scene, res, dem, cfg, "cpu")
        utm, hit = inv_g.pixel_to_geo(feats.pixels)
        dist = np.linalg.norm(utm - feats.pos3d_utm, axis=1)
        pix = np.concatenate([feats.pixels, boundary_polygon(ps.image_size),
                              np.random.default_rng(0).uniform(
                                  (0, 0), ps.image_size, (256, 2))])
        rays = inv_c.rays_for(pix)
        raycast.reset_counts()
        pos_g, hit_g = inv_g.march(rays.to(DEVICE))
        march_counts = dict(raycast.COUNTS)
        pos_c, hit_c = inv_c.march(rays)
        o = torch.as_tensor(inv_c.ray_origin, dtype=torch.float32).expand_as(rays)
        same = (torch.equal(hit_g.cpu(), hit_c) and np.array_equal(
            march_stop_steps(pos_g.cpu(), o, rays), march_stop_steps(pos_c, o, rays)))
        emit(phase="dem_inversion", correction=correction, gpu=True,
             landmark_distance_m=[round(float(v), 2) for v in dist],
             pnp_inlier=inlier.astype(int).tolist(), hits=hit.astype(int).tolist(),
             rays=len(pix), rays_hit=int(hit_g.sum()), march=march_counts,
             same_hits_and_steps_as_cpu=same)
        check(bool(hit[inlier].all()) and float(dist[inlier].max()) <= DEM_INLIER_M,
              f"{correction}: PnP inliers' inversions {dist[inlier]} m from their landmarks")
        check(same, f"{correction}: card and CPU marches differ on the same rays")
    return counts


def march_scene(kind, n, seed=0):
    """``tools/bench_raycast.py``'s scenes: a 12 km DEM at 30 m of rugged
    terrain, rays from 300 m above it, descending (hit), ascending (sky),
    or 60/30/10 hit, sky and grazing (mixed)."""
    import numpy as np

    from ransac_tpu_torch.io.dem import synthetic_dem
    from ransac_tpu_torch.ops.geodesy import SceneFrame

    rng = np.random.default_rng(seed)
    dem = synthetic_dem(SceneFrame(anchor=np.array([739000.0, 2888000.0, 0.0])),
                        extent_m=12000, spacing_m=30.0,
                        terrain_fn=lambda X, Y: (40.0 * np.sin(X / 700.0) * np.cos(Y / 900.0)
                                                 + 30.0 * np.sin((X + Y) / 400.0)))
    d = rng.normal(size=(n, 3))
    spans = {"hit": [(n, 0.1, 0.5, -1.0)], "sky": [(n, 0.05, 0.3, 1.0)],
             "mixed": [(int(0.6 * n), 0.1, 0.5, -1.0),
                       (int(0.9 * n) - int(0.6 * n), 0.05, 0.3, 1.0),
                       (n - int(0.9 * n), 0.002, 0.01, -1.0)]}[kind]
    k = 0
    for m, lo, hi, sign in spans:
        d[k:k + m, 2] = sign * rng.uniform(lo, hi, m)
        k += m
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dem, np.repeat([[0.0, 0.0, 300.0]], n, 0).astype(np.float32), d.astype(np.float32)


def main_path_march(smi):
    """march_rays, march_rays_mip and march_rays_mip_compact on MARCH_RAYS
    rays of each of bench_raycast's scenes on the card (GeoInverter's mip
    parameters and quad pack): hit masks and stop steps equal across the
    three and against the CPU port on MARCH_CPU_RAYS of the rays; rays/s
    (CUDA events, median of 5), trips, host reads, kernels a march, and the
    device idle share of one profiled march."""
    import numpy as np
    import torch

    from ransac_tpu_torch.io.dem import pack_bilinear
    from ransac_tpu_torch.pipelines import raycast

    pool, seg_steps, lookahead = 8, 30, 32  # GeoInverter's at 30 m and 1 m steps
    pool2 = 128  # the smallest power of two with pool2 * 30 >= 32 * 30
    marches = {"chunk": (raycast.march_rays, {}),
               "mip": (raycast.march_rays_mip,
                       dict(pool=pool, seg_steps=seg_steps, lookahead=lookahead, pool2=pool2)),
               "mip_compact": (raycast.march_rays_mip_compact,
                               dict(pool=pool, seg_steps=seg_steps, lookahead=lookahead,
                                    pool2=pool2))}
    common = dict(max_steps=MARCH_MAX_STEPS, step=1.0, min_hit_step=150)
    readings = {}
    for kind in ("hit", "sky", "mixed"):
        dem, o, d = march_scene(kind, MARCH_RAYS)
        sub = slice(None, None, MARCH_RAYS // MARCH_CPU_RAYS)
        for device in (DEVICE, "cpu"):
            n = MARCH_RAYS if device == DEVICE else MARCH_CPU_RAYS
            arrs = dem.device_arrays(device)
            pack = pack_bilinear(dem.data, device)
            sel = slice(None) if device == DEVICE else sub
            ot = torch.as_tensor(o[sel], device=device)
            dt = torch.as_tensor(d[sel], device=device)
            for name, (fn, kw) in marches.items():
                def run(fn=fn, kw=kw):
                    return fn(ot, dt, *arrs, dem_pack=pack, **common, **kw)

                raycast.reset_counts()
                pos, hit = run()
                counts = dict(raycast.COUNTS)
                steps = march_stop_steps(pos, ot, dt)
                readings[(kind, device, name)] = (hit.cpu().numpy(), steps)
                if device != DEVICE:
                    continue
                torch.cuda.synchronize()
                times = []
                for _ in range(6):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                ms = statistics.median(times[1:])
                _, wall, kernels, busy, _, _ = profiled(run)
                emit(phase="main_path", path="dem_march", scene=kind, march=name, rays=n,
                     max_steps=MARCH_MAX_STEPS, hit_fraction=float(hit.float().mean()),
                     ms=ms, all_ms=times[1:], rays_per_s=n / (ms * 1e-3),
                     trips=counts["trips"], host_reads=counts["reads"],
                     l2_scans=counts["l2_scans"], kernels=kernels,
                     kernels_per_trip=kernels / counts["trips"], profiled_wall_ms=wall * 1e3,
                     device_busy_ms=busy * 1e3, device_idle_share=1.0 - busy / wall, gpu=smi)
                check(busy > 0, f"{kind} {name}: the profiled march holds no device time")
        for name in marches:
            hit_g, steps_g = readings[(kind, DEVICE, name)]
            hit_c, steps_c = readings[(kind, "cpu", name)]
            check(np.array_equal(hit_g[sub], hit_c) and np.array_equal(steps_g[sub], steps_c),
                  f"{kind} {name}: the card's march differs from the CPU's")
            check(np.array_equal(hit_g, readings[(kind, DEVICE, "chunk")][0])
                  and np.array_equal(steps_g, readings[(kind, DEVICE, "chunk")][1]),
                  f"{kind} {name}: differs from the chunked march")
        emit(phase="gpu_vs_cpu", path=f"dem_march_{kind}", rays=MARCH_RAYS,
             cpu_rays=MARCH_CPU_RAYS, same_hits_and_steps=True,
             hits=int(readings[(kind, DEVICE, "chunk")][0].sum()))



# ------------------------------------------------------------ calibration
#: Board sets (views, inner corners cols x rows, (H, W)): 5 views of 8 x 5
#: at 640 x 480, and the reference flow's 9 x 6 board (testpro.py:251-287,
#: the CLI's default) in 12 views at the reference photograph's 2142 x 1620.
BOARD_SETS = {"8x5_640": (5, 8, 5, (480, 640)), "9x6_2142": (12, 9, 6, (1620, 2142))}


def main_path_calibrate(tmp, smi):
    """``cli calibrate --device cuda`` on each of BOARD_SETS, rendered on the
    card (seed 0): K near the truth (fx, fy within 3%, cx, cy within 15 px,
    RMS < 1 px) and the CPU's calibration of the same boards within the CPU
    tests' bounds (K 0.1%, dist[:2] 1e-3, RMS 1%); then ``localize
    --calibration`` on a planted scene whose pixels went through a lens: the
    planted candidate on both routes, PnP >= 6 inliers.  Prints the wall,
    the LM passes and reads, the kernels, the host waits and the device
    idle share of the card's calibration, and the CPU's wall."""
    import glob

    import numpy as np

    from ransac_tpu_torch import cli
    from ransac_tpu_torch.io.synthetic import (LENS_DIST, write_boards,
                                               write_planted_calibration,
                                               write_planted_scene)
    from ransac_tpu_torch.io.tables import (build_scene, read_camera_locations,
                                            read_points_data)
    from ransac_tpu_torch.ops import lm
    from ransac_tpu_torch.pipelines.localize import localize

    for name, (views, cols, rows, shape) in BOARD_SETS.items():
        d = os.path.join(tmp, f"boards_{name}")
        _, K_true, _ = write_boards(d, views, cols, rows, seed=0, shape=shape, device=DEVICE)
        out = {}
        for device in (DEVICE, "cpu"):
            npz = os.path.join(tmp, f"cal_{name}_{device}.npz")
            argv = ["calibrate", "--images", os.path.join(d, "board*.npy"), "--cols",
                    str(cols), "--rows", str(rows), "--out", npz, "--device", device]
            lm.reset_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if device == DEVICE:
                    rc, wall, kernels, busy, waits, _ = profiled(lambda: cli.main(argv))
                else:
                    t0 = time.perf_counter()
                    rc, kernels, busy, waits = cli.main(argv), None, None, None
                    wall = time.perf_counter() - t0
            check(rc == 0, f"cli calibrate {name} --device {device}: exit code {rc}\n"
                           f"{buf.getvalue()}")
            out[device] = dict(np.load(npz))
            K = out[device]["K"]
            emit(phase="main_path", path="calibrate", boards=name, device=device, views=views,
                 found=len(out[device]["views"]), fx=K[0, 0], fy=K[1, 1], cx=K[0, 2],
                 cy=K[1, 2], dist=out[device]["dist"].tolist(), rms=float(out[device]["rms"]),
                 wall_s=wall, lm_passes=lm.COUNTS["passes"], lm_reads=lm.COUNTS["reads"],
                 kernels=kernels, host_waits=waits,
                 device_idle_share=None if busy is None else 1.0 - busy / wall, gpu=smi)
        g, c = out[DEVICE], out["cpu"]
        K = g["K"]
        check(len(g["views"]) == views, f"{name}: corners found on {len(g['views'])} boards")
        check(abs(K[0, 0] / K_true[0, 0] - 1) < 0.03 and abs(K[1, 1] / K_true[1, 1] - 1) < 0.03
              and abs(K[0, 2] - K_true[0, 2]) < 15 and abs(K[1, 2] - K_true[1, 2]) < 15
              and float(g["rms"]) < 1.0,
              f"{name}: calibration K {K.tolist()}, rms {float(g['rms'])}")
        d_K = float(np.abs(g["K"] / np.where(c["K"] == 0, 1, c["K"]) - (c["K"] != 0)).max())
        d_dist = float(np.abs(g["dist"][:2] - c["dist"][:2]).max())
        d_rms = abs(float(g["rms"]) / float(c["rms"]) - 1)
        emit(phase="gpu_vs_cpu", path="calibrate", boards=name, K_max_rel=d_K,
             dist12_max_abs=d_dist, rms_rel=d_rms)
        check(d_K <= 1e-3 and d_dist <= 1e-3 and d_rms <= 1e-2,
              f"{name}: calibration card against CPU: K {d_K}, dist {d_dist}, rms {d_rms}")

    # localize --calibration on a planted scene seen through a lens.
    ps = write_planted_scene(os.path.join(tmp, "lens"), seed=0, dist=LENS_DIST)
    cal = write_planted_calibration(os.path.join(tmp, "lens", "cal.npz"), ps)
    feats = read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y)
    with contextlib.redirect_stdout(io.StringIO()):
        cli._apply_calibration(feats, cal, DEVICE)
    scene = build_scene(feats, read_camera_locations(ps.cameras_csv), device=DEVICE)
    reset_counts()
    for route, use_sweep in (("sweep", True), ("engine", False)):
        res = localize(scene, ps.image_size, use_sweep=use_sweep, device=DEVICE)
        n_pnp = int(res.pnp_inliers.sum()) if res.pnp_inliers is not None else 0
        emit(phase="main_path", path="localize_calibration", route=route,
             best=res.best_index, planted=ps.planted, pnp_inliers=n_pnp)
        check(res.best_index == ps.planted and n_pnp >= 6,
              f"localize --calibration {route}: best {res.best_index}, {n_pnp} PnP inliers")
    rc = cli.main(["localize", "--features", ps.features_csv, "--cameras", ps.cameras_csv,
                   "--pixel-x", ps.pixel_x, "--pixel-y", ps.pixel_y,
                   "--width", str(ps.image_size[0]), "--height", str(ps.image_size[1]),
                   "--calibration", cal, "--sweep", "--device", DEVICE,
                   "--output", os.path.join(tmp, "lens.jpg")])
    counts = read_counts()
    check(rc == 0 and glob.glob(os.path.join(tmp, "lens_location.csv")),
          f"cli localize --calibration exit code {rc}")
    check(counts["sweep_multi"] >= 1, "localize --calibration --sweep launched no sweep")
    emit(phase="main_path", path="localize_calibration", launches=counts)
    return counts


def main_path_intrinsics(smi):
    """``search_intrinsics`` on the card and on the CPU: 14 points seen at
    f = 180 mm on film 127 x 178 mm (the JAX package's planted case), 0.3 px
    of noise.  The card picks the planted combination, its refined mean
    error is under 1 px, and the card and the CPU rank the top 5 alike.
    Prints the wall and the LM passes and reads of the whole search, and
    the kernels, host waits and device idle share of a profiled search of
    the planted focal length's 3 combinations: the trace of all 27
    (~290,000 kernels) takes the profiler minutes to read back.  Returns the
    launch counts of the timed search (row 12's pose LM, row 13's PnP
    refit)."""
    import torch

    from ransac_tpu_torch.io.synthetic import planted_focal_case
    from ransac_tpu_torch.ops import lm
    from ransac_tpu_torch.pipelines.intrinsics_search import search_intrinsics

    X, pix, origin, size, f_mm, sensor = planted_focal_case()

    def run(device, **grid):
        return search_intrinsics(X, pix, size, known_origin=origin, rank_by="err",
                                 device=device, **grid)

    def top(r):
        return [(c.focal_mm, tuple(c.sensor_mm)) for c in r.candidates[:5]]

    run(DEVICE)  # warm-up
    lm.reset_counts()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    passes, reads = lm.COUNTS["passes"], lm.COUNTS["reads"]
    counts = read_counts()
    _, p_wall, kernels, busy, waits, _ = profiled(lambda: run(DEVICE, focal_lengths_mm=[f_mm]))
    ref = run("cpu")

    emit(phase="main_path", path="intrinsics", best=[res.best.focal_mm, list(res.best.sensor_mm)],
         refined_mean_err_px=res.refined_mean_err_px, top5=top(res), cpu_top5=top(ref),
         cpu_refined_mean_err_px=ref.refined_mean_err_px, wall_s=wall, lm_passes=passes,
         lm_reads=reads, profiled_combinations=3, profiled_wall_s=p_wall,
         kernels_per_combination=kernels / 3, host_waits=waits,
         device_idle_share=1.0 - busy / p_wall, gpu=smi)
    check((res.best.focal_mm, tuple(res.best.sensor_mm)) == (f_mm, sensor),
          f"intrinsics: best {res.best.focal_mm} {res.best.sensor_mm}")
    check(res.refined_mean_err_px < 1.0, f"intrinsics: refined {res.refined_mean_err_px} px")
    check(top(res) == top(ref), "intrinsics: the card and the CPU rank the top 5 differently")
    return counts


def lm_passes(scene, ps, smi, clock_mhz, design):
    """The pose LM kernel (row 12) at the engine's PnP refit shape on the
    planted scene: 1 problem x 13 points, 6 parameters, from the RANSAC
    winner on its inliers, 10 passes.  ``refine_pose`` is held against the
    plain loop ``levenberg_marquardt`` on the same card inputs in float32
    and float64 (the limits of tests/test_torch_lm_kernel.py: passes and
    done equal, NaN alike, projections and costs no further from the
    float64 loop than ``LM_SLACK`` x the float32 loop's distance plus the
    floors), then timed against the float32 loop with its bound
    (``utils.profiling.OPS``).  The loop's kernels a pass are read on the
    same inputs, profiled at 10 and 20 passes (the difference over 10).
    (Row 12's homography LM runs on the card only inside row 13's fused
    refit, held in ``refit_holds``.)  Returns ({kernel: {ms, plain_ms,
    bound_ms, bound_by}}, {kernel: the largest distance in px between the
    kernel's and the float32 loop's projections})."""
    import torch

    from ransac_tpu_torch.models import ransac as rm
    from ransac_tpu_torch.ops import _build, lm
    from ransac_tpu_torch.ops.projection import project_points
    from ransac_tpu_torch.ops.rotation import exp_so3, log_so3
    from ransac_tpu_torch.utils.config import LocalizeConfig
    from ransac_tpu_torch.utils.profiling import bound

    cfg = LocalizeConfig()
    K = film_K(ps, DEVICE)
    res = rm.ransac_pnp(scene.pos3d, scene.pixels, K, scene.point_mask, cfg.pnp_ransac)
    pose = (log_so3(res.raw_model[:9].reshape(3, 3))[None], res.raw_model[9:][None],
            scene.pos3d[None], scene.pixels[None], K[None], res.inlier_mask.float()[None])

    def p_project(x, a):
        return project_points(a[0], exp_so3(x[:, :3]), x[:, 3:6], a[2])[0]

    # name: (problems, points, kernel call, loop's residuals, x0, data, projection,
    #        bytes read, bytes written)
    cases = {"lm_pose": (
                 1, pose[2].shape[1],
                 lambda: lm.refine_pose(*pose, max_iters=LM_PASSES)[2],
                 lm._pose_residuals, torch.cat(pose[:2], -1), pose[2:], p_project,
                 sum(t.numel() for t in pose) * 4, 6 * 4 + 13)}
    rows, errs = {}, {}
    for name, (B, n, kernel, residuals, x0, data, project, in_b, out_b) in cases.items():
        def loop(passes, dtype=torch.float32, x0=x0, data=data, residuals=residuals):
            return lm.levenberg_marquardt(residuals, x0.to(dtype),
                                          tuple(t.to(dtype) for t in data), max_iters=passes)

        shape = f"B{B}_n{n}_passes{LM_PASSES}"
        lm.reset_counts()
        before = dict(_build.LAUNCHES)
        out = kernel()
        calls = {**lm.COUNTS, "launches": {k: v - before[k] for k, v in _build.LAUNCHES.items()
                                           if v != before[k]}}
        ref, ref64 = loop(LM_PASSES), loop(LM_PASSES, torch.float64)
        data64 = tuple(t.double() for t in data)
        ok = torch.isfinite(out.x).all(-1)
        p64 = project(ref64.x.double(), data64)[ok]
        p_k = project(out.x.double(), data64)[ok]
        p_32 = project(ref.x.double(), data64)[ok]
        px_k, px_32 = float((p_k - p64).abs().max()), float((p_32 - p64).abs().max())
        c64 = ref64.cost[ok].clamp(min=1e-30)
        c_k = float(((out.cost[ok].double() - c64).abs() / c64).max())
        c_32 = float(((ref.cost[ok].double() - c64).abs() / c64).max())
        same = {"iterations": bool(torch.equal(out.iterations, ref.iterations)),
                "converged": bool(torch.equal(out.converged, ref.converged)),
                "nan": bool(torch.equal(ok, torch.isfinite(ref.x).all(-1))
                            and torch.equal(torch.isnan(out.cost), torch.isnan(ref.cost)))}
        errs[name] = float((p_k - p_32).abs().max())
        emit(phase="lm_hold", kernel=name, shape=shape, counts=calls, **same,
             finite=int(ok.sum()), px_to_f64=px_k, loop_px_to_f64=px_32,
             cost_rel_to_f64=c_k, loop_cost_rel_to_f64=c_32, px_to_loop=errs[name],
             limits=[LM_SLACK, LM_PX_FLOOR, LM_COST_FLOOR], gpu=smi)
        check(calls == {"passes": LM_PASSES, "reads": 0, "launches": {name: 1}},
              f"{name}: {calls}, not one launch of {LM_PASSES} passes")
        check(all(same.values()), f"{name}: passes, done or NaN differ from the loop: {same}")
        check(px_k <= LM_SLACK * px_32 + LM_PX_FLOOR,
              f"{name}: projections {px_k} px from float64, the loop's {px_32}")
        check(c_k <= LM_SLACK * c_32 + LM_COST_FLOOR,
              f"{name}: cost {c_k} from float64, the loop's {c_32}")

        ms, reps = cuda_ms(kernel, warm=True)
        plain, plain_reps = cuda_ms(lambda: loop(LM_PASSES))
        dev = device_us(kernel, [f"{name}_kernel"])[f"{name}_kernel"]
        bound_ms, bound_by = bound(name, B * LM_PASSES, n, in_b, out_b, clock_mhz)
        readings = {}
        for passes in (LM_PASSES, 2 * LM_PASSES):
            _, wall, kernels, busy, _, _ = profiled(lambda p=passes: loop(p))
            readings[passes] = (wall, kernels, busy)
        lo, hi = readings[LM_PASSES], readings[2 * LM_PASSES]
        emit(phase="time_kernel", kernel=name, shape=shape, kernel_ms=ms,
             kernel_device_us=dev, plain_ms=plain, plain_kernels=lo[1],
             plain_device_ms=lo[2] * 1e3, bound_ms=bound_ms, bound_by=bound_by,
             pct_of_bound=100.0 * bound_ms / (dev * 1e-3) if dev else None,
             **design.get(name, {}), kernel_reps=reps, plain_reps=plain_reps, gpu=smi)
        emit(phase="lm_passes", path=name, kernels_per_pass=(hi[1] - lo[1]) / LM_PASSES,
             host_ms_per_pass=(hi[0] - lo[0]) / LM_PASSES * 1e3,
             device_ms_per_pass=(hi[2] - lo[2]) / LM_PASSES * 1e3,
             kernels_10_passes=lo[1], wall_ms_10_passes=lo[0] * 1e3, gpu=smi)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by}
    return rows, errs


def refit_times(engine_refits, smi, clock_mhz, design):
    """Row 13 at the engine's refit shapes, on the inputs localize's engine
    route gave it (``main_path_localize``): the search refit (458 problems
    x 13 points, 10 LM passes) and the PnP refit (1 x 13), each launch
    timed by CUDA events and its kernel's device time by the profiler,
    against the plain refit on the card (op by op: the homography's LM the
    plain loop, the pose's row 12's LM kernel), whose device kernels,
    device time and host waits a call are read on one profiled call, with
    its bound (``utils.profiling.OPS``).  Returns {kernel: {ms, plain_ms, bound_ms,
    bound_by}}."""
    import dataclasses

    from ransac_tpu_torch.models import ransac as rm
    from ransac_tpu_torch.ops import lm
    from ransac_tpu_torch.utils.config import RansacConfig
    from ransac_tpu_torch.utils.profiling import bound

    rows = {}
    for name, calls in engine_refits.items():
        args, _ = calls[0]
        cfg = dataclasses.replace(RansacConfig(), refine_iters=args[-1])
        if name == "refit_homography":
            B, n = args[1].shape[:2]
            fused = lambda a=args: lm.fused_refit_homography(*a)
            plain = lambda a=args: rm.refit_homography_plain(*a[:-1], cfg)
            in_b = sum(t.numel() * t.element_size() for t in args[:2]) \
                + args[1][0].numel() * 4 * 2 + args[3].numel()  # dst is shared
            out_b = B * 9 * 4
        else:
            B, n = 1, args[1].shape[0]
            fused = lambda a=args: lm.fused_refit_pose(*a)
            plain = lambda a=args: rm.pnp_refit_plain(*a[:-1], cfg)
            in_b = sum(t.numel() * t.element_size() for t in args[:-1]
                       if hasattr(t, "numel"))
            out_b = 12 * 4
        ms, reps = cuda_ms(fused)
        plain_ms, plain_reps = cuda_ms(plain)
        dev = device_us(fused, [f"{name}_kernel"])[f"{name}_kernel"]
        _, wall, kernels, busy, waits, _ = profiled(plain)
        bound_ms, bound_by = bound(name, B, n, in_b, out_b, clock_mhz)
        emit(phase="time_kernel", kernel=name, shape=f"B{B}_n{n}_passes{args[-1]}",
             kernel_ms=ms, kernel_device_us=dev, plain_ms=plain_ms, plain_kernels=kernels,
             plain_device_ms=busy * 1e3, plain_wall_ms=wall * 1e3, plain_host_waits=waits,
             bound_ms=bound_ms, bound_by=bound_by,
             pct_of_bound=100.0 * bound_ms / (dev * 1e-3) if dev else None,
             **design.get(name, {}), kernel_reps=reps, plain_reps=plain_reps, gpu=smi)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
    return rows


# ------------------------------------------------------------ large pools
def large_check_cases(device):
    """Rows 6, 8 and 9's check cases, planted pools: n <= 64 (one
    unwindowed block), n = 80 (the smallest windowed sizes), and n = 90
    with masked rows poisoned (sampling one would blow up)."""
    import torch

    from ransac_tpu_torch.io.synthetic import planted_homography_pool, planted_pnp_pool
    from ransac_tpu_torch.ops.projection import normalize_pixels

    cases = {}
    for name, n in (("n40", 40), ("n80", 80), ("n90_masked", 90)):
        src, dst, _ = planted_homography_pool(n, seed=n)
        X, pix, K, _, _, _ = planted_pnp_pool(n, seed=n)
        x1, x2 = twoview_correspondences(n, seed=n)
        mask = torch.ones(n)
        if name == "n90_masked":
            mask[5:15] = 0.0
            src[5:15] = 1e6
            X[5:15] = 1e6
            x1[5:15] = 50.0
        t = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in (("src", src), ("dst", dst), ("X", X), ("x1", x1),
                          ("x2", x2), ("mask", mask))}
        t["pix_n"] = normalize_pixels(torch.as_tensor(pix, device=device),
                                      torch.as_tensor(K, device=device))
        cases[name] = t
    return cases


def twoview_correspondences(n, seed=0, outlier_frac=0.25):
    """Normalized correspondences of a planted relative pose, 0.5 px noise
    at f = 600, the last quarter shifted by 0.1-0.3."""
    import numpy as np

    from ransac_tpu_torch.io.synthetic import _rotation

    rng = np.random.default_rng(seed)
    Xw = rng.uniform(-1, 1, size=(n, 3)) * np.array([2, 2, 1]) + [0, 0, 5]
    R = _rotation(rng.normal(size=3) * 0.1)
    t = np.array([1.0, 0.05, 0.1]) / np.linalg.norm([1.0, 0.05, 0.1])
    x1 = Xw[:, :2] / Xw[:, 2:] + rng.normal(scale=0.5 / 600, size=(n, 2))
    Xc = Xw @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:] + rng.normal(scale=0.5 / 600, size=(n, 2))
    n_out = int(outlier_frac * n)
    x2[n - n_out:] += rng.uniform(0.1, 0.3, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32)


def essential_large_hold(core, case, red=None):
    """Row 8: ``ops.sweep_essential_large``'s ``_sweep_kernel`` and
    ``_sweep_plain`` on the arguments ``core`` (all but ``full``): the pool
    order, n_valid and normalization (m1, m2, s) bit for bit, then
    ``compare_fused`` of the full and reduced records (``red``: both, (f,
    i) each, where the caller has them), flips explained by
    ``sweep_essential_large.cut_margins``.  Returns the max abs error."""
    import torch

    from ransac_tpu_torch.ops import sweep_essential_large as sel

    f_k, i_k, nv_k, order_k, norm_k = sel._sweep_kernel(*core, full=True)
    f_p, i_p, nv_p, order_p, norm_p = sel._sweep_plain(*core, full=True)
    same_prep = (int(nv_k) == int(nv_p) and bool(torch.equal(order_k, order_p))
                 and all(bool(torch.equal(a, b.reshape(a.shape)))
                         for a, b in zip(norm_k, norm_p)))
    emit(phase="kernel_check_prep", kernel="essential_ransac_sweep_large", case=case,
         n_valid=int(nv_k), order_equal=bool(torch.equal(order_k, order_p)),
         normalization_equal=same_prep)
    check(same_prep, f"essential_ransac_sweep_large {case}: pool order, n_valid or "
                     f"normalization differ")
    if red is None:
        red = tuple(fn(*core)[:2] for fn in (sel._sweep_kernel, sel._sweep_plain))
    (fr_k, ir_k), (fr_p, ir_p) = red
    return compare_fused("essential_ransac_sweep_large", case, (f_k[0], f_k[1], i_k),
                         (f_p[0], f_p[1], i_p), (fr_k[0::2], fr_k[1::2], ir_k),
                         (fr_p[0::2], fr_p[1::2], ir_p),
                         lambda h: sel.cut_margins(*core, h))


def large_hold(core, case, red=None):
    """compare_fused of row 6: ``ops.sweep_large``'s ``_sweep_kernel`` and
    ``_sweep_plain`` on the arguments ``core`` (all but ``full``), full and
    reduced records of one set of inputs (``red``: the two reduced records
    (msac, counts, flat), where the caller has them), flips explained by
    ``sweep_large.cut_margins``; the pool order and n_valid must be equal.
    Returns the max abs error."""
    import torch

    from ransac_tpu_torch.ops import sweep_large as sl

    f_k, i_k, nv_k, order_k = sl._sweep_kernel(*core, full=True)
    f_p, i_p, nv_p, order_p = sl._sweep_plain(*core, full=True)
    check(int(nv_k) == int(nv_p) and bool(torch.equal(order_k.cpu(), order_p.cpu())),
          f"homography_ransac_sweep_large {case}: pool order or n_valid differ")
    if red is None:
        red = tuple((f[0::2], f[1::2], i) for f, i in
                    (fn(*core)[:2] for fn in (sl._sweep_kernel, sl._sweep_plain)))
    return compare_fused("homography_ransac_sweep_large", case, (f_k[0], f_k[1], i_k),
                         (f_p[0], f_p[1], i_p), *red, lambda h: sl.cut_margins(*core, h))


def check_large():
    """Rows 6, 8 and 9 against their plain versions on the check cases (rows
    6 and 9 by the decision-level criteria, ``large_hold`` and
    ``pnp_hold``; row 8 by ``essential_large_hold``)."""
    import numpy as np
    import torch

    from ransac_tpu_torch.ops import score as sc
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_essential_large as sel
    from ransac_tpu_torch.ops import sweep_large as sl
    from ransac_tpu_torch.ops import sweep_pnp_large as spl

    err = dict.fromkeys(("homography_ransac_sweep_large",
                         "essential_ransac_sweep_large", "pnp_ransac_sweep_large"), 0.0)
    for name, t in large_check_cases(DEVICE).items():
        core = (t["src"], t["dst"], t["mask"], 3.0, sw.draw_seeds(3, sl.N_SEEDS),
                sl.n_hyp_for(4 * sl.BLOCK_H, t["src"].shape[0], sl.BLOCK_H))
        err["homography_ransac_sweep_large"] = max(
            err["homography_ransac_sweep_large"], large_hold(core, name))
        for block_h in (512, sel.BLOCK_H):
            core = (t["x1"], t["x2"], t["mask"], (2.0 / 600.0) ** 2,
                    sw.draw_seeds(4, sel.N_SEEDS),
                    sl.n_hyp_for(8192, t["x1"].shape[0], block_h), block_h)
            err["essential_ransac_sweep_large"] = max(
                err["essential_ransac_sweep_large"],
                essential_large_hold(core, f"{name}_block{block_h}"))
        for block_h, ay in ((512, 0.54), (spl.BLOCK_H, 1.0)):
            args = (5, t["X"], t["pix_n"], t["mask"], 10.0 / 900.0, 4 * spl.BLOCK_H)
            out_k = spl.pnp_ransac_sweep_large(*args, block_h=block_h, ay=ay)
            out_p = spl.pnp_ransac_sweep_large_ref(*args, block_h=block_h, ay=ay)
            check(int(out_k[3][1]) == int(out_p[3][1])
                  and bool(torch.equal(out_k[3][2], out_p[3][2])),
                  f"pnp_ransac_sweep_large {name}: pool order or n_valid differ")
            core = (t["X"], t["pix_n"], t["mask"], sc._thr_sq(10.0 / 900.0),
                    float(np.float32(ay)), sw.draw_seeds(5, spl.N_SEEDS),
                    4 * spl.BLOCK_H, block_h)
            err["pnp_ransac_sweep_large"] = max(
                err["pnp_ransac_sweep_large"],
                pnp_hold("pnp_ransac_sweep_large", core,
                         f"{name}_block{block_h}_ay{ay}")[0])
    return err


def main_path_homography_sweep_large(n):
    """ransac_homography_sweep on a planted pool of n points (30% outliers)
    at 2^20 hypotheses, card vs CPU; the replayed winner re-solves to its
    recorded count within 2."""
    import torch

    from ransac_tpu_torch.io.synthetic import planted_homography_pool
    from ransac_tpu_torch.models.ransac import ransac_homography_sweep
    from ransac_tpu_torch.ops import homography as hops
    from ransac_tpu_torch.ops import sweep_large as sl
    from ransac_tpu_torch.utils.config import RansacConfig

    cfg = RansacConfig(threshold=3.0, num_hypotheses=LARGE_SWEEP_HYP, exhaustive=False)
    src_np, dst_np, n_in = planted_homography_pool(n, seed=7)
    results, card_counts = {}, None
    for device in (DEVICE, "cpu"):
        src, dst = (torch.as_tensor(a, device=device) for a in (src_np, dst_np))
        mask = torch.ones(n, device=device)
        reset_counts()
        t0 = time.perf_counter()
        res = ransac_homography_sweep(src, dst, mask, cfg, 0)
        counts = read_counts()
        wall = time.perf_counter() - t0
        _, c, flat, (seeds, n_valid, order) = sl.homography_ransac_sweep_large(
            0, src, dst, mask, cfg.threshold, LARGE_SWEEP_HYP)
        b = int(res.best_index)
        sample = order[sl.sample_indices_for(flat[0, b], seeds, n_valid)]
        Hm, _ = hops.dlt_homography_minimal(src[sample], dst[sample])
        resolved = int((hops.transfer_errors(Hm, src, dst) <= cfg.threshold).sum())
        n_inl = int(res.num_inliers)
        results[device] = (sorted(sample.tolist()), res.inlier_mask.cpu())
        emit(phase="main_path", path=f"ransac_homography_sweep_large_n{n}",
             device=device, n_hyp=res.num_hypotheses, num_inliers=n_inl,
             planted_inliers=n_in, winning_sample=results[device][0],
             recorded_count=float(c[0, b]), resolved_count=resolved, seconds=wall,
             launches=counts if device == DEVICE else None)
        check(n_inl >= 0.9 * n_in, f"{device} n{n}: {n_inl} of {n_in} planted inliers")
        check(abs(resolved - float(c[0, b])) <= 2, f"{device} n{n}: replay re-solves "
              f"to {resolved}, recorded {float(c[0, b])}")
        check(bool(torch.isfinite(res.model).all()), f"{device} n{n}: model not finite")
        card_counts = counts if device == DEVICE else card_counts
    same = (results[DEVICE][0] == results["cpu"][0]
            and bool(torch.equal(results[DEVICE][1], results["cpu"][1])))
    emit(phase="gpu_vs_cpu", path=f"ransac_homography_sweep_large_n{n}",
         same_decisions=same)
    check(same, f"ransac_homography_sweep n{n}: card and CPU decide differently")
    return card_counts


def main_path_pnp_sweep_large(n):
    """ransac_pnp_sweep on a planted pool of n points (30% outliers) at the
    reference's PnP budget (30 px, 5000 -> 8192), card vs CPU."""
    import numpy as np
    import torch

    from ransac_tpu_torch.io.synthetic import planted_pnp_pool
    from ransac_tpu_torch.models.ransac import pnp_pose_from_result, ransac_pnp_sweep
    from ransac_tpu_torch.ops.rotation import log_so3
    from ransac_tpu_torch.utils.config import LocalizeConfig

    cfg = LocalizeConfig().pnp_ransac
    X_np, pix_np, K_np, R_true, t_true, n_in = planted_pnp_pool(n, seed=11)
    results, card_counts = {}, None
    for device in (DEVICE, "cpu"):
        X, pix, K = (torch.as_tensor(a, device=device) for a in (X_np, pix_np, K_np))
        reset_counts()
        t0 = time.perf_counter()
        res = ransac_pnp_sweep(X, pix, K, torch.ones(n, device=device), cfg, 0)
        counts = read_counts()
        wall = time.perf_counter() - t0
        R, t = (a.cpu().double() for a in pnp_pose_from_result(res))
        rot = float(torch.linalg.vector_norm(log_so3(R @ torch.from_numpy(R_true).T)))
        dt = float(np.abs(t.numpy() - t_true).max())
        kept = int(res.inlier_mask[:n_in].sum())
        results[device] = res.inlier_mask.cpu()
        emit(phase="main_path", path=f"ransac_pnp_sweep_large_n{n}", device=device,
             n_hyp=res.num_hypotheses, num_inliers=int(res.num_inliers),
             planted_inliers=n_in, planted_kept=kept, rotation_error_rad=rot,
             translation_error_m=dt, seconds=wall,
             launches=counts if device == DEVICE else None)
        check(kept >= 0.85 * n_in, f"{device} n{n}: kept {kept} of {n_in}")
        check(rot < 0.01 and dt < 0.05, f"{device} n{n}: pose {rot} rad, {dt} m off")
        card_counts = counts if device == DEVICE else card_counts
    same = bool(torch.equal(results[DEVICE], results["cpu"]))
    emit(phase="gpu_vs_cpu", path=f"ransac_pnp_sweep_large_n{n}", same_decisions=same)
    check(same, f"ransac_pnp_sweep n{n}: card and CPU decide differently")
    return card_counts


def main_path_twoview():
    """two_view_pipeline on a rendered 1024 x 1024 pair with the default
    TwoViewConfig: engine "auto" is the fused sweep on the card; the CPU
    runs the sweep's plain version.  Returns the launch counts and the
    card run's correspondences (for the kernel timing)."""
    import numpy as np
    import torch

    from ransac_tpu_torch.io.synthetic import two_view_pair
    from ransac_tpu_torch.ops.rotation import log_so3
    from ransac_tpu_torch.pipelines.twoview import two_view_pipeline
    from ransac_tpu_torch.utils.config import TwoViewConfig

    img1, img2, K, R_true, t_true = two_view_pair((1024, 1024))
    results, card_counts = {}, None
    for device, cfg in ((DEVICE, TwoViewConfig()), ("cpu", TwoViewConfig(engine="sweep"))):
        reset_counts()
        t0 = time.perf_counter()
        res = two_view_pipeline(img1, img2, K, cfg, seed=0, device=device)
        counts = read_counts()
        wall = time.perf_counter() - t0
        rot = float(torch.linalg.vector_norm(log_so3(
            torch.from_numpy(res.R).double() @ torch.from_numpy(R_true).T)))
        tdot = abs(float(res.t @ t_true))
        inl = res.matches[res.inliers]
        results[device] = (res, {(tuple(np.round(res.kp1[i], 2)), tuple(np.round(res.kp2[j], 2)))
                                 for i, j in inl})
        emit(phase="main_path", path="two_view_pipeline_1024", device=device,
             matches=int(len(res.matches)), inliers=int(res.inliers.sum()),
             rotation_error_rad=rot, t_dot=tdot, n_cheiral=res.n_cheiral,
             seconds=wall, launches=counts if device == DEVICE else None)
        check(len(res.matches) > 40, f"{device}: {len(res.matches)} matches")
        check(rot < 0.05 and tdot > 0.98, f"{device}: pose {rot} rad, |t.t| {tdot}")
        card_counts = counts if device == DEVICE else card_counts
    gpu, cpu = results[DEVICE], results["cpu"]
    common = len(gpu[1] & cpu[1]) / max(len(gpu[1] | cpu[1]), 1)
    d_rot = float(torch.linalg.vector_norm(log_so3(
        torch.from_numpy(gpu[0].R).double() @ torch.from_numpy(cpu[0].R).double().T)))
    emit(phase="gpu_vs_cpu", path="two_view_pipeline_1024",
         inlier_jaccard=common, relative_rotation_rad=d_rot,
         tolerance="inlier correspondences (pixel pairs to 0.01 px) Jaccard >= 0.95, "
                   "poses within 0.005 rad")
    check(common >= 0.95 and d_rot < 0.005,
          f"two_view_pipeline: card and CPU differ (Jaccard {common}, {d_rot} rad)")
    check(card_counts["essential_ransac_sweep_large"] >= 1,
          "the essential sweep was not launched")
    return card_counts


def twoview_pool(device):
    """The correspondences the card's two-view main path hands its sweep
    (1024 match slots of the rendered pair) and the normalized pixel
    threshold^2."""
    import torch

    from ransac_tpu_torch.features.detect import detect_harris
    from ransac_tpu_torch.features.match import mutual_nn_match, patch_descriptors
    from ransac_tpu_torch.io.synthetic import two_view_pair
    from ransac_tpu_torch.ops.projection import normalize_pixels
    from ransac_tpu_torch.utils.config import TwoViewConfig

    cfg = TwoViewConfig()
    img1, img2, K, _, _ = two_view_pair((1024, 1024))
    im = [torch.as_tensor(a, device=device) for a in (img1, img2)]
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device)
    kp = [detect_harris(a, cfg.max_keypoints, cfg.nms_radius, cfg.harris_k) for a in im]
    d = [patch_descriptors(a, k.xy, k.valid, cfg.patch_size) for a, k in zip(im, kp)]
    m = mutual_nn_match(d[0], d[1], kp[0].valid, kp[1].valid, cfg.match_ratio)
    focal = float(K[0, 0] + K[1, 1]) / 2.0
    return (normalize_pixels(kp[0].xy[m.idx1], Kt), normalize_pixels(kp[1].xy[m.idx2], Kt),
            m.valid.to(torch.float32), (cfg.ransac.threshold / focal) ** 2)


# ------------------------------------------------------------ rows 7, 10, 11
def essential_cases(device):
    """Row 7's check cases on planted correspondences (0.5 px noise, the
    last quarter outliers): (x1, x2, mask, n_points)."""
    import torch

    cases = {}
    for name, n, n_points, masked in (("n16", 16, None, []),
                                      ("n13_n_points_10", 13, 10, []),
                                      ("n16_masked", 16, None, [1, 6]),
                                      ("n16_mostly_masked", 16, None, [0, 5, 9, 12])):
        x1, x2 = twoview_correspondences(n, seed=n + len(masked))
        mask = torch.ones(n)
        mask[masked] = 0.0
        cases[name] = tuple(torch.as_tensor(a, device=device) for a in (x1, x2, mask)) + (
            n_points,)
    return cases


def check_sweep_essential():
    """Row 7 against its plain version by the decision-level criteria
    (``compare_fused``): n = 16, n = 13 sampling the first 10, masked points
    (every hypothesis touching one invalid), reduced and full records,
    block_h 512 and the default; then a seed whose winners' last index is >=
    4 (packed >= 2^30; >= 8 is a negative int32), where the unsigned
    tie-break of the records decides."""
    import torch

    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_essential as se
    from ransac_tpu_torch.profile import ESSENTIAL_THRESHOLD

    def hold(seed, x1, x2, mask, n_points, block_h, case):
        args = (seed, x1, x2, mask, ESSENTIAL_THRESHOLD, CHECK_HYP)
        kw = dict(n_points=n_points, block_h=block_h)
        out = {(fn, full): fn(*args, full_records=full, **kw)
               for fn in (se.essential_ransac_sweep, se.essential_ransac_sweep_ref)
               for full in (True, False)}
        k, p = se.essential_ransac_sweep, se.essential_ransac_sweep_ref
        return out[k, True], out[k, False], compare_fused(
            "essential_ransac_sweep", case, out[k, True], out[p, True], out[k, False],
            out[p, False])

    err = 0.0
    cases = essential_cases(DEVICE)
    for name, (x1, x2, mask, n_points) in cases.items():
        for block_h in (512, None):
            block = block_h or se.BLOCK_H
            full_k, _, e = hold(6, x1, x2, mask, n_points, block_h, f"{name}_block{block}")
            err = max(err, e)
            idx = torch.stack([(full_k[2] >> (4 * j)) & 15 for j in range(8)])
            touches = (mask[idx.long()] == 0).any(0)
            tie = ((full_k[0] >= 3e38).reshape(8, -1).all(0)
                   & (full_k[2] < 0).reshape(8, -1).any(0))
            emit(phase="kernel_check_detail", kernel="essential_ransac_sweep",
                 case=name, block_h=block, negative_packed=int((full_k[2] < 0).sum()),
                 records_tied_invalid_with_negative=int(tie.sum()),
                 masked_samples=int(touches.sum()))
            check(bool((full_k[0][touches] >= 3e38).all()
                       and (full_k[1][touches] == -1).all()),
                  f"essential_ransac_sweep {name}: a masked sample is valid")
    x1, x2, mask, _ = cases["n16"]
    for seed in range(100):
        msac, counts, packed = se.essential_ransac_sweep(seed, x1, x2, mask,
                                                         ESSENTIAL_THRESHOLD, CHECK_HYP)
        a = int(msac[0].argmin())
        b = int(torch.where(counts[1] == counts[1].max(), msac[1], float("inf")).argmin())
        last = [int(packed[0][a]) >> 28 & 15, int(packed[1][b]) >> 28 & 15]
        if min(last) >= 4:
            break
    check(min(last) >= 4, "no seed below 100 has winners with a last index >= 4")
    _, _, e = hold(seed, x1, x2, mask, None, None, f"n16_seed{seed}_winners_last{last}")
    return max(err, e)


def check_roofline():
    """Rows 10 and 11 against their plain versions on tile (replica) 0 and
    another: "mixed" bit for bit, "fma" within FMA_RTOL (the kernel fuses
    the multiply-add), the TF32 product chain within MXU_RTOL at up to 8
    steps, where every entry of the float32 chain is a normal number."""
    import torch

    from ransac_tpu_torch.ops import roofline as rf

    err = {}
    for kind in ("fma", "mixed"):
        err[f"roofline_{kind}"] = 0.0
        for n_iters in (1, PROBE_SMALL_TRIPS):
            out_k = rf.run_chain(1.0, n_iters, kind, tiles=6, device=DEVICE)
            out_p = rf.run_chain_plain(1.0, n_iters, kind, tiles=6, device=DEVICE)
            for tile in (0, 5):
                k, p = out_k[tile], out_p[tile]
                rel = float((k / p - 1.0).abs().max())
                abs_err = float((k - p).abs().max())
                emit(phase="kernel_check", kernel=f"roofline_{kind}",
                     case=f"trips{n_iters}_tile{tile}", equal=bool(torch.equal(k, p)),
                     max_rel_err=rel, max_abs_err=abs_err,
                     tolerance="exact" if kind == "mixed" else f"rel {rf.FMA_RTOL}")
                check(torch.equal(k, p) if kind == "mixed" else rel <= rf.FMA_RTOL,
                      f"roofline_{kind} trips {n_iters} tile {tile}: rel err {rel}")
                err[f"roofline_{kind}"] = max(err[f"roofline_{kind}"], abs_err)
    err["roofline_mxu"] = 0.0
    for n_iters in (1, 4, 8, 11, 13):
        out_k = rf.run_mxu(1.0, n_iters, replicas=3, device=DEVICE)
        out_p = rf.run_mxu_plain(1.0, n_iters, replicas=3, device=DEVICE)
        normal = bool((out_p > 1.2e-38).all())
        rel = float((out_k / out_p - 1.0).abs().max()) if normal else None
        emit(phase="kernel_check", kernel="roofline_mxu", case=f"steps{n_iters}_replicas3",
             nonzero_kernel=int((out_k != 0).sum()), nonzero_plain=int((out_p != 0).sum()),
             entries=out_k.numel(), max_rel_err=rel,
             max_abs_err=float((out_k - out_p).abs().max()),
             tolerance=f"rel {rf.MXU_RTOL} where the chain is normal (steps <= 8)")
        if n_iters <= 8:
            check(normal and rel <= rf.MXU_RTOL,
                  f"roofline_mxu {n_iters} steps: rel err {rel}")
            err["roofline_mxu"] = max(err["roofline_mxu"],
                                      float((out_k - out_p).abs().max()))
    return err


def main_path_profile(tmp):
    """``python -m ransac_tpu_torch.cli profile --measure-peaks --out ...``
    in a process of its own (its launch counts start at 0 and are read
    from its last line); its peaks and table are printed here."""
    import subprocess

    out = os.path.join(tmp, "profile.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ransac_tpu_torch.cli", "profile",
                           "--measure-peaks", "--out", out],
                          capture_output=True, text=True, cwd=REPO, timeout=600)
    wall = time.perf_counter() - t0
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0,
          f"cli profile: exit code {proc.returncode}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    counts = json.loads(lines[-1].split(":", 1)[1])
    peaks = json.loads(next(ln for ln in lines if ln.startswith("# measured rooflines:"))
                       .split(":", 1)[1])
    with open(out, encoding="utf-8") as f:
        rows = json.load(f)
    names = [r["kernel"] for r in rows]
    emit(phase="main_path", path="cli_profile", seconds=wall, peaks=peaks,
         rows={r["kernel"]: r["ms"] for r in rows}, launches=counts)
    check(names == ["fused_ransac_sweep", "fused_p3p_sweep", "fused_p3p_sweep_large_n256",
                    "fused_essential_sweep", "pallas_inlier_score", "dlt_minimal_solve",
                    "mutual_nn_match", "harris_response_1024", "twoview_frame_1024"],
          f"cli profile rows {names}")
    check(all(r["ms"] > 0 and r["chip"] == "h100" for r in rows), "cli profile rows' times")
    check(all(v > 0 for v in peaks.values()), f"measured peaks {peaks}")
    for name in ("essential_ransac_sweep", "roofline_fma", "roofline_mixed", "roofline_mxu"):
        check(counts[name] >= 1, f"cli profile launched no {name}")
    return counts


def time_probes(smi, clock_mhz):
    """Rows 10 and 11.  "fma" and "mixed" on 33 tiles: at the probes'
    PROBE_TRIPS (kernel only: the plain chain's 4 M dependent steps are two
    launches each; the output is held finite and positive), and at
    PROBE_HOLD_TRIPS, where kernel and plain are both timed and held
    ("mixed" exactly, "fma" within FMA_HOLD_RTOL).  The product chain at
    the probe's PROBE_STEPS on 33 replicas, kernel and plain (held equal:
    both underflow to 0), and its library yardstick: the same chain as
    PROBE_STEPS TF32 ``addmm`` calls, (a @ b) 1e-3 each.  CUDA events,
    median of 5 after a warm-up (the plain versions 3).  Bounds: the work
    over the data-sheet peak of the unit.  Returns ({name: row of the
    kernels line}, {name: max abs error}); the FP32 chains' rows are at
    PROBE_HOLD_TRIPS."""
    import torch

    from ransac_tpu_torch.ops import roofline as rf
    from ransac_tpu_torch.utils.profiling import TF32_FLOPS

    fp32_ops_per_s = 132 * 128 * clock_mhz * 1e6
    rows, errs = {}, {}
    tiles = rf.PROBE_TILES
    # A mixed group is 5 operations in JAX's count, but the card issues 4
    # instructions for it (compare; the product and the sum, each under the
    # compare's predicate; min: the select folds into the predicate, as
    # the kernel's SASS read once showed, PERF.md), so its bound counts 4.
    for kind, work, peak in (("fma", rf.fma_flops, 2 * fp32_ops_per_s),
                             ("mixed", rf.mixed_ops, fp32_ops_per_s * 5 / 4)):
        out = rf.run_chain(0.0, PROBE_TRIPS, kind, tiles, DEVICE)
        check(bool((torch.isfinite(out) & (out > 0)).all()),
              f"roofline_{kind} at {PROBE_TRIPS} trips: not finite and positive")
        ms = rf.time_ms(lambda: rf.run_chain(0.0, PROBE_TRIPS, kind, tiles, DEVICE))
        bound_ms = work(PROBE_TRIPS, tiles) / peak * 1e3
        emit(phase="time_kernel", kernel=f"roofline_{kind}",
             shape=f"trips{PROBE_TRIPS}_tiles{tiles}", kernel_ms=ms,
             rate_per_s=work(PROBE_TRIPS, tiles) / (ms * 1e-3), peak_per_s=peak,
             bound_ms=bound_ms, bound_by="operations", gpu=smi)

        def fk():
            return rf.run_chain(0.0, PROBE_HOLD_TRIPS, kind, tiles, DEVICE)

        def fp():
            return rf.run_chain_plain(0.0, PROBE_HOLD_TRIPS, kind, tiles, DEVICE)

        out_k, out_p = fk(), fp()
        rel = float((out_k / out_p - 1.0).abs().max())
        tol = "exact" if kind == "mixed" else f"rel {FMA_HOLD_RTOL}"
        check(torch.equal(out_k, out_p) if kind == "mixed" else rel <= FMA_HOLD_RTOL,
              f"roofline_{kind} at {PROBE_HOLD_TRIPS} trips x {tiles} tiles: rel {rel}")
        ms, plain = rf.time_ms(fk), rf.time_ms(fp, reps=3)
        bound_ms = work(PROBE_HOLD_TRIPS, tiles) / peak * 1e3
        errs[f"roofline_{kind}"] = float((out_k - out_p).abs().max())
        emit(phase="time_kernel", kernel=f"roofline_{kind}",
             shape=f"trips{PROBE_HOLD_TRIPS}_tiles{tiles}", kernel_ms=ms, plain_ms=plain,
             equal=bool(torch.equal(out_k, out_p)), max_rel_err=rel,
             max_abs_err=errs[f"roofline_{kind}"], tolerance=tol,
             bound_ms=bound_ms, bound_by="operations", gpu=smi)
        rows[f"roofline_{kind}"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                                    "bound_by": "operations"}

    replicas, steps = rf.PROBE_REPLICAS, PROBE_STEPS

    def fk():
        return rf.run_mxu(0.0, steps, replicas, DEVICE)

    def fp():
        return rf.run_mxu_plain(0.0, steps, replicas, DEVICE)

    a0, b = rf.mxu_operands(0.0, replicas, DEVICE)
    a0 = a0.reshape(-1, rf.MXU_DIM)   # the replicas share b: one [33 x 512, 512] product
    bufs = (torch.empty_like(a0), torch.empty_like(a0))

    def library():
        x, y = bufs[0].copy_(a0), bufs[1]
        for _ in range(steps):
            y.addmm_(x, b, beta=0.0, alpha=1e-3)
            x, y = y, x
        return x

    out_k, out_p = fk(), fp()
    check(torch.equal(out_k, out_p), f"roofline_mxu at {steps} steps: kernel and plain differ")
    ms = rf.time_ms(fk)
    plain = rf.time_ms(fp, reps=3)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        check(not bool(library().any()), "the library chain did not underflow to 0")
        lib_ms = rf.time_ms(library)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    work = rf.mxu_flops(steps, replicas)
    bound_ms = work / TF32_FLOPS * 1e3
    emit(phase="time_kernel", kernel="roofline_mxu", shape=f"steps{steps}_replicas{replicas}",
         kernel_ms=ms, tf32_flops_per_s=work / (ms * 1e-3), nonzero_outputs=int((out_k != 0).sum()),
         plain_ms=plain, library_ms=lib_ms,
         library_note=f"{steps} dependent TF32 addmm calls, (a @ b) * 1e-3 each",
         bound_ms=bound_ms, bound_by="operations", gpu=smi)
    rows["roofline_mxu"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                            "bound_by": "operations", "library_ms": lib_ms}
    errs["roofline_mxu"] = float((out_k - out_p).abs().max())
    return rows, errs


def time_twoview_frames(smi, frames=5):
    """Frames per second of the twoview_frame_1024 workload at one card by
    the host clock around frames that end in a synchronize (after one
    frame whose sweep is held against its plain version); the device idle
    share from torch.profiler over 2 more (each ~20,000 kernels, whose
    trace the profiler is slow to read back)."""
    import torch

    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_essential_large as sel
    from ransac_tpu_torch.ops.sweep_large import n_hyp_for
    from ransac_tpu_torch.profile import ESSENTIAL_THRESHOLD, TWOVIEW_HYPOTHESES, twoview_frame

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    frame = twoview_frame(gen, 0, DEVICE)
    essential_large_hold((frame.x1, frame.x2, frame.mask, ESSENTIAL_THRESHOLD,
                          sw.draw_seeds(0, sel.N_SEEDS),
                          n_hyp_for(TWOVIEW_HYPOTHESES, frame.x1.shape[0], sel.BLOCK_H),
                          sel.BLOCK_H), f"frame{frame.x1.shape[0]}_H{TWOVIEW_HYPOTHESES}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    stats = [twoview_frame(gen, k + 1, DEVICE) for k in range(frames)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    profiled_frames = 2

    def more_frames():
        for k in range(profiled_frames):
            twoview_frame(gen, 100 + k, DEVICE)

    _, p_wall, n_kernels, busy_s, _, _ = profiled(more_frames)
    idle = 1.0 - busy_s / p_wall
    emit(phase="time_twoview_frame_1024", frames=frames, frames_per_s=frames / wall,
         seconds_per_frame=wall / frames, matches=[s.matches for s in stats],
         inliers=[s.inliers for s in stats],
         device_busy_s_per_frame=busy_s / profiled_frames, device_idle_share=idle,
         cuda_events_per_frame=n_kernels / profiled_frames, profiled_frames=profiled_frames,
         profiled_wall_s=p_wall, launches=counts, gpu=smi)
    check(all(bool(torch.isfinite(s.R).all()) for s in stats), "twoview frame pose")
    check(counts["essential_ransac_sweep_large"] == frames, "twoview frames' sweeps")
    return frames / wall, idle


# ------------------------------------------------------------ BA, pose graphs, SfM
BA_CELLS = (  # name, cameras, points, slots per point (the bench's scene)
    ("32_2k_24k", 32, 2000, 12),
    ("512_20k_200k", 512, 20_000, 10),
    ("512_200k_2M", 512, 200_000, 10),
)
BA_PASSES = 3        # LM passes in a timed run (rtol 0: fixed trips)
BA_NOISE_PX = 0.5    # the 32-camera cell's pixel noise: its optimum is not float32 noise
SFM_FRAMES, SFM_POINTS = 32, 2000
SFM_PROFILED_FRAMES = 8        # the profiled cut of the SfM run


def wait_counts(fn):
    """(wall s, device events, device busy s, {aten::item, cudaStreamSynchronize:
    count}, {device event name[:60]: [count, ns]}) of one call of ``fn``
    under torch.profiler (``trace_events``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, busy, waits, by_name = trace_events(prof, ("aten::item", "cudaStreamSynchronize"))
    return wall, kernels, busy, waits, by_name


def lm_pass_readings(run):
    """A BA solver's readings per LM pass, ``run(n)`` running n fixed passes:
    ``ba.bench.time_passes`` (ms a pass by CUDA events, median of 5 runs of
    BA_PASSES passes; the LM's reads; peak memory),
    and from profiled runs of 2 and 4 passes the kernels, ``aten::item``,
    stream synchronizes and device busy time a pass (the difference over
    2), the kernels that take most of it, and the idle share: 1 - device
    busy a pass / ms a pass (the profiler's own wall is longer)."""
    from ransac_tpu_torch.ba.bench import time_passes

    out = time_passes(run, BA_PASSES, device=DEVICE)
    t2, t4 = wait_counts(lambda: run(2)), wait_counts(lambda: run(4))
    top = sorted(((ns - t2[4].get(k, [0, 0])[1]) / 2e6, k) for k, (_, ns) in t4[4].items())
    out.update(kernels_per_pass=(t4[1] - t2[1]) / 2,
               items_per_pass=(t4[3]["aten::item"] - t2[3]["aten::item"]) / 2,
               syncs_per_pass=(t4[3]["cudaStreamSynchronize"]
                               - t2[3]["cudaStreamSynchronize"]) / 2,
               device_ms_per_pass=(t4[2] - t2[2]) / 2 * 1e3,
               device_idle_share=1.0 - (t4[2] - t2[2]) / 2e-3 / out["ms_per_lm_pass"],
               top_device_ms_per_pass=[[round(ms, 4), k] for ms, k in top[::-1][:6]])
    return out


def slots_to_obs(sp):
    """The observation list (``BAProblem``) of a slot problem's live slots,
    ordered by slot row then point (``from_ba_problem`` packs it back into
    the same slots)."""
    import torch

    from ransac_tpu_torch.ba.bundle import BAProblem

    live = sp.slot_w > 0
    D, P = sp.slot_cam.shape
    pt = torch.arange(P, device=sp.slot_cam.device).expand(D, P)
    return BAProblem(cameras=sp.cameras, points=sp.points, K=sp.K, obs_cam=sp.slot_cam[live],
                     obs_pt=pt[live], obs_uv=sp.slot_uv[:, live].T,
                     obs_w=torch.ones(int(live.sum()), device=sp.slot_w.device))


def main_path_ba(smi):
    """Bundle adjustment on the bench's scene (``ba.bench.synth_slot_problem``):
    at 32 cameras / 2,000 points / 24,000 observations (0.5 px of pixel
    noise) the dense Schur ``bundle_adjust`` on the card and on the CPU (15
    passes, cost within rtol 1e-3) and ``bundle_adjust_cg`` against it (cost
    within 5%); then each cell's solvers timed per LM pass (dense; CG with
    cg_iters 16 at cg_tol 0 and with the tolerance exit 1e-4), with kernels,
    reads and synchronizes a pass, idle share and peak memory, the cost
    falling in every cell."""
    import torch

    from ransac_tpu_torch.ba import bundle, schur_cg
    from ransac_tpu_torch.ba.bench import synth_slot_problem
    from ransac_tpu_torch.utils.config import BundleAdjustConfig
    from ransac_tpu_torch.utils.prng import generator_for

    for name, n_cam, n_pt, slots in BA_CELLS:
        sp = synth_slot_problem(n_cam, n_pt, slots, device=DEVICE)
        n_obs = int(sp.slot_w.sum())
        if name == "32_2k_24k":
            g = generator_for(1, device=DEVICE)
            sp = sp._replace(slot_uv=sp.slot_uv + BA_NOISE_PX * torch.randn(
                sp.slot_uv.shape, generator=g, device=DEVICE))
            p = slots_to_obs(sp)
            cfg = BundleAdjustConfig(max_iters=15)
            res, walls = {}, {}
            for device in (DEVICE, "cpu"):
                t0 = time.perf_counter()
                res[device] = bundle.bundle_adjust(p, cfg, device=device)
                float(res[device].cost)
                walls[device] = time.perf_counter() - t0
            cg = schur_cg.bundle_adjust_cg(sp, cfg, device=DEVICE)
            costs = {"card": float(res[DEVICE].cost), "cpu": float(res["cpu"].cost),
                     "cg": float(cg.cost), "initial": float(res[DEVICE].initial_cost)}
            emit(phase="gpu_vs_cpu", path="bundle_adjust", cell=name, n_obs=n_obs,
                 passes=15, costs=costs, card_wall_s=walls[DEVICE], cpu_wall_s=walls["cpu"],
                 tolerance="card vs CPU cost rtol 1e-3; CG vs dense 5%")
            check(abs(costs["card"] / costs["cpu"] - 1) < 1e-3,
                  f"dense BA card {costs['card']} against CPU {costs['cpu']}")
            check(abs(costs["cg"] / costs["card"] - 1) < 0.05,
                  f"CG BA {costs['cg']} against dense {costs['card']}")
            dense = lm_pass_readings(lambda n: bundle.bundle_adjust(
                p, BundleAdjustConfig(max_iters=n, rtol=0.0), device=DEVICE))
            emit(phase="main_path", path="ba", cell=name, solver="dense", n_obs=n_obs,
                 **dense, gpu=smi)
            check(dense["cost_final"] < dense["cost_initial"], f"{name} dense: cost")
            check(dense["peak_mem_bytes"] < 1 << 30,
                  f"{name} dense: {dense['peak_mem_bytes']} bytes of device memory")
        for tol in (0.0, 1e-4):
            r = lm_pass_readings(lambda n: schur_cg.bundle_adjust_cg(
                sp, BundleAdjustConfig(max_iters=n, rtol=0.0), cg_iters=16, cg_tol=tol,
                device=DEVICE))
            emit(phase="main_path", path="ba", cell=name, solver="cg", cg_iters=16,
                 cg_tol=tol, n_obs=n_obs, **r, gpu=smi)
            check(r["cost_final"] < r["cost_initial"], f"{name} cg tol {tol}: cost")
        del sp
        torch.cuda.empty_cache()


def main_path_posegraph(smi):
    """The JAX loop-closure tests' graphs on the card and on the CPU: the
    SE(3) circuit of 32 nodes with biased odometry and 3 closures, and the
    Sim(3) repair of a 24-node circuit with 3% scale drift a step.  The
    card's poses within 1e-3 of the CPU's; the centred ATE cut below 0.35
    (SE(3)) / 0.5 (Sim(3)) of the drifted chain's, as the JAX tests hold it.
    Prints the wall, LM passes and the card run's kernels and idle share."""
    from ransac_tpu_torch.ba import posegraph as pg
    from ransac_tpu_torch.io.synthetic import centered_ate, se3_loop_graph, sim3_drift_graph
    from ransac_tpu_torch.ops import lm

    g3, gt3, drift3 = se3_loop_graph(32)
    g7, gt7, drift7 = sim3_drift_graph(24)
    cases = (("se3_loop_32", lambda d: pg.optimize_pose_graph(g3, max_iters=40, device=d),
              gt3, drift3, 0.35, lambda x: x),
             ("sim3_drift_24", lambda d: pg.optimize_pose_graph_sim3(g7, max_iters=60, device=d),
              gt7, drift7, 0.5, pg.sim3_to_se3))
    for name, run, gt, drifted, cut, to_se3 in cases:
        run(DEVICE)
        out = {}
        for device in (DEVICE, "cpu"):
            lm.reset_counts()
            if device == DEVICE:
                wall, kernels, busy, waits, _ = wait_counts(
                    lambda: out.update(card=run(device)))
                poses = out["card"][0]
            else:
                t0 = time.perf_counter()
                poses = run(device)[0]
                wall, kernels, busy, waits = time.perf_counter() - t0, None, None, None
            ate = centered_ate(to_se3(poses).double().cpu().numpy(), gt)
            out[device] = poses.cpu()
            emit(phase="main_path", path="posegraph", graph=name, device=device,
                 ate=ate, ate_drifted=centered_ate(drifted, gt), wall_s=wall,
                 lm_passes=lm.COUNTS["passes"], lm_reads=lm.COUNTS["reads"], kernels=kernels,
                 host_waits=waits,
                 device_idle_share=None if busy is None else 1.0 - busy / wall, gpu=smi)
            check(ate < cut * centered_ate(drifted, gt), f"{name} {device}: ATE {ate}")
        d = float((out[DEVICE] - out["cpu"]).abs().max())
        emit(phase="gpu_vs_cpu", path="posegraph", graph=name, max_abs_pose_diff=d,
             tolerance=1e-3)
        check(d < 1e-3, f"{name}: card and CPU poses differ by {d}")


def sfm_ate(m, poses_true) -> tuple[float, float]:
    """(ATE of the registered frames' similarity-aligned centres, the scene
    scale max |C_true|), as the JAX SfM test measures them."""
    import numpy as np

    from ransac_tpu_torch.pipelines.sfm import _cam_center

    frames = sorted(m)
    A = np.array([_cam_center(m[f]) for f in frames])
    B = np.array([_cam_center(poses_true[f]) for f in frames])
    muA, muB = A.mean(0), B.mean(0)
    A0, B0 = A - muA, B - muB
    U, S, Vt = np.linalg.svd(B0.T @ A0 / len(A))
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (A0 ** 2).mean(0).sum()
    ate = float(np.sqrt(((B - (s * A @ R.T + muB - s * R @ muA)) ** 2).sum(1).mean()))
    return ate, float(np.abs(np.array([_cam_center(p) for p in poses_true])).max())


def main_path_sfm(tmp, smi):
    """``python -m ransac_tpu_torch.cli sfm --tracks ... --intrinsics ...
    --device cuda`` (called in this process, so its launches are counted)
    on ``write_sfm_tracks`` at 32 frames / 2,000 points, and on the card
    and the CPU at the JAX test's 6 frames / 80 points: every frame
    registered, ATE under 5% of the scene scale.  Every point of that scene
    is seen by every frame, so 32 frames make 450 dense BA passes over up
    to 64,000 observations: ~3 minutes on a CPU.  The CPU runs the first 8
    frames of the 32-frame tracks instead, beside a profiled card run of
    the same cut (its kernels and idle share): the same frames registered.
    At 2,000 points every pool is over the sweeps' sizes (PnP 512,
    essential 1024), so the stage-wise engine runs there; the 80-point
    scene's bootstrap and registration launch rows 8 and 9: each of those
    launches is held against its plain version on the very inputs the run
    gave it (``sfm_sweep_holds``), and so are the last two PnP refits (row
    13, ``refit_holds``).  Prints the wall, LM passes and launches of each
    run.  Returns the launch counts of the card's ``cli sfm`` runs and the
    holds' max abs errors."""
    import numpy as np

    from ransac_tpu_torch import cli
    from ransac_tpu_torch.ba import bundle
    from ransac_tpu_torch.io.synthetic import write_sfm_tracks
    from ransac_tpu_torch.pipelines.sfm import incremental_sfm

    total = None
    cores = {"pnp_ransac_sweep_large": [], "essential_ransac_sweep_large": []}
    refits = {"refit_homography": [], "refit_pose": []}
    for frames, points in ((SFM_FRAMES, SFM_POINTS), (6, 80)):
        st = write_sfm_tracks(os.path.join(tmp, f"sfm_{frames}"), frames, points)
        out = {}
        for device in ((DEVICE,) if frames == SFM_FRAMES else (DEVICE, "cpu")):
            npz = os.path.join(tmp, f"sfm_{frames}_{device}.npz")
            argv = ["sfm", "--tracks", st.tracks_npz, "--intrinsics", st.intrinsics_txt,
                    "--out", npz, "--device", device]
            bundle.reset_counts()
            reset_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), sweep_inputs_kept(cores), \
                    refit_inputs_kept(refits):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            counts = read_counts() if device == DEVICE else None
            check(rc == 0, f"cli sfm {frames} frames --device {device}: exit code {rc}")
            d = np.load(npz)
            poses = {int(f): p for f, p in zip(d["frames"], d["poses"])}
            ate, scale = sfm_ate(poses, st.poses)
            out[device] = sorted(poses)
            emit(phase="main_path", path="cli_sfm", frames=frames, points=points,
                 device=device, registered=len(poses), map_points=len(d["track_ids"]),
                 ate=ate, ate_over_scale=ate / scale, wall_s=wall,
                 lm_passes=bundle.COUNTS["passes"], lm_reads=bundle.COUNTS["reads"],
                 launches={k: v for k, v in (counts or {}).items() if v} or None, gpu=smi)
            check(len(poses) == frames, f"sfm {frames}: {len(poses)} frames registered")
            check(ate < 0.05 * scale, f"sfm {frames} {device}: ATE {ate} of scale {scale}")
            if counts is not None:
                total = counts if total is None else {k: total[k] + counts[k] for k in total}
        if frames != SFM_FRAMES:
            check(out[DEVICE] == out["cpu"], f"sfm {frames}: the card and CPU register "
                                             f"{out[DEVICE]} / {out['cpu']}")
            continue
        # The cut: the first frames of the same tracks, profiled on the card.
        tracks = {k: v for k, v in cli._read_tracks(st.tracks_npz).items()
                  if k[0] < SFM_PROFILED_FRAMES}
        K = np.loadtxt(st.intrinsics_txt)
        order = list(range(SFM_PROFILED_FRAMES))
        cut = {}
        for device in (DEVICE, "cpu"):
            bundle.reset_counts()
            if device == DEVICE:
                wall, kernels, busy, waits, _ = wait_counts(
                    lambda: cut.update(card=incremental_sfm(tracks, K, order, device=device)))
                m = cut["card"]
            else:
                t0 = time.perf_counter()
                m = incremental_sfm(tracks, K, order, device=device)
                wall, kernels, busy, waits = time.perf_counter() - t0, None, None, None
            cut[device] = sorted(m.camera_poses)
            ate, scale = sfm_ate(m.camera_poses, st.poses[:SFM_PROFILED_FRAMES])
            emit(phase="main_path", path="sfm_cut", frames=SFM_PROFILED_FRAMES, points=points,
                 device=device, registered=len(m.camera_poses), ate_over_scale=ate / scale,
                 wall_s=wall, lm_passes=bundle.COUNTS["passes"], kernels=kernels,
                 kernels_per_lm_pass=None if kernels is None
                 else kernels / max(bundle.COUNTS["passes"], 1),
                 host_waits=waits,
                 device_idle_share=None if busy is None else 1.0 - busy / wall, gpu=smi)
            check(ate < 0.05 * scale, f"sfm cut {device}: ATE {ate} of scale {scale}")
        check(cut[DEVICE] == cut["cpu"] == order,
              f"sfm cut: the card and CPU register {cut[DEVICE]} / {cut['cpu']}")
    check(total["pnp_ransac_sweep_large"] >= 1 and total["essential_ransac_sweep_large"] >= 1,
          f"cli sfm launched no sweep: {total}")
    for name, kept in cores.items():
        check(len(kept) == total[name], f"{name}: {len(kept)} inputs kept of "
                                        f"{total[name]} launches")
    # Row 13: the registrations' PnP refits (the last, the 6-frame scene's).
    check(len(refits["refit_pose"]) == total["refit_pose"] >= 1,
          f"cli sfm: {len(refits['refit_pose'])} PnP refits kept of {total['refit_pose']}")
    return total, {**sfm_sweep_holds(cores),
                   **refit_holds({"refit_pose": refits["refit_pose"][-2:]}, "cli_sfm")}


SWEEP_MODULES = {  # kernel -> the ops module whose ``_sweep_kernel`` launches it
    "pnp_ransac_sweep": "sweep_pnp",
    "pnp_ransac_sweep_large": "sweep_pnp_large",
    "essential_ransac_sweep_large": "sweep_essential_large",
}


@contextlib.contextmanager
def sweep_inputs_kept(cores, tags=None, where=None):
    """Within the block, every launch on a CUDA tensor of a kernel named in
    ``cores`` (rows 5, 8, 9: ``SWEEP_MODULES``) appends a copy of its core
    arguments (all but ``full``) to ``cores[kernel]``, and, where ``tags``
    is given, the label ``where[0]`` names at that moment to
    ``tags[kernel]``; the launch itself is the wrapper's, counted once."""
    import importlib
    import inspect

    mods = {name: importlib.import_module(f"ransac_tpu_torch.ops.{SWEEP_MODULES[name]}")
            for name in cores}

    def keeper(name, real):
        # Row 5's wrapper passes ``full`` by position: keep the arguments before it.
        n_core = list(inspect.signature(real).parameters).index("full")

        def core(*args, **kw):
            if args[0].is_cuda:
                cores[name].append(tuple(a.clone() if hasattr(a, "clone") else a
                                         for a in args[:n_core]))
                if tags is not None:
                    tags[name].append(where[0])
            return real(*args, **kw)
        return core

    real = {name: mod._sweep_kernel for name, mod in mods.items()}
    for name, mod in mods.items():
        mod._sweep_kernel = keeper(name, real[name])
    try:
        yield
    finally:
        for name, mod in mods.items():
            mod._sweep_kernel = real[name]


def sfm_sweep_holds(cores):
    """Rows 8 and 9 against their plain versions on the inputs ``cli sfm``
    gave them (its pools: ``_bucket``'s power of two, the live rows then a
    zero-weight tail of zeros): row 8 by ``essential_large_hold``, row 9 by
    ``pnp_hold``.  Returns {kernel: max abs error}."""
    err = {}
    for name, kept in cores.items():
        for i, core in enumerate(kept):
            mask = core[2]
            case = f"cli_sfm_{i}_n{mask.shape[0]}_live{int(mask.sum())}"
            e = (essential_large_hold(core, case) if name == "essential_ransac_sweep_large"
                 else pnp_hold(name, core, case)[0])
            err[name] = max(err.get(name, 0.0), e)
        emit(phase="kernel_check_sfm_inputs", kernel=name, calls=len(kept),
             rows=sorted({int(c[2].shape[0]) for c in kept}),
             live_rows=[int(c[2].sum()) for c in kept], max_abs_err=err.get(name))
    return err


@contextlib.contextmanager
def refit_inputs_kept(kept):
    """Within the block, every fused refit (row 13: ``ops.lm.
    fused_refit_homography`` / ``fused_refit_pose`` as ``models.ransac``
    calls them) appends a copy of its arguments and of its answer to
    ``kept[kernel]``; the launch itself is the wrapper's, counted once."""
    import torch

    from ransac_tpu_torch.models import ransac as rm

    real = {"refit_homography": rm.fused_refit_homography,
            "refit_pose": rm.fused_refit_pose}

    def keeper(name):
        def call(*args):
            out = real[name](*args)
            kept[name].append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args), out.clone()))
            return out
        return call

    rm.fused_refit_homography = keeper("refit_homography")
    rm.fused_refit_pose = keeper("refit_pose")
    try:
        yield
    finally:
        rm.fused_refit_homography = real["refit_homography"]
        rm.fused_refit_pose = real["refit_pose"]


def refit_holds(kept, path, calls=2):
    """Row 13 on the inputs a main path gave it (the first ``calls`` of each
    kernel in ``kept``, ``refit_inputs_kept``): the launch again gives the
    same answer bit for bit, and the answer is held against the plain refit
    on the CPU in float32 and float64 by the limits of
    tests/test_torch_refit_kernel.py (the fallback and NaN where float32
    has them; every point's projection (a pose's live rows: a pool's zero
    padding is no point) no further from float64's than LM_SLACK x
    float32's plus LM_PX_FLOOR px: homographies problem by problem without
    an LM, over the batch after one); beside it, the
    largest distance to the plain refit on the card (op by op: the
    homography's LM the plain loop, the pose's row 12's kernel).  Returns {kernel: max px to the float32 plain refit}."""
    import dataclasses

    import torch

    from ransac_tpu_torch.models import ransac as rm
    from ransac_tpu_torch.ops import homography as hops
    from ransac_tpu_torch.ops import lm
    from ransac_tpu_torch.ops.projection import project_points
    from ransac_tpu_torch.utils.config import RansacConfig

    def h_px(H, H64, src):
        ok = torch.isfinite(src).all(-1)[..., None]
        d = hops.apply_h(H.double(), src.double()) - hops.apply_h(H64, src.double())
        return torch.where(ok, d.abs(), 0.0).flatten(1).amax(-1)

    def pose_px(m, m64, X, K, live):
        def project(m):
            m = m.double()
            return project_points(X, m[:9].reshape(3, 3), m[9:], K)[0][live]
        return (project(m) - project(m64)).abs().max()

    err = {}
    for name, kept_calls in kept.items():
        for i, (args, out) in enumerate(kept_calls[:calls]):
            iters = args[-1]
            cfg = dataclasses.replace(RansacConfig(), refine_iters=iters)
            cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args[:-1]]
            f64 = [a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                   for a in cpu]
            if name == "refit_homography":
                again = lm.fused_refit_homography(*args)
                card_plain = rm.refit_homography_plain(*args[:-1], cfg)
                p32, p64 = (rm.refit_homography_plain(*a, cfg) for a in (cpu, f64))
                k = out.cpu()
                H_best, src = cpu[0], cpu[1]
                fallback = torch.equal((k == H_best).all(-1).all(-1),
                                       (p32 == H_best).all(-1).all(-1))
                nan = torch.equal(torch.isnan(k), torch.isnan(p32))
                ok = torch.isfinite(p32).all(-1).all(-1) & torch.isfinite(p64).all(-1).all(-1)
                d_k, d_32 = h_px(k[ok], p64[ok], src[ok]), h_px(p32[ok], p64[ok], src[ok])
                d_card = float(h_px(k[ok], card_plain.cpu()[ok].double(), src[ok]).max())
                if iters:
                    d_k, d_32 = d_k.max(), d_32.max()
                held = bool((d_k <= LM_SLACK * d_32 + LM_PX_FLOOR).all())
                shape = f"B{src.shape[0]}_n{src.shape[1]}_passes{iters}"
                to_32 = float(h_px(k[ok], p32[ok].double(), src[ok]).max())
            else:
                again = lm.fused_refit_pose(*args)
                card_plain = rm.pnp_refit_plain(*args[:-1], cfg)
                p32, p64 = (rm.pnp_refit_plain(*a, cfg) for a in (cpu, f64))
                k, X64, K64, live = out.cpu(), f64[1], f64[4], cpu[6] > 0
                fallback = torch.equal(k, cpu[0]) == torch.equal(p32, cpu[0])
                nan = torch.equal(torch.isnan(k), torch.isnan(p32))
                d_k, d_32 = pose_px(k, p64, X64, K64, live), pose_px(p32, p64, X64, K64, live)
                d_card = float(pose_px(k, card_plain.cpu().double(), X64, K64, live))
                held = bool(d_k <= LM_SLACK * d_32 + LM_PX_FLOOR)
                shape = (f"n{X64.shape[0]}_live{int(live.sum())}_inliers{int(cpu[5].sum())}"
                         f"_passes{iters}")
                to_32 = float(pose_px(k, p32.double(), X64, K64, live))
            same = torch.equal(torch.isnan(again), torch.isnan(out)) and torch.equal(
                again.nan_to_num(), out.nan_to_num())
            emit(phase="refit_hold", kernel=name, path=path, call=i, shape=shape,
                 relaunch_equal=same, fallback_alike=fallback, nan_alike=nan,
                 px_to_f64=float(d_k.max()), plain_px_to_f64=float(d_32.max()),
                 px_to_plain=to_32, px_to_card_plain=d_card, held=held,
                 limits=[LM_SLACK, LM_PX_FLOOR])
            check(same and fallback and nan and held,
                  f"{name} on {path} call {i}: relaunch {same}, fallback {fallback}, "
                  f"NaN {nan}, projections {float(d_k.max())} px from float64, "
                  f"the plain refit's {float(d_32.max())}")
            err[name] = max(err.get(name, 0.0), to_32)
    return err


DEMO_FRAMES = 64                 # `cli sfm --demo 64 [--loop]`, the JAX demo's size
DEMO_CUT_FRAMES = 16             # the card-vs-CPU cut, profiled on the card
# ATE over the trajectory (line) / the circuit (loop).  One demo run is one
# draw of a chaotic process, and the card's runs are not repeatable (atomic
# sums in the BA): six card runs of the line demo read 5.3-19.2% (its
# bootstrap's row 8 winner keeps a match the stage engine's model puts 26 px
# off, as the JAX sweep does on the same inputs and seed), the loop demo
# 10.9-14.4%; the CPU's sweep route 12.4%, its stage route 5.3%.
DEMO_ATE_GATE = {False: 0.25, True: 0.20}
DEMO_CUT_ATE_GATE = 0.10         # the JAX package's CPU run: 7.21% at 16 frames


@contextlib.contextmanager
def demo_stage_tags(where, pg_passes):
    """Within the block, ``where[0]`` names the demo stage that launches a
    sweep ("closure_edge" inside ``loop_closure._essential_pose``, else
    "sfm"), and ``pg_passes`` gathers the LM passes of each Sim(3) pose
    graph optimized."""
    from ransac_tpu_torch.ba import posegraph
    from ransac_tpu_torch.ops import lm
    from ransac_tpu_torch.pipelines import loop_closure

    real_pose, real_pg = loop_closure._essential_pose, posegraph.optimize_pose_graph_sim3

    def pose(*args, **kw):
        where[0] = "closure_edge"
        try:
            return real_pose(*args, **kw)
        finally:
            where[0] = "sfm"

    def pg(*args, **kw):
        before = lm.COUNTS["passes"]
        out = real_pg(*args, **kw)
        pg_passes.append(lm.COUNTS["passes"] - before)
        return out

    loop_closure._essential_pose, posegraph.optimize_pose_graph_sim3 = pose, pg
    try:
        yield
    finally:
        loop_closure._essential_pose, posegraph.optimize_pose_graph_sim3 = real_pose, real_pg


def demo_line(d, wall, launches, ba_passes, lm_passes, pg_passes, report, smi, **extra):
    """One JSON line of a demo run: its metrics dict ``d`` (``run_demo``'s,
    or the CLI's JSON) with the readings around it."""
    base = d["ate"] / max(d["ate_frac"], 1e-30)
    nopg = d["ate_no_posegraph"]
    return dict(
        frames=d["frames"], registered=d["registered"], rescued=d["rescued"],
        tracks=d["tracks"], observations=d["observations"], ate=d["ate"],
        ate_frac=d["ate_frac"], ate_no_posegraph=nopg,
        ate_no_posegraph_frac=None if nopg is None else nopg / base,
        loop_edges=d["loop_edges"], posegraph_committed=d["posegraph_committed"],
        frontend_frames_per_s=d["frontend"][0][1], t_tracks_s=d["t_tracks_s"],
        t_sfm_s=d["t_sfm_s"], t_ba_s=d["t_ba_s"], wall_s=wall, ba_lm_passes=ba_passes,
        lm_passes_all=lm_passes, posegraph_lm_passes=pg_passes, slots=d["slots"],
        slot_live_share=d["slots"]["live"] / d["slots"]["total"],
        launches={k: v for k, v in (launches or {}).items() if v} or None,
        report=[ln for ln in report.splitlines() if ln.strip()], gpu=smi, **extra)


def main_path_sfm_demo(tmp, smi):
    """``python -m ransac_tpu_torch.cli sfm --demo 64 [--loop] --device cuda``
    (in this process, so its launches are counted), seed 0: the line demo
    (160 x 200 frames, 256 keypoints) and the loop demo (320 x 400, 768
    keypoints, loop closure and the Sim(3) pose graph).  Every frame
    registered; ATE under 25% of the trajectory (line) and 20% of the
    circuit (loop), ``DEMO_ATE_GATE``.  Each run's wall, stage times,
    front-end frames/s, BA and pose-graph LM passes, launches, loop edges
    and the verdict, the ATE with and without the pose graph, and the final
    CG problem's live slots of its [D, P] layout.  Then the first 16 frames (``run_demo``) on the
    card, profiled (kernels, host waits, idle share), and on the CPU: every
    frame registered on both, both ATEs within 10%.  Every launch of rows
    5, 8 and 9 in the 64-frame runs is kept (``closure_edge``'s pixel-match
    pools tagged) and held against its plain version
    (``demo_sweep_holds``).  Returns the launch counts of the card's
    64-frame runs and the holds' max abs errors."""
    from ransac_tpu_torch import cli
    from ransac_tpu_torch.ba import bundle
    from ransac_tpu_torch.ops import lm
    from ransac_tpu_torch.pipelines.sfm_demo import run_demo

    total = None
    cores = {k: [] for k in SWEEP_MODULES}
    tags = {k: [] for k in SWEEP_MODULES}
    where = ["sfm"]
    for loop in (False, True):
        path = os.path.join(tmp, f"demo_{int(loop)}.json")
        argv = ["sfm", "--demo", str(DEMO_FRAMES), "--seed", "0", "--out", path,
                "--device", DEVICE] + (["--loop"] if loop else [])
        bundle.reset_counts()
        lm.reset_counts()
        reset_counts()
        pg_passes = []
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), sweep_inputs_kept(cores, tags, where), \
                demo_stage_tags(where, pg_passes):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        check(rc == 0, f"cli sfm --demo {DEMO_FRAMES} loop={loop}: exit code {rc}")
        with open(path, encoding="utf-8") as fh:
            d = json.load(fh)
        emit(phase="main_path", path="cli_sfm_demo", loop=loop, device=DEVICE,
             **demo_line(d, wall, counts, bundle.COUNTS["passes"], lm.COUNTS["passes"],
                         pg_passes, buf.getvalue(), smi))
        check(d["registered"] == DEMO_FRAMES,
              f"demo loop={loop}: {d['registered']}/{DEMO_FRAMES} frames registered")
        check(d["ate_frac"] < DEMO_ATE_GATE[loop],
              f"demo loop={loop}: ATE {d['ate_frac']} of the trajectory")
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    for name, kept in cores.items():
        check(len(kept) == total[name], f"{name}: {len(kept)} inputs kept of "
                                        f"{total[name]} launches")
    check(total["essential_ransac_sweep_large"] >= 1 and total["pnp_ransac_sweep_large"] >= 1,
          f"the demo launched no large sweep: {total}")
    check("closure_edge" in tags["essential_ransac_sweep_large"],
          "closure_edge launched no essential sweep on the card")

    # The cut: card (profiled) against the CPU.
    cut = {}
    for device in (DEVICE, "cpu"):
        bundle.reset_counts()
        lm.reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if device == DEVICE:
                wall, kernels, busy, waits, by_name = wait_counts(lambda: cut.update(
                    card=run_demo(DEMO_CUT_FRAMES, seed=0, device=DEVICE)))
                d = cut["card"]
                top = sorted(((ns * 1e-6, n, k) for k, (n, ns) in by_name.items()),
                             reverse=True)[:6]
            else:
                t0 = time.perf_counter()
                d = run_demo(DEMO_CUT_FRAMES, seed=0, device=device)
                wall, kernels, busy, waits, top = time.perf_counter() - t0, None, None, None, None
        cut[device] = d
        emit(phase="gpu_vs_cpu", path="sfm_demo_cut", device=device, kernels=kernels,
             device_busy_s=busy, top_device_ms=top,
             host_waits=waits, device_idle_share=None if busy is None else 1.0 - busy / wall,
             **demo_line(d, wall, None, bundle.COUNTS["passes"], lm.COUNTS["passes"], None,
                         buf.getvalue(), smi))
        check(d["registered"] == DEMO_CUT_FRAMES,
              f"demo cut {device}: {d['registered']}/{DEMO_CUT_FRAMES} registered")
        check(d["ate_frac"] <= DEMO_CUT_ATE_GATE, f"demo cut {device}: ATE {d['ate_frac']}")
    return total, demo_sweep_holds(cores, tags)


def demo_sweep_holds(cores, tags):
    """Rows 5, 8 and 9 against their plain versions on every pool the demo
    gave them (``_bucket``'s powers of two from the SfM stages; the
    appearance matches of ``closure_edge`` as they come): row 8 by
    ``essential_large_hold``, rows 5 and 9 by ``pnp_hold``.  Returns
    {kernel: max abs error} of the kernels launched."""
    err = {}
    for name, kept in cores.items():
        if not kept:
            emit(phase="kernel_check_demo_inputs", kernel=name, calls=0)
            continue
        t0 = time.perf_counter()
        mask_at = 3 if name == "pnp_ransac_sweep" else 2
        for i, (core, tag) in enumerate(zip(kept, tags[name])):
            case = f"demo_{tag}_{i}_n{core[mask_at].shape[0]}_live{int(core[mask_at].sum())}"
            e = (essential_large_hold(core, case) if name == "essential_ransac_sweep_large"
                 else pnp_hold(name, core, case)[0])
            err[name] = max(err.get(name, 0.0), e)
        sizes = [int(c[mask_at].shape[0]) for c in kept]
        emit(phase="kernel_check_demo_inputs", kernel=name, calls=len(kept),
             by_stage={t: tags[name].count(t) for t in sorted(set(tags[name]))},
             rows={n: sizes.count(n) for n in sorted(set(sizes))},
             live_rows=[int(c[mask_at].sum()) for c in kept],
             closure_pools=[int(c[mask_at].sum()) for c, t in zip(kept, tags[name])
                            if t == "closure_edge"],
             max_abs_err=err[name], seconds=time.perf_counter() - t0)
    return err


def native_ingest(tmp):
    """``io.tables`` through the native reader (built from ``native/fastio.cpp``
    into ``build/native/``) against the Python path on the planted scene:
    ``use_native="always"`` equals ``"never"``."""
    import numpy as np

    from ransac_tpu_torch.io import native, tables
    from ransac_tpu_torch.io.synthetic import write_planted_scene

    ps = write_planted_scene(os.path.join(tmp, "native"), seed=0, n_unannotated=3)
    t0 = time.perf_counter()
    check(native.available(), f"the native reader did not build: {native.error()}")
    build_s = time.perf_counter() - t0
    read = {}
    for mode in ("always", "never"):
        t0 = time.perf_counter()
        read[mode] = (tables.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y,
                                              keep_unannotated=True, use_native=mode),
                      tables.read_camera_locations(ps.cameras_csv, use_native=mode))
        read[mode + "_s"] = time.perf_counter() - t0
    (fa, ca), (fn, cn) = read["always"], read["never"]
    same = (fa.symbols == fn.symbols and fa.names == fn.names
            and all(np.array_equal(getattr(fa, k), getattr(fn, k))
                    for k in ("pixels", "pos3d_utm", "lonlat", "heights", "elevations"))
            and np.array_equal(ca.grid_codes, cn.grid_codes)
            and float(np.abs(ca.pos3d_utm - cn.pos3d_utm).max()) <= 1e-9)
    emit(phase="native_ingest", library=native.library_path().name, build_s=build_s,
         features=len(fa), cameras=len(ca), native_s=read["always_s"],
         python_s=read["never_s"], equal=same)
    check(same, "native ingest differs from the Python path")


# ------------------------------------------------------------ parallel/
PAR_WORLD = 4                 # ranks of the gloo world that share the one card
PAR_COLLECTIVE_S = 240.0      # a collective's timeout in a spawned world
PAR_DEADLINE_S = 600.0        # a spawned world's deadline, and each torchrun's
PAR_CG_CELL = (512, 200_000, 10)   # the JAX BA bench's size (ba.bench)
PAR_BA_PASSES = 3
PAR_DEMO_FRAMES = 16          # `cli sfm --demo 16` under torchrun, the ATE gate's cut


def _max_excess(a, b, rtol, atol) -> float:
    """The largest |a - b| - (atol + rtol |b|): <= 0 where a and b agree."""
    import torch

    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def parallel_checks(ps, backend: str, world: int, smi) -> tuple[list, dict]:
    """Every rank's side of ``main_path_parallel``: the port's distributed
    functions on a world of ``world`` ranks, each against its one-device
    form (the search), its emulation, or its run on the primary's 1-rank
    sub-mesh.  Returns the primary's (lines to print, arrays to hold across
    worlds)."""
    import numpy as np
    import torch

    from ransac_tpu_torch.ba.bench import synth_slot_problem
    from ransac_tpu_torch.ba.posegraph import sim3_to_se3
    from ransac_tpu_torch.ba.schur_cg import slot_cost
    from ransac_tpu_torch.io.synthetic import (centered_ate, se3_loop_graph,
                                               sim3_drift_graph)
    from ransac_tpu_torch.parallel import mesh as m
    from ransac_tpu_torch.parallel.dist_ba import (distributed_bundle_adjust,
                                                   distributed_bundle_adjust_cg)
    from ransac_tpu_torch.parallel.dist_posegraph import (distributed_pose_graph,
                                                          distributed_pose_graph_sim3)
    from ransac_tpu_torch.parallel.multihost import is_primary
    from ransac_tpu_torch.parallel.sharded_frontend import distributed_frontend
    from ransac_tpu_torch.parallel.sharded_search import (distributed_score_candidates,
                                                          emulate_hypothesis_sharded,
                                                          pad_candidates)
    from ransac_tpu_torch.pipelines.localize import score_candidates
    from ransac_tpu_torch.pipelines.sfm_demo import synth_trajectory_frames
    from ransac_tpu_torch.utils.config import LocalizeConfig, RansacConfig, TwoViewConfig
    from ransac_tpu_torch.utils.prng import generator_for

    primary = is_primary()
    dev = m.rank_device(DEVICE)
    lines, arrays = [], {}

    def note(**kw):
        lines.append({"check": kw.pop("check"), "backend": backend, "world": world, **kw,
                      "rank_elapsed_s": time.perf_counter() - START, "gpu": smi})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    data_mesh = m.make_mesh(world, data=world, model=1, device=DEVICE)
    one = m.make_mesh(1, device=DEVICE)

    # 1. The candidate-sharded search at full width, against score_candidates.
    scene = scene_from(ps, dev)
    cam_locs, grids = pad_candidates(scene.cam_locs, scene.grid_codes, PAR_WORLD)
    args = (scene.pixels, scene.pos3d, scene.point_mask, cam_locs, grids)
    cfg = LocalizeConfig(ransac=RansacConfig(threshold=75.0, exhaustive=True,
                                             refine_iters=0))
    distributed_score_candidates(*args, cfg, 0, data_mesh)
    out_d, wall_d = timed(lambda: distributed_score_candidates(*args, cfg, 0, data_mesh))
    if primary:
        out_s, wall_s = timed(lambda: score_candidates(*args, cfg))
        ex = max(_max_excess(out_d[k], out_s[k], 2e-4, 2e-3) for k in ("err1", "err2"))
        note(check="candidate_sharded_search", mesh=data_mesh.shape,
             candidates=int(cam_locs.shape[0]), best=int(out_d["best"]),
             single_device_best=int(out_s["best"]), planted=ps.planted,
             best_err2=float(out_d["best_err2"]), max_excess_over_tolerance=ex,
             tolerance="rtol 2e-4, atol 2e-3", wall_s=wall_d, single_device_wall_s=wall_s)
        check(int(out_d["best"]) == int(out_s["best"]) == ps.planted,
              f"candidate-sharded best {int(out_d['best'])}, single-device "
              f"{int(out_s['best'])}, planted {ps.planted}")
        check(ex <= 0, f"candidate-sharded err1 / err2 off by {ex} over the tolerance")
        arrays["search_err2"] = out_d["err2"].cpu()

    # 2. The hypothesis-sharded search on the squarest mesh, against its emulation.
    sq = m.make_mesh(world, device=DEVICE)
    n_d, n_m = sq.shape["data"], sq.shape["model"]
    cfg_h = LocalizeConfig(ransac=RansacConfig(threshold=75.0, num_hypotheses=1024 * n_m,
                                               exhaustive=False))
    out_h, wall_h = timed(lambda: distributed_score_candidates(*args, cfg_h, 0, sq))
    if primary:
        out_e, wall_e = timed(lambda: emulate_hypothesis_sharded(*args, cfg_h, 0, n_d, n_m,
                                                                 device=dev))
        ex = max(_max_excess(out_h[k], out_e[k], 2e-4, 2e-3) for k in ("err1", "err2"))
        note(check="hypothesis_sharded_search", mesh=sq.shape, best=int(out_h["best"]),
             emulation_best=int(out_e["best"]), max_excess_over_tolerance=ex,
             tolerance="rtol 2e-4, atol 2e-3", wall_s=wall_h, emulation_wall_s=wall_e)
        check(int(out_h["best"]) == int(out_e["best"]),
              f"hypothesis-sharded best {int(out_h['best'])} != emulation {int(out_e['best'])}")
        check(ex <= 0, f"hypothesis-sharded err off its emulation by {ex} over the tolerance")

    # 3-6 against the primary's 1-rank sub-mesh (in a world of one the run
    # itself is that; the worlds are held against each other afterwards).
    against_one = primary and world > 1

    # 3. Dense distributed BA, 32 cameras / 96 points.
    sp = synth_slot_problem(32, 96, 8, seed=0, device=dev)
    g = generator_for(1, device=dev)
    sp = sp._replace(slot_uv=sp.slot_uv + BA_NOISE_PX * torch.randn(
        sp.slot_uv.shape, generator=g, device=dev))
    p = slots_to_obs(sp)
    distributed_bundle_adjust(p, data_mesh, n_iters=1)
    (c_n, _, cost_n), w_n = timed(lambda: distributed_bundle_adjust(
        p, data_mesh, n_iters=PAR_BA_PASSES))
    if against_one:
        (c_1, _, cost_1), w_1 = timed(lambda: distributed_bundle_adjust(
            p, one, n_iters=PAR_BA_PASSES))
        d_cost = abs(float(cost_n) / float(cost_1) - 1)
        ex = _max_excess(c_n, c_1, 5e-3, 5e-4)
        check(d_cost <= 1e-3, f"dense distributed BA cost {float(cost_n)} vs {float(cost_1)}")
        check(ex <= 0, f"dense distributed BA cameras off by {ex} over the tolerance")
        one_rank = dict(one_rank_cost=float(cost_1), cost_rel_diff=d_cost,
                        cameras_max_excess=ex, one_rank_wall_s=w_1)
    if primary:
        note(check="dist_bundle_adjust", cameras=32, points=96,
             observations=int(p.obs_w.numel()), passes=PAR_BA_PASSES, cost=float(cost_n),
             tolerance="cost rtol 1e-3; cameras rtol 5e-3, atol 5e-4", wall_s=w_n,
             **(one_rank if against_one else {}))
        arrays["dense_cost"] = float(cost_n)

    # 4. Distributed CG BA at the JAX bench's size, points over the ranks.
    n_cam, n_pt, slots = PAR_CG_CELL
    sp = synth_slot_problem(n_cam, n_pt, slots, device=dev)
    distributed_bundle_adjust_cg(sp, data_mesh, n_iters=1)
    (_, _, cost_n), w_n = timed(lambda: distributed_bundle_adjust_cg(
        sp, data_mesh, n_iters=PAR_BA_PASSES))
    if against_one:
        distributed_bundle_adjust_cg(sp, one, n_iters=1)
        (_, _, cost_1), w_1 = timed(lambda: distributed_bundle_adjust_cg(
            sp, one, n_iters=PAR_BA_PASSES))
        d_cost = abs(float(cost_n) / float(cost_1) - 1)
        check(d_cost <= 1e-3, f"CG distributed BA cost {float(cost_n)} vs {float(cost_1)}")
        one_rank = dict(one_rank_cost=float(cost_1), cost_rel_diff=d_cost,
                        one_rank_ms_per_lm_pass=w_1 / PAR_BA_PASSES * 1e3)
    if primary:
        c0 = float(slot_cost(sp, sp.cameras, sp.points))
        note(check="dist_bundle_adjust_cg", cameras=n_cam, points=n_pt,
             observations=int(sp.slot_w.sum()), passes=PAR_BA_PASSES, cg_iters=24,
             initial_cost=c0, cost=float(cost_n),
             tolerance="cost rtol 1e-3, below the initial cost",
             ms_per_lm_pass=w_n / PAR_BA_PASSES * 1e3,
             timing="host clock between device synchronizes, initial cost included",
             **(one_rank if against_one else {}))
        check(float(cost_n) < c0, f"CG distributed BA cost {float(cost_n)} from {c0}")
        arrays["cg_cost"] = float(cost_n)
    del sp
    torch.cuda.empty_cache()

    # 5. The pose graphs: the Sim(3) drifted circuit and the SE(3) loop.
    g7, gt7, drift7 = sim3_drift_graph(24)
    g3, _, _ = se3_loop_graph(32)
    ate0 = centered_ate(drift7, gt7)

    def sim3_ate(poses):
        return centered_ate(sim3_to_se3(poses).double().cpu().numpy(), gt7)

    for name, run, n_iters in (
            ("sim3_drift_24", lambda mesh: distributed_pose_graph_sim3(g7, mesh, n_iters=40), 40),
            ("se3_loop_32", lambda mesh: distributed_pose_graph(g3, mesh, n_iters=20), 20)):
        (poses_n, cost_n), w_n = timed(lambda: run(data_mesh))
        sim3 = name.startswith("sim3")
        if against_one:
            (poses_1, cost_1), w_1 = timed(lambda: run(one))
            d = float((poses_n - poses_1).abs().max())
            one_rank = dict(one_rank_cost=float(cost_1), max_abs_pose_diff=d,
                            one_rank_wall_s=w_1)
            if sim3:
                # Each rank floors its translation rows at its own edges'
                # median (as the JAX function does), so ranks and one rank
                # reach slightly different optima: held by the ATE, as the
                # dryrun holds JAX's.
                one_rank["one_rank_ate"] = sim3_ate(poses_1)
                check(abs(sim3_ate(poses_n) - one_rank["one_rank_ate"]) <= 1e-3,
                      f"{name}: ATE {sim3_ate(poses_n)} vs one rank's "
                      f"{one_rank['one_rank_ate']}")
            else:
                check(d <= 1e-3, f"{name}: {world} ranks and one differ by {d}")
        if primary:
            extra = dict(ate=sim3_ate(poses_n), ate_drifted=ate0) if sim3 else {}
            note(check="dist_pose_graph", graph=name, passes=n_iters, cost=float(cost_n),
                 tolerance=("ATE within 1e-3 of one rank's, below half the drifted" if sim3
                            else "poses within 1e-3"), wall_s=w_n, **extra,
                 **(one_rank if against_one else {}))
            if sim3:
                check(extra["ate"] < 0.5 * ate0, f"{name}: ATE {extra['ate']} from {ate0}")
            arrays[name] = extra["ate"] if sim3 else poses_n.cpu()

    # 6. The front end on the 64-frame line demo's renders.
    imgs, _, _, _ = synth_trajectory_frames(F=64)
    fe_cfg = TwoViewConfig(max_keypoints=256, nms_radius=3, patch_size=8)
    distributed_frontend(imgs, data_mesh, fe_cfg)
    (xy, valid, _, idx2, mvalid), w_n = timed(lambda: distributed_frontend(imgs, data_mesh,
                                                                            fe_cfg))
    if against_one:
        (xy1, valid1, _, idx21, mvalid1), w_1 = timed(lambda: distributed_frontend(
            imgs, one, fe_cfg))
        keep = mvalid1[:-1]
        same = {"valid": bool(torch.equal(valid, valid1)), "xy": bool(torch.equal(xy, xy1)),
                "mvalid": bool(torch.equal(mvalid[:-1], mvalid1[:-1])),
                "idx2": bool(torch.equal(idx2[:-1][keep], idx21[:-1][keep]))}
        check(all(same.values()), f"front end over {world} ranks differs from one: {same}")
        one_rank = dict(bit_for_bit=same, one_rank_frames_per_s=64 / w_1)
    if primary:
        note(check="sharded_frontend", frames=64, keypoints=int(valid.sum()),
             matches=int(mvalid.sum()), last_row_invalid=not bool(mvalid[-1].any()),
             frames_per_s=64 / w_n, **(one_rank if against_one else {}))
        check(not bool(mvalid[-1].any()), "the last pair row is not all invalid")
        arrays["frontend_xy"] = xy.cpu()
        arrays["frontend_valid"] = valid.cpu()
    return lines, arrays


def parallel_rank(rank, world, backend, directory, ps, smi):
    """One spawned rank of ``main_path_parallel``: a ``file://`` group in
    ``directory``, every collective failing after PAR_COLLECTIVE_S; the
    primary saves its lines and arrays there."""
    import torch

    from ransac_tpu_torch.parallel.multihost import initialize_cluster, shutdown_cluster

    initialize_cluster(f"file://{os.path.join(directory, 'store_' + backend)}", world, rank,
                       device=DEVICE, backend=backend, timeout_s=PAR_COLLECTIVE_S)
    try:
        lines, arrays = parallel_checks(ps, backend, world, smi)
    finally:
        shutdown_cluster()
    if rank == 0:
        torch.save({"lines": lines, "arrays": arrays},
                   os.path.join(directory, f"results_{backend}.pt"))


def spawn_world(world, backend, directory, ps, smi) -> dict:
    """Run ``parallel_rank`` in ``world`` spawned ranks; a failing rank, or a
    world past PAR_DEADLINE_S (killed), fails the run.  Returns the
    primary's results."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(parallel_rank, args=(world, backend, directory, ps, smi),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + PAR_DEADLINE_S
    while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
        if time.monotonic() >= end:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"check failed: {world} {backend} ranks still running "
                               f"after {PAR_DEADLINE_S} s")
    out = torch.load(os.path.join(directory, f"results_{backend}.pt"))
    out["wall_s"] = time.perf_counter() - t0
    return out


def run_group(cmd, timeout_s: float) -> tuple[int, str]:
    """(exit code, stdout + stderr) of ``cmd`` in a session of its own, the
    whole session killed at ``timeout_s`` (a failure)."""
    import signal
    import subprocess

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"check failed: {' '.join(cmd[-4:])} still running after "
                           f"{timeout_s} s") from None
    return proc.returncode, out


def torchrun_entry_points(smi):
    """(c): ``profile --scaling-only`` and ``sfm --demo 16`` under
    ``torch.distributed.run --standalone --nproc-per-node 4`` on the one card
    (gloo: the ranks share it), as a user runs them."""
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(PAR_WORLD), "-m", "ransac_tpu_torch.cli"]
    t0 = time.perf_counter()
    rc, out = run_group(run + ["profile", "--scaling-only"], PAR_DEADLINE_S)
    wall = time.perf_counter() - t0
    rows = [ln.split() for ln in out.splitlines()
            if re.match(r"\s+\d+ \{'data'", ln)]
    counts = [int(r[0]) for r in rows]
    emit(phase="main_path_parallel", check="torchrun_profile_scaling_only", rc=rc,
         world=PAR_WORLD, backend_line=[ln for ln in out.splitlines()
                                        if ln.startswith("# scaling: backend")],
         rows=[" ".join(r) for r in rows],
         virtual_notes=out.count("# NOTE: virtual single-host devices"), wall_s=wall,
         gpu=smi)
    check(rc == 0, f"torchrun profile --scaling-only exit code {rc}:\n{out[-3000:]}")
    check(counts == [1, 2, 4, 1, 2, 4], f"scaling rows at {counts}")
    check(out.count("# NOTE: virtual single-host devices") == 2, "no virtual note")
    check("# scaling: backend gloo" in out, "the scaling run is not on gloo")

    t0 = time.perf_counter()
    rc, out = run_group(run + ["sfm", "--demo", str(PAR_DEMO_FRAMES)], PAR_DEADLINE_S)
    wall = time.perf_counter() - t0
    reg = re.search(r"incremental SfM: (\d+)/(\d+) frames registered", out)
    ate = re.search(r"ATE \(sim3-aligned\): \S+ \(([\d.]+)% of", out)
    fe_rows = [int(ln.split()[0]) for ln in out.splitlines()
               if re.match(r"\s+\d+\s+data=\d+\s", ln)]
    total = re.search(r"total wall time: ([\d.]+) s", out)
    emit(phase="main_path_parallel", check="torchrun_sfm_demo", rc=rc, world=PAR_WORLD,
         frames=PAR_DEMO_FRAMES, registered=reg.group(0) if reg else None,
         demo_total_wall_s=float(total.group(1)) if total else None,
         ate_percent=float(ate.group(1)) if ate else None, frontend_rows=fe_rows,
         frontend_table=[ln for ln in out.splitlines() if re.match(r"\s+\d+\s+data=", ln)],
         wall_s=wall, gpu=smi)
    check(rc == 0, f"torchrun sfm --demo exit code {rc}:\n{out[-3000:]}")
    check(reg is not None and reg.group(1) == reg.group(2) == str(PAR_DEMO_FRAMES),
          f"torchrun demo registered {reg.group(0) if reg else None}")
    check(ate is not None and float(ate.group(1)) < DEMO_CUT_ATE_GATE * 100,
          f"torchrun demo ATE {ate.group(1) if ate else None}%")
    check(fe_rows == [1, 2, 4], f"torchrun demo front-end rows {fe_rows}")


def main_path_parallel(tmp, smi):
    """``parallel/`` on the one card: (a) the distributed functions in 4
    spawned ranks under gloo, sharing the card, each against its one-rank
    form or its emulation; (b) the same checks in one rank under NCCL, and
    the two worlds' results against each other; (c) the torchrun entry
    points.  Any failing or hung rank fails the run."""
    import torch

    from ransac_tpu_torch.io.synthetic import write_planted_scene

    ps = write_planted_scene(os.path.join(tmp, "parallel_scene"), seed=0)
    directory = os.path.join(tmp, "parallel")
    os.makedirs(directory, exist_ok=True)
    results = {}
    for world, backend in ((PAR_WORLD, "gloo"), (1, "nccl")):
        res = spawn_world(world, backend, directory, ps, smi)
        for line in res["lines"]:
            emit(phase="main_path_parallel", **line)
        emit(phase="main_path_parallel", check="world", backend=backend, world=world,
             wall_s=res["wall_s"], gpu=smi)
        results[backend] = res["arrays"]
    a, b = results["gloo"], results["nccl"]
    diffs = {
        "search_err2": _max_excess(a["search_err2"], b["search_err2"], 2e-4, 2e-3),
        "dense_cost": abs(a["dense_cost"] / b["dense_cost"] - 1) - 1e-3,
        "cg_cost": abs(a["cg_cost"] / b["cg_cost"] - 1) - 1e-3,
        "sim3_drift_24_ate": abs(a["sim3_drift_24"] - b["sim3_drift_24"]) - 1e-3,
        "se3_loop_32": float((a["se3_loop_32"] - b["se3_loop_32"]).abs().max()) - 1e-3}
    same_fe = bool(torch.equal(a["frontend_xy"], b["frontend_xy"])
                   and torch.equal(a["frontend_valid"], b["frontend_valid"]))
    emit(phase="main_path_parallel", check="gloo_4_vs_nccl_1", backend=["gloo", "nccl"],
         world=[PAR_WORLD, 1], excess_over_tolerance=diffs, frontend_bit_for_bit=same_fe,
         gpu=smi)
    check(all(v <= 0 for v in diffs.values()), f"gloo x4 and nccl x1 differ: {diffs}")
    check(same_fe, "the front end differs between gloo x4 and nccl x1")
    torchrun_entry_points(smi)


def sm_clock_mhz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    return float(out.strip())


# ------------------------------------------------------------ times
def kernel_design(ptxas_rows) -> dict:
    """{kernel: its design as its time lines print it}: row 6's hypotheses
    a thread and row 8's lanes a hypothesis, read from the sources (row 1
    takes one sample a thread, row 8 one record a block); and from ptxas's
    report the registers and spill bytes of the sweep and prep kernels of
    rows 1, 3, 4, 6 and 8."""
    def const(path, name):
        with open(os.path.join(REPO, path), encoding="utf-8") as f:
            return int(re.search(rf"constexpr int {name} = (\w+);", f.read())[1])
    k = const(KERNELS["homography_ransac_sweep_large"][0], "kHyp")
    lanes = const("ransac_tpu_torch/csrc/sweep_essential_large.cuh", "kLanes")
    regs = {row["kernel"]: row for row in ptxas_rows}

    def of(kernel):
        row = regs.get(kernel, {})
        return {"registers": row.get("registers"),
                "spill_bytes": row.get("spill_stores", 0) + row.get("spill_loads", 0)}
    return {"sweep_multi": {"hyp_per_thread": 1, **of("sweep_multi_kernel")},
            "essential_ransac_sweep_large": {
                "lanes_a_hypothesis": lanes, "records_a_block": 1,
                "sweep": of("sweep_essential_large_kernel"),
                "solve": of("sweep_essential_large_solve_kernel"),
                "prep": of("sweep_essential_large_prep_kernel")},
            "homography_ransac_sweep_large": {
                "hyp_per_thread": k, "sweep": of("sweep_large_kernel"),
                "prep": of("sweep_large_prep_kernel")},
            "homography_scores": {"models_a_tile": 256,
                                  **of("homography_scores_kernel")},
            "pnp_scores": {"models_a_tile": 256, **of("pnp_scores_kernel")},
            "lm_pose": {"problems_a_warp": 1, **of("lm_pose_kernel")},
            "refit_homography": {"problems_a_warp": 1, **of("refit_homography_kernel")},
            "refit_pose": {"problems_a_warp": 1, **of("refit_pose_kernel")}}


def scorer_launches(kernel, shape, score, pad, calls=20):
    """What one call ``score()`` of scorer ``kernel`` issues on the card,
    over ``calls`` calls: its kernel launches (the wrapper's count) and the
    torch operations that write device memory (``aten::zero_``,
    ``aten::fill_``, ``aten::copy_``; torch.profiler's host-side record, a
    nested fill_ apart from its zero_), and those of ``pad()``, the padding
    its plain version runs (``_pad_points`` of both point tensors), which a
    wrapper that padded on the host would add to every call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ransac_tpu_torch.ops import _build

    def torch_writes(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {ev.key: ev.count / calls for ev in prof.key_averages()
                if ev.key in ("aten::zero_", "aten::fill_", "aten::copy_")}
    before = _build.LAUNCHES[kernel]
    call = torch_writes(score)
    launches = (_build.LAUNCHES[kernel] - before) / calls
    emit(phase="scorer_launches", kernel=kernel, shape=shape, calls=calls,
         kernel_launches_a_call=launches, torch_writes_a_call=call,
         padding_torch_writes_a_call=torch_writes(pad))
    check(launches == 1 and not call,
          f"{kernel} {shape}: {launches} launches and {call} a call")


def time_kernels(smi, in13, in16, thr, ps, scene, clock_mhz, design):
    """Kernel vs plain version, CUDA events, on the same prepared inputs
    (the wrappers' own preparation is left out of both), at the main
    paths' sizes; the outputs of both are held as in the kernel's checks.
    ``design`` ({kernel: fields}) is printed with a kernel's time lines.
    Returns {name: {ms, plain_ms, bound_ms, bound_by}} of each kernel's
    first shape, and {name: max abs error} over all its shapes."""
    import torch

    from ransac_tpu_torch import bench
    from ransac_tpu_torch.io.synthetic import planted_homography_pool, planted_pnp_pool
    from ransac_tpu_torch.ops import score as sc
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_essential_large as sel
    from ransac_tpu_torch.ops import sweep_large as sl
    from ransac_tpu_torch.ops import sweep_multi as sm
    from ransac_tpu_torch.ops import sweep_pnp as sp
    from ransac_tpu_torch.ops import sweep_pnp_large as spl
    from ransac_tpu_torch.ops import sweep_essential as se
    from ransac_tpu_torch.ops.projection import normalize_pixels
    from ransac_tpu_torch.profile import ESSENTIAL_THRESHOLD
    from ransac_tpu_torch.utils.profiling import bound

    rows, errs = {}, {}

    symbols = {"sweep_multi": ["sweep_multi_kernel"],
               "homography_ransac_sweep": ["sweep_kernel", "sweep_prep_kernel"],
               "homography_scores": ["homography_scores_kernel"],
               "pnp_scores": ["pnp_scores_kernel"],
               "pnp_ransac_sweep": ["sweep_pnp_kernel"],
               "homography_ransac_sweep_large": ["sweep_large_kernel",
                                                 "sweep_large_prep_kernel"],
               "essential_ransac_sweep_large": ["sweep_essential_large_kernel",
                                                "sweep_essential_large_prep_kernel",
                                                "sweep_essential_large_solve_kernel"],
               "pnp_ransac_sweep_large": ["sweep_pnp_large_kernel",
                                          "sweep_pnp_large_prep_kernel"],
               "essential_ransac_sweep": ["sweep_essential_kernel",
                                          "sweep_essential_prep_kernel"]}

    def record(name, shape, fk, fp, work, hold, view=lambda out: out):
        """kernel_ms / plain_ms: CUDA events around one call of the kernel's
        wrapper core and of the plain version (host launch gaps included);
        kernel_device_us: the kernel alone, from torch.profiler (and its
        one-block prep kernel apart, where it has one).  ``work`` is
        (hypotheses, points scored, input bytes, output bytes[, the share
        of valid (sample, root) pairs]) of the call, for its bound;
        ``hold(case, out_k, out_p)`` holds the two outputs, each first
        turned by ``view`` (rows 1, 2, 5-9: ``compare_fused`` or its like;
        rows 3 and 4: ``score_hold``)."""
        case = f"{shape}_timed"
        out_k, out_p = view(fk()), view(fp())
        err = hold(case, out_k, out_p)
        ms, reps = cuda_ms(fk, warm=True)
        plain, plain_reps = cuda_ms(fp, warm=True)
        dev = device_us(fk, symbols[name])
        bound_ms, bound_by = bound(name, *work[:4], clock_mhz, *work[4:])
        # The P3P rows: the bound of their valid pairs, and of all four roots.
        shares = ({"valid_share": work[4],
                   "bound_4root_ms": bound(name, *work[:4], clock_mhz)[0]}
                  if len(work) > 4 else {})
        emit(phase="time_kernel", kernel=name, shape=shape, kernel_ms=ms,
             kernel_device_us=dev[symbols[name][0]],
             **({"prep_kernel_device_us": dev[symbols[name][1]]}
                if len(symbols[name]) > 1 else {}),
             **({"solve_kernel_device_us": dev[symbols[name][2]]}
                if len(symbols[name]) > 2 else {}),
             plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by, **shares,
             **design.get(name, {}), kernel_reps=reps, plain_reps=plain_reps, gpu=smi)
        rows.setdefault(name, {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                               "bound_by": bound_by})
        errs[name] = max(errs.get(name, 0.0), err)

    def records_out(n_hyp):
        return n_hyp // 8 * 24

    for shape, (pos2, dst, mask, idx) in (("C458_n13_H1024", in13),
                                          ("C458_n16_H2048", in16)):
        args = sm._normalize(pos2, dst, mask, thr)[:4] + (idx, dst.shape[0])
        C, n = pos2.shape[0], dst.shape[0]
        H = idx.shape[1]  # the [4, H] sample table
        # The kernel scores the distinct samples: sample 0 and every column
        # that is not a copy of it (the table's padding repeats it).
        scored = 1 + int((idx[:, 1:] != idx[:, :1]).any(0).sum())
        work = (C * scored, n, C * n * 8 + dst.numel() * 4 + idx.numel() * 4,
                C * records_out(H))
        record("sweep_multi", shape, lambda: sm._sweep_kernel(*args),
               lambda: sm._sweep_plain(*args), work,
               hold=lambda case, out_k, out_p, core=args: multi_hold(case, core,
                                                                     (out_k, out_p)))

    src, dst, mask = bench.problem(DEVICE)
    seeds = sw.draw_seeds(5, 4)

    def hold_row2(args):
        full = args[:-1] + (True,)

        def hold(case, out_k, out_p):
            return compare_fused("homography_ransac_sweep", case, sw._sweep_kernel(*full),
                                 sw._sweep_plain(*full), out_k, out_p,
                                 lambda h: sw.cut_margins(*args[:-1], h))
        return hold

    for n_hyp in (SWEEP_HYP, PROFILE_HYP):
        args = (src, dst, mask, 75.0, seeds, 13, n_hyp, False)
        record("homography_ransac_sweep", f"n13_H2^{n_hyp.bit_length() - 1}",
               lambda: sw._sweep_kernel(*args), lambda: sw._sweep_plain(*args),
               (n_hyp, 13, 13 * 20, records_out(n_hyp)), hold=hold_row2(args))

    for n_models in (STAGEWISE_HYP, PROFILE_HYP):
        models, s, d, m = score_models(n_models, DEVICE, seed=1)
        shape = f"n13_H2^{n_models.bit_length() - 1}"
        if n_models == STAGEWISE_HYP:
            scorer_launches("homography_scores", shape,
                            lambda: sc.homography_scores(models, s, d, m, 75.0),
                            lambda: (sc._pad_points(s, m, 2), sc._pad_points(d, m, 2)))
        args = (models.reshape(-1, 9).contiguous(), s, d, m, sc._thr_sq(75.0))
        record("homography_scores", shape,
               lambda: sc._h_kernel(*args), lambda: sc._h_plain(*args),
               (n_models, 13, n_models * 36 + 13 * 20, n_models * 8),
               hold=lambda case, out_k, out_p, a=(models, s, d, m): score_hold(
                   "homography_scores", case, out_k, out_p,
                   lambda h: sc.cut_margins(*a, 75.0, h)))

    X, _, _, pmask, pix_n, thr_n, ay = pnp_inputs(ps, scene)
    # cli profile's 2^20 poses, and the 12 that ransac_pnp_sweep re-scores
    for n_poses, shape in ((PROFILE_HYP, f"n13_H2^{PROFILE_HYP.bit_length() - 1}"),
                           (12, "n13_H12")):
        poses = pose_models(n_poses, X, pix_n)
        scorer_launches("pnp_scores", shape,
                        lambda: sc.pnp_scores(poses, X, pix_n, pmask, thr_n),
                        lambda: (sc._pad_points(X, pmask, 3),
                                 sc._pad_points(pix_n, pmask, 2)))
        args = (poses, X, pix_n, pmask, sc._thr_sq(thr_n))
        record("pnp_scores", shape, lambda: sc._pnp_kernel(*args),
               lambda: sc._pnp_plain(*args),
               (n_poses, 13, n_poses * 48 + 13 * 24, n_poses * 8),
               hold=lambda case, out_k, out_p, a=args[:4]: score_hold(
                   "pnp_scores", case, out_k, out_p,
                   lambda h: sc.pose_cut_margins(*a, thr_n, h)))

    def large_view(out):
        return out[0][0::2], out[0][1::2], out[1]

    def hold_p3p(kernel, core):
        def hold(case, out_k, out_p):
            return pnp_hold(kernel, core, case, red=(out_k, out_p))[0]
        return hold

    prep = sp.prepare(X, pix_n, pmask, thr_n, ay)
    n = X.shape[0]
    for n_hyp, shape in ((8192, "n13_H8192_block4096"),
                         (PROFILE_HYP, f"n13_H2^{PROFILE_HYP.bit_length() - 1}_block4096")):
        core = (*prep, sw.draw_seeds(3, 3), n, n, n_hyp, sp.BLOCK_H)
        share = sp.valid_root_share(3, X, pix_n, pmask, thr_n, n_hyp,
                                    block_h=sp.BLOCK_H, ay=ay)
        record("pnp_ransac_sweep", shape, lambda: sp._sweep_kernel(*core, False),
               lambda: sp._sweep_plain(*core, False),
               (n_hyp, n, n * 36, records_out(n_hyp), share),
               hold_p3p("pnp_ransac_sweep", core), large_view)

    for n in (1024, 256):
        src_np, dst_np, _ = planted_homography_pool(n, seed=7)
        src, dst = (torch.as_tensor(a, device=DEVICE) for a in (src_np, dst_np))
        args = (src, dst, torch.ones(n, device=DEVICE), 3.0, sw.draw_seeds(0, 6),
                LARGE_SWEEP_HYP)
        record("homography_ransac_sweep_large", f"n{n}_H2^20",
               lambda: sl._sweep_kernel(*args), lambda: sl._sweep_plain(*args),
               (LARGE_SWEEP_HYP, n, n * 20, records_out(LARGE_SWEEP_HYP)),
               lambda case, out_k, out_p, core=args: large_hold(core, case,
                                                                (out_k, out_p)),
               large_view)

    x1, x2, emask, thr_sq = twoview_pool(DEVICE)
    n_valid = int(emask.sum())
    args = (x1, x2, emask, thr_sq, sw.draw_seeds(0, 10), 8192, sel.BLOCK_H)
    record("essential_ransac_sweep_large", f"twoview1024_H8192_nvalid{n_valid}",
           lambda: sel._sweep_kernel(*args), lambda: sel._sweep_plain(*args),
           (8192, n_valid, x1.shape[0] * 20, records_out(8192)),
           lambda case, out_k, out_p, core=args: essential_large_hold(
               core, case, (out_k[:2], out_p[:2])))

    # The PnP budget of 8192 runs as 4 blocks of 4096 (>= 4 windows for
    # pools over 64 points), as on the main path; `cli profile` gives the
    # 256-point pool 2^20 hypotheses (fused_p3p_sweep_large_n256).
    for n, n_hyp in ((512, spl.n_hyp_for(8192, 512, spl.BLOCK_H)),
                     (256, spl.n_hyp_for(8192, 256, spl.BLOCK_H)), (256, PROFILE_HYP)):
        X_np, pix_np, K_np, _, _, _ = planted_pnp_pool(n, seed=11)
        Xt = torch.as_tensor(X_np, device=DEVICE)
        pixn = normalize_pixels(torch.as_tensor(pix_np, device=DEVICE),
                                torch.as_tensor(K_np, device=DEVICE))
        ones = torch.ones(n, device=DEVICE)
        core = (Xt, pixn, ones, sc._thr_sq(30.0 / 900.0), 1.0, sw.draw_seeds(0, 5), n_hyp,
                spl.BLOCK_H)
        share = spl.valid_root_share(0, Xt, pixn, ones, n_hyp)
        record("pnp_ransac_sweep_large", f"n{n}_H2^{n_hyp.bit_length() - 1}",
               lambda: spl._sweep_kernel(*core), lambda: spl._sweep_plain(*core),
               (n_hyp, n, n * 24, records_out(n_hyp), share),
               hold_p3p("pnp_ransac_sweep_large", core), large_view)

    x1, x2, emask, _ = essential_cases(DEVICE)["n16"]
    args = (x1, x2, emask, ESSENTIAL_THRESHOLD, sw.draw_seeds(0, 8), 16, PROFILE_HYP,
            se.BLOCK_H, False)

    def hold_row7(case, out_k, out_p):
        full = args[:-1] + (True,)
        f_k, i_k = se._sweep_kernel(*full)
        f_p, i_p = se._sweep_plain(*full)
        return compare_fused("essential_ransac_sweep", case, (f_k[0], f_k[1], i_k),
                             (f_p[0], f_p[1], i_p), out_k, out_p)

    record("essential_ransac_sweep", f"n16_H2^{PROFILE_HYP.bit_length() - 1}",
           lambda: se._sweep_kernel(*args), lambda: se._sweep_plain(*args),
           (PROFILE_HYP, 16, 16 * 20, records_out(PROFILE_HYP)), hold_row7, large_view)
    torch.cuda.synchronize()
    return rows, errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1

    from ransac_tpu_torch.bench import gpu_name_and_limit
    from ransac_tpu_torch.ops import _build, lm
    from ransac_tpu_torch.pipelines.localize import localize
    from ransac_tpu_torch.utils.config import LocalizeConfig

    check(set(KERNELS) == set(_build.KERNELS),
          f"KERNELS differs from ops._build.KERNELS: {set(KERNELS) ^ set(_build.KERNELS)}")

    # 1. Device.
    smi = gpu_name_and_limit()
    check(smi is not None, "nvidia-smi did not report the card")
    clock_mhz = sm_clock_mhz()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", gpu=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, max_sm_clock_mhz=clock_mhz,
         fp32_ops_per_s=132 * 128 * clock_mhz * 1e6,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. Build (one nvcc per source, in parallel), with ptxas's report.
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    ptxas = ptxas_summary(_build.ptxas_report())
    emit(phase="build", seconds=time.perf_counter() - t0, library=lib.name,
         gpu=smi, ptxas=ptxas)

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
        max_err.update(check_large())
        max_err["essential_ransac_sweep"] = check_sweep_essential()
        max_err.update(check_roofline())

        # 4. The main paths, each with the counts set to 0 just before it.
        ps_main, scene_main, counts, errs, engine_refits = main_path_localize(tmp, cfg)
        max_err.update(errs)
        for name in ("sweep_multi", "refit_homography", "refit_pose"):
            launches[name] += counts[name]
        counts, errs = main_path_homography_sweep()
        launches["homography_ransac_sweep"] += counts["homography_ransac_sweep"]
        launches["refit_homography"] += counts["refit_homography"]
        max_err["refit_homography"] = max(max_err["refit_homography"], errs["refit_homography"])
        counts = main_path_pnp_sweep(ps_main, scene_main, scene_main.to("cpu"))
        launches["pnp_ransac_sweep"] += counts["pnp_ransac_sweep"]
        launches["pnp_scores"] += counts["pnp_scores"]
        counts = main_path_bench("sweep")
        launches["homography_ransac_sweep"] += counts["homography_ransac_sweep"]
        launches["roofline_fma"] += counts["roofline_fma"]  # control_vpu_tflops
        bench_idle_share(smi)
        counts = main_path_bench("stagewise")
        launches["homography_scores"] += counts["homography_scores"]
        for n in (1024, 256):
            counts = main_path_homography_sweep_large(n)
            launches["homography_ransac_sweep_large"] += counts["homography_ransac_sweep_large"]
        for n in (512, 256):
            counts = main_path_pnp_sweep_large(n)
            launches["pnp_ransac_sweep_large"] += counts["pnp_ransac_sweep_large"]
        counts = main_path_twoview()
        launches["essential_ransac_sweep_large"] += counts["essential_ransac_sweep_large"]
        counts = main_path_profile(tmp)
        for name in ("essential_ransac_sweep", "roofline_fma", "roofline_mixed",
                     "roofline_mxu"):
            launches[name] += counts[name]
        for phase in (main_path_report, main_path_dem):
            launches["sweep_multi"] += phase(tmp)["sweep_multi"]
        main_path_march(smi)
        launches["sweep_multi"] += main_path_calibrate(tmp, smi)["sweep_multi"]
        counts = main_path_intrinsics(smi)
        for name in ("lm_pose", "refit_pose"):
            launches[name] += counts[name]
        main_path_ba(smi)
        main_path_posegraph(smi)
        counts, errs = main_path_sfm(tmp, smi)
        for name in ("pnp_ransac_sweep", "pnp_ransac_sweep_large", "pnp_scores",
                     "essential_ransac_sweep_large"):
            launches[name] += counts[name]
        for name, err in errs.items():
            max_err[name] = max(max_err[name], err)
        counts, errs = main_path_sfm_demo(tmp, smi)
        for name in ("pnp_ransac_sweep", "pnp_ransac_sweep_large", "pnp_scores",
                     "essential_ransac_sweep_large"):
            launches[name] += counts[name]
        emit(phase="demo_launches", **{k: v for k, v in counts.items() if v})
        for name, err in errs.items():
            max_err[name] = max(max_err[name], err)
        native_ingest(tmp)
        main_path_parallel(tmp, smi)
        for name, n in launches.items():
            check(n >= 1, f"{name}: no launch on its main path")

        # 5. Times.
        design = kernel_design(ptxas)
        times, errs = time_kernels(smi, in13, in16, thr, ps_main, scene_main, clock_mhz,
                                   design)
        probe_times, errs_probes = time_probes(smi, clock_mhz)
        lm_times, errs_lm = lm_passes(scene_main, ps_main, smi, clock_mhz, design)
        times.update(probe_times)
        times.update(lm_times)
        times.update(refit_times(engine_refits, smi, clock_mhz, design))
        for name, err in {**errs, **errs_probes}.items():
            max_err[name] = max(max_err[name], err)
        max_err.update(errs_lm)
        time_twoview_frames(smi)
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
            lm.reset_counts()
            _, wall, kernels, busy, waits, _ = profiled(lambda: localize(
                scene_main, ps_main.image_size, cfg, use_sweep=use_sweep, device=DEVICE))
            emit(phase="time_localize", route=route, median_ms=statistics.median(walls),
                 all_ms=walls, profiled_wall_ms=wall * 1e3, kernels=kernels,
                 lm_passes=lm.COUNTS["passes"], lm_reads=lm.COUNTS["reads"],
                 host_waits=waits, device_idle_share=1.0 - busy / wall, gpu=smi)

    emit(phase="library_ms",
         note="null where no single PyTorch call computes the kernel's function: a "
              "fused RANSAC sweep, a model-by-point score with its truncation and "
              "count, or a chain of dependent FP32 FMAs or selects; roofline_mxu's "
              "is the same chain as 4096 dependent TF32 addmm calls; the FP32 chains' "
              f"ms, plain_ms and bound_ms are at {PROBE_HOLD_TRIPS} trips x 33 tiles")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_err[name],
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": times[name].get("library_ms")}
        for name, (source, replaces) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
