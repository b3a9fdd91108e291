"""Speed-of-light report of the port's hot kernels and workloads.

    python -m ransac_tpu_torch.cli profile [--hypotheses N] [--out rows.json]
                                           [--measure-peaks] [--device cuda|cpu]
                                           [--scaling | --scaling-only]
    torchrun --nproc-per-node N -m ransac_tpu_torch.cli profile --scaling-only

The port of ``ransac_tpu.cli profile``: the same rows under the same names,
shapes and thresholds, each timed by ``utils.profiling.SolProfiler`` and
reported against the card's peaks.  Inputs come from
``numpy.random.default_rng(0)`` and the port's generators (the bits need
not be the JAX package's).

- On the card: ``fused_ransac_sweep`` (kernel row 2), ``fused_p3p_sweep``
  (row 5), ``fused_p3p_sweep_large_n256`` (row 9), ``fused_essential_sweep``
  (row 7, 16 points), each at ``--hypotheses`` (default 2^20); the P3P
  rows' issued operations count the valid (sample, root) pairs of their
  inputs (``valid_root_share``, printed as ``# valid root share``);
  ``pallas_inlier_score`` (row 3), ``dlt_minimal_solve``,
  ``mutual_nn_match`` (16 pairs of 1024 x 64 descriptors, one batched
  call),
  ``harris_response_1024`` at min(hypotheses, 2^20) models; and
  ``twoview_frame_1024`` (``twoview_frame``: two random 1024 x 1024 images
  through detection, matching, the large-pool essential sweep, pose
  recovery and the LM polish), with its frames per second.
- ``--device cpu`` runs the rows the JAX package runs off the TPU:
  ``pallas_inlier_score``, ``dlt_minimal_solve``, ``mutual_nn_match`` and
  ``harris_response_1024`` (the plain versions of the kernels, host clock;
  not device numbers).
- ``--measure-peaks`` (card only) first measures the card's rooflines with
  the probes of ``ops.roofline`` (kernel rows 10 and 11, and the memory
  read) and reports against them instead of the data sheet's.
- ``--out`` writes the rows as JSON (``KernelReport.row``).

- ``--scaling`` then runs the scaling harness (``utils.scaling``: the
  distributed candidate search and the sharded front end at 1, 2, 4, ...
  ranks up to the world), ``--scaling-only`` runs only that.  Under
  torchrun every rank runs the harness (the primary alone the kernel
  table) and only the primary prints; without torchrun it reports one
  point.

The last line printed is ``# launches: {...}``, every kernel's launch count
in this process (not after ``--scaling-only``).  The default device is
``cuda``; without CUDA that is an error (exit code 2), as is
``--measure-peaks`` on the CPU.
"""

from __future__ import annotations

import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from ransac_tpu_torch.utils import profiling

TWOVIEW_SIZE = 1024
TWOVIEW_CORNERS = 512
TWOVIEW_HYPOTHESES = 4096
TWOVIEW_FOCAL = 600.0
TWOVIEW_THRESHOLD_PX = 2.0
#: The essential rows' squared Sampson bound in normalized units: 2 px at f = 600.
ESSENTIAL_THRESHOLD = (TWOVIEW_THRESHOLD_PX / TWOVIEW_FOCAL) ** 2


class Frame(NamedTuple):
    matches: int
    inliers: int
    R: torch.Tensor
    t: torch.Tensor
    x1: torch.Tensor     # [512, 2] normalized correspondences
    x2: torch.Tensor
    mask: torch.Tensor   # [512] valid matches


def twoview_frame(gen: torch.Generator, seed: int, device) -> Frame:
    """One frame of the ``twoview_frame_1024`` workload
    (ransac_tpu/cli.py:604-632): two fresh uniform 1024 x 1024 images from
    ``gen``, Harris detection (512 corners) -> patch descriptors -> mutual
    nearest neighbours -> the fused essential sweep (4096 hypotheses, 2 px
    at f = 600) -> pose recovery + LM polish."""
    from ransac_tpu_torch.features.detect import detect_harris
    from ransac_tpu_torch.features.match import mutual_nn_match, patch_descriptors
    from ransac_tpu_torch.models import ransac as rm
    from ransac_tpu_torch.ops import epipolar
    from ransac_tpu_torch.ops.projection import normalize_pixels
    from ransac_tpu_torch.utils.config import RansacConfig

    c = TWOVIEW_SIZE / 2
    Kc = torch.tensor([[TWOVIEW_FOCAL, 0, c], [0, TWOVIEW_FOCAL, c], [0, 0, 1.0]],
                      device=device)
    e_cfg = RansacConfig(threshold=ESSENTIAL_THRESHOLD,
                         num_hypotheses=TWOVIEW_HYPOTHESES, exhaustive=False)
    size = (TWOVIEW_SIZE, TWOVIEW_SIZE)
    img1 = torch.rand(size, generator=gen, device=device)
    img2 = torch.rand(size, generator=gen, device=device)
    kp1 = detect_harris(img1, TWOVIEW_CORNERS)
    kp2 = detect_harris(img2, TWOVIEW_CORNERS)
    m = mutual_nn_match(patch_descriptors(img1, kp1.xy, kp1.valid),
                        patch_descriptors(img2, kp2.xy, kp2.valid),
                        kp1.valid, kp2.valid)
    x1 = normalize_pixels(kp1.xy[m.idx1], Kc)
    x2 = normalize_pixels(kp2.xy[m.idx2], Kc)
    mask = m.valid.to(torch.float32)
    res = rm.ransac_essential_sweep(x1, x2, mask, e_cfg, seed)
    w = res.inlier_mask.to(torch.float32)
    R0, t0, _, _ = epipolar.recover_pose(res.model, x1, x2, w)
    R, t, _ = epipolar.refine_relative_pose(R0, t0, x1, x2, w)
    return Frame(int(m.valid.sum()), int(res.num_inliers), R, t, x1, x2, mask)


def run(hypotheses: int = 1 << 20, device="cuda", measure_peaks: bool = False):
    """Time every row (see the module doc) and return the profiler."""
    from ransac_tpu_torch.features.detect import harris_response
    from ransac_tpu_torch.features.match import mutual_nn_match
    from ransac_tpu_torch.ops.homography import dlt_homography_minimal
    from ransac_tpu_torch.ops.score import homography_scores

    device = torch.device(device)
    on_card = device.type == "cuda"
    if measure_peaks:
        peaks = profiling.refresh_peaks_measured()
        print("# measured rooflines:", json.dumps(peaks), flush=True)
    prof = profiling.SolProfiler(device=device)
    iters, reps = (30, 3) if on_card else (2, 1)

    def entry(name, step, **kw):
        prof.measure(name, step, iters=kw.pop("iters", iters),
                     reps=kw.pop("reps", reps), vary=lambda i: (i,), **kw)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    rng = np.random.default_rng(0)
    n, H = 13, int(hypotheses)
    src = t(rng.uniform(-1.5, 1.5, (n, 2)))
    dst = t(rng.uniform(0, 1000, (n, 2)))
    mask = torch.ones(n, device=device)

    if on_card:
        from ransac_tpu_torch.ops.sweep import homography_ransac_sweep
        from ransac_tpu_torch.ops.sweep_essential import essential_ransac_sweep
        from ransac_tpu_torch.ops.sweep_pnp import pnp_ransac_sweep, valid_root_share
        from ransac_tpu_torch.ops.sweep_pnp_large import pnp_ransac_sweep_large
        from ransac_tpu_torch.ops.sweep_pnp_large import (
            valid_root_share as valid_root_share_large)

        # Fused rows claim no algorithmic FLOPs: their operations are counted
        # as issued operations (profiling.OPS) against the FP32 rate.
        entry("fused_ransac_sweep",
              lambda s: homography_ransac_sweep(s, src, dst, mask, 75.0, H)[1][0, 0],
              bytes_moved=H // 85,
              issued_ops=profiling.issued_ops("homography_ransac_sweep", H, n))
        Xw = t(rng.uniform(-2, 2, (n, 3)))
        pixn = t(rng.uniform(-0.5, 0.5, (n, 2)))
        # The P3P rows' bounds count the valid (sample, root) pairs of their
        # inputs, read once by the plain versions (seed 0).
        share = valid_root_share(0, Xw, pixn, mask, 30.0 / 900.0, H)
        print(f"# valid root share fused_p3p_sweep: {share}", flush=True)
        entry("fused_p3p_sweep",
              lambda s: pnp_ransac_sweep(s, Xw, pixn, mask, 30.0 / 900.0, H)[1][0, 0],
              bytes_moved=H // 42,
              issued_ops=profiling.issued_ops("pnp_ransac_sweep", H, n, share))
        nL = 256
        XwL = t(rng.uniform(-2, 2, (nL, 3)))
        pixnL = t(rng.uniform(-0.5, 0.5, (nL, 2)))
        maskL = torch.ones(nL, device=device)
        share = valid_root_share_large(0, XwL, pixnL, maskL, H)
        print(f"# valid root share fused_p3p_sweep_large_n256: {share}", flush=True)
        entry("fused_p3p_sweep_large_n256",
              lambda s: pnp_ransac_sweep_large(s, XwL, pixnL, maskL, 30.0 / 900.0,
                                               H)[1][0, 0],
              bytes_moved=H // 42,
              issued_ops=profiling.issued_ops("pnp_ransac_sweep_large", H, nL, share))
        x1 = t(rng.uniform(-0.5, 0.5, (n + 3, 2)))
        x2 = t(rng.uniform(-0.5, 0.5, (n + 3, 2)))
        maske = torch.ones(n + 3, device=device)
        entry("fused_essential_sweep",
              lambda s: essential_ransac_sweep(s, x1, x2, maske, ESSENTIAL_THRESHOLD,
                                               H)[1][0, 0],
              bytes_moved=H // 85,
              issued_ops=profiling.issued_ops("essential_ransac_sweep", H, n + 3))

    # Stage-wise rows hold [H, ...] intermediates in device memory: cap H.
    Hs = min(H, 1 << 20)
    models0 = t(np.eye(3)[None] + rng.normal(scale=0.1, size=(Hs, 3, 3)))

    def score(s):
        counts, msac = homography_scores(models0 + s * 1e-12, src, dst, mask, 75.0)
        return counts[0] + msac[0] * 1e-6

    entry("pallas_inlier_score", score, flops=Hs * 14 * 16, bytes_moved=Hs * (9 + 2) * 4)

    def gen(s):
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        return g

    def solve(s):
        i = torch.randint(0, n, (Hs, 4), generator=gen(s), device=device)
        Hm, ok = dlt_homography_minimal(src[i], dst[i])
        return ok.sum().to(torch.float32) + Hm[0, 0, 0] * 1e-6

    entry("dlt_minimal_solve", solve, flops=Hs * 700, bytes_moved=Hs * (32 + 36 + 4))

    B, Kp, D = 16, 1024, 64
    valid = torch.ones((B, Kp), dtype=torch.bool, device=device)

    def match(s):
        g = gen(s)
        d1 = torch.randn((B, Kp, D), generator=g, device=device)
        d2 = torch.randn((B, Kp, D), generator=g, device=device)
        return mutual_nn_match(d1, d2, valid, valid).idx2.sum().to(torch.float32)

    entry("mutual_nn_match", match, flops=B * 2 * Kp * Kp * D,
          bytes_moved=B * 2 * Kp * D * 4, unit="mxu")

    def harris(s):
        img = torch.rand((1024, 1024), generator=gen(s), device=device)
        return harris_response(img).sum()

    entry("harris_response_1024", harris, flops=1024 * 1024 * 400,
          bytes_moved=1024 * 1024 * 4 * 6, unit="mxu")

    if on_card:
        frames = gen(0)
        entry("twoview_frame_1024", lambda s: twoview_frame(frames, s, device),
              flops=2 * 1024 * 1024 * 400 + TWOVIEW_HYPOTHESES * 5200,
              bytes_moved=2 * 1024 * 1024 * 4 * 6, iters=5, reps=1)
        print(f"# twoview frames/s (1 card): {1.0 / prof.reports[-1].seconds:.2f}",
              flush=True)
    return prof


def add_arguments(ap) -> None:
    ap.add_argument("--hypotheses", type=int, default=1 << 20)
    ap.add_argument("--out", default="", help="write the rows as JSON")
    ap.add_argument("--measure-peaks", dest="measure_peaks", action="store_true",
                    help="measure the card's FP32, tensor-core and memory "
                         "rooflines first and report against them (card only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the rows the "
                         "JAX package runs off the TPU, on the plain versions)")
    ap.add_argument("--scaling", action="store_true",
                    help="also run the multi-rank scaling harness (all ranks "
                         "under torchrun)")
    ap.add_argument("--scaling-only", dest="scaling_only", action="store_true",
                    help="skip the kernel table (scaling harness only)")


def run_scaling(device) -> None:
    """The scaling harness on every rank of the world; the primary prints."""
    from ransac_tpu_torch.parallel.multihost import backend_name, is_primary
    from ransac_tpu_torch.utils.scaling import (measure_frontend_scaling, measure_scaling,
                                                report)

    pts = measure_scaling(device=device)
    fe = measure_frontend_scaling(device=device)
    if is_primary():
        print(f"# scaling: backend {backend_name() or 'none (one process)'}", flush=True)
        print(report(pts))
        print("# keyframe front end (weak scaling over mesh data axis)")
        print(report(fe, unit="frames/s"), flush=True)


def run_args(args) -> int:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available",
              file=sys.stderr)
        return 2
    if args.measure_peaks and device.type != "cuda":
        print("error: --measure-peaks measures the card; it needs --device cuda",
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    from ransac_tpu_torch.parallel.multihost import (initialize_cluster, is_primary,
                                                     shutdown_cluster)

    scaling = args.scaling or args.scaling_only
    # A group started here is ended here; one the caller runs is kept.
    owns = scaling and not dist.is_initialized() and initialize_cluster(
        device=device)
    try:
        if not args.scaling_only and is_primary():
            prof = run(args.hypotheses, device, args.measure_peaks)
            print(prof.table())
            if args.out:
                with open(args.out, "w", encoding="utf-8") as f:
                    json.dump([r.row() for r in prof.reports], f, indent=1)
                print(f"wrote {args.out}")
        if scaling:
            run_scaling(device)
        if not args.scaling_only and is_primary():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print("# launches:", json.dumps(profiling.launch_counts()), flush=True)
    finally:
        if owns:
            shutdown_cluster()
    return 0
