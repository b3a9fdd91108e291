"""SLAM-scale bundle-adjustment benchmark (port of ``ransac_tpu.ba.bench``).

Builds a synthetic 512-camera / 200k-point / ~2M-observation problem on
the device in the slot layout (``ba.schur_cg``), from an explicit
generator, and times LM passes of the matrix-free CG Schur path, a shape
where the dense path's [C*P, 6, 3] cross terms would need ~7 TB.

Timing: fixed-trip LM runs (rtol 0, cg_iters 16, the CG's tolerance
exit) between CUDA events, each over 3 passes (the initial cost's one
residual pass included); ms per LM pass is the median of 5 runs after one
warm-up.  On the CPU (``--device cpu``) the host clock times them instead.

Run: ``python -m ransac_tpu_torch.ba.bench [n_cam n_pt slots] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ransac_tpu_torch.ba import bundle, schur_cg
from ransac_tpu_torch.ba.schur_cg import BASlotProblem, bundle_adjust_cg
from ransac_tpu_torch.utils.config import BundleAdjustConfig
from ransac_tpu_torch.utils.prng import generator_for


def synth_slot_problem(n_cam: int = 512, n_pt: int = 200_000, slots: int = 10,
                       seed: int = 0, noise_pt: float = 0.02, noise_cam: float = 0.003,
                       device="cuda") -> BASlotProblem:
    """Synthetic SfM scene in the slot layout, made on ``device``.

    Cameras sit along a line looking at a point cloud; each point is seen
    by ``slots`` consecutive cameras from a random first one (short,
    camera-local tracks, as in real SfM), and a slot counts where the
    point's depth exceeds 0.1.  Observations are the exact projections;
    the initial points and cameras 1.. are perturbed, so LM has real work
    to do."""
    g = generator_for(seed, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    K = torch.tensor([[700.0, 0, 320.0], [0, 700.0, 240.0], [0, 0, 1.0]], **f32)
    pts = ((torch.rand((n_pt, 3), generator=g, **f32) * 2.0 - 1.0)
           * torch.tensor([6.0, 6.0, 2.0], **f32) + torch.tensor([0.0, 0.0, 10.0], **f32))
    rvecs = torch.randn((n_cam, 3), generator=g, **f32) * 0.03
    tx = torch.linspace(-2.0, 2.0, n_cam, **f32)
    cams = torch.cat([rvecs, torch.stack([tx, torch.zeros_like(tx), torch.zeros_like(tx)],
                                         -1)], -1)                 # [C,6]
    base = torch.randint(0, n_cam, (n_pt,), generator=g, device=device)
    slot_cam = (base[None, :] + torch.arange(slots, device=device)[:, None]) % n_cam
    u, v, z = schur_cg._project_lanes(cams.T[:, slot_cam], pts.T[:, None, :], K)
    pts0 = pts + torch.randn(pts.shape, generator=g, **f32) * noise_pt
    cams0 = cams.clone()
    cams0[1:] += torch.randn((n_cam - 1, 6), generator=g, **f32) * noise_cam
    return BASlotProblem(cameras=cams0, points=pts0, K=K, slot_cam=slot_cam,
                         slot_uv=torch.stack([u, v]), slot_w=(z > 0.1).to(torch.float32))


def time_passes(run, passes: int = 3, reps: int = 5, device="cuda") -> dict:
    """Readings of a BA solver, ``run(n)`` running n fixed LM passes (rtol
    0): ms per LM pass (the median of ``reps`` runs of ``passes`` passes
    after one warm-up, CUDA events on the card, the host clock elsewhere),
    the LM's host reads, the peak device memory, and the last run's
    costs."""
    cuda = torch.device(device).type == "cuda"
    run(passes)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    bundle.reset_counts()
    ms = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = run(passes)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / passes)
        else:
            t0 = time.perf_counter()
            res = run(passes)
            ms.append((time.perf_counter() - t0) * 1e3 / passes)
    return {
        "ms_per_lm_pass": statistics.median(ms), "all_ms_per_lm_pass": ms,
        "lm_reads": bundle.COUNTS["reads"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "cost_initial": float(res.initial_cost), "cost_final": float(res.cost),
    }


def bench_ba_scale(n_cam: int = 512, n_pt: int = 200_000, slots: int = 10,
                   cg_iters: int = 16, device="cuda") -> dict:
    """The JAX bench's dict (seconds per LM pass, the problem's shape, the
    costs) with the port's readings beside it."""
    sp = synth_slot_problem(n_cam, n_pt, slots, device=device)
    out = time_passes(lambda n: bundle_adjust_cg(
        sp, BundleAdjustConfig(max_iters=n, rtol=0.0), cg_iters=cg_iters, device=device),
        device=device)
    sec = out["ms_per_lm_pass"] * 1e-3
    return {
        "n_cam": n_cam, "n_pt": n_pt, "n_obs": int(sp.slot_w.sum()), "cg_iters": cg_iters,
        "sec_per_lm_iter": sec, "lm_iters_per_s": 1.0 / sec, **out,
        "device": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda"
        else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ransac_tpu_torch.ba.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", type=int, help="n_cam n_pt slots "
                    "(default 512 200000 10)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu times by the host clock)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available", file=sys.stderr)
        return 2
    shape = list(args.shape) + [512, 200_000, 10][len(args.shape):]
    print(json.dumps(bench_ba_scale(*shape[:3], device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
