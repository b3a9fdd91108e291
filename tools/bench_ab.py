"""Run the port's headline bench (sweep mode), or ``ransac_pnp_sweep``, from
several checkouts in turns on one card, with the host-side waits of each.

    python tools/bench_ab.py [--pnp-sweep] [--pairs N] ROOT [ROOT ...]
    # from the repository root

Each ROOT is the root of a checkout of the repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``).  The checkouts run in the order A B ... then ... B A, N / 2
times (N = 2 by default: A B B A A B B A for two), each run in a process
of its own that imports that checkout's ``ransac_tpu_torch`` and builds
its kernels there.  Prints one JSON line a run with the card's name and
power limit, and with ``--pairs`` >= 2 a last line: each checkout's median
and quartiles of its runs' medians, and how many of the pairs (the runs
of a turn, in order) each later checkout won against the first.  Needs a
card.

Bench mode: a run is ``bench.run("sweep")`` (the JSON record ``python -m
ransac_tpu_torch.bench`` prints: median and batches in hypotheses/s), then
one batch of the bench's sweep calls under torch.profiler: the device idle
share (1 - the device's busy time over the batch's wall time, the batch
ending in one synchronize) and the host-side waits in the trace
(``aten::item``, ``cudaStreamSynchronize``, ...).

``--pnp-sweep``: a run calls ``ransac_pnp_sweep`` at the reference's PnP
budget on the planted scene's PnP inputs (``io.synthetic.write_planted_scene``,
seed 0; K on the card), 40 calls timed by the host clock, each ending in a
synchronize (median and all), then one call under torch.profiler: its
waits in all, and those before its refit span where the checkout marks
one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "aten::item", "aten::_local_scalar_dense")
PNP_CALLS = 40


def one(root: str) -> None:
    """One run of the checkout at ``root`` (in this process)."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ransac_tpu_torch import bench

    rec = bench.run("sweep", "cuda")
    n_hyp, iters = bench.DEFAULTS["sweep"]
    step = bench.sweep_step(*bench.problem("cuda"), n_hyp)
    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            step(1000 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(getattr(ev, "self_device_time_total", 0.0) for ev in events
               if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA) * 1e-6
    print(json.dumps({
        "root": root, "value": rec["value"], "batches": rec["batches"],
        "winner_count": rec["winner_count"], "calls": iters,
        "profiled_ms_per_call": wall / iters * 1e3,
        "device_busy_ms_per_call": busy / iters * 1e3,
        "device_idle_share": 1.0 - busy / wall,
        "host_waits": {ev.key: ev.count for ev in events if ev.key in HOST_WAITS},
        "gpu": rec["gpu"]}), flush=True)


def one_pnp_sweep(root: str) -> None:
    """One ``--pnp-sweep`` run of the checkout at ``root`` (in this process)."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ransac_tpu_torch.bench import gpu_name_and_limit
    from ransac_tpu_torch.io.synthetic import write_planted_scene
    from ransac_tpu_torch.io.tables import (build_scene, read_camera_locations,
                                            read_points_data)
    from ransac_tpu_torch.models.ransac import ransac_pnp_sweep
    from ransac_tpu_torch.ops.projection import intrinsics_from_physical
    from ransac_tpu_torch.utils.config import LocalizeConfig

    ps = write_planted_scene(tempfile.mkdtemp(), seed=0)
    scene = build_scene(read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y),
                        read_camera_locations(ps.cameras_csv), device="cuda")
    cfg = LocalizeConfig()
    ic = cfg.intrinsics
    K = intrinsics_from_physical(ic.focal_length_mm, ic.sensor_width_mm,
                                 ic.sensor_height_mm, *ps.image_size, ic.cx, ic.cy).cuda()

    def call():
        return ransac_pnp_sweep(scene.pos3d, scene.pixels, K, scene.point_mask,
                                cfg.pnp_ransac, 0)

    call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(PNP_CALLS):
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CPU]
    refit = [ev.time_range.start for ev in events if ev.name == "ransac.refit"]
    waits = {name: sum(ev.name == name for ev in events) for name in HOST_WAITS}
    before = ({name: sum(ev.name == name and ev.time_range.start < refit[0]
                         for ev in events) for name in HOST_WAITS} if refit else None)
    print(json.dumps({
        "root": root, "value": statistics.median(walls), "unit": "ms a call",
        "all_ms": walls, "num_inliers": int(res.num_inliers),
        "cpu_ops_in_call": sum(ev.name.startswith("aten::") for ev in events),
        "waits_in_call": waits, "waits_before_refit": before,
        "gpu": gpu_name_and_limit()}), flush=True)


def summary(roots: list[str], runs: list[dict], pnp_sweep: bool) -> dict:
    """Each checkout's median and quartiles of its runs' values, and the
    pairs (the k-th run of each checkout) that each later one won against
    the first: lower ms a call, or higher hypotheses/s."""
    by_root = {r: [run["value"] for run in runs if run["root"] == r] for r in roots}
    out = {"unit": "ms a call" if pnp_sweep else "hypotheses/s", "checkouts": {}}
    for r, vals in by_root.items():
        q1, q2, q3 = statistics.quantiles(vals, n=4, method="inclusive")
        out["checkouts"][r] = {"runs": len(vals), "median": q2, "q1": q1, "q3": q3}
    base = by_root[roots[0]]
    for r in roots[1:]:
        wins = sum((v < b) if pnp_sweep else (v > b) for v, b in zip(by_root[r], base))
        ties = sum(v == b for v, b in zip(by_root[r], base))
        out["checkouts"][r].update(pairs=len(base), wins_over_first=wins, ties=ties)
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tools/bench_ab.py")
    ap.add_argument("--pnp-sweep", action="store_true",
                    help="time ransac_pnp_sweep instead of the bench's sweep mode")
    ap.add_argument("--pairs", type=int, default=2,
                    help="runs of each checkout (even; default 2 turns of A B B A)")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    if args.pairs < 2 or args.pairs % 2:
        ap.error("--pairs must be even and at least 2")
    roots = args.roots
    order = (roots + roots[::-1]) * (args.pairs // 2)
    fn = "one_pnp_sweep" if args.pnp_sweep else "one"
    code = (f"import sys; sys.path.insert(0, {str(Path(__file__).parent)!r}); "
            f"import bench_ab; bench_ab.{fn}(sys.argv[1])")
    runs = []
    for root in order:
        proc = subprocess.run([sys.executable, "-c", code, root], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        runs.append(json.loads(line))
        print(line, flush=True)
    print(json.dumps(summary(roots, runs, args.pnp_sweep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
