"""The SfM demo's trajectory error on each RANSAC route.

``run_demo`` registers frames through ``pipelines.sfm.incremental_sfm``,
whose engine is the fused sweeps (kernel rows 5, 8, 9) on a CUDA device and
the stage-wise engine on the CPU (``pipelines.sfm.default_engine``).  This
tool runs the demo once per engine named, the engine forced in place of
that default, on one device, and prints one JSON line each: registered
frames, rescued frames, ATE over the trajectory (or circuit), the SfM and
polish times and the wall.  On the CPU the sweep route runs the kernels'
plain versions (minutes at 64 frames).

    python tools/demo_routes.py [--frames 64] [--loop] [--seed 0] \
        [--engines sweep,stage] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engines", default="sweep,stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ransac_tpu_torch.pipelines import sfm
    from ransac_tpu_torch.pipelines.sfm_demo import run_demo

    default = sfm.default_engine
    for engine in args.engines.split(","):
        sfm.default_engine = lambda device, e=engine: e
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                d = run_demo(args.frames, seed=args.seed, loop=args.loop, device=args.device)
        finally:
            sfm.default_engine = default
        print(json.dumps({
            "engine": engine, "device": args.device, "frames": args.frames, "loop": args.loop,
            "seed": args.seed, "registered": d["registered"], "rescued": d["rescued"],
            "ate_frac": d["ate_frac"], "ate_no_posegraph": d["ate_no_posegraph"],
            "loop_edges": d["loop_edges"], "t_sfm_s": d["t_sfm_s"], "t_ba_s": d["t_ba_s"],
            "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
