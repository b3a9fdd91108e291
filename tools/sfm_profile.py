"""Count the kernels, device busy time and host waits of a whole ``cli sfm``
run on one card.

    python tools/sfm_profile.py [--frames 32] [--points 2000]   # from the repository root

Builds the kernels, writes ``io.synthetic.write_sfm_tracks(frames, points)``
and runs ``python -m ransac_tpu_torch.cli sfm --tracks ... --device cuda``
in this process three times: under torch.profiler with CUDA activity only
(kernels and device busy time at little cost to the run), under CPU and
CUDA activity (adds ``aten::item`` and the other host operators), and
without the profiler (the wall).  Each profiled run's raw events are read
directly (the profiler's averages would take minutes on ~10^6 kernels).
Prints one line a run, with the time the profiler took to stop and be read
back, and the card's name and power limit.  ``chip_smoke.py`` profiles an
8-frame cut of the same tracks instead: this run takes ~3 minutes.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")

from ransac_tpu_torch import cli  # noqa: E402
from ransac_tpu_torch.io.synthetic import write_sfm_tracks  # noqa: E402
from ransac_tpu_torch.ops import _build  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--points", type=int, default=2000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    _build.build()
    _build.load()
    with tempfile.TemporaryDirectory() as tmp:
        st = write_sfm_tracks(os.path.join(tmp, "tracks"), args.frames, args.points)
        argv = ["sfm", "--tracks", st.tracks_npz, "--intrinsics", st.intrinsics_txt,
                "--device", "cuda"]

        def run():
            with contextlib.redirect_stdout(io.StringIO()):
                assert cli.main(argv) == 0
            torch.cuda.synchronize()

        for name, acts in (("cuda_only", [ProfilerActivity.CUDA]),
                           ("cpu_cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                run()
                wall = time.perf_counter() - t0
            t1 = time.perf_counter()
            events = prof.profiler.kineto_results.events()
            kernels = busy_ns = items = syncs = 0
            for ev in events:
                if ev.device_type() == torch.autograd.DeviceType.CUDA:
                    kernels += 1
                    busy_ns += ev.duration_ns()
                elif ev.name() == "aten::item":
                    items += 1
                elif ev.name() == "cudaStreamSynchronize":
                    syncs += 1
            print(json.dumps({
                "tool": "sfm_profile", "run": name, "frames": args.frames,
                "points": args.points, "profiled_wall_s": wall,
                "readback_s": time.perf_counter() - t1, "events": len(events),
                "kernels": kernels, "device_busy_s": busy_ns * 1e-9,
                "aten_item": items if name == "cpu_cuda" else None,
                "stream_syncs": syncs, "gpu": smi}), flush=True)
        t0 = time.perf_counter()
        run()
        print(json.dumps({"tool": "sfm_profile", "run": "unprofiled", "frames": args.frames,
                          "points": args.points, "wall_s": time.perf_counter() - t0,
                          "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
