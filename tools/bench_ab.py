"""Run the port's headline bench (sweep mode) from several checkouts in turns
on one card, with the device idle share of one profiled batch of each.

    python tools/bench_ab.py ROOT [ROOT ...]     # from the repository root

Each ROOT is the root of a checkout of the repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``).  The checkouts run in the order A B ... then ... B A, twice
(A B B A A B B A for two), each run in a process of its own that imports
that checkout's ``ransac_tpu_torch`` and builds its kernels there.  A run
is ``bench.run("sweep")`` (the JSON record ``python -m
ransac_tpu_torch.bench`` prints: median and batches in hypotheses/s), then
one batch of the bench's sweep calls under torch.profiler: the device idle
share (1 - the device's busy time over the batch's wall time, the batch
ending in one synchronize) and the host-side waits in the trace
(``aten::item``, ``cudaStreamSynchronize``, ...).  Prints one JSON line a
run with the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "aten::item", "aten::_local_scalar_dense")


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


def main(roots: list[str]) -> int:
    if not roots:
        print("usage: python tools/bench_ab.py ROOT [ROOT ...]", file=sys.stderr)
        return 1
    order = (roots + roots[::-1]) * 2
    code = (f"import sys; sys.path.insert(0, {str(Path(__file__).parent)!r}); "
            "import bench_ab; bench_ab.one(sys.argv[1])")
    for root in order:
        proc = subprocess.run([sys.executable, "-c", code, root], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
