"""The benchmark of ``ransac_tpu_torch`` on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  A cell of ``BENCHMARK.json`` names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<mix>.json``); the mix's ``kind`` names the module
that drives the port (``benchmark/lib/kind_<kind>.py``); each per-layer
metric is read by ``benchmark/metrics/<metric>.py``.  Nothing else names a
cell, so a new cell, mix or metric is new files and entries.

One run: set-up (inputs made from the seed, ingest, warm-up), then a
closed loop of one client for ``--seconds``: each request is sent when the
last has returned, and its latency is the host clock around the port's
call, which ends in the answer on the host.  With ``--trace 1`` a few more
requests run under torch.profiler after the window.  Once the window has
closed, the program's state is freed and every answer is held against the
plain reference (``benchmark/lib/reference.py``); the numbers compared are
printed beside their limits as the last lines of standard error and as the
result's last key.  The last line of standard output is the result.

The run exits with 2, printing no result, without a CUDA card (or with
fewer than the cell asks for) and with 3 if the JAX package or JAX was
loaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# One process with few threads: the port's host work is one Python thread
# launching kernels; idle intra-op workers only add noise to its clock.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE / "lib"), str(HERE / "metrics"), str(ROOT)]

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "ransac_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc), so that set-up
    counts the interpreter's and torch's start too."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


T_SETUP0 = time.perf_counter() - process_age_s()


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def gpu_info() -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""

    config: dict
    traffic: dict
    requests: int
    window_s: float
    spans: dict
    counters: dict
    trace: object = None


def _counters() -> dict:
    from ransac_tpu_torch.ops import lm
    from ransac_tpu_torch.pipelines import raycast

    return {**{f"raycast.{k}": v for k, v in raycast.COUNTS.items()},
            **{f"lm.{k}": v for k, v in lm.COUNTS.items()}}


def _span_counts() -> dict:
    from ransac_tpu_torch.utils.logging import metrics

    return {n: len(metrics.all(n)) for n in ("localize.search", "localize.pnp")}


def _spans_since(counts: dict) -> dict:
    from ransac_tpu_torch.utils.logging import metrics

    return {n: [r["value"] for r in metrics.all(n)[k:]] for n, k in counts.items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cut: dict | None = None) -> dict:
    """One run of a cell; returns the result.  ``cut`` overrides sizes of
    the configuration and the mix (the CPU tests' small cases)."""
    import torch

    import tracing

    bench = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg, traffic = load("configs", cell["config"]), load("traffic", cell["traffic"])
    cut = cut or {}
    traffic.update(cut.get("traffic", {}))
    kind = importlib.import_module("kind_" + traffic["kind"])
    cuda = device != "cpu"
    if cuda:
        torch.set_num_threads(1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    logging_quiet()

    with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
        session = kind.Session(cfg, traffic, seed, device, workdir, cut.get("candidates"))
        i = 0
        for _ in range(traffic["warmup_requests"]):
            session.request(session.next_input(i))
            i += 1
        sync()
        setup_s = time.perf_counter() - T_SETUP0

        spans0, counters0 = _span_counts(), _counters()
        answers, latencies = [], []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            x = session.next_input(i)
            t0 = time.perf_counter()
            answers.append(session.request(x))
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            i += 1
            if t1 >= deadline:
                break
        window_s = t1 - t_start
        counters = {k: v - counters0[k] for k, v in _counters().items()}
        run = Run(cfg, traffic, len(answers), window_s, _spans_since(spans0), counters)
        device_info = gpu_info() if cuda else {"platform": "cpu", "kind": "cpu", "count": 0}
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        if trace:
            inputs = [session.next_input(i + k) for k in range(traffic["trace_requests"])]
            outs, run.trace = tracing.traced(session.request, inputs, cuda)
            answers += outs
            device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)

    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = traffic["limits"]
    failed, checks = verdict(kind.judge_run(session, answers, device), limits)
    correct = (failed == 0 and len(answers) > 0
               and all(v <= limits[k] for k, v in checks.items()))

    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if workload in m.get("workloads", [workload]):
                value = importlib.import_module(m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"requests_per_s": len(latencies) / window_s,
                  "request_p90_ms": 1e3 * percentile(latencies, 90),
                  "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(answers), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return result


def verdict(judged: list[dict], limits: dict):
    """(requests failed, the worst of each number) of the judged units; a
    unit with ``request`` False (a run's start) is not a request."""
    failed = sum(any(not v <= limits[k] for k, v in unit.items() if k != "request")
                 for unit in judged if unit.get("request", True))
    worst = {}
    for unit in judged:
        for k, v in unit.items():
            if k != "request":
                worst[k] = max(worst.get(k, -math.inf), v)
    return failed, worst


def percentile(values, q: float) -> float:
    """numpy's default (linear) percentile."""
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def logging_quiet() -> None:
    """The port logs each query's answer at INFO; a run keeps its standard
    error for the comparison's lines."""
    import logging

    from ransac_tpu_torch.utils.logging import get_logger

    get_logger("benchmark")  # installs the port's handler and level first
    logging.getLogger("ransac_tpu_torch").setLevel(logging.WARNING)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    import torch

    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
