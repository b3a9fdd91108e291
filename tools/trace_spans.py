"""The program's spans on one card: what a span and a counted host sync
cost, where a request's time goes by span, and where the device idles by
the innermost program span.

    python tools/trace_spans.py --cost [--device cuda|cpu]
    python tools/trace_spans.py --cell kuliang1898.engine --seed 7 \\
        [--requests 4] [--plain 16] [--out build/trace_spans] [--device cuda|cpu]
    # from the repository root

``--cost``: microseconds a ``utils.logging.timed`` span (empty block) and a
``host_sync`` (empty block) take, with no profiler on and under
torch.profiler (CPU, and CUDA on a card), best of 5 rounds of 20,000.

``--cell``: the cell's session from ``benchmark/`` (its configuration and
mix, inputs from ``--seed``; ``kind_<kind>.Session``), two warm requests,
then ``--plain`` requests with no profiler: the mean a request of each
span's self time (its seconds less its children's) by its path of names,
with the root's counters.  Then ``--requests`` requests under
torch.profiler, ending in one synchronize; the Chrome trace goes to
``<out>/trace_<cell>.json.gz``.  From the trace's events: whether every
profiled span is an annotation nested as the program nests it, the
device's busy share, and its idle stretches (between its busy intervals)
by the innermost program span running at each stretch's middle on the
host.  One JSON line each.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT / "benchmark" / "lib"), str(ROOT)]

import torch  # noqa: E402

from ransac_tpu_torch.utils.logging import Metrics, host_sync, metrics, timed  # noqa: E402


def card() -> dict:
    if not torch.cuda.is_available():
        return {"device": "cpu"}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "smi": out.stdout.strip()}


def cost(device: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    n = 20_000

    def best(block) -> float:
        rounds = []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with block():
                    pass
            rounds.append((time.perf_counter_ns() - t0) / n / 1e3)
        return min(rounds)

    scratch = Metrics()  # the spans' records, dropped after
    span = lambda: timed("cost.span", registry=scratch)  # noqa: E731
    sync = lambda: host_sync("cost.sync")  # noqa: E731
    out = {"span_us_off": best(span), "sync_us_off": best(sync)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts):
        out["span_us_on"] = best(span)
        out["sync_us_on"] = best(sync)
    return out


def self_times(spans: list) -> dict:
    """{path of names: self seconds} of one request's spans."""
    by_id = {s["id"]: s for s in spans}
    out = {}
    for s in spans:
        path, p = [s["name"]], by_id.get(s["parent"])
        while p is not None:
            path.append(p["name"])
            p = by_id.get(p["parent"])
        kids = sum(c["value"] for c in spans if c["parent"] == s["id"])
        key = "/".join(reversed(path))
        out[key] = out.get(key, 0.0) + s["value"] - kids
    return out


def plain_breakdown(session, inputs, root: str) -> dict:
    n0 = len(metrics.all())
    walls = []
    for x in inputs:
        t0 = time.perf_counter()
        session.request(x)
        walls.append(time.perf_counter() - t0)
    recs = metrics.all()[n0:]
    roots = [r for r in recs if r["name"] == root and r["parent"] is None]
    total, counts = {}, {}
    for r in roots:
        for k, v in self_times([s for s in recs if s["request"] == r["id"]]).items():
            total[k] = total.get(k, 0.0) + v
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    n = len(roots)
    return {"requests": n, "wall_ms": 1e3 * sum(walls) / n,
            "self_ms": {k: 1e3 * v / n for k, v in sorted(total.items(), key=lambda kv: -kv[1])},
            "root_counts": {k: v / n for k, v in counts.items()}}


def traced(session, inputs, cuda: bool, out_dir: str, cell: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    n0 = len(metrics.all())
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for x in inputs:
            session.request(x)
        sync()
        wall = time.perf_counter() - t0
    spans = [r for r in metrics.all()[n0:] if r["profiled"]]
    dev, notes = [], {}
    for ev in prof.profiler.kineto_results.events():
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                dev.append((start, end))
        elif ev.is_user_annotation():
            notes.setdefault(ev.name(), []).append((start, end))
    # Each span's annotation: the one of its name starting nearest to it.
    note_of, worst_lag_us = {}, 0.0
    for s in spans:
        cands = notes.get(s["name"], [])
        if cands:
            note_of[s["id"]] = min(cands, key=lambda n: abs(n[0] - s["start_ns"]))
            worst_lag_us = max(worst_lag_us, abs(note_of[s["id"]][0] - s["start_ns"]) / 1e3)
    by_id = {s["id"]: s for s in spans}
    unnested = sum(1 for s in spans if s["parent"] in note_of and s["id"] in note_of
                   and not (note_of[s["parent"]][0] <= note_of[s["id"]][0]
                            <= note_of[s["id"]][1] <= note_of[s["parent"]][1]))
    # Idle stretches by the innermost span (annotation) at their middle.
    dev.sort()
    segments = []
    for s, e in dev:
        if segments and s <= segments[-1][1]:
            segments[-1][1] = max(segments[-1][1], e)
        else:
            segments.append([s, e])
    busy = sum(e - s for s, e in segments)
    intervals = sorted((*note_of[i], i) for i in note_of)  # the trace's own
    starts = [iv[0] for iv in intervals]
    idle = {}
    for (_, e0), (s1, _) in zip(segments, segments[1:]):
        mid = e0 + (s1 - e0) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "(no span)"
        for j in range(i, -1, -1):  # the latest-starting span around mid
            if intervals[j][1] >= mid:
                s = by_id[intervals[j][2]]
                path, p = [s["name"]], by_id.get(s["parent"])
                while p is not None:
                    path.append(p["name"])
                    p = by_id.get(p["parent"])
                name = "/".join(reversed(path))
                break
        idle[name] = idle.get(name, 0.0) + (s1 - e0) * 1e-9
    path = os.path.join(out_dir, f"trace_{cell}.json")
    prof.export_chrome_trace(path)
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(path)
    return {"requests": len(inputs), "wall_s": wall, "busy_s": busy * 1e-9,
            "idle_pct": 100.0 * (1.0 - busy * 1e-9 / wall) if cuda else None,
            "spans": len(spans), "annotated": len(note_of), "unnested": unnested,
            "worst_start_lag_us": worst_lag_us,
            "idle_s_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "trace": path + ".gz"}


def run_cell(cell: str, seed: int, requests: int, plain: int, out_dir: str,
             device: str) -> None:
    import importlib

    import run as bench

    spec = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
    w = next(w for w in spec["workloads"] if w["name"] == cell)
    cfg, mix = bench.load("configs", w["config"]), bench.load("traffic", w["traffic"])
    kind = importlib.import_module("kind_" + mix["kind"])
    bench.logging_quiet()
    with tempfile.TemporaryDirectory(prefix="spans-") as workdir:
        session = kind.Session(cfg, mix, seed, device, workdir)
    inputs = [session.next_input(i) for i in range(2 + plain + requests)]
    for x in inputs[:2]:
        session.request(x)
    line = {"cell": cell, "seed": seed, **card()}
    line["plain"] = plain_breakdown(session, inputs[2:2 + plain], mix["kind"])
    line["traced"] = traced(session, inputs[2 + plain:], device == "cuda", out_dir, cell)
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cost", action="store_true")
    p.add_argument("--cell")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--plain", type=int, default=16)
    p.add_argument("--out", default="build/trace_spans")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    if args.cost:
        print(json.dumps({"cost": cost(args.device), **card()}), flush=True)
    if args.cell:
        run_cell(args.cell, args.seed, args.requests, args.plain, args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
