"""The control's readings: the reference put in the program's place, in
the precision below the configuration's (float32 with its matrix products
in TF32 against float32 with TF32 off), judged as a run judges the
program's answers.

    python3 benchmark/readings.py --workload <cell> --seeds <n> [<n> ...] [--requests R]

For each seed it builds the cell's inputs (and, for a cell whose requests
start from the program's set-up, that set-up), answers ``R`` requests with
the control (by default one for each photograph of the mix's pool, or
one request where the mix has no pool), judges them and prints one JSON
line of the worst numbers beside the limits.  The benchmark's own runs never run this; its limits are set
between these readings and the program's (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE / "lib"), str(HERE.parent)]

import run  # noqa: E402


def readings(workload: str, seed: int, requests: int | None, device="cuda", cut=None) -> dict:
    import importlib

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg, traffic = run.load("configs", cell["config"]), run.load("traffic", cell["traffic"])
    cut = cut or {}
    traffic.update(cut.get("traffic", {}))
    kind = importlib.import_module("kind_" + traffic["kind"])
    run.logging_quiet()
    with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
        session = kind.Session(cfg, traffic, seed, device, workdir, cut.get("candidates"))
    n = requests or traffic.get("scenes") or 1
    answers = kind.control_answers(session, n, device)
    session.release()
    limits = traffic["limits"]
    failed, worst = run.verdict(kind.judge_run(session, answers, device), limits)
    return {"workload": workload, "seed": seed, "answers": len(answers), "failed": failed,
            "numbers": {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int)
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
