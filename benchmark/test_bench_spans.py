"""The per-layer metrics read from the program's spans and counters
(``lib/program_spans.py``): a traced CPU run of each cell, cut as
``test_bench_contract.test_a_new_cell_mix_and_metric_are_new_files_only``
cuts it, reports each of them, and they hold to the spans they lie in.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(HERE / "lib"), str(HERE / "metrics"), str(ROOT)]

import run  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
SPAN_METRICS = {"search_refit_ms", "pnp_refit_ms", "lm_passes_per_request",
                "host_syncs_per_request", "host_wait_ms", "march_ms"}
CUT = {"candidates": 12, "traffic": {"scenes": 1, "warmup_requests": 1, "trace_requests": 1}}


@pytest.fixture(scope="module", params=["kuliang1898.engine", "kuliang1898-dem.repl21"])
def traced(request):
    return request.param, run.run_cell(request.param, 5, 0.1, True, device="cpu", cut=CUT)


def test_each_new_metric_reads_in_its_cells(traced):
    cell, result = traced
    assert result["correct"], result["checks"]
    want = {m["name"] for m in BENCH["per_layer"]
            if m["name"] in SPAN_METRICS and cell in m["workloads"]}
    assert want and want <= set(result["metrics"]), (want, sorted(result["metrics"]))
    assert all(result["metrics"][n]["value"] is not None for n in want)


def test_the_readings_lie_within_the_spans_that_hold_them(traced):
    cell, result = traced
    v = {k: m["value"] for k, m in result["metrics"].items()}
    assert v["host_syncs_per_request"] >= 1 and v["host_wait_ms"] >= 0
    if cell == "kuliang1898.engine":
        assert 0 < v["search_refit_ms"] <= v["search_ms"]
        assert 0 < v["pnp_refit_ms"] <= v["pnp_ms"]
        assert v["lm_passes_per_request"] == 20  # two LMs of 10 passes
    else:
        assert v["host_syncs_per_request"] >= v["march_trips_per_request"]
        assert v["march_ms"] > 0
