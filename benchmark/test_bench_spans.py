"""The per-layer metrics read from the program's spans and counters
(``lib/program_spans.py``): a traced CPU run of each cell, cut as
``test_bench_contract.test_a_new_cell_mix_and_metric_are_new_files_only``
cuts it, reports each of them, and they hold to the spans they lie in.
The device's time by span (``refit_idle_ms``) has nothing to read on the
CPU; the ``cuda`` test reads it in a traced engine run on the card.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(HERE / "lib"), str(HERE / "metrics"), str(ROOT)]

import run  # noqa: E402
import tracing  # noqa: E402

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
        assert "refit_idle_ms" not in v  # the CPU's trace holds no device
    else:
        assert v["host_syncs_per_request"] >= v["march_trips_per_request"]
        assert v["march_ms"] > 0


@pytest.mark.cuda
def test_device_time_by_span_on_the_card(monkeypatch):
    """A traced engine run on the card: the device's seconds by span sum to
    its busy time, its idle by span to its idle stretches, the two refits
    hold most of the idle, and ``refit_idle_ms`` lies within the window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    traces, read = [], tracing.read
    monkeypatch.setattr(tracing, "read", lambda *a: traces.append(read(*a)) or traces[-1])
    result = run.run_cell("kuliang1898.engine", 2**31 + 19, 2.0, True)
    (t,) = traces
    idle = sum(t.idle_s_by_span.values())
    refit = sum(s for p, s in t.idle_s_by_span.items() if p.endswith("/ransac.refit"))
    print(json.dumps({"busy_s": t.busy_s, "device_s_by_span": t.device_s_by_span,
                      "idle_s_by_span": t.idle_s_by_span, "window_s": t.window_s,
                      "metrics": result["metrics"]}))
    assert result["correct"], result["checks"]
    assert sum(t.device_s_by_span.values()) == pytest.approx(t.busy_s, rel=0.01)
    assert tracing.NO_LAUNCH not in t.device_s_by_span
    assert idle == pytest.approx(sum(t.idle_by_host.values()), rel=1e-9)
    assert refit > idle / 2
    v = result["metrics"]["refit_idle_ms"]["value"]
    assert v == pytest.approx(1e3 * refit / t.requests)
    assert 0 < v * t.requests / 1e3 <= t.window_s
