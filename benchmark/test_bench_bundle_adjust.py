"""The ``bundle_adjust`` kind and the cell ``bal-venice1778.solve5`` on the
CPU at a cut size: the problem fixed by the seed, the port correct by the
plain reference, the per-layer metrics read, the control and a broken
timed path not correct, no JAX in a run.  The chip's half is the ``cuda``
test at the end.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(HERE / "lib"), str(HERE / "metrics"), str(ROOT)]

import ba_cg_iters_per_request  # noqa: E402
import ba_linearize_ms  # noqa: E402
import ba_pcg_ms  # noqa: E402
import ba_pcg_roofline  # noqa: E402
import kind_bundle_adjust as kb  # noqa: E402
import readings  # noqa: E402
import reference_ba as ref  # noqa: E402
import run  # noqa: E402
import tracing  # noqa: E402

CELL = "bal-venice1778.solve5"
BIG_SEED = 2**31 + 2**30 + 12345
CUT = {"traffic": {"size": {"cameras": 16, "points": 400, "observations": 1700}}}
METRICS = (ba_pcg_ms, ba_linearize_ms, ba_cg_iters_per_request, ba_pcg_roofline)


def cfg():
    return run.load("configs", "bal-venice1778")


@pytest.mark.parametrize("seed", [0, BIG_SEED])
def test_the_problem_is_fixed_by_the_seed_at_its_counts(seed):
    c = cfg()
    a, b = (ref.make_problem(c["scene"], 16, 400, 1700, seed, "cpu") for _ in range(2))
    other = ref.make_problem(c["scene"], 16, 400, 1700, seed + 1, "cpu")
    for k in ("cameras", "points", "obs_cam", "obs_pt", "obs_uv"):
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["obs_uv"], other["obs_uv"])
    assert len(a["obs_cam"]) == 1700 and a["longest_track"] <= 16
    counts = torch.bincount(a["obs_pt"], minlength=400)
    assert int(counts.min()) >= 2 and int(counts.sum()) == 1700
    # By point, cameras ascending within a track, each camera once.
    key = a["obs_pt"] * 16 + a["obs_cam"]
    assert bool((key[1:] > key[:-1]).all())


def test_track_lengths_meet_the_published_total():
    law = cfg()["scene"]["track_law"]
    g = torch.Generator().manual_seed(3)
    L = ref.track_lengths(993_923, 5_001_946, law["min"], law["max"], law["exponent"], g, "cpu")
    assert int(L.sum()) == 5_001_946 and int(L.min()) >= 2 and 1751 <= int(L.max()) <= 1778


def _traced(seed=BIG_SEED):
    return run.run_cell(CELL, seed, 0.5, True, device="cpu", cut=CUT)


def test_the_port_on_the_cpu_is_correct_by_the_reference():
    result = run.run_cell(CELL, BIG_SEED, 0.5, False, device="cpu", cut=CUT)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"requests_per_s", "request_p90_ms", "setup_s"}


def _run_with_a_trace_by_span(seed: int):
    """A traced CPU run, and its ``Run`` with a device trace made from the
    traced requests' own spans: one device operation for each span,
    launched at its start and lasting it (the CPU trace has no device
    operations to name)."""
    captured = {}
    real = tracing.traced

    def keep(fn, inputs, cuda=True):
        outs, trace = real(fn, inputs, cuda)
        captured["trace"] = trace
        return outs, trace

    tracing.traced = keep
    try:
        result = _traced(seed)
    finally:
        tracing.traced = real
    from ransac_tpu_torch.utils.logging import metrics

    t = captured["trace"]
    recs = [r for r in metrics.all() if r.get("profiled")]
    roots = [r for r in recs if r["name"] == "bundle_adjust" and r["parent"] is None][-t.requests:]
    ids = {r["id"] for r in roots}
    spans = [r for r in recs if r["request"] in ids]
    notes = [(r["start_ns"], r["end_ns"], r["name"]) for r in spans]
    ops = [(r["start_ns"], r["end_ns"], r["start_ns"]) for r in spans
           if r["name"] in ("ba.pcg", "ba.linearize")]
    t.device_s_by_span, t.idle_s_by_span = tracing.by_span(ops, notes)
    c = cfg()
    traffic = dict(run.load("traffic", "solve5"), **CUT["traffic"])
    return result, spans, run.Run(c, traffic, 1, 1.0, {}, {}, trace=t)


def test_each_new_metric_reads_and_lies_inside_its_spans():
    result, spans, r = _run_with_a_trace_by_span(BIG_SEED)
    assert result["correct"], result["checks"]
    # The real traced run reads the program's counter.
    assert result["metrics"]["ba_cg_iters_per_request"]["value"] == 5 * 24
    values = {m.__name__: m.read(r) for m in METRICS}
    for name in ("ba_pcg_ms", "ba_linearize_ms", "ba_pcg_roofline"):
        assert values[name] is not None and values[name] > 0, name
    n = r.trace.requests
    for name, span in (("ba_pcg_ms", "ba.pcg"), ("ba_linearize_ms", "ba.linearize")):
        host_ms = 1e3 * sum(s["value"] for s in spans if s["name"] == span) / n
        assert values[name] == pytest.approx(host_ms, rel=1e-6), name
    iters = 5 * 24
    moved = iters * ba_pcg_roofline.bytes_per_iteration(16, 400, 1700)
    want = 100 * moved / ba_pcg_roofline.PEAK_BYTES_PER_S / (1e-3 * values["ba_pcg_ms"])
    assert values["ba_pcg_roofline"] == pytest.approx(want, rel=1e-9)


def test_the_frozen_byte_count_at_venice():
    b = ba_pcg_roofline.bytes_per_iteration(1778, 993_923, 5_001_946)
    assert b == 5_001_946 * 184 + 993_923 * 36 + 1778 * 936
    assert 0.95e9 < b < 0.96e9


def test_the_control_is_not_correct():
    """The reference in float32 with TF32 products, in the program's place."""
    r = readings.readings(CELL, 11, 2, device="cpu", cut=CUT)
    over = {k: n for k, n in r["numbers"].items() if not n["value"] <= n["limit"]}
    assert over and r["failed"] > 0, r


def test_a_run_with_the_schur_term_dropped_is_not_correct(monkeypatch):
    """The timed path's Schur operator without W V^-1 W^T (S = Ud): the
    step is wrong, the answer not correct."""
    from ransac_tpu_torch.ba import schur_cg

    def no_schur(p, W, Vinv, Ud, n_cam, fix_mask, cam_psum):
        return lambda x: (Ud @ (x * fix_mask[:, None])[..., None])[..., 0] * fix_mask[:, None]

    monkeypatch.setattr(schur_cg, "_cg_step_operator", no_schur)
    result = run.run_cell(CELL, 21, 0.5, False, device="cpu", cut=CUT)
    assert not result["correct"] and result["failed"] > 0, result["checks"]
    assert not result["checks"]["cost_gap"]["value"] <= result["checks"]["cost_gap"]["limit"]


def test_metric_readers_read_nothing_from_a_run_of_another_kind():
    empty = run.Run(config={}, traffic={"kind": "localize"}, requests=3, window_s=1.0,
                    spans={}, counters={},
                    trace=tracing.Trace(2, 1.0, 0.5, 10, device_s_by_span={"localize": 0.5}))
    for m in (ba_pcg_ms, ba_linearize_ms, ba_pcg_roofline):
        assert m.read(empty) is None, m.__name__


def test_a_cells_run_loads_no_jax(tmp_path):
    code = ("import json, sys; sys.path[:0] = ['benchmark', 'benchmark/lib']; "
            "import run, kind_bundle_adjust as kb; "
            "c = run.load('configs', 'bal-venice1778'); t = run.load('traffic', 'solve5'); "
            f"t.update({CUT['traffic']!r}); "
            f"s = kb.Session(c, t, 3, 'cpu', {str(tmp_path)!r}); "
            "a = s.request(s.next_input(0)); kb.judge_run(s, [a], 'cpu'); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "ransac_tpu_torch" in top and "torch" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_the_session_reads_the_problem_back_through_io_bal(tmp_path):
    traffic = dict(run.load("traffic", "solve5"), **CUT["traffic"])
    s = kb.Session(cfg(), traffic, 5, "cpu", str(tmp_path))
    parsed = ref.parse_bal(s.text)
    assert s.problem.obs_cam.shape == (1700,) and s.problem.cameras.shape == (16, 9)
    np.testing.assert_array_equal(s.problem.obs_uv.T.numpy(), parsed["obs_uv"].astype(np.float32))
    assert [s.next_input(i) for i in range(6)] == [0, 1, 2, 3, 0, 1]
    assert len({float(c.sum()) for c, _ in s.starts}) == traffic["starts"]


@pytest.mark.cuda
def test_the_cell_on_the_card_reads_every_metric():
    """On the card, at the cell's own size: a traced run is correct, each
    new metric reads, and the roofline share is at most 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = run.run_cell(CELL, 33, 5.0, True)
    assert result["correct"], result["checks"]
    m = result["metrics"]
    for name in ("ba_pcg_ms", "ba_linearize_ms", "ba_cg_iters_per_request", "ba_pcg_roofline"):
        assert name in m, name
    assert 0 < m["ba_pcg_roofline"]["value"] <= 100
    busy_ms = 1e3 * result["device"]["busy_s"] / 2
    assert m["ba_pcg_ms"]["value"] + m["ba_linearize_ms"]["value"] <= busy_ms
