"""The port's speed-of-light report (``ransac_tpu_torch.utils.profiling``)
and ``cli profile`` (``ransac_tpu_torch.profile``) on the CPU.

``SolProfiler`` is held to what the JAX package's test asks of its own
(``tests/test_aux.py``'s ``test_sol_profiler_reports``); ``cli profile
--device cpu`` writes the rows the JAX package runs off the TPU, under its
names and with its row keys.  Times from a CPU run are host-clock times of
the plain versions, not device numbers: the rows say ``"chip": "cpu"``.
"""

import contextlib
import json
import types

import pytest
import torch

from ransac_tpu_torch import cli
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.utils import profiling
from ransac_tpu_torch.utils.logging import timed
from ransac_tpu_torch.utils.profiling import SolProfiler
from torch_threads import one_torch_thread  # noqa: F401

ROW_KEYS = {"kernel", "ms", "gflops", "gbps", "issued_gops", "unit",
            "sol_compute", "sol_memory", "sol_issue", "sol", "chip"}
CPU_ROWS = ["pallas_inlier_score", "dlt_minimal_solve", "mutual_nn_match",
            "harris_response_1024"]


def test_sol_profiler_reports():
    prof = SolProfiler(chip="cpu", device="cpu")
    x = torch.ones(1000)
    out, rep = prof.measure("axpy", lambda v: v * 2.0 + 1.0, x, flops=2000,
                            bytes_moved=8000, iters=3)
    assert torch.equal(out, torch.full((1000,), 3.0))
    assert rep.seconds > 0
    assert 0 <= rep.sol
    assert "axpy" in prof.table()
    assert set(rep.row()) == ROW_KEYS and rep.row()["chip"] == "cpu"


def test_cli_profile_cpu_writes_rows_with_the_jax_names(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rc = cli.main(["profile", "--device", "cpu", "--hypotheses", "4096",
                   "--out", str(out)])
    assert rc == 0
    rows = json.loads(out.read_text())
    assert [r["kernel"] for r in rows] == CPU_ROWS
    for r in rows:
        assert set(r) == ROW_KEYS and r["chip"] == "cpu" and r["ms"] > 0
    printed = capsys.readouterr().out
    assert all(name in printed for name in CPU_ROWS)
    last = printed.strip().splitlines()[-1]
    assert last.startswith("# launches:")
    counts = json.loads(last.split(":", 1)[1])
    assert set(counts) >= {"essential_ransac_sweep", "roofline_fma",
                           "roofline_mixed", "roofline_mxu"}
    assert not any(counts.values())


def test_cli_profile_needs_the_card_where_it_asks_for_it(monkeypatch, capsys):
    assert cli.main(["profile", "--device", "cpu", "--measure-peaks"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["profile"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "--measure-peaks" in captured.err and "CUDA is not available" in captured.err


def test_peaks_are_the_data_sheet_until_measured():
    h100 = profiling.CHIP_PEAKS["h100"]
    assert h100["vpu_flops"] == pytest.approx(66.9e12, rel=1e-3)
    assert h100["vpu_ops"] == h100["vpu_flops"] / 2
    assert h100["mxu_flops"] == 495e12 and h100["hbm_bytes"] == 3.35e12
    assert set(profiling.CHIP_PEAKS) == {"h100", "cpu"}
    assert profiling.detect_chip("cpu") == "cpu"


def test_one_operation_count_per_kernel():
    """Row 7's count is the 8 draws and the canonical solve plus the
    Sampson score per point, each product-sum counted once (as one FFMA);
    ``bound`` divides it by the FP32 rate at the given clock, or the bytes
    by the memory rate."""
    assert profiling.OPS["essential_ransac_sweep"] == (8 * 15 + 333, 25)
    assert profiling.OPS["homography_ransac_sweep"] == (4 * 15 + 93, 19)
    ops = profiling.issued_ops("essential_ransac_sweep", 1 << 20, 16)
    assert ops == (1 << 20) * (453 + 25 * 16)
    ms, by = profiling.bound("essential_ransac_sweep", 1 << 20, 16, 16 * 20,
                             (1 << 20) // 8 * 24, 1980.0)
    assert by == "operations"
    assert ms == pytest.approx(ops / (132 * 128 * 1980e6) * 1e3)
    ms, by = profiling.bound("homography_scores", 1, 13, 3.35e9, 0, 1980.0)
    assert by == "bytes" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["pnp_ransac_sweep", "pnp_ransac_sweep_large"])
def test_p3p_bounds_count_the_valid_pairs(name):
    """The P3P sweeps' score term is 24 operations a point for each valid
    (sample, root) pair: ``valid_share`` scales it and leaves the solve and
    draws; the 4-root count (share 1) is the JAX package's.  Other rows
    score every hypothesis and refuse a share."""
    assert profiling.OPS[name] == (3 * 15 + 1150, 4 * 24)
    n_hyp, n = 1 << 20, 256
    assert profiling.issued_ops(name, n_hyp, n) == n_hyp * (1195 + 96 * n)
    assert profiling.issued_ops(name, n_hyp, n, 0.374) == pytest.approx(
        n_hyp * (1195 + 0.374 * 4 * 24 * n))
    ms, by = profiling.bound(name, n_hyp, n, n * 24, n_hyp * 3, 1980.0, 0.374)
    assert by == "operations" and ms == pytest.approx(
        profiling.issued_ops(name, n_hyp, n, 0.374) / (132 * 128 * 1980e6) * 1e3)
    with pytest.raises(ValueError, match="valid_share"):
        profiling.issued_ops("homography_ransac_sweep", n_hyp, 13, 0.5)


@pytest.mark.parametrize("model, n", [("homography", 8), ("pose", 6)])
def test_lm_bound_counts_every_pass_of_every_problem(model, n):
    """An LM pass's count is per problem: the normal equations' 2 rows x (n
    + n (n + 1) / 2) product-sums a point, the residual twice, its tangents
    and the costs, and per problem the elimination (and the pose's two
    rotations); the pose LM kernel's ``n_hyp`` is problems x passes."""
    fixed, per_point = profiling.LM_PASS_OPS[model]
    assert per_point - 2 * (n + n * (n + 1) // 2) in (2 * 13 + 26 + 4, 2 * 19 + 40 + 4)
    assert fixed == round(n ** 3 / 3 + n * n) + (120 if model == "pose" else 0)
    if model == "pose":
        assert profiling.OPS["lm_pose"] == (fixed, per_point)
        ms, by = profiling.bound("lm_pose", 458 * 10, 13, 458 * 13 * 20, 458 * 49, 1980.0)
        assert by == "operations"
        assert ms == pytest.approx(458 * 10 * (fixed + per_point * 13)
                                   / (132 * 128 * 1980e6) * 1e3)


@pytest.mark.parametrize("name, model, B", [("refit_homography", "homography", 458),
                                             ("refit_pose", "pose", 1)])
def test_refit_bound_counts_the_seed_and_ten_lm_passes(name, model, B):
    """A fused refit's count is per problem: its seed's, then the engines'
    10 passes of its LM's count, per problem and per point."""
    fixed, per_point = profiling.OPS[name]
    lm_fixed, lm_per_point = profiling.LM_PASS_OPS[model]
    assert fixed > 10 * lm_fixed and per_point > 10 * lm_per_point
    ms, by = profiling.bound(name, B, 13, B * 13 * 20, B * 36, 1980.0)
    assert by == "operations"
    assert ms == pytest.approx(B * (fixed + per_point * 13) / (132 * 128 * 1980e6) * 1e3)


def test_launch_counts_cover_every_kernel():
    counts = profiling.launch_counts()
    assert set(counts) == set(_build.KERNELS) == {
        "sweep_multi", "homography_ransac_sweep", "homography_scores",
        "pnp_scores", "pnp_ransac_sweep", "homography_ransac_sweep_large",
        "essential_ransac_sweep", "essential_ransac_sweep_large",
        "pnp_ransac_sweep_large", "roofline_fma", "roofline_mixed",
        "roofline_mxu", "lm_pose", "refit_homography", "refit_pose"}
    _build.LAUNCHES["essential_ransac_sweep"] = 3
    _build.LAUNCHES["roofline_mxu"] = 2
    _build.LAUNCHES["lm_pose"] = 4
    try:
        assert profiling.launch_counts()["essential_ransac_sweep"] == 3
        assert profiling.launch_counts()["lm_pose"] == 4
        profiling.reset_launch_counts()
        assert not any(profiling.launch_counts().values())
    finally:
        profiling.reset_launch_counts()


def test_launch_raises_on_a_cuda_error_and_counts_nothing(monkeypatch):
    """``_build.launch`` on a stub library: a tensor goes by its pointer and
    the stream last; a nonzero return raises the entry's ``RuntimeError``
    and counts nothing, a zero return counts one launch."""
    calls, err = [], [700]
    lib = types.SimpleNamespace(sweep_multi_launch=lambda *a: calls.append(a) or err[0])
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=42))
    x = torch.zeros(3)
    with pytest.raises(RuntimeError, match="^sweep_multi_launch failed: CUDA error 700$"):
        _build.launch("sweep_multi", "cuda", x, 5)
    assert calls == [(x.data_ptr(), 5, 42)] and not any(profiling.launch_counts().values())
    err[0] = 0
    _build.launch("sweep_multi", "cuda", x, 5)
    assert profiling.launch_counts() == {**dict.fromkeys(_build.KERNELS, 0), "sweep_multi": 1}


def test_trace_and_annotate(tmp_path):
    """A ``timed`` span under ``trace`` is an annotation of the trace."""
    with profiling.trace(str(tmp_path)):
        with timed("phase"):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "phase" for ev in trace["traceEvents"])


@pytest.mark.cuda
def test_profiler_times_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prof = SolProfiler()
    assert prof.device.type == "cuda" and prof.chip in profiling.CHIP_PEAKS
    x = torch.ones(1 << 20, device="cuda")
    _, rep = prof.measure("axpy", lambda v: v * 2.0 + 1.0, x, flops=2 << 20,
                          bytes_moved=8 << 20, iters=5)
    assert rep.seconds > 0 and rep.chip == "h100"
