"""The port's headline benchmark (``ransac_tpu_torch.bench``) on the CPU at
a small size: both modes print one JSON line with the JAX bench's keys and
find the consensus; its problem is the JAX bench's; asking for CUDA where
there is none is an error.  (Times from a CPU run are not device numbers:
the record says ``"device": "cpu"`` and ``"gpu": null``.)"""

import json

import numpy as np
import pytest
import torch

from ransac_tpu_torch import bench, cli
from ransac_tpu_torch.ops import _build
from torch_threads import one_torch_thread  # noqa: F401

KEYS = {"metric", "value", "unit", "vs_baseline", "best", "batches",
        "protocol", "gpu", "device", "mode", "n_hyp", "winner_count"}


def one_json_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("mode,entry", [("sweep", "bench"), ("stagewise", "cli")])
def test_bench_modes_print_one_json_line(mode, entry, capsys, monkeypatch):
    monkeypatch.setattr(bench, "DEFAULTS", {"sweep": (4096, 2), "stagewise": (4096, 2)})
    argv = ["--mode", mode, "--device", "cpu"]
    rc = bench.main(argv) if entry == "bench" else cli.main(["bench", *argv])
    assert rc == 0
    rec = one_json_line(capsys.readouterr().out)
    assert KEYS <= set(rec)
    assert rec["metric"] == "ransac_hypotheses_per_s_per_chip"
    assert rec["unit"] == "hypotheses/s"
    assert rec["mode"] == mode and rec["device"] == "cpu" and rec["gpu"] is None
    assert rec["n_hyp"] == 4096
    assert len(rec["batches"]) == 5 and rec["batches"] == sorted(rec["batches"])
    assert rec["best"] == rec["batches"][-1] and rec["value"] == rec["batches"][2]
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 1e5)
    assert rec["winner_count"] >= 10
    # The control reading of the card's FMA rate: sweep mode only, and null
    # on the CPU (there is no card to read).
    if mode == "sweep":
        assert rec["control_vpu_tflops"] is None
    else:
        assert "control_vpu_tflops" not in rec


@pytest.mark.cuda
def test_sweep_bench_reads_the_fma_control_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(bench, "DEFAULTS", {"sweep": (1 << 16, 2)})
    before = _build.LAUNCHES["roofline_fma"]
    rec = bench.run("sweep", "cuda")
    assert _build.LAUNCHES["roofline_fma"] > before
    assert 1.0 < rec["control_vpu_tflops"] < 100.0


@pytest.mark.parametrize("mode", ["sweep", "stagewise"])
def test_steps_pick_the_winner_on_the_device(mode, monkeypatch):
    """Both steps return the min-MSAC winner as tensors picked by
    ``index_select`` with the argmin index tensor (no read-back), the
    winner that indexing with that index picks."""
    calls = []
    select = torch.Tensor.index_select
    monkeypatch.setattr(torch.Tensor, "index_select",
                        lambda t, *a: calls.append(a) or select(t, *a))
    step = {"sweep": bench.sweep_step, "stagewise": bench.stagewise_step}[mode](
        *bench.problem("cpu"), 4096)
    out = step(7)
    assert len(calls) == len(out) - 1
    assert all(isinstance(t, torch.Tensor) for t in out)
    assert all(isinstance(a[1], torch.Tensor) for a in calls)
    if mode == "sweep":
        from ransac_tpu_torch.ops.sweep import homography_ransac_sweep

        msac, counts, packed = homography_ransac_sweep(7, *bench.problem("cpu"),
                                                       bench.THRESHOLD, 4096)
        rows = (msac[0], counts[0], packed[0])
    else:
        from ransac_tpu_torch.ops.homography import dlt_homography_minimal
        from ransac_tpu_torch.ops.score import homography_scores
        from ransac_tpu_torch.utils.prng import generator_for, sample_without_replacement

        src, dst, mask = bench.problem("cpu")
        idx = sample_without_replacement(generator_for(7, device="cpu"), 4096, 4, 13)
        models, ok = dlt_homography_minimal(src[idx], dst[idx])
        counts, msac = homography_scores(models, src, dst, mask, bench.THRESHOLD)
        rows = (torch.where(ok, msac, torch.inf), counts, models)
    best = int(rows[0].argmin())
    for got, want in zip(out, rows):
        assert torch.equal(got, want[best])
    assert float(out[1]) >= 10


def test_problem_is_the_jax_bench_problem():
    import bench as jbench  # the JAX package's bench.py at the repo root

    src_j, dst_j, mask_j = (np.asarray(a) for a in jbench._problem())
    src, dst, mask = bench.problem("cpu")
    np.testing.assert_array_equal(src.numpy(), src_j)
    np.testing.assert_allclose(dst.numpy(), dst_j, rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(mask.numpy(), mask_j)


def test_cuda_without_cuda_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) != 0
    assert cli.main(["bench", "--mode", "stagewise"]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA is not available" in captured.err
