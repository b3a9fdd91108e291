"""Headline benchmark of the port: RANSAC hypotheses per second on one GPU.

    python -m ransac_tpu_torch.bench [--mode sweep|stagewise] [--device cuda]
    python -m ransac_tpu_torch.cli bench [same options]

Both run the reference's problem shape (13 correspondences, homography
threshold 75 px, ``main_v1.py:312``), built as the JAX package's
``bench.py`` builds it (``default_rng(0)``, the same true homography, 1 px
noise, +300 px on points 10 and up).

- ``sweep`` (the headline, default): the fused sweep kernel
  (``ops.sweep.homography_ransac_sweep``) over 2^22 hypotheses per call,
  a fresh seed per call, then the argmin over the min-MSAC records.
  A call reads nothing back: the winner stays on the device until the
  batches are done (``pick_min``).
- ``stagewise``: seeded random samples (``utils.prng``) -> batched
  minimal DLT -> the scoring kernel (``ops.score.homography_scores``) ->
  argmin, 2^18 hypotheses per call.

Timing: one warm-up call, then 5 batches of 20 calls (sweep) or 10 calls
(stagewise), each batch timed by CUDA events (host clock with ``--device
cpu``).  The
value is the median batch in hypotheses/s, ``best`` the fastest batch,
``batches`` all of them.  Prints ONE JSON line with the JAX bench's keys
(``metric``, ``value``, ``unit``, ``vs_baseline`` = value / 1e5) plus
``best``, ``batches``, ``protocol``, ``gpu`` (the card's name and power
limit as nvidia-smi prints them), ``device`` and ``winner_count``.  The
winner must hold at least 10 inliers.  Sweep mode adds the JAX bench's
control reading ``control_vpu_tflops``: the card's FP32 FMA rate in
TFLOP/s, read by the roofline probe (``ops.roofline.measure_vpu_fma_peak``
at 32768 trips) after the batches, so that a slow clock shows beside the
headline.  A failed probe fails the bench (the JAX bench wrote 0.0); on
the CPU the key is null (there is no card to read).  The default device is ``cuda``;
without CUDA that is an error (exit code 2), and no mode falls back to
another.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

METRIC = "ransac_hypotheses_per_s_per_chip"
BASELINE = 1e5
THRESHOLD = 75.0
#: mode -> (hypotheses per call, calls per batch): the JAX bench's sizes.
DEFAULTS = {"sweep": (1 << 22, 20), "stagewise": (1 << 18, 10)}
BATCHES = 5
CONTROL_ITERS = 32768   # trips of the FMA probe behind control_vpu_tflops


def gpu_name_and_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def problem(device, n_points: int = 13):
    """src [n,2], dst [n,2], mask [n] float32 on ``device``: the JAX
    bench's problem (``bench.py:29-41``)."""
    from ransac_tpu_torch.ops.homography import apply_h

    rng = np.random.default_rng(0)
    H_true = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0],
                       [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, size=(n_points, 2)).astype(np.float32)
    dst = apply_h(torch.tensor(H_true, dtype=torch.float32),
                  torch.from_numpy(src)).numpy()
    dst = (dst + rng.normal(scale=1.0, size=dst.shape)).astype(np.float32)
    dst[10:] += 300.0
    return (torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device),
            torch.ones(n_points, dtype=torch.float32, device=device))


def pick_min(msac, *rows):
    """(min of msac, then each of ``rows`` at its first argmin), all on
    msac's device: the index stays a tensor (``index_select``), so nothing
    is read back to the host (indexing with a 0-d CUDA tensor would be an
    ``aten::item``, a wait for the device)."""
    value, best = torch.min(msac, 0)
    return (value, *(r.index_select(0, best.reshape(1))[0] for r in rows))


def sweep_step(src, dst, mask, n_hyp):
    """One headline call: the fused sweep with ``seed``, then the winner of
    the min-MSAC records -> (msac, count, packed) on the device, with no
    read-back (``pick_min``)."""
    from ransac_tpu_torch.ops.sweep import homography_ransac_sweep

    def step(seed):
        msac, counts, packed = homography_ransac_sweep(
            seed, src, dst, mask, THRESHOLD, n_hyp=n_hyp)
        return pick_min(msac[0], counts[0], packed[0])

    return step


def stagewise_step(src, dst, mask, n_hyp):
    """One stagewise call: random samples, minimal DLT, the scoring kernel,
    argmin -> (msac, count, model) on the device, with no read-back
    (``pick_min``)."""
    from ransac_tpu_torch.ops.homography import dlt_homography_minimal
    from ransac_tpu_torch.ops.score import homography_scores
    from ransac_tpu_torch.utils.prng import generator_for, sample_without_replacement

    def step(seed):
        gen = generator_for(seed, device=src.device)
        idx = sample_without_replacement(gen, n_hyp, 4, src.shape[0])
        models, ok = dlt_homography_minimal(src[idx], dst[idx])
        counts, msac = homography_scores(models, src, dst, mask, THRESHOLD)
        return pick_min(torch.where(ok, msac, torch.inf), counts, models)

    return step


def time_batches(step, device, iters: int, n_batches: int):
    """Milliseconds of each batch of ``iters`` calls (fresh seed per call)
    after one warm-up call: CUDA events on a card, host clock on the CPU."""
    step(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seed = 1
    times = []
    for _ in range(n_batches):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                step(seed)
                seed += 1
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                step(seed)
                seed += 1
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def run(mode: str, device="cuda") -> dict:
    """Run one mode and return its JSON record (see the module doc)."""
    device = torch.device(device)
    n_hyp, iters = DEFAULTS[mode]
    n_batches = BATCHES
    src, dst, mask = problem(device)
    make = {"sweep": sweep_step, "stagewise": stagewise_step}[mode]
    step = make(src, dst, mask, n_hyp)
    times = time_batches(step, device, iters, n_batches)
    rates = sorted(n_hyp * iters / (ms / 1e3) for ms in times)
    winner_count = float(step(0)[1])
    if winner_count < 10:
        raise RuntimeError(f"consensus not found: winner count {winner_count}")
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    value = statistics.median(rates)
    control = {}
    if mode == "sweep":
        from ransac_tpu_torch.ops.roofline import measure_vpu_fma_peak

        control["control_vpu_tflops"] = (measure_vpu_fma_peak(CONTROL_ITERS) / 1e12
                                         if device.type == "cuda" else None)
    return {
        "metric": METRIC, "value": value, "unit": "hypotheses/s",
        "vs_baseline": value / BASELINE, "best": rates[-1], "batches": rates,
        "protocol": (f"{mode}: median of {n_batches} batches of {iters} calls "
                     f"x {n_hyp} hypotheses, n=13, threshold {THRESHOLD:g} px, "
                     f"fresh seed per call, one warm-up call, {clock}"),
        "gpu": gpu_name_and_limit() if device.type == "cuda" else None,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "mode": mode, "n_hyp": n_hyp, "winner_count": winner_count, **control,
    }


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--mode", choices=["sweep", "stagewise"], default="sweep")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")


def run_args(args) -> int:
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available",
              file=sys.stderr)
        return 2
    rec = run(args.mode, args.device)
    print(json.dumps(rec), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ransac_tpu_torch.bench",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(ap)
    return run_args(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
