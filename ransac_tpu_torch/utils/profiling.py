"""Speed-of-light report of the port's kernels, and trace helpers.

Port of ``ransac_tpu.utils.profiling``.  Each timed kernel or workload is a
``KernelReport``: its achieved FLOP/s, issued operations/s and bytes/s
against the card's peaks in ``CHIP_PEAKS``.  The keys keep the JAX
package's names: ``vpu`` is the card's FP32 CUDA cores, ``mxu`` its tensor
cores (TF32, what float32 products run on), ``hbm`` its device memory.

- The ``"h100"`` row holds NVIDIA's data-sheet values for the H100 SXM (not
  measurements): FP32 132 SMs x 128 lanes x 2 FLOPs (FMA) x 1980 MHz = 66.9
  TFLOP/s, one operation per lane and clock = 33.5 T operations/s, dense
  TF32 495 TFLOP/s, device memory 3.35 TB/s.  ``refresh_peaks_measured``
  (``cli profile --measure-peaks``) replaces it with the readings of the
  roofline probes (``ops.roofline``).  The TPU rows of the JAX package are
  not carried over: they are TPU numbers.  ``cpu`` is an order of
  magnitude, as in the JAX package.
- ``OPS`` is the one count of FP32 (and integer) operations per hypothesis
  of each sweep or scoring kernel, read from its CUDA source; ``bound``
  turns it into the least time the card could take for a call, and
  ``issued_ops`` into a report's issued operations.  (The JAX package's
  per-kernel VPU issue-slot audits are TPU counts and are not ported.)
- ``SolProfiler.measure`` times with CUDA events on the card (best of
  ``reps`` runs of ``iters`` calls after a warm-up call) and the host clock
  on the CPU.  The JAX package's chained tunnel protocol
  (``measure_chained``) is not ported.
- ``trace`` wraps ``torch.profiler`` (the program's ``utils.logging.timed``
  spans show in it as annotations).
- ``launch_counts`` reads every kernel's launch count (``ops._build``).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from ransac_tpu_torch.ops import _build

SMS = 132
FP32_LANES = 128                 # per SM
DATASHEET_SM_CLOCK_MHZ = 1980.0  # H100 SXM maximum SM clock
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
TF32_FLOPS = 495e12              # H100 SXM dense TF32, NVIDIA's data sheet

CHIP_PEAKS = {
    # name: dict(vpu_flops, vpu_ops, mxu_flops, hbm_bytes)
    "h100": dict(vpu_flops=SMS * FP32_LANES * 2 * DATASHEET_SM_CLOCK_MHZ * 1e6,
                 vpu_ops=SMS * FP32_LANES * DATASHEET_SM_CLOCK_MHZ * 1e6,
                 mxu_flops=TF32_FLOPS, hbm_bytes=HBM_BYTES_PER_S),
    "cpu": dict(vpu_flops=1e11, vpu_ops=1e11, mxu_flops=1e11, hbm_bytes=5e10),
}

# FP32 (and integer) operations each kernel does, read from its source
# (csrc/): per hypothesis (or model) a fixed part and a part per scored
# point.  A bound is the least time the card could take, so a product-sum
# a b + c that the card can issue as one FFMA counts once, whether the
# kernel fuses it (rows 2 and 7) or rounds the product and the sum apart
# (every other row); a division or a reciprocal counts as one operation.
#   homography solve: 2 frames (10 differences, 4 determinants of 2, 6
#     products) 48, adjugate 9 x 2, H 9 x 3 -> 93;
#   homography score per point (rows 2, 6): u, v, w 6, residual 2, r2 2,
#     w^2 and its clamp 2, bound 1, reciprocal 1, count 2, MSAC 3 -> 19;
#     row 1 divides for the reciprocal and its product -> 18; the scorer
#     (row 3): u, v, w 6, guard and reciprocal 3, residual 2, e2 2, count 2,
#     MSAC 2 -> 17;
#   pose score per point and root (rows 5, 9): camera point 9, behind 1,
#     residual 2, r2 2, z^2 and its clamp 2, bound 1, the behind select 1,
#     count 2, MSAC 4 -> 24, for the valid roots only (``issued_ops``'s
#     valid_share; an invalid root's record is a constant); the pose scorer (row 4): camera point 9, behind
#     1, guard and reciprocal 2, residual 2, e2 3, count 2, MSAC 2 -> 21;
#   counter draws: 15 per draw (hash 8, multiply-high reduction 7);
#   P3P solve: law of cosines and the quartic's coefficients 90; the quartic
#     325 (12 resolvent Newton steps of 13, 8 root polishes of 12); world
#     triad 40; per root 170 (depth polish 66, camera triad and pose 70, the
#     rest 34) -> ~1150;
#   8-point canonical solve: 2 adjugate frames 2 x 61 (frame 48 / 2 + 18 +
#     norm 19), 4 rows 72, 20 minors 40, 5 det4 35, P and F 45, norm 19
#     -> 333;
#   Sampson score per point: F x1 6, F^T x2 4, x2' F x1 2, denominator 4,
#     clamp 1, square and bound 2, reciprocal 1, count 2, MSAC 3 -> 25;
#   LM pass (``csrc/lm.cuh``, ``LM_PASS_OPS``; the pose LM's kernel,
#     ``csrc/lm.cu``, is counted per problem and pass, so ``n_hyp`` is
#     problems x passes): per point the normal equations' 2 rows x (n + n (n
#     + 1) / 2) (88 homography, 54 pose), the residual at x and at x + dx (2
#     x 13, 2 x 19), its Jacobian's tangents (26, 40) and the two costs 4 ->
#     144, 136; per problem the elimination n^3 / 3 + n^2 (235, 108) and the
#     pose's two rotations (2 x 60) -> 235, 228;
#   fused refits (``csrc/refit.cu``, counted per problem at the engines' 10
#     LM passes, which add 10 x the LM's counts): homography, per point the
#     two Hartley frames' sums 25, the two weighted DLT rows and their 45
#     upper products each 226 -> 251 + 1440; per problem 8 eliminations of
#     9 x 10 with their shifts and norms 2888, two Rayleigh quotients 486,
#     frames and Td^-1 Hn Ts 186 -> 3560 + 2350; pose, per point the DLT-PnP
#     rows and 78 products 342, EPnP's centroid and covariance 32, its
#     barycentrics (a 4 x 4 elimination, 40) and rows 384, both cases' sign,
#     centroid and cross-covariance passes 430, the 4 candidates' MSAC 121
#     -> 1309 + 1360; per problem DLT-PnP's 8 eliminations of 12 x 13 and
#     quotients 7050 and its scale and rotation 400, EPnP's Jacobi rotations
#     (212 each, ``EPNP_ROTATIONS`` of them) 60,844 and the rest of EPnP
#     1,100, log_so3 and exp_so3 120 -> 69,514 + 2280.
#: One LM pass of each model (per problem, per point and problem).
LM_PASS_OPS = {"homography": (235, 88 + 2 * 13 + 26 + 4),
               "pose": (108 + 2 * 60, 54 + 2 * 19 + 40 + 4)}
#: The rotations of EPnP's Jacobi eigensolver that ``refit_pose`` counts:
#: the fewest that the host build of ``csrc/refit_seed.cuh`` makes on the
#: engine-shaped 13-point refits of tests/test_torch_refit_kernel.py (287 to
#: 307, 4.3 to 4.7 sweeps of 66), so the bound does not overstate the work.
EPNP_ROTATIONS = 287
OPS = {  # name -> (fixed ops per hypothesis, ops per point and hypothesis)
    "sweep_multi": (93, 18),
    "homography_ransac_sweep": (4 * 15 + 93, 19),
    "homography_scores": (0, 17),
    "pnp_scores": (0, 21),
    "pnp_ransac_sweep": (3 * 15 + 1150, 4 * 24),
    "homography_ransac_sweep_large": (4 * 15 + 93, 19),
    "essential_ransac_sweep": (8 * 15 + 333, 25),
    "essential_ransac_sweep_large": (8 * 15 + 333, 25),
    "pnp_ransac_sweep_large": (3 * 15 + 1150, 4 * 24),
    "lm_pose": LM_PASS_OPS["pose"],
    "refit_homography": (3560 + 10 * LM_PASS_OPS["homography"][0],
                         251 + 10 * LM_PASS_OPS["homography"][1]),
    "refit_pose": (7450 + 212 * EPNP_ROTATIONS + 1100 + 120 + 10 * LM_PASS_OPS["pose"][0],
                   1309 + 10 * LM_PASS_OPS["pose"][1]),
}


#: The rows whose score term counts only the valid (sample, root) pairs.
SCORES_VALID_PAIRS = ("pnp_ransac_sweep", "pnp_ransac_sweep_large")


def issued_ops(name: str, n_hyp: int, n_points: int, valid_share: float = 1.0) -> float:
    """Operations of one call of kernel ``name`` (``OPS``).  For the P3P
    sweeps (``SCORES_VALID_PAIRS``) ``valid_share`` is the share of (sample,
    root) pairs the call's inputs make valid (``valid_root_share`` of
    ``ops.sweep_pnp`` / ``ops.sweep_pnp_large``): an invalid pair's record
    is a constant, so the function needs no score for it, and the score
    term is 24 x points x 4 roots x valid_share (1.0: every root, the JAX
    package's count)."""
    fixed, per_point = OPS[name]
    if name not in SCORES_VALID_PAIRS and valid_share != 1.0:
        raise ValueError(f"{name} scores every hypothesis; valid_share is for "
                         f"{SCORES_VALID_PAIRS}")
    return float(n_hyp) * (fixed + per_point * n_points * valid_share)


def bound(name, n_hyp, n_points, in_bytes, out_bytes, clock_mhz, valid_share=1.0):
    """(bound_ms, bound_by) of one call: its operations (``issued_ops``,
    with ``valid_share`` for the P3P sweeps) over the FP32 rate 132 SMs x
    128 lanes x the SM clock, or its bytes (inputs read once, outputs
    written once) over the memory rate, whichever is longer."""
    ops_s = (issued_ops(name, n_hyp, n_points, valid_share)
             / (SMS * FP32_LANES * clock_mhz * 1e6))
    bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes")


def refresh_peaks_measured(chip: str | None = None) -> dict:
    """Measure the rooflines of the card (``ops.roofline.measure_all``) and
    install them in ``CHIP_PEAKS`` (``cli profile --measure-peaks``).
    Returns the dict."""
    from ransac_tpu_torch.ops.roofline import measure_all

    chip = chip or detect_chip("cuda")
    m = measure_all()
    CHIP_PEAKS[chip] = dict(vpu_flops=m["vpu_fma_flops"], vpu_ops=m["vpu_ops"],
                            mxu_flops=m["mxu_flops"], hbm_bytes=m["hbm_bytes"])
    return CHIP_PEAKS[chip]


def detect_chip(device="cuda") -> str:
    """``"cpu"`` for the CPU, ``"h100"`` for an H100, else the card's name
    in lower case (a name with no ``CHIP_PEAKS`` row until
    ``refresh_peaks_measured`` installs one)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    return "h100" if "H100" in name else name.lower()


@dataclass
class KernelReport:
    """One kernel's achieved rates against the card's peaks.

    - ``sol_compute``: algorithmic FLOPs / the peak of the unit they run on
      (``unit`` = "vpu" or "mxu"): a lower bound on how busy it is.
    - ``sol_issue``: issued operations (``OPS``) / the FP32 operation rate:
      the utilization figure for the fused sweeps.
    - ``sol_memory``: bytes moved / the device-memory rate.

    ``sol`` is the largest of the three: the binding unit's utilization.
    """

    name: str
    seconds: float
    flops: float
    bytes_moved: float
    chip: str
    issued_ops: float = 0.0
    unit: str = "vpu"

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds

    @property
    def achieved_bw(self) -> float:
        return self.bytes_moved / self.seconds

    @property
    def sol_compute(self) -> float:
        return self.achieved_flops / CHIP_PEAKS[self.chip][f"{self.unit}_flops"]

    @property
    def sol_issue(self) -> float:
        return (self.issued_ops / self.seconds) / CHIP_PEAKS[self.chip]["vpu_ops"]

    @property
    def sol_memory(self) -> float:
        return self.achieved_bw / CHIP_PEAKS[self.chip]["hbm_bytes"]

    @property
    def sol(self) -> float:
        return max(self.sol_compute, self.sol_memory, self.sol_issue)

    def row(self) -> dict:
        return {
            "kernel": self.name, "ms": self.seconds * 1e3,
            "gflops": self.achieved_flops / 1e9,
            "gbps": self.achieved_bw / 1e9,
            "issued_gops": self.issued_ops / self.seconds / 1e9,
            "unit": self.unit,
            "sol_compute": self.sol_compute, "sol_memory": self.sol_memory,
            "sol_issue": self.sol_issue,
            "sol": self.sol, "chip": self.chip,
        }


@dataclass
class SolProfiler:
    reports: list = field(default_factory=list)
    chip: str = ""
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if not self.chip:
            self.chip = detect_chip(self.device)

    def measure(self, name: str, fn, *args, flops: float = 0.0,
                bytes_moved: float = 0.0, issued_ops: float = 0.0,
                unit: str = "vpu", iters: int = 30, vary=None, reps: int = 3):
        """Time ``fn(*args)`` and record its report: one warm-up call, then
        the best of ``reps`` runs of ``iters`` calls, per call, by CUDA
        events on the card (the host clock on the CPU).  ``vary`` (i ->
        args) gives each call its own inputs.  Returns (the last output,
        the report)."""
        on_card = self.device.type == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize(self.device)

        out = fn(*(vary(0) if vary else args))
        sync()
        dt = float("inf")
        for rep in range(reps):
            calls = [vary(rep * iters + i + 1) if vary else args for i in range(iters)]
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for a in calls:
                    out = fn(*a)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) * 1e-3
            else:
                t0 = time.perf_counter()
                for a in calls:
                    out = fn(*a)
                seconds = time.perf_counter() - t0
            dt = min(dt, seconds / iters)
        report = KernelReport(name=name, seconds=dt, flops=flops,
                              bytes_moved=bytes_moved, chip=self.chip,
                              issued_ops=issued_ops, unit=unit)
        self.reports.append(report)
        return out, report

    def table(self) -> str:
        lines = [f"{'kernel':28s} {'ms':>9s} {'GF/s':>9s} {'Gop/s':>8s} "
                 f"{'GB/s':>8s} {'SoL%':>6s}  binding"]
        for r in self.reports:
            binding = max((r.sol_compute, r.unit), (r.sol_issue, "issue"),
                          (r.sol_memory, "hbm"))[1]
            lines.append(
                f"{r.name:28s} {r.seconds * 1e3:9.3f} "
                f"{r.achieved_flops / 1e9:9.1f} "
                f"{r.issued_ops / r.seconds / 1e9:8.1f} "
                f"{r.achieved_bw / 1e9:8.1f} "
                f"{100 * r.sol:6.1f}  {binding}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written to ``logdir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ------------------------------------------------------------ launch counts
def launch_counts() -> dict:
    """{kernel: launches in this process} of every kernel (``_build.LAUNCHES``)."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _build.LAUNCHES.update(dict.fromkeys(_build.LAUNCHES, 0))
