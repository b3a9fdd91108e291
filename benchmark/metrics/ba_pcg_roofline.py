"""BA PCG: the PCG's share of its memory roofline, %.

The bytes are a frozen count of the work, kept here so that every later
implementation is read against the same work: the minimum one PCG
iteration of the flat layout moves in float32, a function of the
problem's cameras C, points P and observations O (``bytes_per_iteration``).
A PCG iteration applies S = Ud - W V^-1 W^T once; at its least it reads
each observation's W block once and its camera index, gathers the search
direction's 9 values of its camera and scatters 9 values back to it; it
reads each point's V^-1; and each camera's damped block Ud and
preconditioner block, and the CG vectors x, r, d, z and S d (x, r, d read
and written, z and S d written):

    per observation: W 9 x 3 x 4 = 108 B, camera index 4 B,
                     gather 9 x 4 = 36 B, scatter 9 x 4 = 36 B;
    per point:       V^-1 3 x 3 x 4 = 36 B;
    per camera:      Ud and Minv 2 x 81 x 4 = 648 B, CG vectors 8 x 36 B.

At Venice's 1,778 / 993,923 / 5,001,946 that is 0.958 GB an iteration,
0.286 ms at 3.35 TB/s (an H100 SXM's HBM3).  The share is that time for
the iterations launched (the traced requests' ``ba.cg_iters``; O from
their ``ba.obs`` over ``ba.passes``, C and P from the run's problem) over
the device time under the ``ba.pcg`` spans of the same requests, which
also holds each pass's warm-start operator application and first
preconditioner step (so the share reads a little low).
"""

import ba_trace
import kind_bundle_adjust

PEAK_BYTES_PER_S = 3.35e12


def bytes_per_iteration(n_cam: int, n_pt: int, n_obs: int) -> int:
    return n_obs * (108 + 4 + 36 + 36) + n_pt * 36 + n_cam * (648 + 8 * 36)


def read(run):
    pcg_ms = ba_trace.device_ms(run, "ba.pcg")
    roots = ba_trace.traced_roots(run)
    if pcg_ms is None or not roots:
        return None
    counts = [r["counts"] for r in roots]
    if any(not c.get("ba.passes") or "ba.cg_iters" not in c or "ba.obs" not in c
           for c in counts):
        return None
    n_cam, n_pt, _ = kind_bundle_adjust.problem_size(run.config, run.traffic)
    moved = sum(c["ba.cg_iters"] * bytes_per_iteration(n_cam, n_pt, c["ba.obs"] // c["ba.passes"])
                for c in counts) / len(counts)
    return 100.0 * (moved / PEAK_BYTES_PER_S) / (1e-3 * pcg_ms)
