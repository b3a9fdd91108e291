"""Traffic of kind ``bundle_adjust``: each request is one global bundle
adjustment of the configuration's problem through the port's
``ba.schur_cg.bundle_adjust_cg``, as ``python -m ransac_tpu_torch.cli ba``
runs it: a BAL file read through ``io.bal``, solved in the flat layout.

Set-up makes the problem on the device from the seed
(``reference_ba.make_problem``), draws a pool of ``starts`` initial states
over the same observations (``make_start``), writes the problem with
start 0 as BAL text into the run's work directory, reads it back through
``io.bal.read_bal`` and packs it in the flat layout (nothing dropped).
Request i solves from start i mod ``starts`` and ends with the solved
cameras, points, cost and initial cost on the host.

The comparison holds each answer against the plain reference
(``reference_ba``, float64, its own parse of the same text), which solves
once from each start with the same schedule:

- ``cost_gap``: the float64 cost of the answer, as the reference computes
  it, minus the reference's cost after the same passes, over the
  reference's decrease;
- ``cost_report_gap``: the answer's own cost against that float64 cost,
  relative (a program that optimises another objective, or over other
  observations, reports another cost).

A mix's ``size`` ({"cameras", "points", "observations"}) replaces the
configuration's counts: the CPU tests' cuts.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import reference_ba as ref

#: Every number ``judge_run`` returns: the keys of a mix's ``limits``.
LIMITS = ("cost_gap", "cost_report_gap")


def problem_size(cfg: dict, traffic: dict) -> tuple:
    """(cameras, points, observations) of a run: the configuration's, or
    the mix's ``size``."""
    size = {k: cfg[k] for k in ("cameras", "points", "observations")}
    size.update(traffic.get("size", {}))
    return size["cameras"], size["points"], size["observations"]


class Session:
    def __init__(self, cfg, traffic, seed, device, workdir, n_candidates=None):
        from ransac_tpu_torch.ba.bundle import BAProblem
        from ransac_tpu_torch.ba.schur_cg import flat_from_ba_problem, to_device
        from ransac_tpu_torch.io.bal import read_bal, write_bal
        from ransac_tpu_torch.utils.config import BundleAdjustConfig

        self.traffic, self.device = traffic, device
        n_cam, n_pt, n_obs = problem_size(cfg, traffic)
        truth = ref.make_problem(cfg["scene"], n_cam, n_pt, n_obs, seed, device)
        starts = [ref.make_start(truth, cfg["start"], seed, k) for k in range(traffic["starts"])]
        path = os.path.join(workdir, "problem.txt")
        write_bal(path, BAProblem(*starts[0], None, truth["obs_cam"], truth["obs_pt"],
                                  truth["obs_uv"], torch.ones(n_obs)))
        del truth
        with open(path, encoding="ascii") as f:
            self.text = f.read()  # the reference's copy, parsed by its own reader
        self.problem = to_device(flat_from_ba_problem(read_bal(path)), device)
        self.starts = [(self.problem.cameras, self.problem.points)] + starts[1:]
        self.starts_host = [(c.cpu().numpy(), p.cpu().numpy()) for c, p in self.starts]
        self.ba_cfg = BundleAdjustConfig(max_iters=traffic["lm_passes"], rtol=traffic["rtol"],
                                         huber_scale=traffic["huber_scale"])

    def next_input(self, i: int) -> int:
        return i % self.traffic["starts"]

    def request(self, k: int):
        from ransac_tpu_torch.ba.schur_cg import bundle_adjust_cg

        cams, pts = self.starts[k]
        t = self.traffic
        res = bundle_adjust_cg(self.problem._replace(cameras=cams, points=pts), self.ba_cfg,
                               fix_first_camera=t["fix_first_camera"], cg_iters=t["cg_iters"],
                               cg_tol=t["cg_tol"], device=self.device)
        cost, c0 = torch.stack([res.cost, res.initial_cost]).cpu().tolist()
        return k, res.cameras.cpu().numpy(), res.points.cpu().numpy(), cost, c0

    def release(self) -> None:
        self.problem = self.starts = None


def _start(session: Session, parsed: dict, k: int, P: ref.Prec, device):
    cams, pts = (parsed["cameras"], parsed["points"]) if k == 0 else session.starts_host[k]
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(P.dtype)  # noqa: E731
    return t(cams), t(pts)


def _solve(session: Session, parsed: dict, k: int, P: ref.Prec, device) -> dict:
    t = session.traffic
    pb = ref.problem_of(parsed, P, device)
    return ref.solve(pb, *_start(session, parsed, k, P, device), t["lm_passes"], t["cg_iters"],
                     t["cg_tol"], t["rtol"], P)


def control_answers(session: Session, n: int, device) -> list:
    """The control's answers to the session's first ``n`` requests: the
    reference in float32 with TF32 products (``reference_ba.CONTROL``)."""
    parsed = ref.parse_bal(session.text)
    out = []
    for i in range(n):
        k = session.next_input(i)
        r = _solve(session, parsed, k, ref.CONTROL, device)
        out.append((k, r["cameras"].cpu().numpy(), r["points"].cpu().numpy(), r["cost"],
                    r["initial_cost"]))
    return out


def judge_run(session: Session, answers, device) -> list[dict]:
    """Each answer's numbers against the reference's solve from its start."""
    parsed = ref.parse_bal(session.text)
    pb = ref.problem_of(parsed, ref.REFERENCE, device)
    solved, out = {}, []
    for k, cams, pts, cost, _ in answers:
        if k not in solved:
            solved[k] = _solve(session, parsed, k, ref.REFERENCE, device)
        r = solved[k]
        t = lambda a: torch.as_tensor(a, device=device).double()  # noqa: E731
        c64 = float(ref.cost(pb, t(cams), t(pts)))
        out.append({"cost_gap": (c64 - r["cost"]) / max(r["initial_cost"] - r["cost"], 1e-300),
                    "cost_report_gap": abs(cost - c64) / max(c64, 1e-300)})
    return out
