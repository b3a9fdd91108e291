"""Matrix-free Schur-complement bundle adjustment (port of
``ransac_tpu.ba.schur_cg``).

The dense Schur path (``ba.bundle``) forms [C*P, 6, 3] cross terms.  This
module solves the same damped normal equations at thousands of cameras,
millions of points and observations without forming S.  One step serves
two camera models and two layouts.

- **Cameras**: [C, 6] (rvec, tvec) sharing one K, projected as
  ``ops.projection.project_points`` does; or BAL's [C, 9] (rvec, tvec, f,
  k1, k2; Agarwal et al., "Bundle Adjustment in the Large", ECCV 2010):
  P = R X + t, p = -P / P_z, p' = f (1 + k1 |p|^2 + k2 |p|^4) p, the
  camera looking down -z and the observations centred on the image.  The
  model follows from the camera width; BAL problems carry no K.
- **Layouts**: an observation's *slot* is its place in one of two layouts,
  each with the same four reductions (camera gather and sum, point gather
  and sum).  ``BASlotProblem`` is the JAX package's ``[D, P]`` slot
  layout: slot (d, p) holds an observation of point p (camera
  ``slot_cam[d, p]``), padded with zero weight; a point's values reach its
  slots by broadcasting over D and slot values their point by a sum over
  D.  ``BAFlatProblem`` is one row a live observation with a camera and a
  point index; both of its sums are ``index_add_`` on dim 0.  The slots
  pad every point to the longest track, which heavy-tailed tracks cannot
  afford (BAL Venice: a track of ~1,775 over ~10^6 points is ~1.8e9
  slots), so BAL problems take the flat layout.  On an H100 the slots
  measured no slower than the flat layout on every scene the SfM callers
  make (PERF.md).
- **Camera side**: a camera gather is ``table.T[:, cam]`` and a camera
  sum is ``index_add_`` along dim 0 of the transposed values (along dim
  1, the values' own layout, it was several times slower on the card,
  ``_index_sum``); the JAX module's chunked one-hot contractions and hi/lo
  group folds are TPU scaffolding.
- **Jacobians**: ``_project_lanes`` and ``_project_bal_lanes`` write
  Rodrigues and the projection component by component, and the per-slot
  partials are their forward-mode derivatives along the k + 3 basis
  tangents (9 or 12), one ``jvp`` under ``vmap`` (the primal runs once).
- **Preconditioned CG** on the reduced camera system: each iteration
  applies S = Ud - W V^-1 W^T matrix-free (two W passes, one camera gather,
  one camera sum), preconditioned by the inverted k x k diagonal blocks,
  and warm-started from the last accepted step.  Its relative-residual
  exit is a freeze: once ``sum(r*r) <= tol * |b|^2`` the iterate no longer
  moves, which gives JAX's early exit with no host read.

Spans (``utils.logging.timed``): ``bundle_adjust`` around a solve (a
request's root where no span is open), and on every LM pass
``ba.linearize`` (residuals and Jacobians), ``ba.assemble`` (U, V, W, the
gradients, the inverses, the right-hand side), ``ba.pcg``, ``ba.backsub``
and ``ba.cost`` (``ba.bundle.lm_loop``).  ``COUNTS``: PCG iterations
launched and observation slots linearised (the flat layout's rows, all
live; the [D, P] slots, padding included: a shape, read from no device),
carried in every span as ``ba.cg_iters`` and ``ba.obs``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ransac_tpu_torch.ba.bundle import (BAProblem, BAResult, host, huber_weights, lm_loop,
                                        tensor_on, _robust)
from ransac_tpu_torch.ops.linalg import inv3x3
from ransac_tpu_torch.utils.config import BundleAdjustConfig
from ransac_tpu_torch.utils.logging import register_counters, timed

#: PCG iterations launched and observation slots linearised in this process.
COUNTS = {"cg_iters": 0, "obs": 0}
register_counters("ba", COUNTS)


def _index_sum(index, values, n: int):
    """Sums [n, k] of ``values`` [k, ...] by ``index`` (the values' trailing
    shape): ``index_add_`` along dim 0 of the transposed values."""
    k = values.shape[0]
    return values.new_zeros(n, k).index_add_(
        0, index.reshape(-1), values.reshape(k, -1).T.contiguous())


class BASlotProblem(NamedTuple):
    """Slot layout of a BA problem (see the module docstring)."""
    cameras: torch.Tensor    # [C,6] (rvec, tvec) or [C,9] BAL
    points: torch.Tensor     # [P,3]
    K: torch.Tensor          # [3,3] (None for BAL cameras)
    slot_cam: torch.Tensor   # [D,P] camera id per slot (0 if pad)
    slot_uv: torch.Tensor    # [2,D,P]
    slot_w: torch.Tensor     # [D,P] weight (0 = padding)

    @property
    def uv(self):
        return self.slot_uv

    @property
    def w(self):
        return self.slot_w

    @property
    def slots(self) -> int:
        return self.slot_w.numel()

    def cam_at(self, table):
        """Camera table [C, k] at every slot: [k, D, P]."""
        return table.T[:, self.slot_cam]

    def cam_sum(self, values, n_cam: int):
        """Per-camera sums [C, k] of slot values [k, D, P]."""
        return _index_sum(self.slot_cam, values, n_cam)

    def pt_at(self, lanes):
        """Point lanes [..., P] at every slot: [..., 1, P] (broadcasts)."""
        return lanes[..., None, :]

    def pt_sum(self, values):
        """Per-point sums [..., P] of slot values [..., D, P]."""
        return values.sum(-2)


class BAFlatProblem(NamedTuple):
    """Flat layout of a BA problem: a row a live observation (see the
    module docstring)."""
    cameras: torch.Tensor    # [C,6] (rvec, tvec) or [C,9] BAL
    points: torch.Tensor     # [P,3]
    K: torch.Tensor          # [3,3] (None for BAL cameras)
    obs_cam: torch.Tensor    # [O] camera id
    obs_pt: torch.Tensor     # [O] point id
    obs_uv: torch.Tensor     # [2,O]
    obs_w: torch.Tensor      # [O] weight (> 0)

    @property
    def uv(self):
        return self.obs_uv

    @property
    def w(self):
        return self.obs_w

    @property
    def slots(self) -> int:
        return self.obs_w.numel()

    def cam_at(self, table):
        """Camera table [C, k] at every row: [k, O]."""
        return table.T[:, self.obs_cam]

    def cam_sum(self, values, n_cam: int):
        """Per-camera sums [C, k] of row values [k, O]."""
        return _index_sum(self.obs_cam, values, n_cam)

    def pt_at(self, lanes):
        """Point lanes [..., P] at every row: [..., O]."""
        return lanes[..., self.obs_pt]

    def pt_sum(self, values):
        """Per-point sums [..., P] of row values [..., O]."""
        lead = values.shape[:-1]
        sums = _index_sum(self.obs_pt, values.reshape(-1, values.shape[-1]),
                          self.points.shape[0])
        return sums.T.reshape(*lead, -1)


def _device_of(p) -> torch.device | str:
    return p.cameras.device if isinstance(p.cameras, torch.Tensor) else "cpu"


def from_ba_problem(p: BAProblem, max_slots: int | None = None) -> BASlotProblem:
    """Pack an observation-list problem into the slot layout, on the device
    of ``p.cameras`` (numpy: the CPU).

    Host-side (numpy), vectorised: the live observations (weight > 0) in a
    stable sort by point; an observation's slot row is its rank within its
    point's track.  ``max_slots`` defaults to the longest track;
    observations beyond it are dropped."""
    obs_pt = host(p.obs_pt)
    obs_w = host(p.obs_w)
    n_pt = int(p.points.shape[0])
    live = np.flatnonzero(obs_w > 0)
    order = live[np.argsort(obs_pt[live], kind="stable")]
    q = obs_pt[order].astype(np.int64)
    counts = np.bincount(q, minlength=n_pt)
    rank = np.arange(q.size) - (np.cumsum(counts) - counts)[q]
    D = int(counts.max()) if max_slots is None else int(max_slots)
    D = max(D, 1)
    keep = rank < D
    o, q, d = order[keep], q[keep], rank[keep]
    slot_cam = np.zeros((D, n_pt), np.int32)
    slot_uv = np.zeros((2, D, n_pt), np.float32)
    slot_w = np.zeros((D, n_pt), np.float32)
    slot_cam[d, q] = host(p.obs_cam)[o]
    slot_uv[:, d, q] = host(p.obs_uv)[o].T
    slot_w[d, q] = obs_w[o]
    return to_device(BASlotProblem(p.cameras, p.points, p.K, slot_cam, slot_uv, slot_w),
                     _device_of(p))


def flat_from_ba_problem(p: BAProblem) -> BAFlatProblem:
    """The flat layout of an observation-list problem: its live
    observations (weight > 0) in their order, on the device of
    ``p.cameras`` (numpy: the CPU).  Nothing is dropped."""
    live = np.flatnonzero(host(p.obs_w) > 0)
    pick = lambda a: host(a)[live]  # noqa: E731
    return to_device(BAFlatProblem(p.cameras, p.points, p.K, pick(p.obs_cam), pick(p.obs_pt),
                                   np.ascontiguousarray(pick(p.obs_uv).T), pick(p.obs_w)),
                     _device_of(p))


def to_device(p, device):
    """The problem's arrays (either layout) as tensors on ``device``,
    indices as int64."""
    t = lambda a: None if a is None else tensor_on(a, device)  # noqa: E731
    if isinstance(p, BAFlatProblem):
        return BAFlatProblem(cameras=t(p.cameras), points=t(p.points), K=t(p.K),
                             obs_cam=t(p.obs_cam).long(), obs_pt=t(p.obs_pt).long(),
                             obs_uv=t(p.obs_uv), obs_w=t(p.obs_w))
    return BASlotProblem(cameras=t(p.cameras), points=t(p.points), K=t(p.K),
                         slot_cam=t(p.slot_cam).long(), slot_uv=t(p.slot_uv),
                         slot_w=t(p.slot_w))


# ------------------------------------------------------------ residuals
def _rigid_lanes(cam, X):
    """R X + t with Rodrigues written out: ``cam`` [6+, ...] (rvec, tvec
    leading), ``X`` [3, ...] (broadcasts) -> (Xc0, Xc1, Xc2).  The formulas
    of ``ops.rotation.exp_so3`` (the same smooth-at-zero guards, with K^2 =
    w w^T - |w|^2 I)."""
    wx, wy, wz = cam[0], cam[1], cam[2]
    tx, ty, tz = cam[3], cam[4], cam[5]
    eps = 1e-20
    theta2 = wx * wx + wy * wy + wz * wz
    theta = torch.sqrt(theta2 + eps * eps) - eps
    small = theta2 < 1e-8
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    R00 = 1.0 + b * (wx * wx - theta2)
    R01 = -a * wz + b * wx * wy
    R02 = a * wy + b * wx * wz
    R10 = a * wz + b * wx * wy
    R11 = 1.0 + b * (wy * wy - theta2)
    R12 = -a * wx + b * wy * wz
    R20 = -a * wy + b * wx * wz
    R21 = a * wx + b * wy * wz
    R22 = 1.0 + b * (wz * wz - theta2)
    x, y, z = X[0], X[1], X[2]
    Xc0 = R00 * x + R01 * y + R02 * z + tx
    Xc1 = R10 * x + R11 * y + R12 * z + ty
    Xc2 = R20 * x + R21 * y + R22 * z + tz
    return Xc0, Xc1, Xc2


def _guard_depth(z):
    return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)


def _project_lanes(cam6, X, K):
    """Projection with the Rodrigues and projection components written
    out: ``cam6`` [6, ...], ``X`` [3, ...] (broadcasts) -> (u, v, depth).
    ``_rigid_lanes`` then the formulas of ``ops.projection.project_points``
    (guarded divide, no distortion)."""
    Xc0, Xc1, Xc2 = _rigid_lanes(cam6, X)
    inv_z = 1.0 / _guard_depth(Xc2)
    u = K[0, 0] * (Xc0 * inv_z) + K[0, 2]
    v = K[1, 1] * (Xc1 * inv_z) + K[1, 2]
    return u, v, Xc2


def _project_bal_lanes(cam9, X):
    """BAL's projection (the module docstring), component by component:
    ``cam9`` [9, ...] (rvec, tvec, f, k1, k2), ``X`` [3, ...] -> (u, v,
    P_z); a point in front has P_z < 0."""
    Xc0, Xc1, Xc2 = _rigid_lanes(cam9, X)
    f, k1, k2 = cam9[6], cam9[7], cam9[8]
    inv_z = -1.0 / _guard_depth(Xc2)
    px, py = Xc0 * inv_z, Xc1 * inv_z
    r2 = px * px + py * py
    s = f * (1.0 + r2 * (k1 + k2 * r2))
    return s * px, s * py, Xc2


def _residual_lanes(cam, X, uv, K):
    """Reprojection residual r [2, ...] against ``uv`` [2, ...]: the
    shared-K model for 6-parameter cameras, BAL's for 9."""
    if cam.shape[0] == 9:
        u, v, _ = _project_bal_lanes(cam, X)
    else:
        u, v, _ = _project_lanes(cam, X, K)
    return torch.stack([u - uv[0], v - uv[1]])


def slot_cost(p, cameras, points, huber_scale: float = 0.0):
    """0.5 sum(w^2 r^2) over the slots of either layout (Huber with a
    scale > 0)."""
    r = _residual_lanes(p.cam_at(cameras), p.pt_at(points.T), p.uv, p.K) * p.w
    r2 = (r * r).sum(0)
    if huber_scale > 0.0:
        return 0.5 * _robust(r2, huber_scale).sum()
    return 0.5 * r2.sum()


def _slot_blocks(p, cameras, points, huber_scale: float):
    """Per-slot residuals r [2, ...slots] and Jacobian blocks Jc [k, 2,
    ...slots], Jp [3, 2, ...slots] (robust- and mask-weighted), k the
    camera width: the partials along the k + 3 basis tangents, one ``jvp``
    under ``vmap`` (slots are independent, so the per-slot blocks are
    exactly the elementwise partials)."""
    COUNTS["obs"] += p.slots
    with timed("ba.linearize"):
        cam = p.cam_at(cameras)                   # [k,...slots]
        X = p.pt_at(points.T)                     # [3,...slots] (broadcasts)
        k = cam.shape[0]
        n = k + 3
        basis = torch.eye(n, dtype=cam.dtype, device=cam.device)
        tc = basis[:, :k].reshape(n, k, *(1,) * (cam.dim() - 1)).expand(n, *cam.shape)
        tx = basis[:, k:].reshape(n, 3, *(1,) * (X.dim() - 1)).expand(n, *X.shape)

        def f(c, x):
            return _residual_lanes(c, x, p.uv, p.K)

        r, J = vmap(lambda a, b: jvp(f, (cam, X), (a, b)), out_dims=(None, 0))(tc, tx)
        ww = p.w
        if huber_scale > 0.0:
            ww = ww * huber_weights(torch.sqrt(r[0] * r[0] + r[1] * r[1]) + 1e-12,
                                    huber_scale)
        return r * ww, J[:k] * ww, J[k:] * ww


# ------------------------------------------------------------ small algebra
def _inv3x3_lanes(A, eps: float = 0.0):
    """Closed-form 3x3 inverse with the matrix dims leading: A [3,3,P] ->
    [3,3,P] (``ops.linalg.inv3x3``'s adjugate / det)."""
    return inv3x3(A.permute(2, 0, 1), eps=eps).permute(1, 2, 0)


def _inv_spd(A, eps: float = 1e-9):
    """Batched SPD inverse of A [C, n, n], n a multiple of 3, by 3x3 block
    Schur: the leading 3x3 block by its adjugate, the rest by recursion on
    its Schur complement (a block LDL^T with no pivoting, which SPD
    matrices need none of); reads nothing on the host."""
    if A.shape[-1] == 3:
        return inv3x3(A, eps=eps)
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    S = A[..., 3:, 3:]
    Pinv = inv3x3(P, eps=eps)
    Qt = Q.transpose(-1, -2)
    T = S - Qt @ Pinv @ Q
    Tinv = _inv_spd(T, eps=eps)
    PiQ = Pinv @ Q
    top_left = Pinv + PiQ @ Tinv @ PiQ.transpose(-1, -2)
    top_right = -PiQ @ Tinv
    return torch.cat([torch.cat([top_left, top_right], -1),
                      torch.cat([top_right.transpose(-1, -2), Tinv], -1)], -2)


def _assemble_cam_blocks(p, Jc, r, n_cam: int, cam_psum):
    """Camera normal-equation blocks U [C,k,k] (= sum Jc^T Jc) and gc [C,k]
    (= -sum Jc^T r) in one camera sum of the k(k+1)/2 upper entries and k
    gradient rows, completed across point shards by ``cam_psum``."""
    k = Jc.shape[0]
    ii, jj = torch.triu_indices(k, k, device=r.device)       # the upper entries
    m = ii.numel()
    rows = torch.cat([(Jc[ii] * Jc[jj]).sum(1), (Jc * r[None]).sum(1)])  # [m+k,...slots]
    out = cam_psum(p.cam_sum(rows, n_cam))                             # [C,m+k]
    U = out.new_zeros(n_cam, k, k)
    U[:, ii, jj] = out[:, :m]
    U[:, jj, ii] = out[:, :m]
    return U, -out[:, m:]


def _damp_lanes(V, lam):
    """V + lam * diag(max(diag(V), 1e-6)) over [3,3,P] blocks."""
    Vd = V.clone()
    for k in range(3):
        Vd[k, k] = V[k, k] + lam * torch.clamp(V[k, k], min=1e-6)
    return Vd


def _cg_step_operator(p, W, Vinv, Ud, n_cam, fix_mask, cam_psum):
    """S_apply(x): the damped Schur operator (Ud - W V^-1 W^T) x, matrix-free
    over the slots, its camera sum completed by ``cam_psum``.  ``W`` [k, 3,
    ...slots]."""
    def S_apply(x):                                   # x [C,k]
        x = x * fix_mask[:, None]
        t = p.pt_sum((W * p.cam_at(x)[:, None]).sum(0))                 # [3,P]
        u = (Vinv * t[None]).sum(1)                                     # [3,P]
        y = cam_psum(p.cam_sum((W * p.pt_at(u)[None]).sum(1), n_cam))  # [C,k]
        return ((Ud @ x[..., None])[..., 0] - y) * fix_mask[:, None]

    return S_apply


def _guard(x):
    return torch.where(x.abs() < 1e-30, torch.full_like(x, 1e-30), x)


def _pcg(S_apply, b, Minv, n_iters: int, tol: float = 1e-8, x0=None):
    """Preconditioned conjugate gradient on the [C,k] camera system.
    ``Minv`` [C,k,k]: the block-Jacobi preconditioner.  JAX's loop exits
    once ``sum(r*r) <= tol * sum(b*b)`` (tested before each iteration);
    here every iteration runs and the iterate freezes at that test, which
    gives the same ``x`` and reads nothing."""
    def prec(r):
        return (Minv @ r[..., None])[..., 0]

    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - S_apply(x0)
    z = prec(r)
    d = z
    rz = (r * z).sum()
    bound = tol * torch.clamp((b * b).sum(), min=1e-30)
    for _ in range(n_iters):
        go = (r * r).sum() > bound
        Sd = S_apply(d)
        alpha = rz / _guard((d * Sd).sum())
        x_new = x + alpha * d
        r_new = r - alpha * Sd
        z = prec(r_new)
        rz_new = (r_new * z).sum()
        d_new = z + rz_new / _guard(rz) * d
        x = torch.where(go, x_new, x)
        r = torch.where(go, r_new, r)
        d = torch.where(go, d_new, d)
        rz = torch.where(go, rz_new, rz)
    return x


def _schur_cg_step(p, r, Jc, Jp, lam, n_cam, fix_first: bool,
                   cg_iters: int, cam_psum=None, cg_tol: float = 1e-4, dc_warm=None):
    """One damped GN step: matrix-free Schur + PCG over the slots of either
    layout (r [2,...slots]; Jc [k,2,...slots]; Jp [3,2,...slots]).
    Returns (dc [C,k], dp [P,3]).

    ``cam_psum`` (default the identity) completes every camera-side sum
    across point shards: U and gc, the rhs and each operator application,
    the only traffic ``parallel.dist_ba`` needs."""
    if cam_psum is None:
        cam_psum = lambda x: x  # noqa: E731
    dt, dev = r.dtype, r.device
    k = Jc.shape[0]
    with timed("ba.assemble"):
        U, gc = _assemble_cam_blocks(p, Jc, r, n_cam, cam_psum)
        V = p.pt_sum((Jp[:, None] * Jp[None]).sum(2))                   # [3,3,P]
        gp = -p.pt_sum((Jp * r[None]).sum(1))                           # [3,P]
        d = torch.clamp(U.diagonal(dim1=-2, dim2=-1), min=1e-6)
        Ud = U + torch.diag_embed(lam * d)
        Vinv = _inv3x3_lanes(_damp_lanes(V, lam), eps=1e-9)
        W = (Jc[:, None] * Jp[None]).sum(2)                             # [k,3,...slots]

        # rhs: b = gc - sum over slots of W Vinv gp.
        u0 = (Vinv * gp[None]).sum(1)                                   # [3,P]
        b = gc - cam_psum(p.cam_sum((W * p.pt_at(u0)[None]).sum(1), n_cam))
        fix_mask = torch.ones(n_cam, dtype=dt, device=dev)
        if fix_first:
            fix_mask = (torch.arange(n_cam, device=dev) > 0).to(dt)
        b = b * fix_mask[:, None]
        Minv = _inv_spd(Ud + 1e-8 * torch.eye(k, dtype=dt, device=dev))
    S_apply = _cg_step_operator(p, W, Vinv, Ud, n_cam, fix_mask, cam_psum)
    COUNTS["cg_iters"] += cg_iters
    with timed("ba.pcg"):
        dc = _pcg(S_apply, b, Minv, cg_iters, tol=cg_tol, x0=dc_warm)
    with timed("ba.backsub"):
        dc = dc * fix_mask[:, None]
        # Point back-substitution: dp = Vinv (gp - sum over slots of W^T dc[cam]).
        t = p.pt_sum((W * p.cam_at(dc)[:, None]).sum(0))                # [3,P]
        dp = (Vinv * (gp - t)[None]).sum(1)                             # [3,P]
    return dc, dp.T


def bundle_adjust_cg(p, cfg: BundleAdjustConfig = BundleAdjustConfig(),
                     fix_first_camera: bool = True, cg_iters: int = 24,
                     cg_tol: float = 1e-4, device="cuda") -> BAResult:
    """LM bundle adjustment with matrix-free PCG Schur solves over either
    layout (``BASlotProblem``, ``BAFlatProblem``), on ``device``, under
    the span ``bundle_adjust``.

    The damping schedule of ``ba.bundle.bundle_adjust``; each inner PCG
    exits at relative residual ``sqrt(cg_tol)`` and warm-starts from the
    last accepted camera step.  ``fix_first_camera`` holds every parameter
    of camera 0."""
    with timed("bundle_adjust"):
        p = to_device(p, device)
        n_cam = p.cameras.shape[0]

        def step(cams, pts, lam, dc_prev):
            r, Jc, Jp = _slot_blocks(p, cams, pts, cfg.huber_scale)
            return _schur_cg_step(p, r, Jc, Jp, lam, n_cam, fix_first_camera, cg_iters,
                                  cg_tol=cg_tol, dc_warm=dc_prev)

        return lm_loop(lambda c, x: slot_cost(p, c, x, cfg.huber_scale), step,
                       p.cameras, p.points, cfg)
