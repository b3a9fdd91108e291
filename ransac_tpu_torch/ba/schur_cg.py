"""Matrix-free Schur-complement bundle adjustment (port of
``ransac_tpu.ba.schur_cg``).

The dense Schur path (``ba.bundle``) forms [C*P, 6, 3] cross terms.  This
module solves the same damped normal equations at 512 cameras, 200k points
and millions of observations without forming S:

- **Slots**: the JAX package's ``[D, P]`` slot layout: slot (d, p) holds
  an observation of point p (camera ``slot_cam[d, p]``), padded with zero
  weight.  A point's values reach its slots by broadcasting over D and
  slot values their point by a sum over D.  On an H100 it measured no
  slower than the live slots flat with a point index each, on every scene
  a caller makes (PERF.md).
- **Camera side**: a per-slot camera gather is ``table.T[:, slot_cam]``
  and a per-camera sum is ``index_add_`` along dim 0 of the transposed
  slot values (along dim 1, the values' own layout, it was several times
  slower on the card, ``_to_cams``); the JAX module's chunked one-hot
  contractions and hi/lo group folds are TPU scaffolding.
- **Jacobians**: ``_residual_lanes`` writes Rodrigues and the projection
  component by component, and the 9 per-slot partials are its
  forward-mode derivatives along the 9 basis tangents, one ``jvp`` under
  ``vmap`` (the primal runs once).
- **Preconditioned CG** on the reduced camera system: each iteration
  applies S = Ud - W V^-1 W^T matrix-free (two W passes, one camera gather,
  one camera sum), preconditioned by the inverted 6x6 diagonal blocks, and
  warm-started from the last accepted step.  Its relative-residual exit is
  a freeze: once ``sum(r*r) <= tol * |b|^2`` the iterate no longer moves,
  which gives JAX's early exit with no host read.
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


class BASlotProblem(NamedTuple):
    """Slot layout of a BA problem (see the module docstring)."""
    cameras: torch.Tensor    # [C,6] (rvec, tvec)
    points: torch.Tensor     # [P,3]
    K: torch.Tensor          # [3,3]
    slot_cam: torch.Tensor   # [D,P] camera id per slot (0 if pad)
    slot_uv: torch.Tensor    # [2,D,P]
    slot_w: torch.Tensor     # [D,P] weight (0 = padding)


def from_ba_problem(p: BAProblem, max_slots: int | None = None) -> BASlotProblem:
    """Pack an observation-list problem into the slot layout, on the device
    of ``p.cameras`` (numpy: the CPU).

    Host-side (numpy): runs once per problem.  ``max_slots`` defaults to
    the longest track; observations beyond it are dropped."""
    obs_pt = host(p.obs_pt)
    obs_cam = host(p.obs_cam)
    obs_uv = host(p.obs_uv)
    obs_w = host(p.obs_w)
    n_pt = int(p.points.shape[0])
    counts = np.zeros(n_pt, np.int64)
    live = obs_w > 0
    for q in obs_pt[live]:
        counts[q] += 1
    D = int(counts.max()) if max_slots is None else int(max_slots)
    D = max(D, 1)
    slot_cam = np.zeros((D, n_pt), np.int32)
    slot_uv = np.zeros((2, D, n_pt), np.float32)
    slot_w = np.zeros((D, n_pt), np.float32)
    fill = np.zeros(n_pt, np.int64)
    for o in np.where(live)[0]:
        q = obs_pt[o]
        d = fill[q]
        if d >= D:
            continue
        slot_cam[d, q] = obs_cam[o]
        slot_uv[:, d, q] = obs_uv[o]
        slot_w[d, q] = obs_w[o]
        fill[q] = d + 1
    device = p.cameras.device if isinstance(p.cameras, torch.Tensor) else "cpu"
    return to_device(BASlotProblem(p.cameras, p.points, p.K, slot_cam, slot_uv, slot_w),
                     device)


def to_device(p: BASlotProblem, device) -> BASlotProblem:
    """The problem's arrays as tensors on ``device``, camera ids as int64."""
    t = lambda a: tensor_on(a, device)  # noqa: E731
    return BASlotProblem(cameras=t(p.cameras), points=t(p.points), K=t(p.K),
                         slot_cam=t(p.slot_cam).long(), slot_uv=t(p.slot_uv),
                         slot_w=t(p.slot_w))


# ------------------------------------------------------------ the camera side
def _cams_at(p: BASlotProblem, table):
    """Camera table [C, k] at every slot: [k, D, P]."""
    return table.T[:, p.slot_cam]


def _to_cams(p: BASlotProblem, values, n_cam: int):
    """Per-camera sums [C, k] of slot values [k, D, P]."""
    k = values.shape[0]
    return values.new_zeros(n_cam, k).index_add_(
        0, p.slot_cam.reshape(-1), values.reshape(k, -1).T.contiguous())


# ------------------------------------------------------------ residuals
def _project_lanes(cam6, X, K):
    """Projection with the Rodrigues and projection components written
    out: ``cam6`` [6, ...], ``X`` [3, ...] (broadcasts) -> (u, v, depth).
    The formulas of ``ops.rotation.exp_so3`` (the same smooth-at-zero
    guards, with K^2 = w w^T - |w|^2 I) and of
    ``ops.projection.project_points`` (guarded divide, no distortion)."""
    wx, wy, wz = cam6[0], cam6[1], cam6[2]
    tx, ty, tz = cam6[3], cam6[4], cam6[5]
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
    inv_z = 1.0 / torch.where(Xc2.abs() < 1e-12, torch.full_like(Xc2, 1e-12), Xc2)
    u = K[0, 0] * (Xc0 * inv_z) + K[0, 2]
    v = K[1, 1] * (Xc1 * inv_z) + K[1, 2]
    return u, v, Xc2


def _residual_lanes(cam6, X, uv, K):
    """Reprojection residual r [2, ...] of ``_project_lanes`` against
    ``uv`` [2, ...]."""
    u, v, _ = _project_lanes(cam6, X, K)
    return torch.stack([u - uv[0], v - uv[1]])


def slot_cost(p: BASlotProblem, cameras, points, huber_scale: float = 0.0):
    r = _residual_lanes(_cams_at(p, cameras), points.T[:, None, :], p.slot_uv, p.K) * p.slot_w
    r2 = (r * r).sum(0)
    if huber_scale > 0.0:
        return 0.5 * _robust(r2, huber_scale).sum()
    return 0.5 * r2.sum()


def _slot_blocks(p: BASlotProblem, cameras, points, huber_scale: float):
    """Per-slot residuals r [2,D,P] and Jacobian blocks Jc [6,2,D,P],
    Jp [3,2,D,P] (robust- and mask-weighted): the partials along the 9
    basis tangents, one ``jvp`` under ``vmap`` (slots are independent, so
    the per-slot blocks are exactly the elementwise partials)."""
    cam = _cams_at(p, cameras)                    # [6,D,P]
    X = points.T[:, None, :]                      # [3,1,P]
    basis = torch.eye(9, dtype=cam.dtype, device=cam.device)
    tc = basis[:, :6].reshape(9, 6, 1, 1).expand(9, *cam.shape)
    tx = basis[:, 6:].reshape(9, 3, 1, 1).expand(9, *X.shape)

    def f(c, x):
        return _residual_lanes(c, x, p.slot_uv, p.K)

    r, J = vmap(lambda a, b: jvp(f, (cam, X), (a, b)), out_dims=(None, 0))(tc, tx)
    ww = p.slot_w
    if huber_scale > 0.0:
        ww = ww * huber_weights(torch.sqrt(r[0] * r[0] + r[1] * r[1]) + 1e-12, huber_scale)
    return r * ww, J[:6] * ww, J[6:] * ww


# ------------------------------------------------------------ small algebra
def _inv3x3_lanes(A, eps: float = 0.0):
    """Closed-form 3x3 inverse with the matrix dims leading: A [3,3,P] ->
    [3,3,P] (``ops.linalg.inv3x3``'s adjugate / det)."""
    return inv3x3(A.permute(2, 0, 1), eps=eps).permute(1, 2, 0)


def _inv_spd_6x6(A, eps: float = 1e-9):
    """Batched SPD 6x6 inverse by 3x3 block Schur: A [C,6,6]."""
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    S = A[..., 3:, 3:]
    Pinv = inv3x3(P, eps=eps)
    Qt = Q.transpose(-1, -2)
    T = S - Qt @ Pinv @ Q
    Tinv = inv3x3(T, eps=eps)
    PiQ = Pinv @ Q
    top_left = Pinv + PiQ @ Tinv @ PiQ.transpose(-1, -2)
    top_right = -PiQ @ Tinv
    return torch.cat([torch.cat([top_left, top_right], -1),
                      torch.cat([top_right.transpose(-1, -2), Tinv], -1)], -2)


def _assemble_cam_blocks(p: BASlotProblem, Jc, r, n_cam: int, cam_psum):
    """Camera normal-equation blocks U [C,6,6] (= sum Jc^T Jc) and gc [C,6]
    (= -sum Jc^T r) in one camera sum of the 21 upper entries and 6
    gradient rows, completed across point shards by ``cam_psum``."""
    ii, jj = torch.triu_indices(6, 6, device=r.device)       # the 21 upper entries
    rows = torch.cat([(Jc[ii] * Jc[jj]).sum(1), (Jc * r[None]).sum(1)])   # [27,D,P]
    out = cam_psum(_to_cams(p, rows, n_cam))                              # [C,27]
    U = out.new_zeros(n_cam, 6, 6)
    U[:, ii, jj] = out[:, :21]
    U[:, jj, ii] = out[:, :21]
    return U, -out[:, 21:]


def _damp_lanes(V, lam):
    """V + lam * diag(max(diag(V), 1e-6)) over [3,3,P] blocks."""
    Vd = V.clone()
    for k in range(3):
        Vd[k, k] = V[k, k] + lam * torch.clamp(V[k, k], min=1e-6)
    return Vd


def _cg_step_operator(p: BASlotProblem, W, Vinv, Ud, n_cam, fix_mask, cam_psum):
    """S_apply(x): the damped Schur operator (Ud - W V^-1 W^T) x, matrix-free
    over the slots, its camera sum completed by ``cam_psum``.  ``W``
    [6,3,D,P]."""
    def S_apply(x):                                   # x [C,6]
        x = x * fix_mask[:, None]
        t = (W * _cams_at(p, x)[:, None]).sum((0, 2))                  # [3,P]
        u = (Vinv * t[None]).sum(1)                                     # [3,P]
        y = cam_psum(_to_cams(p, (W * u[None, :, None]).sum(1), n_cam))  # [C,6]
        return ((Ud @ x[..., None])[..., 0] - y) * fix_mask[:, None]

    return S_apply


def _guard(x):
    return torch.where(x.abs() < 1e-30, torch.full_like(x, 1e-30), x)


def _pcg(S_apply, b, Minv, n_iters: int, tol: float = 1e-8, x0=None):
    """Preconditioned conjugate gradient on the [C,6] camera system.
    ``Minv`` [C,6,6]: the block-Jacobi preconditioner.  JAX's loop exits
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


def _schur_cg_step(p: BASlotProblem, r, Jc, Jp, lam, n_cam, fix_first: bool,
                   cg_iters: int, cam_psum=None, cg_tol: float = 1e-4, dc_warm=None):
    """One damped GN step: matrix-free Schur + PCG over the slots (r
    [2,D,P]; Jc [6,2,D,P]; Jp [3,2,D,P]).  Returns (dc [C,6], dp [P,3]).

    ``cam_psum`` (default the identity) completes every camera-side sum
    across point shards: U and gc, the rhs and each operator application,
    the only traffic ``parallel.dist_ba`` needs."""
    if cam_psum is None:
        cam_psum = lambda x: x  # noqa: E731
    dt, dev = r.dtype, r.device
    U, gc = _assemble_cam_blocks(p, Jc, r, n_cam, cam_psum)
    V = (Jp[:, None] * Jp[None]).sum((2, 3))                        # [3,3,P]
    gp = -(Jp * r[None]).sum((1, 2))                                # [3,P]
    d = torch.clamp(U.diagonal(dim1=-2, dim2=-1), min=1e-6)
    Ud = U + torch.diag_embed(lam * d)
    Vinv = _inv3x3_lanes(_damp_lanes(V, lam), eps=1e-9)
    W = (Jc[:, None] * Jp[None]).sum(2)                             # [6,3,D,P]

    # rhs: b = gc - sum over slots of W Vinv gp.
    u0 = (Vinv * gp[None]).sum(1)                                   # [3,P]
    b = gc - cam_psum(_to_cams(p, (W * u0[None, :, None]).sum(1), n_cam))
    fix_mask = torch.ones(n_cam, dtype=dt, device=dev)
    if fix_first:
        fix_mask = (torch.arange(n_cam, device=dev) > 0).to(dt)
    b = b * fix_mask[:, None]

    Minv = _inv_spd_6x6(Ud + 1e-8 * torch.eye(6, dtype=dt, device=dev))
    S_apply = _cg_step_operator(p, W, Vinv, Ud, n_cam, fix_mask, cam_psum)
    dc = _pcg(S_apply, b, Minv, cg_iters, tol=cg_tol, x0=dc_warm)
    dc = dc * fix_mask[:, None]

    # Point back-substitution: dp = Vinv (gp - sum over slots of W^T dc[cam]).
    t = (W * _cams_at(p, dc)[:, None]).sum((0, 2))                  # [3,P]
    dp = (Vinv * (gp - t)[None]).sum(1)                             # [3,P]
    return dc, dp.T


def bundle_adjust_cg(p: BASlotProblem, cfg: BundleAdjustConfig = BundleAdjustConfig(),
                     fix_first_camera: bool = True, cg_iters: int = 24,
                     cg_tol: float = 1e-4, device="cuda") -> BAResult:
    """LM bundle adjustment with matrix-free PCG Schur solves, on
    ``device``.

    The damping schedule of ``ba.bundle.bundle_adjust``; each inner PCG
    exits at relative residual ``sqrt(cg_tol)`` and warm-starts from the
    last accepted camera step."""
    p = to_device(p, device)
    n_cam = p.cameras.shape[0]

    def step(cams, pts, lam, dc_prev):
        r, Jc, Jp = _slot_blocks(p, cams, pts, cfg.huber_scale)
        return _schur_cg_step(p, r, Jc, Jp, lam, n_cam, fix_first_camera, cg_iters,
                              cg_tol=cg_tol, dc_warm=dc_prev)

    return lm_loop(lambda c, x: slot_cost(p, c, x, cfg.huber_scale), step,
                   p.cameras, p.points, cfg)
