"""Levenberg-Marquardt bundle adjustment with a dense Schur complement
(port of ``ransac_tpu.ba.bundle``).

Joint LM over cameras [C, 6] (rvec, tvec) and points [P, 3] on the
reprojection residuals of an observation list padded to O with a weight
mask.  Each observation's Jacobian blocks come from ``torch.func.jacfwd``
under ``vmap``, each item on a batch of one (a 0-d float32 intermediate
under ``vmap(jacfwd(...))`` is promoted to float64).  The per-camera and
per-point normal-equation blocks and the [C*P, 6, 3] cross terms are
accumulated by ``index_add_``: the JAX function builds them as one-hot
contractions because XLA serialises scatter-adds on the TPU, and its
``[O, C, P]`` intermediate would take 6 GB at 32 cameras, 2,000 points and
24,000 observations.  The reduced camera system is solved by the
pivot-free Gauss-Jordan of ``ops.linalg.solve_spd_gj`` (the JAX function's
rounding order, no read back).  The damping schedule is a host loop that
reads ``done`` every ``ops.lm.CHECK_EVERY`` passes from the first pass at
which it can be set (``ops.lm._first_read``): a float32 decrease is at
least an ulp of the cost, so below rtol ~3e-8 only the damping cap ends a
run, 19 rejections from the default damping; a 15-pass run reads nothing.
Stopping gives the fixed loop's result, since a finished run no longer
changes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ransac_tpu_torch.ops import lm
from ransac_tpu_torch.ops.linalg import inv3x3, solve_spd_gj
from ransac_tpu_torch.ops.projection import project_points
from ransac_tpu_torch.ops.rotation import exp_so3
from ransac_tpu_torch.utils.config import BundleAdjustConfig

#: LM passes of the BA loops (dense and CG) and host reads of their done flag
#: in this process.
COUNTS = {"passes": 0, "reads": 0}

#: The damping cap: a run whose damping reaches it is done.
DAMPING_MAX = 1e8


def reset_counts() -> None:
    COUNTS.update(passes=0, reads=0)


class BAProblem(NamedTuple):
    cameras: torch.Tensor    # [C,6] (rvec, tvec)
    points: torch.Tensor     # [P,3]
    K: torch.Tensor          # [3,3] shared intrinsics
    obs_cam: torch.Tensor    # [O] int
    obs_pt: torch.Tensor     # [O] int
    obs_uv: torch.Tensor     # [O,2]
    obs_w: torch.Tensor      # [O] weights (0 = padding)


class BAResult(NamedTuple):
    cameras: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor           # final 0.5*sum(w*r^2)
    initial_cost: torch.Tensor
    iterations: torch.Tensor


def tensor_on(a, device) -> torch.Tensor:
    """An array (numpy or tensor) as a tensor on ``device``, in its dtype."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.tensor(np.asarray(a), device=device)


def host(a) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def to_device(p: BAProblem, device) -> BAProblem:
    """The problem's arrays as tensors on ``device``, indices as int64."""
    t = lambda a: tensor_on(a, device)  # noqa: E731
    return BAProblem(cameras=t(p.cameras), points=t(p.points), K=t(p.K),
                     obs_cam=t(p.obs_cam).long(), obs_pt=t(p.obs_pt).long(),
                     obs_uv=t(p.obs_uv), obs_w=t(p.obs_w))


def _project(cams, X, K):
    """Pixels [..., 2] and depth [...] of points X [..., 3] seen by cameras
    [..., 6] (the JAX ``_residuals_one``'s exp_so3 and projection)."""
    pix, z = project_points(X[..., None, :], exp_so3(cams[..., :3]), cams[..., 3:6], K)
    return pix[..., 0, :], z[..., 0]


def residuals(p: BAProblem, cameras, points):
    pix, z = _project(cameras[p.obs_cam], points[p.obs_pt], p.K)
    return (pix - p.obs_uv) * p.obs_w[:, None], z


def _robust(r2, huber_scale: float):
    s2 = huber_scale * huber_scale
    return torch.where(r2 <= s2, r2, 2.0 * huber_scale * torch.sqrt(r2) - s2)


def cost_fn(p: BAProblem, cameras, points, huber_scale: float = 0.0):
    r, _ = residuals(p, cameras, points)
    r2 = (r * r).sum(-1)
    if huber_scale > 0.0:
        return 0.5 * _robust(r2, huber_scale).sum()
    return 0.5 * r2.sum()


def huber_weights(rn, huber_scale: float):
    """sqrt of the Huber IRLS weight of residual norms ``rn`` (+1e-12)."""
    s = rn.new_tensor(huber_scale)
    return torch.sqrt(torch.where(rn <= s, torch.ones_like(rn), s / rn))


def _blocks(p: BAProblem, cameras, points, huber_scale: float):
    """Per-observation residuals r [O,2] and Jacobian blocks Jc [O,2,6],
    Jp [O,2,3], robust- and mask-weighted."""
    def one(c6, x3, uv):
        r = _project(c6[None], x3[None], p.K)[0][0] - uv
        return r, r

    (Jc, Jp), r = vmap(jacfwd(one, argnums=(0, 1), has_aux=True))(
        cameras[p.obs_cam], points[p.obs_pt], p.obs_uv)
    ww = p.obs_w
    if huber_scale > 0.0:
        ww = ww * huber_weights(torch.linalg.vector_norm(r, dim=-1) + 1e-12,
                                huber_scale)
    return r * ww[:, None], Jc * ww[:, None, None], Jp * ww[:, None, None]


def _damped(A, lam):
    """A + lam * diag(max(diag(A), 1e-6)) over [..., n, n] blocks."""
    d = torch.clamp(A.diagonal(dim1=-2, dim2=-1), min=1e-6)
    return A + torch.diag_embed(lam * d)


def _solve_schur(p: BAProblem, r, Jc, Jp, lam, n_cam, n_pt, fix_first: bool, psum=None):
    """One damped GN step via the dense Schur reduction of the camera
    system: (dc [C,6], dp [P,3]).  ``psum`` (default the identity)
    completes each sum over the observations across observation shards:
    U, V, gc, gp, the cross terms and W^T dc (``parallel.dist_ba``)."""
    if psum is None:
        psum = lambda x: x  # noqa: E731
    cam, pt = p.obs_cam, p.obs_pt
    JcT, JpT = Jc.transpose(-1, -2), Jp.transpose(-1, -2)
    U = psum(r.new_zeros(n_cam, 6, 6).index_add_(0, cam, JcT @ Jc))
    V = psum(r.new_zeros(n_pt, 3, 3).index_add_(0, pt, JpT @ Jp))
    gc = -psum(r.new_zeros(n_cam, 6).index_add_(0, cam, (JcT @ r[..., None])[..., 0]))
    gp = -psum(r.new_zeros(n_pt, 3).index_add_(0, pt, (JpT @ r[..., None])[..., 0]))
    Ud = _damped(U, lam)
    Vinv = inv3x3(_damped(V, lam), eps=1e-9)

    W = JcT @ Jp                                    # [O,6,3]
    Y = W @ Vinv[pt]                                # [O,6,3]
    # The cross terms B[c, p] = sum over the observations of p by c, at the
    # flat index cam * P + pt, laid out [C*6, P*3] for one product.
    flat = cam * n_pt + pt

    def cross(blocks):
        B = psum(r.new_zeros(n_cam * n_pt, 6, 3).index_add_(0, flat, blocks))
        return B.view(n_cam, n_pt, 6, 3).permute(0, 2, 1, 3).reshape(n_cam * 6, n_pt * 3)

    By = cross(Y)
    S = -(By @ cross(W).T)                          # [C*6, C*6]
    S4 = S.view(n_cam, 6, n_cam, 6)
    c = torch.arange(n_cam, device=r.device)
    S4[c, :, c, :] += Ud
    b = gc - (By @ gp.reshape(-1)).view(n_cam, 6)

    if fix_first:
        # Gauge fix: camera 0's rows and columns zeroed, identity on its
        # diagonal block.
        mask = (torch.arange(n_cam, device=r.device) > 0).to(r.dtype)
        S4 = S4 * mask[:, None, None, None] * mask[None, None, :, None]
        S4[0, :, 0, :] = torch.eye(6, dtype=r.dtype, device=r.device)
        b = b * mask[:, None]

    Sd = S4.reshape(n_cam * 6, n_cam * 6)
    Sd = Sd + 1e-8 * torch.eye(n_cam * 6, dtype=r.dtype, device=r.device)
    dc = solve_spd_gj(Sd, b.reshape(-1)).view(n_cam, 6)

    # Back-substitution: dp = Vinv (gp - sum over each point's observations
    # of W^T dc[cam]).
    Wt_dc = psum(r.new_zeros(n_pt, 3).index_add_(
        0, pt, (W.transpose(-1, -2) @ dc[cam][..., None])[..., 0]))
    dp = (Vinv @ (gp - Wt_dc)[..., None])[..., 0]
    return dc, dp


def lm_loop(cost_of: Callable, step: Callable, cameras, points,
            cfg: BundleAdjustConfig) -> BAResult:
    """The BA damping schedule over ``step(cams, pts, lam, dc_prev) -> (dc,
    dp)``; ``dc_prev`` is the last accepted camera step (zeros after a
    rejection), the CG solve's warm start.  A finished run keeps its state,
    so reading ``done`` only every ``ops.lm.CHECK_EVERY`` passes from
    ``ops.lm._first_read`` gives the fixed loop's result."""
    c0 = cost_of(cameras, points)
    cams, pts, cost = cameras, points, c0
    lam = torch.full((), cfg.damping_init, dtype=cameras.dtype, device=cameras.device)
    it = torch.zeros((), dtype=torch.int64, device=cameras.device)
    done = torch.zeros((), dtype=torch.bool, device=cameras.device)
    dc_prev = torch.zeros_like(cameras)
    k = lm.CHECK_EVERY
    first = lm._first_read(cameras.dtype, cfg.rtol, cfg.damping_init, cfg.damping_up,
                           DAMPING_MAX)
    for n in range(cfg.max_iters):
        if k and n >= first and n % k == 0:
            COUNTS["reads"] += 1
            if bool(done):
                break
        COUNTS["passes"] += 1
        dc, dp = step(cams, pts, lam, dc_prev)
        cams_new, pts_new = cams + dc, pts + dp
        cost_new = cost_of(cams_new, pts_new)
        live = ~done
        accept = cost_new < cost
        take = live & accept
        lam_new = torch.where(accept, torch.clamp(lam * cfg.damping_down, min=1e-10),
                              torch.clamp(lam * cfg.damping_up, max=DAMPING_MAX))
        rel = (cost - cost_new).abs() <= cfg.rtol * torch.clamp(cost, min=1e-30)
        cams = torch.where(take, cams_new, cams)
        pts = torch.where(take, pts_new, pts)
        cost = torch.where(take, cost_new, cost)
        lam = torch.where(live, lam_new, lam)
        dc_prev = torch.where(live, torch.where(accept, dc, torch.zeros_like(dc)), dc_prev)
        done = done | (live & ((accept & rel) | (lam_new >= DAMPING_MAX)))
        it = it + live.long()
    return BAResult(cameras=cams, points=pts, cost=cost, initial_cost=c0, iterations=it)


def bundle_adjust(p: BAProblem, cfg: BundleAdjustConfig = BundleAdjustConfig(),
                  fix_first_camera: bool = True, device="cuda") -> BAResult:
    """Joint LM over all cameras and points, on ``device``."""
    p = to_device(p, device)
    n_cam, n_pt = p.cameras.shape[0], p.points.shape[0]

    def step(cams, pts, lam, _):
        r, Jc, Jp = _blocks(p, cams, pts, cfg.huber_scale)
        return _solve_schur(p, r, Jc, Jp, lam, n_cam, n_pt, fix_first_camera)

    return lm_loop(lambda c, x: cost_fn(p, c, x, cfg.huber_scale), step,
                   p.cameras, p.points, cfg)
