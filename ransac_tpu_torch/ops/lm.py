"""Batched Levenberg-Marquardt (port of ``ransac_tpu.ops.lm``).

One damped Gauss-Newton core over a leading batch dimension.  Jacobians
come from ``torch.func.jacfwd`` under ``torch.func.vmap`` (the JAX
package used ``jax.jacfwd``).  JAX's ``lax.while_loop`` under ``vmap``
becomes a loop of at most ``max_iters`` passes with a per-item ``done``
mask: finished items keep their state, which is what the vmapped
while-loop computes.  It stops once every item is done, reading
``done.all()`` every ``CHECK_EVERY`` passes from the first pass by which an
item can have finished (``_first_read``); stopping gives the fixed loop's
result bit for bit, since a finished item no longer changes.  The step solve is the unrolled pivoted
elimination up to 16 parameters and the pivot-free Gauss-Jordan above
(``ops.linalg.solve_spd_gj``), as in the JAX function.

``refine_pose`` takes ``csrc/lm.cu`` for CUDA float32 tensors: every pass
of every problem in one launch (a warp a problem), the same residuals,
forward-mode Jacobian, step solve and accept / damping / done logic, summed
in the warp's order.  CPU tensors take the loop, the kernel's plain
version; a CUDA tensor of another dtype raises.  ``refine_homography`` is
the loop on any device: on the card its LM runs inside the fused
homography refit below.  The generic ``levenberg_marquardt`` stays the
loop for its other callers.

The engines' two refits (``models.ransac.refit_homography`` and
``_pnp_refit``) take ``csrc/refit.cu`` on the card, one launch each from
their inputs to their result: the seed (the weighted DLT; DLT-PnP, EPnP and
their MSAC choice), the LM and the fallback to the RANSAC winner
(``fused_refit_homography``, ``fused_refit_pose``); their plain versions
are those refits' CPU code.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.homography import apply_h
from ransac_tpu_torch.ops.linalg import solve_spd_gj, solve_unrolled
from ransac_tpu_torch.ops.projection import project_points
from ransac_tpu_torch.ops.rotation import exp_so3
from ransac_tpu_torch.utils.logging import host_sync, register_counters


#: Passes of the LM loops and host reads of their done masks in this process
#: (launches are ``_build.LAUNCHES``).  A launch reads nothing and adds its
#: ``max_iters`` to the passes: the most any of its problems runs, so on the
#: kernel route ``passes`` is an upper bound where items can finish early
#: (the engines' 10-pass refits cannot, so there it is the loop's count).
COUNTS = {"passes": 0, "reads": 0}
register_counters("lm", COUNTS)

#: Passes between the LM's reads of its done mask (PERF.md, the LM's pass
#: counts); 0 reads nothing and runs every pass.
CHECK_EVERY = 4


def reset_counts() -> None:
    COUNTS.update(passes=0, reads=0)


class LMResult(NamedTuple):
    x: torch.Tensor           # [B, n]
    cost: torch.Tensor        # [B]
    iterations: torch.Tensor  # [B]
    converged: torch.Tensor   # [B] bool


def levenberg_marquardt(
    residual_fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    args: tuple = (),
    max_iters: int = 30,
    damping_init: float = 1e-3,
    damping_up: float = 10.0,
    damping_down: float = 0.1,
    rtol: float = 1e-10,
    damping_max: float = 1e8,
) -> LMResult:
    """Minimize 0.5 ||r(x)||^2 for each item of a batch.

    ``residual_fn(x [B, n], *args) -> [B, m]`` is written for a batch;
    ``x0`` is [B, n] and every tensor in ``args`` is batched on dim 0.
    Masked residuals (0/1 weights inside ``residual_fn``) give inlier-only
    refinement without dynamic shapes.  The Jacobian of each item runs the
    residual on a batch of one, so no intermediate is 0-dimensional (under
    ``vmap(jacfwd(...))`` a 0-d float32 intermediate combined with a Python
    float is promoted to float64).  ``done.all()`` is read (one host read
    each time) before every ``CHECK_EVERY``-th pass from ``_first_read``
    on, so a loop in which no item can finish early reads nothing.
    """
    B, n = x0.shape

    def item(x, *a):
        return residual_fn(x[None], *(t[None] for t in a))[0]

    j_fn = vmap(jacfwd(item, argnums=0))

    def cost_of(x):
        r = residual_fn(x, *args)
        return 0.5 * (r * r).sum(-1)

    x = x0
    lam = torch.full((B,), damping_init, dtype=x0.dtype, device=x0.device)
    cost = cost_of(x)
    it = torch.zeros(B, dtype=torch.int64, device=x0.device)
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    k = CHECK_EVERY
    first = _first_read(x0.dtype, rtol, damping_init, damping_up, damping_max)
    for p in range(max_iters):
        if k and p >= first and p % k == 0:
            COUNTS["reads"] += 1
            with host_sync("lm.done"):
                finished = bool(done.all())
            if finished:
                break
        COUNTS["passes"] += 1
        active = ~done
        r = residual_fn(x, *args)                # [B, m]
        J = j_fn(x, *args)                       # [B, m, n]
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        H = J.transpose(-1, -2) @ J
        # Marquardt scaling: lam * diag(H).
        D = torch.diag_embed(torch.clamp(H.diagonal(dim1=-2, dim2=-1), min=1e-12))
        if n <= 16:
            dx, _ = solve_unrolled(H + lam[:, None, None] * D, -g)
        else:
            dx = solve_spd_gj(H + lam[:, None, None] * D, -g)
        x_new = x + dx
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        lam_new = torch.where(accept, torch.clamp(lam * damping_down, min=1e-12),
                              torch.clamp(lam * damping_up, max=damping_max))
        improved = (cost - cost_new).abs() <= rtol * torch.clamp(cost, min=1e-30)
        step = active & accept
        x = torch.where(step[:, None], x_new, x)
        cost = torch.where(step, cost_new, cost)
        lam = torch.where(active, lam_new, lam)
        done = done | (active & ((accept & improved) | (lam_new >= damping_max)))
        it = it + active.to(it.dtype)
    return LMResult(x=x, cost=cost, iterations=it, converged=done)


def _first_read(dtype, rtol, damping_init, damping_up, damping_max) -> int:
    """The first pass count after which an item can be done.  A step is
    taken only on a cost decrease, which in ``dtype`` is at least eps / 4
    of the cost: where ``rtol`` is below that, no step converges and an
    item finishes only when its damping reaches ``damping_max``, which
    takes that many rejections from ``damping_init`` (11 at the defaults;
    so a float32 loop of 10 passes, as the engines' refits, reads nothing)."""
    if rtol >= torch.finfo(dtype).eps / 4 or damping_up <= 1:
        return 1
    return math.ceil(math.log(damping_max / damping_init, damping_up) - 1e-9)


def _pose_residuals(params, Xw, pixels, K, w):
    pix, _ = project_points(Xw, exp_so3(params[:, :3]), params[:, 3:6], K)
    return ((pix - pixels) * w[..., None]).flatten(1)


def refine_pose(rvec0: torch.Tensor, tvec0: torch.Tensor, Xw: torch.Tensor,
                pixels: torch.Tensor, K: torch.Tensor,
                weights: torch.Tensor | None = None, max_iters: int = 30):
    """6-DoF pose LM on reprojection error (``cv2.solvePnPRefineLM``),
    batched: rvec0/tvec0 [B,3], Xw [B,N,3], pixels [B,N,2], K [B,3,3],
    weights [B,N].  Returns (rvec [B,3], tvec [B,3], LMResult)."""
    if weights is None:
        w = torch.ones(Xw.shape[:-1], dtype=Xw.dtype, device=Xw.device)
    else:
        w = weights.to(Xw.dtype)
    if rvec0.device.type != "cpu":
        n = Xw.shape[-2]
        res = _launch("lm_pose", max_iters, 6, n, (rvec0, (3,)), (tvec0, (3,)),
                      (Xw, (n, 3)), (pixels, (n, 2)), (K, (3, 3)), (w, (n,)))
    else:
        res = levenberg_marquardt(_pose_residuals, torch.cat([rvec0, tvec0], -1),
                                  (Xw, pixels, K, w), max_iters=max_iters)
    return res.x[:, :3], res.x[:, 3:6], res


def _homography_residuals(h8, src, dst, w):
    H = torch.cat([h8, torch.ones_like(h8[:, :1])], -1).reshape(-1, 3, 3)
    return ((apply_h(H, src) - dst) * w[..., None]).flatten(1)


def refine_homography(H0: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      weights: torch.Tensor | None = None, max_iters: int = 20):
    """8-parameter homography LM on forward transfer error (h33 fixed at
    1), batched: H0 [B,3,3], src/dst [B,N,2], weights [B,N].  The plain
    loop on every device (``fused_refit_homography`` runs its arithmetic on
    the card).  Returns (H [B,3,3], LMResult)."""
    if weights is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    else:
        w = weights.to(src.dtype)
    h33 = H0[:, 2:3, 2:3]
    h33 = torch.where(h33.abs() < 1e-12, torch.ones_like(h33), h33)
    h0 = (H0 / h33).reshape(-1, 9)[:, :8]
    res = levenberg_marquardt(_homography_residuals, h0, (src, dst, w),
                              max_iters=max_iters)
    H = torch.cat([res.x, torch.ones_like(res.x[:, :1])], -1).reshape(-1, 3, 3)
    return H, res


def _item_args(kernel: str, B: int, inputs) -> list:
    """Check (tensor [B, *shape], shape[, dtype]) inputs (float32 unless a
    dtype is given) on the first one's CUDA device and make each item's
    entries contiguous where they are not, keeping any stride between items
    (an expanded input is not copied).  Returns their (tensor, item stride)
    arguments, as launched."""
    dev = inputs[0][0].device
    args = []
    for t, shape, *dtype in inputs:
        dtype = dtype[0] if dtype else torch.float32
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (B, *shape):
            raise ValueError(f"the {kernel} kernel needs {dtype} [{B}, {shape}] tensors "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if B and not t[0].is_contiguous():
            t = t.contiguous()
        args += [t, t.stride(0)]
    return args


def _launch(kernel: str, max_iters: int, width: int, n: int, *inputs) -> LMResult:
    """``<kernel>_launch`` of ``csrc/lm.cu`` on the current stream, one
    launch, of float32 (tensor [B, *shape], shape) pairs on one CUDA device
    in the entry's order (``_item_args``).  Returns the LMResult with x [B,
    width]."""
    dev, B = inputs[0][0].device, inputs[0][0].shape[0]
    args = _item_args(kernel, B, inputs)
    x = torch.empty((B, width), dtype=torch.float32, device=dev)
    cost = torch.empty(B, dtype=torch.float32, device=dev)
    iterations = torch.empty(B, dtype=torch.int64, device=dev)
    converged = torch.empty(B, dtype=torch.bool, device=dev)
    _build.launch(kernel, dev, *args, B, n, max_iters, x, cost, iterations, converged)
    COUNTS["passes"] += max_iters
    return LMResult(x=x, cost=cost, iterations=iterations, converged=converged)


def fused_refit_homography(H_best: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                           inlier_mask: torch.Tensor, max_iters: int) -> torch.Tensor:
    """``models.ransac.refit_homography`` on the card in one launch of
    ``csrc/refit.cu``: per problem the weighted DLT on the inliers, then
    ``max_iters`` LM passes (none at 0), then H_best where an entry is not
    finite.  H_best [B,3,3], src/dst [B,N,2] float32, inlier_mask [B,N]
    bool, on one CUDA device (any stride between items).  Returns H
    [B,3,3]."""
    B, n = src.shape[:2]
    args = _item_args("refit_homography", B, (
        (H_best, (3, 3)), (src, (n, 2)), (dst, (n, 2)), (inlier_mask, (n,), torch.bool)))
    H = torch.empty((B, 3, 3), dtype=torch.float32, device=src.device)
    _build.launch("refit_homography", src.device, *args, B, n, max_iters, H)
    COUNTS["passes"] += max_iters
    return H


def fused_refit_pose(model_best: torch.Tensor, Xw: torch.Tensor, pixels: torch.Tensor,
                     pix_n: torch.Tensor, K: torch.Tensor, best_mask: torch.Tensor,
                     point_mask: torch.Tensor, thr_n, ay, max_iters: int) -> torch.Tensor:
    """``models.ransac._pnp_refit`` on the card in one launch of
    ``csrc/refit.cu``: DLT-PnP and EPnP on the inliers, the seed of least
    truncated MSAC among them and the winner ``model_best`` [12], its pose
    LM (``max_iters`` passes), then the winner where a value is not finite.
    Xw [N,3], pixels and pix_n [N,2], K [3,3] float32, best_mask [N] bool,
    point_mask [N] (any dtype; MSAC's weights), thr_n and ay numbers or 0-d
    tensors (read on the card).  Returns the [12] model."""
    dev, n = Xw.device, Xw.shape[0]
    args = _item_args("refit_pose", 1, (
        (model_best[None], (12,)), (Xw[None], (n, 3)), (pixels[None], (n, 2)),
        (pix_n[None], (n, 2)), (K[None], (3, 3)), (best_mask[None], (n,), torch.bool),
        (point_mask.to(torch.float32)[None], (n,))))
    out = torch.empty(12, dtype=torch.float32, device=dev)
    _build.launch("refit_pose", dev, *args[::2], *_build.f32_arg(thr_n, dev),
                  *_build.f32_arg(ay, dev), n, max_iters, out)
    COUNTS["passes"] += max_iters
    return out


def _ray_scale_residuals(s, rays, ideal, w):
    corr = rays * s[:, None, :]
    corr = corr / torch.clamp(
        torch.linalg.vector_norm(corr, dim=-1, keepdim=True), min=1e-12)
    return ((corr - ideal) * w[..., None]).flatten(1)


def fit_ray_scales(control_dirs_ideal: torch.Tensor, control_rays: torch.Tensor,
                   weights: torch.Tensor | None = None, max_iters: int = 30):
    """3-parameter per-axis ray-scale fit, the counterpart of
    ``scipy.optimize.least_squares(residual_scales_control_points, ...)``
    (test_pro.py:645-680, 882-887): s minimizing
    || normalize(s * ray_i) - ideal_dir_i || over the control rays [C, 3],
    from s = 1.  One problem, run as a batch of one.  Returns (s [3],
    LMResult)."""
    rays = control_rays
    if weights is None:
        w = torch.ones(rays.shape[:-1], dtype=rays.dtype, device=rays.device)
    else:
        w = weights.to(rays.dtype)
    res = levenberg_marquardt(
        _ray_scale_residuals, torch.ones((1, 3), dtype=rays.dtype, device=rays.device),
        (rays[None], control_dirs_ideal[None], w[None]), max_iters=max_iters)
    return res.x[0], res
