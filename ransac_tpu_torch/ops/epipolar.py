"""Two-view epipolar geometry: normalized 8-point F/E, Sampson distance,
pose decomposition, DLT triangulation, cheirality and the relative-pose LM
(port of ``ransac_tpu.ops.epipolar``).

Batched over leading dimensions ``[...]`` like the rest of the port; the
closed-form 3x3 SVD (``linalg.svd3x3``) and the inverse-iteration
nullspace (``linalg.nullspace_last_fast``) carry the linear algebra.
"""

from __future__ import annotations

import torch

from ransac_tpu_torch.ops.homography import normalization_transform
from ransac_tpu_torch.ops.linalg import nullspace_last_fast, svd3x3
from ransac_tpu_torch.ops.lm import levenberg_marquardt
from ransac_tpu_torch.ops.rotation import exp_so3, hat, log_so3


def _hom(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def eight_point(x1: torch.Tensor, x2: torch.Tensor,
                weights: torch.Tensor | None = None, essential: bool = True,
                rank2: bool = True) -> torch.Tensor:
    """Normalized 8-point algorithm on [..., N>=8, 2] correspondences.

    Returns F (or E) [..., 3, 3] of unit Frobenius norm.  The rank-2 (for
    E: equal singular values) constraint is enforced after
    denormalization, as the JAX package does; ``rank2=False`` returns the
    unconstrained linear solution."""
    T1 = normalization_transform(x1, weights)
    T2 = normalization_transform(x2, weights)
    p1 = _hom(x1) @ T1.transpose(-1, -2)
    p2 = _hom(x2) @ T2.transpose(-1, -2)
    u1, v1, u2, v2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], -1)
    if weights is not None:
        A = A * weights[..., None]
    f = nullspace_last_fast(A)
    F = T2.transpose(-1, -2) @ f.reshape(*f.shape[:-1], 3, 3) @ T1
    if rank2:
        U, S, Vt = svd3x3(F)
        if essential:
            s = (S[..., 0] + S[..., 1]) / 2.0
            S2 = torch.stack([s, s, torch.zeros_like(s)], -1)
        else:
            S2 = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
        F = (U * S2[..., None, :]) @ Vt
    norm = torch.linalg.vector_norm(F.flatten(-2), dim=-1)
    return F / torch.clamp(norm, min=1e-12)[..., None, None]


def sampson_distance(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """First-order geometric (Sampson) distance, squared, per
    correspondence: F [..., 3, 3], x1/x2 [..., N, 2] -> [..., N]."""
    p1, p2 = _hom(x1), _hom(x2)
    Fx1 = p1 @ F.transpose(-1, -2)     # [..., N, 3]: F p1
    Ftx2 = p2 @ F                      # [..., N, 3]: F^T p2
    x2Fx1 = (p2 * Fx1).sum(-1)
    denom = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
             + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return x2Fx1 * x2Fx1 / torch.clamp(denom, min=1e-12)


def decompose_essential(E: torch.Tensor):
    """E -> the four (R, t), |t| = 1: (R1, t), (R1, -t), (R2, t), (R2, -t).
    Returns (R [..., 4, 3, 3], t [..., 4, 3])."""
    U, _, Vt = svd3x3(E)
    detU = torch.linalg.det(U)
    detV = torch.linalg.det(Vt)
    one = torch.ones_like(detU)
    U = U * torch.stack([one, one, detU], -1)[..., None, :]
    Vt = Vt * torch.stack([one, one, detV], -1)[..., :, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], -3), torch.stack([t, -t, t, -t], -2)


def triangulate_dlt(x1, x2, R1, t1, R2, t2):
    """DLT triangulation of [..., N, 2] normalized correspondences seen
    from (R1, t1) and (R2, t2).  Returns world points [..., N, 3]."""
    P1 = torch.cat([R1, t1[..., :, None]], -1)  # [..., 3, 4]
    P2 = torch.cat([R2, t2[..., :, None]], -1)

    def rows(P, x):
        r1 = x[..., 0, None] * P[..., None, 2, :] - P[..., None, 0, :]
        r2 = x[..., 1, None] * P[..., None, 2, :] - P[..., None, 1, :]
        return torch.stack([r1, r2], -2)         # [..., N, 2, 4]

    X = nullspace_last_fast(torch.cat([rows(P1, x1), rows(P2, x2)], -2))
    w = X[..., 3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


def cheirality_counts(x1, x2, R, t, weights=None):
    """Points in front of both views for the relative pose (R, t), view 1
    at the identity: (count [...], points [..., N, 3])."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R)
    X = triangulate_dlt(x1, x2, eye, torch.zeros_like(t), R, t)
    z2 = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    ok = (X[..., 2] > 0) & (z2 > 0)
    if weights is not None:
        ok = ok & (weights > 0)
    return ok.sum(-1), X


def recover_pose(E: torch.Tensor, x1, x2, weights=None):
    """``cv2.recoverPose``: the decomposition of E with the most points in
    front of both views.  Returns (R, t, points3d, n_cheiral)."""
    Rs, ts = decompose_essential(E)
    counts, Xs = [], []
    for k in range(4):
        c, X = cheirality_counts(x1, x2, Rs[..., k, :, :], ts[..., k, :], weights)
        counts.append(c)
        Xs.append(X)
    counts = torch.stack(counts, -1)
    best = counts.argmax(-1)  # first maximum, as jnp.argmax
    Xs = torch.stack(Xs, -3)  # [..., 4, N, 3]

    def take(a, trailing):
        idx = best.reshape(*best.shape, 1, *([1] * len(trailing)))
        return a.gather(best.dim(), idx.expand(*best.shape, 1, *trailing)
                        ).squeeze(best.dim())

    return (take(Rs, (3, 3)), take(ts, (3,)), take(Xs, Xs.shape[-2:]),
            counts.gather(-1, best[..., None])[..., 0])


def _build_E(params: torch.Tensor) -> torch.Tensor:
    """E = [t/|t|]x exp(rvec) of params [B, 6] = (rvec, t)."""
    tv = params[:, 3:]
    tn = tv / torch.clamp(torch.linalg.vector_norm(tv, dim=-1, keepdim=True),
                          min=1e-12)
    return hat(tn) @ exp_so3(params[:, :3])


def _sampson_residuals(params, x1, x2, w):
    d2 = sampson_distance(_build_E(params), x1, x2)
    return torch.sqrt(torch.clamp(d2, min=1e-20)) * w


def refine_relative_pose(R: torch.Tensor, t: torch.Tensor, x1, x2,
                         weights=None, max_iters: int = 20):
    """LM on the inlier Sampson residuals of E = [t]x R over (rvec, t),
    the norm gauge absorbed by the damping.  One problem: R [3,3], t [3],
    x1/x2 [N,2], weights [N].  Returns (R, t_unit, E)."""
    w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device) \
        if weights is None else weights.to(x1.dtype)
    x0 = torch.cat([log_so3(R), t])[None]
    res = levenberg_marquardt(_sampson_residuals, x0,
                              (x1[None], x2[None], w[None]),
                              max_iters=max_iters)
    x = res.x[0]
    tr = x[3:] / torch.clamp(torch.linalg.vector_norm(x[3:]), min=1e-12)
    return exp_so3(x[:3]), tr, _build_E(res.x)[0]
