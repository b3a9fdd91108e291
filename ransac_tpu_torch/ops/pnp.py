"""Perspective-n-Point solvers: P3P (Grunert), EPnP, DLT-PnP (port of
``ransac_tpu.ops.pnp``).

Each solver is a batched function over leading dimensions, so one call
solves every minimal sample of the hypothesis tensor.  The P3P quartic is
solved closed-form (``linalg.solve_quartic_real``) as in the JAX package;
EPnP takes its control axes from the closed-form ``linalg.eigh3x3`` and
its kernel vectors from ``torch.linalg.eigh`` of the 12 x 12 M^T M (the
one host read of the PnP refit on the card: torch has no form of ``eigh``
that skips the check of its info).

Conventions: world-to-camera (R, t), x_cam = R @ X + t.
"""

from __future__ import annotations

import torch

from ransac_tpu_torch.ops.linalg import (_cross, _guard, eigh3x3, inv3x3,
                                         nullspace_last_fast,
                                         solve_quartic_real, solve_unrolled)
from ransac_tpu_torch.ops.rotation import project_to_so3
from ransac_tpu_torch.utils.logging import host_sync


def bearing_vectors(pixels_norm: torch.Tensor) -> torch.Tensor:
    """Normalized image coords [...,N,2] -> unit bearing vectors [...,N,3]."""
    v = torch.cat([pixels_norm, torch.ones_like(pixels_norm[..., :1])], -1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _weights(X, weights):
    if weights is None:
        return torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    return weights.to(X.dtype)


def absolute_orientation(Xw: torch.Tensor, Xc: torch.Tensor,
                         weights: torch.Tensor | None = None):
    """Weighted Kabsch: rigid (R, t) minimizing ||(R Xw + t) - Xc||.
    Xw/Xc [...,N,3].  Returns (R [...,3,3], t [...,3])."""
    w = _weights(Xw, weights)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    cw = (Xw * w[..., None]).sum(-2) / wsum
    cc = (Xc * w[..., None]).sum(-2) / wsum
    Aw = Xw - cw[..., None, :]
    Ac = Xc - cc[..., None, :]
    H = (Ac * w[..., None]).transpose(-1, -2) @ Aw
    R = project_to_so3(H)
    return R, cc - (R @ cw[..., None])[..., 0]


def triad_orientation(Xw: torch.Tensor, Xc: torch.Tensor):
    """Exact 3-point absolute orientation via triangle frames (the P3P
    back-substitution case).  Xw/Xc [...,3,3] (rows = points).  Returns
    (R, t) with Xc ~ R @ Xw + t."""

    def triad(P):
        u = P[..., 1, :] - P[..., 0, :]
        v = P[..., 2, :] - P[..., 0, :]
        e1 = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                             min=1e-12)
        v_perp = v - (v * e1).sum(-1, keepdim=True) * e1
        e2 = v_perp / torch.clamp(
            torch.linalg.vector_norm(v_perp, dim=-1, keepdim=True), min=1e-12)
        return torch.stack([e1, e2, _cross(e1, e2)], dim=-1)  # columns

    R = triad(Xc) @ triad(Xw).transpose(-1, -2)
    t = Xc.mean(-2) - (R @ Xw.mean(-2)[..., None])[..., 0]
    return R, t


def p3p_grunert(Xw: torch.Tensor, pixels_norm: torch.Tensor):
    """Grunert's P3P on minimal samples.

    Xw [...,3,3] world points, pixels_norm [...,3,2] normalized image
    coords.  Returns (R [...,4,3,3], t [...,4,3], valid [...,4]): up to 4
    solutions, invalid slots masked.  The law-of-cosines system reduces by
    resultant elimination to one quartic in v (s3 = v s1); each real
    positive root gives one pose through the triad orientation.
    """
    f = bearing_vectors(pixels_norm)  # [...,3,3]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = Xw[..., 0, :], Xw[..., 1, :], Xw[..., 2, :]

    cos_a = (f2 * f3).sum(-1)  # angle opposite side a = |P2-P3|
    cos_b = (f1 * f3).sum(-1)
    cos_g = (f1 * f2).sum(-1)
    a2 = ((P2 - P3) ** 2).sum(-1)
    b2 = ((P1 - P3) ** 2).sum(-1)
    c2 = ((P1 - P2) ** 2).sum(-1)
    b2 = torch.where(b2 < 1e-12, torch.full_like(b2, 1e-12), b2)
    ra = a2 / b2
    rc = c2 / b2

    qa2, qa1, qa0 = ra, -2.0 * ra * cos_b, ra
    qc2, qc1, qc0 = rc, -2.0 * rc * cos_b, rc
    # N(v) = v^2 - Qa - 1 + Qc ;  P(v) = 1 - Qc ;  D(v) = 2 cos_a v - 2 cos_g.
    n2, n1, n0 = 1.0 - qa2 + qc2, -qa1 + qc1, -qa0 - 1.0 + qc0
    p2, p1, p0 = -qc2, -qc1, 1.0 - qc0
    d1, d0 = 2.0 * cos_a, -2.0 * cos_g

    # Quartic N^2 - 2 cos_g N D + P D^2 = 0.
    c4 = n2 * n2 + p2 * d1 * d1
    c3 = 2 * n2 * n1 - 2 * cos_g * (n2 * d1) + 2 * p2 * d1 * d0 + p1 * d1 * d1
    c2_ = (2 * n2 * n0 + n1 * n1 - 2 * cos_g * (n2 * d0 + n1 * d1)
           + p2 * d0 * d0 + 2 * p1 * d1 * d0 + p0 * d1 * d1)
    c1 = (2 * n1 * n0 - 2 * cos_g * (n1 * d0 + n0 * d1)
          + p1 * d0 * d0 + 2 * p0 * d1 * d0)
    c0 = n0 * n0 - 2 * cos_g * (n0 * d0) + p0 * d0 * d0

    v, v_ok = solve_quartic_real(c4, c3, c2_, c1, c0)  # [...,4]

    # Back-substitute each root.
    D = d1[..., None] * v + d0[..., None]
    N = (n2[..., None] * v + n1[..., None]) * v + n0[..., None]
    u = N / _guard(D, 1e-9)
    s1 = torch.sqrt(b2[..., None] / torch.clamp(
        1.0 + v * v - 2.0 * v * cos_b[..., None], min=1e-12))
    s2 = u * s1
    s3 = v * s1
    valid = v_ok & (v > 1e-6) & (u > 1e-6) & (D.abs() > 1e-9)

    # Newton polish of the depths on the exact law-of-cosines system
    # (closed-form zero-diagonal 3x3 solve), steps clamped to 10% of s1.
    ca, cb, cg = cos_a[..., None], cos_b[..., None], cos_g[..., None]
    a2e, b2e, c2e = a2[..., None], b2[..., None], c2[..., None]
    for _ in range(3):
        r1 = -(s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * ca - a2e)
        r2 = -(s1 * s1 + s3 * s3 - 2.0 * s1 * s3 * cb - b2e)
        r3 = -(s1 * s1 + s2 * s2 - 2.0 * s1 * s2 * cg - c2e)
        j12 = 2 * s2 - 2 * s3 * ca
        j13 = 2 * s3 - 2 * s2 * ca
        j21 = 2 * s1 - 2 * s3 * cb
        j23 = 2 * s3 - 2 * s1 * cb
        j31 = 2 * s1 - 2 * s2 * cg
        j32 = 2 * s2 - 2 * s1 * cg
        det = j13 * j21 * j32 + j12 * j23 * j31
        inv_det = 1.0 / _guard(det, 1e-9)
        ds1 = (r1 * (-j23 * j32) - j12 * (r2 * 0.0 - j23 * r3)
               + j13 * (r2 * j32 - 0.0)) * inv_det
        ds2 = (0.0 - r1 * (j21 * 0.0 - j23 * j31)
               + j13 * (j21 * r3 - r2 * j31)) * inv_det
        ds3 = (0.0 - j12 * (j21 * r3 - r2 * j31)
               + r1 * (j21 * j32 - 0.0)) * inv_det
        lim = 0.1 * s1.abs() + 1e-6
        s1 = s1 + torch.clamp(ds1, -lim, lim)
        s2 = s2 + torch.clamp(ds2, -lim, lim)
        s3 = s3 + torch.clamp(ds3, -lim, lim)
    valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # Camera-frame points for all 4 roots: [...,4,3,3].
    Xc = torch.stack([
        s1[..., None] * f1[..., None, :],
        s2[..., None] * f2[..., None, :],
        s3[..., None] * f3[..., None, :],
    ], dim=-2)
    R, t = triad_orientation(Xw[..., None, :, :].expand_as(Xc), Xc)
    return R, t, valid


def epnp(Xw: torch.Tensor, pixels_norm: torch.Tensor,
         weights: torch.Tensor | None = None):
    """EPnP (Lepetit et al.) for N>=4 points in normalized coords.

    Returns both beta-case candidates for the caller to pick by
    reprojection error: (R [...,2,3,3], t [...,2,3], valid [...,2]).
    """
    w = _weights(Xw, weights)
    wsum = torch.clamp(w.sum(-1), min=1e-12)

    # Control points: centroid + principal axes.
    c0 = (Xw * w[..., None]).sum(-2) / wsum[..., None]
    Xc0 = (Xw - c0[..., None, :]) * w[..., None]
    cov = Xc0.transpose(-1, -2) @ Xc0 / wsum[..., None, None]
    # The closed form reads nothing back: torch.linalg.eigh checks its info
    # on the host (a device wait on the card).
    eval_, evec = eigh3x3(cov)  # ascending
    scale = torch.sqrt(torch.clamp(eval_, min=1e-10))
    ctrl = torch.cat([
        c0[..., None, :],
        c0[..., None, :] + scale[..., :, None] * evec.transpose(-1, -2),
    ], dim=-2)  # [...,4,3]

    # Barycentric coordinates: solve [ctrl^T; 1] alpha = [X; 1].
    ones_row = torch.ones((*ctrl.shape[:-2], 1, 4), dtype=ctrl.dtype,
                          device=ctrl.device)
    CT = torch.cat([ctrl.transpose(-1, -2), ones_row], dim=-2)
    Xh = torch.cat([Xw, torch.ones_like(Xw[..., :1])], -1)  # [...,N,4]
    alphas, _ = solve_unrolled(
        CT[..., None, :, :].expand(*Xw.shape[:-1], 4, 4), Xh)  # [...,N,4]

    # M (2N x 12), columns j*3+k = control point j, coordinate k.
    u = pixels_norm[..., 0]
    v = pixels_norm[..., 1]
    zeros = torch.zeros_like(u)
    cols_x, cols_y = [], []
    for j in range(4):
        a = alphas[..., j]
        cols_x += [a, zeros, -u * a]
        cols_y += [zeros, a, -v * a]
    M = torch.cat([torch.stack(cols_x, -1) * w[..., None],
                   torch.stack(cols_y, -1) * w[..., None]], dim=-2)

    with host_sync("epnp.eigh"):  # eigh reads its info back to check it
        _, eigvec = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    V = eigvec[..., :, 0]   # kernel vector (smallest eigenvalue), [...,12]
    V2 = eigvec[..., :, 1]

    iu0, iu1 = torch.triu_indices(4, 4, offset=1, device=Xw.device)
    dw = ctrl[..., None, :, :] - ctrl[..., :, None, :]
    dist_w = torch.sqrt(torch.clamp((dw * dw).sum(-1), min=1e-12))[..., iu0, iu1]

    def signed(cc_cam):
        # Depths must be positive for the majority of points.
        Xcam = alphas @ cc_cam
        sign = torch.where((Xcam[..., 2] * w).sum(-1) < 0, -1.0, 1.0)
        return Xcam * sign[..., None, None]

    def case1(Vk):
        cc = Vk.reshape(*Vk.shape[:-1], 4, 3)
        dc = cc[..., None, :, :] - cc[..., :, None, :]
        dist_c = torch.sqrt(torch.clamp((dc * dc).sum(-1), min=1e-20))[..., iu0, iu1]
        beta = (dist_w * dist_c).sum(-1) / torch.clamp(
            (dist_c ** 2).sum(-1), min=1e-20)
        return signed(beta[..., None, None] * cc)

    def case2(Vk1, Vk2):
        # v1 + lam v2 from the distance constraints: linear least squares
        # in (b1^2, b1 b2, b2^2), then sqrt.
        cc1 = Vk1.reshape(*Vk1.shape[:-1], 4, 3)
        cc2 = Vk2.reshape(*Vk2.shape[:-1], 4, 3)
        d1 = (cc1[..., None, :, :] - cc1[..., :, None, :])[..., iu0, iu1, :]
        d2 = (cc2[..., None, :, :] - cc2[..., :, None, :])[..., iu0, iu1, :]
        A = torch.stack([(d1 * d1).sum(-1), 2.0 * (d1 * d2).sum(-1),
                         (d2 * d2).sum(-1)], -1)  # [...,6,3]
        rhs = dist_w ** 2
        AtA = A.transpose(-1, -2) @ A
        Atb = (A.transpose(-1, -2) @ rhs[..., None])[..., 0]
        sol = (inv3x3(AtA, eps=1e-9) @ Atb[..., None])[..., 0]
        b1 = torch.sqrt(torch.clamp(sol[..., 0], min=1e-20))
        b2 = sol[..., 1] / torch.clamp(b1, min=1e-10)
        return signed(b1[..., None, None] * cc1 + b2[..., None, None] * cc2)

    R1, t1 = absolute_orientation(Xw, case1(V), w)
    R2, t2 = absolute_orientation(Xw, case2(V, V2), w)
    R = torch.stack([R1, R2], dim=-3)
    t = torch.stack([t1, t2], dim=-2)
    valid = torch.ones(R.shape[:-2], dtype=torch.bool, device=R.device)
    return R, t, valid


def dlt_pnp(Xw: torch.Tensor, pixels_norm: torch.Tensor,
            weights: torch.Tensor | None = None):
    """Linear PnP from N>=6 points via DLT on P = [R|t] (normalized
    coords), then SO(3) projection."""
    w = _weights(Xw, weights)
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    u, v = pixels_norm[..., 0], pixels_norm[..., 1]
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero,
                      -u * X, -u * Y, -u * Z, -u], -1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one,
                      -v * X, -v * Y, -v * Z, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    p = nullspace_last_fast(A)
    P = p.reshape(*p.shape[:-1], 3, 4)
    # Scale and sign: force det(R) > 0.
    sign = torch.where(torch.linalg.det(P[..., :3]) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    s = torch.clamp(torch.linalg.det(P[..., :3]).abs() ** (1.0 / 3.0), min=1e-12)
    R = project_to_so3(P[..., :3] / s[..., None, None])
    return R, P[..., 3] / s[..., None]
