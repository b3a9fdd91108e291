"""The plain reference: the deployment's semantics in plain PyTorch, from
the benchmark's own inputs.  Imports nothing of the program.

Localization (main_v1.py:254-312, :332-419, :497-508, :836-930):
  - every candidate camera's east-axis plane projection of the landmarks;
  - homography RANSAC over every C(N, 4) sample: the exact 4-point
    homography of each sample (Hartley-normalized, h22 = 1), OpenCV's
    collinear-sample rejection, forward transfer errors, MSAC selection
    (first index on ties); the winner's inliers (error <= 75 px);
  - the inlier refit: weighted normalized DLT, then 10 Levenberg-Marquardt
    passes on the forward transfer error (damping 1e-3, x10 / x0.1,
    Marquardt's diagonal scaling), a non-finite refit keeping the sample's
    homography;
  - the reference's per-candidate scores: err1 the inliers' pixel errors,
    err2 their plane errors plus 75 per outlier; argmin of err2 (0 and
    non-finite scoring 1e6);
  - PnP RANSAC over every C(N, 3) sample (Grunert's P3P, the quartic's
    real roots from its companion matrix, the pose by Kabsch), MSAC on the
    pixel error at 30 px, then LM on the inliers' reprojection error until
    it converges.

DEM inversion (main_v1.py:547-684): the GeoTIFF's (lat, lon) bilinear
surface resampled onto the scene-centred UTM grid the deployment states,
each pixel's ray K^-1 [u, v, 1] rotated into the world, its z scaled by
the weighted control-point factors (|f| > 2 dropped, inverse-distance
weights capped at 1, the nearest control point x10) and renormalized, and
the 1 m march whose stops only count after 150 steps.

``Prec`` sets the arithmetic: float64 is the reference; float32 with
matrix products in TF32 (``tf32_round`` on both operands, float32 sums, as
the tensor cores take float32 products with TF32 on) is the control, the
precision step below the deployment's float32 with TF32 off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from geodesy import utm_to_wgs84, wgs84_to_utm


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest,
    ties to even)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


@dataclass(frozen=True)
class Prec:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b


REFERENCE = Prec()
CONTROL = Prec(torch.float32, tf32=True)


# ------------------------------------------------------------ homographies
def hartley(pts: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Similarity T taking pts [..., N, 2] to zero (weighted) mean at mean
    distance sqrt(2)."""
    if w is None:
        w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    wsum = w.sum(-1, keepdim=True).clamp(min=1e-12)
    mean = (pts * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    d = torch.linalg.vector_norm(pts - mean, dim=-1)
    s = math.sqrt(2.0) / ((d * w).sum(-1) / wsum[..., 0]).clamp(min=1e-12)
    T = torch.zeros(*s.shape, 3, 3, dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * mean[..., 0, 0]
    T[..., 1, 2] = -s * mean[..., 0, 1]
    T[..., 2, 2] = 1.0
    return T


def homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], -1)


def apply_h(H: torch.Tensor, pts: torch.Tensor, P: Prec) -> torch.Tensor:
    """H [..., 3, 3] applied to pts [..., N, 2]."""
    q = P.mm(homogeneous(pts), H.transpose(-1, -2))
    return q[..., :2] / q[..., 2:]


def _scaled(H: torch.Tensor) -> torch.Tensor:
    s = H[..., 2:3, 2:3]
    return H / torch.where(s.abs() < 1e-12, torch.ones_like(s), s)


def minimal_h(src: torch.Tensor, dst: torch.Tensor, P: Prec):
    """The exact homography of 4-point samples src, dst [..., 4, 2] (h22 =
    1, normalized coordinates).  Returns (H [..., 3, 3], ok [...])."""
    Ts, Td = hartley(src), hartley(dst)
    a = P.mm(homogeneous(src), Ts.transpose(-1, -2))
    b = P.mm(homogeneous(dst), Td.transpose(-1, -2))
    x, y, u, v = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], -2)
    h, info = torch.linalg.solve_ex(A, torch.cat([u, v], -1))
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(*h.shape[:-1], 3, 3)
    H = _scaled(P.mm(P.mm(torch.linalg.inv(Td), Hn), Ts))
    return H, (info == 0) & torch.isfinite(H).all(-1).all(-1)


def collinear(pts: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """True where 3 of a sample's 4 points [..., 4, 2] are (near-)collinear
    (OpenCV's checkSubset)."""
    out = torch.zeros(pts.shape[:-2], dtype=torch.bool, device=pts.device)
    for i, j, k in combinations(range(4), 3):
        a = pts[..., j, :] - pts[..., i, :]
        b = pts[..., k, :] - pts[..., i, :]
        cross = (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]).abs()
        scale = (torch.linalg.vector_norm(a, dim=-1)
                 * torch.linalg.vector_norm(b, dim=-1)).clamp(min=1e-12)
        out |= cross / scale < eps
    return out


def weighted_dlt(src, dst, w, P: Prec) -> torch.Tensor:
    """Normalized DLT over the rows w selects: src, dst [B, N, 2], w [B, N]
    -> H [B, 3, 3] (h22 = 1)."""
    Ts, Td = hartley(src, w), hartley(dst, w)
    a = P.mm(homogeneous(src), Ts.transpose(-1, -2))
    b = P.mm(homogeneous(dst), Td.transpose(-1, -2))
    x, y, u, v = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)], -2)
    A = A * torch.cat([w, w], -1)[..., None]
    _, vec = torch.linalg.eigh(P.mm(A.transpose(-1, -2), A))
    Hn = vec[..., :, 0].reshape(-1, 3, 3)
    return _scaled(P.mm(P.mm(torch.linalg.inv(Td), Hn), Ts))


def lm(residual_and_jacobian, x0, update, iters: int, P: Prec):
    """Levenberg-Marquardt on 0.5 |r|^2 over a batch: damping 1e-3, x10 on
    a rejected step and x0.1 on an accepted one (within [1e-12, 1e8]),
    Marquardt's diagonal scaling, an item done once an accepted step moves
    its cost by <= 1e-10 of it or its damping reaches 1e8."""
    x = x0
    r, J = residual_and_jacobian(x)
    cost = 0.5 * (r * r).sum(-1)
    lam = torch.full_like(cost, 1e-3)
    done = torch.zeros_like(cost, dtype=torch.bool)
    for _ in range(iters):
        if bool(done.all()):
            break
        g = P.mm(J.transpose(-1, -2), r[..., None])[..., 0]
        JtJ = P.mm(J.transpose(-1, -2), J)
        D = torch.diag_embed(JtJ.diagonal(dim1=-2, dim2=-1).clamp(min=1e-12))
        dx, _ = torch.linalg.solve_ex(JtJ + lam[:, None, None] * D, -g)
        x_new = update(x, dx)
        r_new, J_new = residual_and_jacobian(x_new)
        cost_new = 0.5 * (r_new * r_new).sum(-1)
        accept = cost_new < cost
        lam_new = torch.where(accept, (lam * 0.1).clamp(min=1e-12),
                              (lam * 10.0).clamp(max=1e8))
        improved = (cost - cost_new).abs() <= 1e-10 * cost.clamp(min=1e-30)
        step = ~done & accept
        x = torch.where(step.reshape(-1, *[1] * (x.dim() - 1)), x_new, x)
        r = torch.where(step[:, None], r_new, r)
        J = torch.where(step[:, None, None], J_new, J)
        cost = torch.where(step, cost_new, cost)
        lam = torch.where(done, lam, lam_new)
        done = done | (accept & improved) | (lam_new >= 1e8)
    return x


def refine_h(H0, src, dst, w, iters: int, P: Prec) -> torch.Tensor:
    """LM on the weighted forward transfer error over h = H's first 8
    entries (h22 = 1): H0 [B, 3, 3], src, dst [B, N, 2], w [B, N]."""

    def rj(h8):
        H = torch.cat([h8, torch.ones_like(h8[:, :1])], -1).reshape(-1, 3, 3)
        q = P.mm(homogeneous(src), H.transpose(-1, -2))
        den = q[..., 2]
        u, v = q[..., 0] / den, q[..., 1] / den
        x, y = src[..., 0], src[..., 1]
        z, o = torch.zeros_like(x), torch.ones_like(x)
        Ju = torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1) / den[..., None]
        Jv = torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1) / den[..., None]
        r = torch.stack([(u - dst[..., 0]) * w, (v - dst[..., 1]) * w], -1)
        J = torch.stack([Ju * w[..., None], Jv * w[..., None]], -2)
        return r.flatten(1), J.flatten(1, 2)

    h8 = lm(rj, _scaled(H0).reshape(-1, 9)[:, :8], lambda h, d: h + d, iters, P)
    return torch.cat([h8, torch.ones_like(h8[:, :1])], -1).reshape(-1, 3, 3)


# ------------------------------------------------------------ localization
#: An inlier mask under judgement may differ from a sample's where that
#: sample's squared error lies within this share of the bound's square:
#: there float32 and float64 can fall on either side of it.
NEAR_BOUND = 1e-4


def near_bound(r2: torch.Tensor, thr: float) -> torch.Tensor:
    return (r2 - thr * thr).abs() <= NEAR_BOUND * thr * thr


def msac_with_mask(msac: torch.Tensor, masks: torch.Tensor, near: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """MSAC [..., S] of the hypotheses whose inlier mask (masks [..., S, N])
    is ``mask`` [..., 1, N], rows near the bound counting either way; inf
    for the others."""
    return torch.where(((masks == mask) | near).all(-1), msac, math.inf)


@dataclass
class Problem:
    """One photograph against the candidate grid, scene-centred: what both
    sides are given, in the reference's arithmetic."""

    landmarks: torch.Tensor  # [N, 3] centred (E, N, z)
    pixels: torch.Tensor     # [N, 2]
    cams: torch.Tensor       # [C, 3] centred
    grid_codes: torch.Tensor  # [C]
    anchor: np.ndarray       # [3] float64 UTM
    K: torch.Tensor          # [3, 3]


def make_problem(grid_utm, grid_codes, landmarks_utm, pixels, K, P: Prec,
                 device) -> Problem:
    anchor = np.concatenate([landmarks_utm, grid_utm]).mean(0)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=P.dtype, device=device)  # noqa: E731
    return Problem(t(landmarks_utm - anchor), t(pixels), t(grid_utm - anchor),
                   torch.as_tensor(grid_codes, device=device), anchor, t(K))


def plane_points(pb: Problem) -> torch.Tensor:
    """The east-axis plane projection of every landmark from every
    candidate (main_v1.py:306-311): [C, N, 2] = (dz / dE, dN / dE)."""
    p = pb.landmarks[None] - pb.cams[:, None]
    return torch.stack([p[..., 2] / p[..., 0], p[..., 1] / p[..., 0]], -1)


@dataclass
class Search:
    """Every candidate's exhaustive homography RANSAC: per sample its MSAC
    score (px^2, inf where invalid), inlier mask and homography."""

    msac: torch.Tensor   # [C, S]
    masks: torch.Tensor  # [C, S, N] bool
    near: torch.Tensor   # [C, S, N] bool: error within rounding of the bound
    H: torch.Tensor      # [C, S, 3, 3]


def homography_search(pb: Problem, thr: float, P: Prec) -> Search:
    pos2 = plane_points(pb)
    n = pb.pixels.shape[0]
    idx = torch.tensor(list(combinations(range(n), 4)), device=pos2.device)
    src4, dst4 = pos2[:, idx], pb.pixels[idx][None].expand(pos2.shape[0], -1, -1, -1)
    H, ok = minimal_h(src4, dst4, P)
    ok &= ~collinear(src4) & ~collinear(dst4)
    e = torch.linalg.vector_norm(apply_h(H, pos2[:, None], P) - pb.pixels, dim=-1)
    r2 = torch.where(torch.isfinite(e), e * e, math.inf)
    msac = torch.where(ok, r2.clamp(max=thr * thr).sum(-1), math.inf)
    return Search(msac, (r2 <= thr * thr) & ok[..., None], near_bound(r2, thr), H)


def best_of(search: Search):
    """Each candidate's MSAC winner: (sample [C], its mask [C, N])."""
    best = search.msac.argmin(-1)
    rows = torch.arange(best.shape[0], device=best.device)
    return best, search.masks[rows, best]


def scores(pb: Problem, search: Search, masks: torch.Tensor, thr: float,
           refine_iters: int, P: Prec):
    """Refit and score every candidate on its inlier mask [C, N] (the
    reference's own winners, or the answers under judgement).  Each mask's
    fallback homography is that of its best sample.  Returns (H [C, 3, 3],
    err1 [C], err2 [C], best, mask_gap [C]): mask_gap is how far the best
    sample with that mask lies above the best sample, in px^2 of MSAC (inf
    where no sample has that mask)."""
    pos2 = plane_points(pb)
    C = pos2.shape[0]
    msac_m = msac_with_mask(search.msac, search.masks, search.near, masks[:, None])
    k = msac_m.argmin(-1)
    rows = torch.arange(C, device=pos2.device)
    mask_gap = msac_m[rows, k] - search.msac.min(-1).values
    w = masks.to(P.dtype)
    px = pb.pixels[None].expand(C, -1, -1)
    H = refine_h(weighted_dlt(pos2, px, w, P), pos2, px, w, refine_iters, P)
    H = torch.where(torch.isfinite(H).all(-1).all(-1)[:, None, None], H,
                    search.H[rows, k])
    e1 = torch.linalg.vector_norm(apply_h(H, pos2, P) - pb.pixels, dim=-1)
    e2 = torch.linalg.vector_norm(apply_h(torch.linalg.inv(H), px, P) - pos2, dim=-1)
    e1 = torch.where(torch.isfinite(e1), e1, 1e9)
    e2 = torch.where(torch.isfinite(e2), e2, 1e9)
    err1 = (e1 * w).sum(-1)
    err2 = (e2 * w).sum(-1) + (pb.pixels.shape[0] - w.sum(-1)) * thr
    gate = pb.grid_codes >= 0
    err1, err2 = torch.where(gate, err1, 0.0), torch.where(gate, err2, 0.0)
    sel = torch.where((err2 == 0) | ~torch.isfinite(err2), 1e6, err2)
    return H, err1, err2, int(sel.argmin()), mask_gap


# ------------------------------------------------------------ PnP
def rodrigues(v: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.vector_norm(v, dim=-1, keepdim=True)[..., None]
    k = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-30)
    z = torch.zeros_like(k[..., 0])
    Kx = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                      torch.stack([k[..., 2], z, -k[..., 0]], -1),
                      torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand_as(Kx)
    return eye + torch.sin(th) * Kx + (1 - torch.cos(th)) * (Kx @ Kx)


def kabsch(Xw: torch.Tensor, Xc: torch.Tensor, P: Prec):
    """Rigid (R, t) with Xc ~ R Xw + t: Xw, Xc [..., M, 3]."""
    cw, cc = Xw.mean(-2, keepdim=True), Xc.mean(-2, keepdim=True)
    U, _, Vh = torch.linalg.svd(P.mm((Xc - cc).transpose(-1, -2), Xw - cw))
    d = torch.linalg.det(U @ Vh)
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ S @ Vh
    return R, cc[..., 0, :] - P.mm(R, cw.transpose(-1, -2))[..., 0]


def p3p(Xw: torch.Tensor, f: torch.Tensor, P: Prec):
    """Grunert's P3P: world points Xw [S, 3, 3] and unit bearings f [S, 3, 3]
    -> (R [S, 4, 3, 3], t [S, 4, 3], valid [S, 4]).  With v = s3 / s1 and
    u = s2 / s1, the law of cosines reduces to one quartic in v."""
    f1, f2, f3 = f[:, 0], f[:, 1], f[:, 2]
    cos_a, cos_b, cos_g = (f2 * f3).sum(-1), (f1 * f3).sum(-1), (f1 * f2).sum(-1)
    a2 = ((Xw[:, 1] - Xw[:, 2]) ** 2).sum(-1)
    b2 = ((Xw[:, 0] - Xw[:, 2]) ** 2).sum(-1).clamp(min=1e-12)
    c2 = ((Xw[:, 0] - Xw[:, 1]) ** 2).sum(-1)
    ra, rc = a2 / b2, c2 / b2
    # N(v) = (1 - ra + rc) v^2 + 2 (ra - rc) cos_b v + (rc - ra - 1);
    # P(v) = -rc v^2 + 2 rc cos_b v + (1 - rc); D(v) = 2 cos_a v - 2 cos_g.
    n2, n1, n0 = 1 - ra + rc, 2 * (ra - rc) * cos_b, rc - ra - 1
    p2, p1, p0 = -rc, 2 * rc * cos_b, 1 - rc
    d1, d0 = 2 * cos_a, -2 * cos_g
    # N^2 - 2 cos_g N D + P D^2 = 0.
    c4 = n2 * n2 + p2 * d1 * d1
    c3 = 2 * n2 * n1 - 2 * cos_g * n2 * d1 + 2 * p2 * d1 * d0 + p1 * d1 * d1
    c2_ = (2 * n2 * n0 + n1 * n1 - 2 * cos_g * (n2 * d0 + n1 * d1)
           + p2 * d0 * d0 + 2 * p1 * d1 * d0 + p0 * d1 * d1)
    c1 = (2 * n1 * n0 - 2 * cos_g * (n1 * d0 + n0 * d1) + p1 * d0 * d0
          + 2 * p0 * d1 * d0)
    c0 = n0 * n0 - 2 * cos_g * n0 * d0 + p0 * d0 * d0
    comp = torch.zeros(Xw.shape[0], 4, 4, dtype=Xw.dtype, device=Xw.device)
    comp[:, 0] = -torch.stack([c3, c2_, c1, c0], -1) / c4[:, None]
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
    ok = torch.isfinite(comp).all(-1).all(-1)
    roots = torch.linalg.eigvals(torch.where(ok[:, None, None], comp, 0.0))
    v = roots.real
    real = roots.imag.abs() <= 1e-6 * v.abs().clamp(min=1.0)
    D = d1[:, None] * v + d0[:, None]
    u = ((n2[:, None] * v + n1[:, None]) * v + n0[:, None]) / D
    s1 = torch.sqrt(b2[:, None] / (1 + v * v - 2 * v * cos_b[:, None]).clamp(min=1e-12))
    valid = ok[:, None] & real & (v > 1e-6) & (u > 1e-6) & (D.abs() > 1e-9)
    Xc = torch.stack([s1[..., None] * f1[:, None], (u * s1)[..., None] * f2[:, None],
                      (v * s1)[..., None] * f3[:, None]], -2)  # [S, 4, 3, 3]
    Xc = torch.where(valid[..., None, None], Xc, Xw[:, None])
    R, t = kabsch(Xw[:, None].expand_as(Xc), Xc, P)
    return R, t, valid & torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)


def pnp_errors(R, t, X, pix, K, P: Prec) -> torch.Tensor:
    """Pixel reprojection errors [..., N] of poses R [..., 3, 3], t [..., 3];
    inf behind the camera."""
    Xc = P.mm(X, R.transpose(-1, -2)) + t[..., None, :]
    z = Xc[..., 2]
    u = K[0, 0] * Xc[..., 0] / z + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / z + K[1, 2]
    e = torch.sqrt((u - pix[..., 0]) ** 2 + (v - pix[..., 1]) ** 2)
    return torch.where(z > 1e-6, e, math.inf)


@dataclass
class PnpSearch:
    msac: torch.Tensor   # [S * 4] px^2, inf where invalid
    masks: torch.Tensor  # [S * 4, N]
    near: torch.Tensor   # [S * 4, N]
    R: torch.Tensor      # [S * 4, 3, 3]
    t: torch.Tensor      # [S * 4, 3]


def pnp_search(pb: Problem, thr: float, P: Prec) -> PnpSearch:
    X, pix, K = pb.landmarks, pb.pixels, pb.K
    idx = torch.tensor(list(combinations(range(X.shape[0]), 3)), device=X.device)
    xn = torch.stack([(pix[:, 0] - K[0, 2]) / K[0, 0], (pix[:, 1] - K[1, 2]) / K[1, 1]], -1)
    f = homogeneous(xn)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    R, t, valid = p3p(X[idx], f[idx], P)
    R, t, valid = R.flatten(0, 1), t.flatten(0, 1), valid.flatten()
    e = pnp_errors(R, t, X, pix, K, P)
    r2 = torch.where(torch.isfinite(e), e * e, math.inf)
    msac = torch.where(valid, r2.clamp(max=thr * thr).sum(-1), math.inf)
    return PnpSearch(msac, (r2 <= thr * thr) & valid[:, None], near_bound(r2, thr), R, t)


def pnp_mask_gap(search: PnpSearch, mask: torch.Tensor) -> float:
    """How far the best hypothesis with inlier mask ``mask`` [N] lies above
    the best hypothesis, in px^2 of MSAC: 0 where ``mask`` is the winner's,
    inf where no hypothesis has it."""
    msac_m = msac_with_mask(search.msac, search.masks, search.near, mask)
    return float(msac_m.min() - search.msac.min())


def pnp_pose(pb: Problem, search: PnpSearch, mask: torch.Tensor, iters: int,
             P: Prec):
    """The pose refit on ``mask`` [N]: LM on the inliers' reprojection error
    from the best hypothesis with that mask (the best of all where none has
    it).  Returns (R, t)."""
    msac_m = msac_with_mask(search.msac, search.masks, search.near, mask)
    k = int((msac_m if torch.isfinite(msac_m).any() else search.msac).argmin())
    X, pix, K, w = pb.landmarks, pb.pixels, pb.K, mask.to(pb.landmarks.dtype)

    def rj(x):  # x [1, 12]: R (9) and t (3); steps rotate R on the left
        R, t = x[:, :9].reshape(-1, 3, 3), x[:, 9:]
        Xr = P.mm(X, R.transpose(-1, -2))  # [1, N, 3]
        Xc = Xr + t[:, None]
        z = Xc[..., 2]
        u, v = Xc[..., 0] / z, Xc[..., 1] / z
        r = torch.stack([(K[0, 0] * u + K[0, 2] - pix[:, 0]) * w,
                         (K[1, 1] * v + K[1, 2] - pix[:, 1]) * w], -1)
        du = torch.stack([K[0, 0] / z, torch.zeros_like(z), -K[0, 0] * u / z], -1)
        dv = torch.stack([torch.zeros_like(z), K[1, 1] / z, -K[1, 1] * v / z], -1)
        # d Xc / d(rotation) = -[R X]_x, d Xc / dt = I.
        zr = torch.zeros_like(Xr[..., 0])
        skew = torch.stack([torch.stack([zr, Xr[..., 2], -Xr[..., 1]], -1),
                            torch.stack([-Xr[..., 2], zr, Xr[..., 0]], -1),
                            torch.stack([Xr[..., 1], -Xr[..., 0], zr], -1)], -2)
        Ju = torch.cat([(du[..., None, :] @ skew)[..., 0, :], du], -1) * w[..., None]
        Jv = torch.cat([(dv[..., None, :] @ skew)[..., 0, :], dv], -1) * w[..., None]
        return r.flatten(1), torch.stack([Ju, Jv], -2).flatten(1, 2)

    def update(x, d):
        R = rodrigues(d[:, :3]) @ x[:, :9].reshape(-1, 3, 3)
        return torch.cat([R.reshape(-1, 9), x[:, 9:] + d[:, 3:]], -1)

    x = lm(rj, torch.cat([search.R[k].reshape(1, 9), search.t[k][None]], -1),
           update, iters, P)
    return x[0, :9].reshape(3, 3), x[0, 9:]


def camera_origin(pb: Problem, R, t) -> np.ndarray:
    """The camera centre -R^T t, absolute UTM, float64."""
    c = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    return c.detach().cpu().double().numpy() + pb.anchor


# ------------------------------------------------------------ DEM
@dataclass
class Surface:
    """A regular scene-centred UTM grid of elevations (centred z)."""

    data: torch.Tensor  # [H, W]
    x0: float
    y0: float
    dx: float
    dy: float

    @property
    def xmax(self) -> float:
        return self.x0 + self.dx * (self.data.shape[1] - 1)

    @property
    def ymax(self) -> float:
        return self.y0 + self.dy * (self.data.shape[0] - 1)


def _bilinear_np(grid, rows_coord, cols_coord, r, c):
    ri = np.interp(r, rows_coord, np.arange(len(rows_coord)))
    ci = np.interp(c, cols_coord, np.arange(len(cols_coord)))
    r0 = np.clip(np.floor(ri).astype(int), 0, grid.shape[0] - 2)
    c0 = np.clip(np.floor(ci).astype(int), 0, grid.shape[1] - 2)
    fr, fc = ri - r0, ci - c0
    return (grid[r0, c0] * (1 - fr) * (1 - fc) + grid[r0 + 1, c0] * fr * (1 - fc)
            + grid[r0, c0 + 1] * (1 - fr) * fc + grid[r0 + 1, c0 + 1] * fr * fc)


def utm_surface(data, lon, lat, anchor, spacing_m: float, P: Prec, device) -> Surface:
    """The raster's bilinear (lat, lon) surface sampled on the UTM grid of
    ``spacing_m`` that spans the UTM box of its corners, centred on
    ``anchor`` (z too)."""
    data = np.asarray(data, np.float64)
    if lat[0] > lat[-1]:
        lat, data = lat[::-1], data[::-1]
    corners = [(lon.min(), lat.min()), (lon.min(), lat.max()),
               (lon.max(), lat.min()), (lon.max(), lat.max())]
    es, ns = zip(*[wgs84_to_utm(lo, la) for lo, la in corners])
    xs = np.arange(min(es) - anchor[0], max(es) - anchor[0] + spacing_m, spacing_m)
    ys = np.arange(min(ns) - anchor[1], max(ns) - anchor[1] + spacing_m, spacing_m)
    XX, YY = np.meshgrid(xs, ys)
    glon, glat = utm_to_wgs84(XX.ravel() + anchor[0], YY.ravel() + anchor[1])
    glat = np.clip(glat, lat.min(), lat.max())
    glon = np.clip(glon, lon.min(), lon.max())
    z = _bilinear_np(data, lat, lon, glat, glon).reshape(XX.shape) - anchor[2]
    return Surface(torch.as_tensor(z, dtype=P.dtype, device=device), float(xs[0]),
                   float(ys[0]), spacing_m, spacing_m)


def sample(s: Surface, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear elevation at centred (x, y), clamped to the border cells."""
    h, w = s.data.shape
    ci, ri = (x - s.x0) / s.dx, (y - s.y0) / s.dy
    r0 = torch.floor(ri).clamp(0, h - 2)
    c0 = torch.floor(ci).clamp(0, w - 2)
    fr, fc = (ri - r0).clamp(0, 1), (ci - c0).clamp(0, 1)
    i = r0.long() * w + c0.long()
    g = s.data.reshape(-1)
    return (g[i] * (1 - fr) * (1 - fc) + g[i + w] * fr * (1 - fc)
            + g[i + 1] * (1 - fr) * fc + g[i + w + 1] * fr * fc)


def pixel_rays(pixels: torch.Tensor, K: torch.Tensor, R: torch.Tensor, P: Prec):
    """World directions of pixels [M, 2]: K^-1 [u, v, 1], normalized,
    rotated by R^T, normalized."""
    xn = torch.stack([(pixels[:, 0] - K[0, 2]) / K[0, 0],
                      (pixels[:, 1] - K[1, 2]) / K[1, 1]], -1)
    cam = homogeneous(xn)
    cam = cam / torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    world = P.mm(cam, R)
    return world / torch.linalg.vector_norm(world, dim=-1, keepdim=True)


def _control_factors(K, R, origin, ctrl_pixels, ctrl_pos, rc: dict, P: Prec):
    """Each control point's componentwise ideal / computed ray ratio
    (main_v1.py:577-598): (ideal directions [K, 3], computed rays [K, 3],
    factors [K, 3], valid [K]: a finite ideal and every |f| <=
    factor_abs_max)."""
    ideal = ctrl_pos - origin
    nrm = torch.linalg.vector_norm(ideal, dim=-1, keepdim=True)
    ideal = ideal / torch.where(nrm > 0, nrm, 1.0)
    cr = pixel_rays(ctrl_pixels, K, R, P)
    f = ideal / torch.where(cr.abs() < 1e-12, 1e-12, cr)
    return ideal, cr, f, (nrm[:, 0] > 0) & (f.abs() <= rc["factor_abs_max"]).all(-1)


def _control_weights(pixels, ctrl_pixels, valid, rc: dict) -> torch.Tensor:
    """Per query pixel [M] and control point [K], the weight of its factor
    (main_v1.py:600-632): min(1 / d, max_weight), the nearest control
    point's x knn_weight, 0 where the factor is not valid; normalized."""
    d = torch.linalg.vector_norm(pixels[:, None] - ctrl_pixels[None], dim=-1)
    w = torch.where(d == 0, 1.0, 1.0 / torch.where(d == 0, 1.0, d)).clamp(max=rc["max_weight"])
    nearest = torch.nn.functional.one_hot(d.argmin(1), d.shape[1]).to(w.dtype)
    w = w * (1 + (rc["knn_weight"] - 1) * nearest) * valid.to(w.dtype)
    return w / w.sum(1, keepdim=True).clamp(min=1e-12)


def corrected_rays(pixels, K, R, origin, ctrl_pixels, ctrl_pos, rc: dict, P: Prec):
    """The weighted-factor correction (main_v1.py:577-632, 671-678): each
    ray's z scaled by the weighted mean of the control points' z-factors,
    then renormalized."""
    _, _, f, valid = _control_factors(K, R, origin, ctrl_pixels, ctrl_pos, rc, P)
    fz = (_control_weights(pixels, ctrl_pixels, valid, rc) * f[None, :, 2]).sum(1)
    rays = pixel_rays(pixels, K, R, P)
    rays = torch.cat([rays[:, :2], rays[:, 2:] * fz[:, None]], 1)
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


#: One float32 rounding (2^-24) of a unit vector's component: the program's
#: errors there read about a fifth of it (PERF.md).
FLOAT32_ROUNDING = 2.0 ** -24


def correction_tolerance(pixels, K, R, origin, ctrl_pixels, ctrl_pos, rc: dict) -> torch.Tensor:
    """Per ray, the angle (rad) by which float32 rounding of the control
    rays and ideal directions can move the corrected ray, to first order.
    Each factor f_k = ideal_z / ray_z is as ill-conditioned as 1 / |ray_z|
    + 1 / |ideal_z|: a landmark near the horizon makes it so, and the
    nearest control point's x10 weight carries that into every ray near
    it.  A ray's z-factor F moves by FLOAT32_ROUNDING x sum_k w_k |f_k|
    kappa_k (normalized weights), its direction by |r_z| dF / |(r_x, r_y,
    r_z F)|."""
    ideal, cr, f, valid = _control_factors(K, R, origin, ctrl_pixels, ctrl_pos, rc, REFERENCE)
    f = f[:, 2]
    kappa = 1.0 / cr[:, 2].abs() + 1.0 / ideal[:, 2].abs()
    w = _control_weights(pixels, ctrl_pixels, valid, rc)
    dF = FLOAT32_ROUNDING * (w * (f.abs() * kappa)[None]).sum(1)
    F = (w * f[None]).sum(1)
    r = pixel_rays(pixels, K, R, REFERENCE)
    scaled = torch.cat([r[:, :2], r[:, 2:] * F[:, None]], 1)
    return r[:, 2].abs() * dF / torch.linalg.vector_norm(scaled, dim=-1)


def _steps(s: Surface, origin, dirs, g: torch.Tensor, step_m: float):
    """Heights above the surface and distances outside the footprint of
    rays dirs [M, 3] at steps g [M, k]."""
    t = g.to(dirs.dtype) * step_m
    p = origin + t[..., None] * dirs[:, None]
    above = p[..., 2] - sample(s, p[..., 0], p[..., 1])
    out = torch.stack([s.x0 - p[..., 0], p[..., 0] - s.xmax,
                       s.y0 - p[..., 1], p[..., 1] - s.ymax], -1).amax(-1)
    return above, out


def march(s: Surface, origin, dirs, rc: dict, chunk: int = 256):
    """The 1 m march: the first step at or past min_hit_step that is at or
    under the surface inside the footprint (a hit), or the first outside it,
    within max_steps.  Returns (stop step [M], hit [M])."""
    max_steps = int(rc["max_search_dist_m"] / rc["step_m"])
    m, dev = dirs.shape[0], dirs.device
    stop = torch.full((m,), max_steps, dtype=torch.long, device=dev)
    hit = torch.zeros(m, dtype=torch.bool, device=dev)
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    for g0 in range(0, max_steps, chunk):
        live = (~done).nonzero()[:, 0]
        if live.numel() == 0:
            break
        g = torch.arange(g0, min(g0 + chunk, max_steps), device=dev)
        above, out = _steps(s, origin, dirs[live], g[None].expand(live.numel(), -1),
                            rc["step_m"])
        hit_k = (g >= rc["min_hit_step"]) & (above <= 0) & (out <= 0)
        stop_k = hit_k | (out > 0)
        any_k = stop_k.any(1)
        first = stop_k.to(torch.uint8).argmax(1)
        sel = live[any_k]
        stop[sel] = g0 + first[any_k]
        hit[sel] = hit_k[any_k, first[any_k]]
        done[sel] = True
    return stop, hit


def stop_violations(s: Surface, origin, dirs, stop, hit, rc: dict, chunk: int = 256):
    """How far each claimed stop (step [M], hit [M]) is from the march's
    rule, in meters, on the rays dirs: before the stop every step is inside
    the footprint and, from min_hit_step on, above the surface; a hit lies
    at or under the surface inside it, past min_hit_step; any other stop
    short of max_steps lies outside the footprint."""
    max_steps = int(rc["max_search_dist_m"] / rc["step_m"])
    m, dev = dirs.shape[0], dirs.device
    viol = torch.zeros(m, dtype=dirs.dtype, device=dev)
    for g0 in range(0, int(stop.max()) + 1, chunk):
        live = (stop >= g0).nonzero()[:, 0]
        g = torch.arange(g0, g0 + chunk, device=dev)[None].expand(live.numel(), -1)
        above, out = _steps(s, origin, dirs[live], g, rc["step_m"])
        st = stop[live, None]
        before = g < st
        at = (g == st) & (st < max_steps)
        v = torch.where(before, out.clamp(min=0), 0.0)
        v = torch.maximum(v, torch.where(before & (g >= rc["min_hit_step"]),
                                         (-above).clamp(min=0), 0.0))
        h = hit[live, None]
        v_at = torch.where(h, torch.maximum(above.clamp(min=0), out.clamp(min=0)),
                           (-out).clamp(min=0))
        v_at = torch.where(h & (g < rc["min_hit_step"]), math.inf, v_at)
        v = torch.maximum(v, torch.where(at, v_at, 0.0))
        viol[live] = torch.maximum(viol[live], v.amax(1))
    return viol
