"""Homography estimation: normalized DLT, 4-point minimal and N-point
least squares (port of ``ransac_tpu.ops.homography``).

OpenCV ``findHomography`` semantics: forward transfer error as the
residual, least-squares refit on the inlier set.  Inputs take leading
batch dimensions, so one call solves a whole [candidates, samples] batch.
"""

from __future__ import annotations

import math

import torch

from ransac_tpu_torch.ops.linalg import (_guard, inv3x3, nullspace_last_fast,
                                         solve_unrolled)
from ransac_tpu_torch.utils.logging import host_sync


def normalization_transform(pts: torch.Tensor, mask: torch.Tensor | None = None):
    """Hartley normalization: similarity T with T@pts zero-mean at mean
    distance sqrt(2).  pts [...,N,2]; mask [...,N] optional weights."""
    if mask is None:
        w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    else:
        w = mask.to(pts.dtype)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    mean = (pts * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    d = torch.linalg.vector_norm(pts - mean, dim=-1)
    mean_d = (d * w).sum(-1, keepdim=True) / wsum
    s = (math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12))[..., 0]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zeros, -s * mx], -1),
        torch.stack([zeros, s, -s * my], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)


def apply_h(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply homography [...,3,3] to [...,N,2] -> [...,N,2] (guarded w)."""
    x, y = pts[..., 0], pts[..., 1]
    w = _guard(H[..., 2, 0, None] * x + H[..., 2, 1, None] * y
               + H[..., 2, 2, None], 1e-12)
    u = (H[..., 0, 0, None] * x + H[..., 0, 1, None] * y + H[..., 0, 2, None]) / w
    v = (H[..., 1, 0, None] * x + H[..., 1, 1, None] * y + H[..., 1, 2, None]) / w
    return torch.stack([u, v], dim=-1)


def _normalized_rows(src, dst, Ts, Td):
    ones = torch.ones_like(src[..., :1])
    sh = torch.cat([src, ones], -1) @ Ts.transpose(-1, -2)
    dh = torch.cat([dst, ones], -1) @ Td.transpose(-1, -2)
    return sh[..., 0], sh[..., 1], dh[..., 0], dh[..., 1]


def dlt_homography(src: torch.Tensor, dst: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized DLT: H minimizing the algebraic error of dst ~ H src.

    src/dst [...,N,2], N>=4; ``weights`` [...,N] soft-selects rows (inlier
    refit without dynamic shapes).  Returns H [...,3,3] with H[2,2]=1
    where possible.
    """
    Ts = normalization_transform(src, weights)
    Td = normalization_transform(dst, weights)
    x, y, u, v = _normalized_rows(src, dst, Ts, Td)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    row2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([row1, row2], dim=-2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    h = nullspace_last_fast(A)
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    H = inv3x3(Td) @ (Hn @ Ts)  # denormalize: H = Td^-1 Hn Ts
    s = H[..., 2:3, 2:3]
    return H / torch.where(s.abs() < 1e-12, torch.ones_like(s), s)


def dlt_homography_minimal(src: torch.Tensor, dst: torch.Tensor):
    """Exact 4-point homography via the normalized 8x8 solve (h22=1).

    h22=0 configurations surface as bad pivots -> ok=False.  src/dst
    [...,4,2].  Returns (H [...,3,3], ok [...]).
    """
    Ts = normalization_transform(src)
    Td = normalization_transform(dst)
    x, y, u, v = _normalized_rows(src, dst, Ts, Td)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    A = torch.cat([r1, r2], dim=-2)                       # [...,8,8]
    b = torch.cat([u, v], dim=-1)                         # [...,8]
    h8, ok = solve_unrolled(A, b)
    Hn = torch.cat([h8, torch.ones_like(h8[..., :1])], -1)
    Hn = Hn.reshape(*Hn.shape[:-1], 3, 3)
    # Closed-form similarity inverse of Td = [[s,0,-s mx],[0,s,-s my],[0,0,1]].
    s = Td[..., 0, 0]
    mx = -Td[..., 0, 2] / s
    my = -Td[..., 1, 2] / s
    inv_s = 1.0 / s
    zeros = torch.zeros_like(s)
    ones_ = torch.ones_like(s)
    Td_inv = torch.stack([
        torch.stack([inv_s, zeros, mx], -1),
        torch.stack([zeros, inv_s, my], -1),
        torch.stack([zeros, zeros, ones_], -1),
    ], dim=-2)
    H = Td_inv @ Hn @ Ts
    h22 = H[..., 2:3, 2:3]
    H = H / torch.where(h22.abs() < 1e-12, torch.ones_like(h22), h22)
    ok = ok & torch.isfinite(H).all(-1).all(-1)
    return H, ok


def transfer_errors(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """Forward transfer distance per point (OpenCV's findHomography
    RANSAC residual)."""
    return torch.linalg.vector_norm(apply_h(H, src) - dst, dim=-1)


def sample_is_degenerate(pts: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """True if any 3 of the 4 sample points [...,4,2] are (near-)collinear
    (OpenCV's checkSubset rejection)."""
    with host_sync("sample_is_degenerate"):  # a blocking copy to the device
        idx3 = torch.tensor([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]],
                            device=pts.device)
    tri = pts[..., idx3, :]  # [...,4,3,2]
    a = tri[..., 1, :] - tri[..., 0, :]
    b = tri[..., 2, :] - tri[..., 0, :]
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    scale = torch.clamp(torch.linalg.vector_norm(a, dim=-1)
                        * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
    return (cross.abs() / scale < eps).any(-1)
