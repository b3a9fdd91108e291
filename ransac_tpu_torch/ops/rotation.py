"""SO(3) operations: Rodrigues exp/log maps (port of
``ransac_tpu.ops.rotation``).

Closed-form, branch-free (``torch.where``) and differentiable under
``torch.func.jacfwd``: the pose LM differentiates ``exp_so3``.
"""

from __future__ import annotations

import torch

from ransac_tpu_torch.ops.linalg import svd3x3

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [...,3] -> [...,3,3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def exp_so3(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector [...,3] -> rotation matrix [...,3,3],
    with 2nd-order Taylor coefficients below sqrt(eps)."""
    theta2 = (rvec * rvec).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS) - _EPS  # ~theta, smooth at 0
    small = theta2 < 1e-8
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    K = hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0, by a
    branch-free Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    best = torch.stack([qw2, qx2, qy2, qz2], dim=-1).argmax(dim=-1)
    cand = torch.stack([cw, cx, cy, cz], dim=-2)  # [...,4,4]
    q = cand.gather(-2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rvec_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation vector."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-8),
                        theta / torch.where(small, torch.ones_like(vnorm), vnorm))
    return v * scale[..., None]


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues through the quaternion (stable near pi)."""
    return rvec_from_quat(quat_from_matrix(R))


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix (Frobenius) via the closed-form SVD."""
    U, _, Vt = svd3x3(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vt
