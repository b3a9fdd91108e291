"""Pinhole camera projection (port of ``ransac_tpu.ops.projection``).

Conventions: world-to-camera pose (R, t); x_cam = R @ X + t; pixel =
K @ x_cam / z.  All functions take leading batch dimensions.  Distortion
is OpenCV's (k1, k2, p1, p2, k3) model, as in the JAX package.
"""

from __future__ import annotations

import torch

from ransac_tpu_torch.ops.linalg import _guard
from ransac_tpu_torch.utils.logging import host_sync


def intrinsics_from_physical(
    focal_length_mm: float,
    sensor_width_mm: float,
    sensor_height_mm: float,
    width_px: float,
    height_px: float,
    cx: float,
    cy: float,
    dtype=torch.float32,
    device="cpu",
) -> torch.Tensor:
    """K from physical film parameters (main_v1.py:869-883):
    fx = f/sensor_w * W, fy = f/sensor_h * H."""
    fx = focal_length_mm / sensor_width_mm * width_px
    fy = focal_length_mm / sensor_height_mm * height_px
    with host_sync("intrinsics_from_physical"):  # a blocking copy to ``device``
        return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                            dtype=dtype, device=device)


def project_points(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                   K: torch.Tensor, dist: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Project world points [...,N,3] with pose (R [...,3,3], t [...,3]),
    through the distortion ``dist`` [..., 5] where given.  Returns (pixels
    [...,N,2], depth [...,N]); points behind the camera still give finite
    pixels (guarded divide), the caller masks on depth."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    inv_z = 1.0 / _guard(z, 1e-12)
    xn = Xc[..., 0] * inv_z
    yn = Xc[..., 1] * inv_z
    if dist is not None:
        xn, yn = distort(xn, yn, dist[..., None, :])
    u = K[..., 0, 0, None] * xn + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * yn + K[..., 1, 2, None]
    return torch.stack([u, v], dim=-1), z


def distort(xn, yn, dist):
    """OpenCV (k1, k2, p1, p2, k3) distortion of normalized coordinates;
    ``dist[..., i]`` broadcasts against xn and yn."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    y = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return x, y


def undistort_normalized(xd, yd, dist, iters: int = 8):
    """Invert :func:`distort` by ``iters`` fixed-point iterations (OpenCV's
    algorithm, the JAX function's count)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def normalize_pixels(pixels: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels [...,N,2] -> normalized camera coords (K^-1 applied)."""
    x = (pixels[..., 0] - K[..., 0, 2, None]) / K[..., 0, 0, None]
    y = (pixels[..., 1] - K[..., 1, 2, None]) / K[..., 1, 1, None]
    return torch.stack([x, y], dim=-1)


def pixel_to_ray(pixels: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                 force_unit_z: bool = False) -> torch.Tensor:
    """Batched camera ray directions in the world frame (main_v1.py:547-574):
    K^-1 [u, v, 1], normalized, rotated by R^T, normalized again.
    ``force_unit_z=True`` is the test_pro.py:565-596 variant that keeps the
    camera-frame z at 1 before the rotation.  pixels [..., N, 2], K and R
    [..., 3, 3] -> [..., N, 3]."""
    xn = normalize_pixels(pixels, K)
    cam = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    if not force_unit_z:
        cam = cam / torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    world = cam @ R  # R^T @ cam for each row
    return world / torch.linalg.vector_norm(world, dim=-1, keepdim=True)


def east_axis_plane_projection(
    pos3d: torch.Tensor, camera_location: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's candidate-camera projection (main_v1.py:306-311):
    p = pos3d - camera_location (E, N, z), optical axis fixed along
    +easting, plane coordinates (dz/dE, dN/dE).  Returns (pos2 [...,N,2],
    d_east [...,N])."""
    p = pos3d - camera_location[..., None, :]
    d_east = p[..., 0]
    inv = 1.0 / _guard(d_east, 1e-12)
    return torch.stack([p[..., 2] * inv, p[..., 1] * inv], dim=-1), d_east
