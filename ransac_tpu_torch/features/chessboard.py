"""Checkerboard corner detection and grid ordering (port of
``ransac_tpu.features.chessboard``).

The counterpart of ``cv2.findChessboardCorners`` + ``cv2.cornerSubPix``
(``testpro.py:270-276``), the image front end of ``models.calibration``.
Inner corners are saddle points: a strong negative determinant of the
smoothed Hessian.  The response is computed on the image's device, with
the JAX function's full 2-D Gaussian (``conv2d`` in float32: cuDNN's TF32
is turned off around it, as in ``detect._sep_corr``); window maxima by
``max_pool2d``, the exact top K, and the chessboard's own quadratic
subpixel step (clipped to +-1 px, guarded at 1e-12).  Ordering the grid
is host work on the few detections, in numpy as in the JAX package, with
the port's DLT homography on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ransac_tpu_torch.features.detect import gauss_taps
from ransac_tpu_torch.ops import homography as hops


def _conv2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'same' 2-D correlation with zero padding of an odd-sized kernel, in
    float32 on the card too."""
    kh, kw = kernel.shape
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(img[None, None], kernel[None, None],
                        padding=(kh // 2, kw // 2))[0, 0]


def _gauss_kernel(sigma: float, radius: int, device) -> torch.Tensor:
    g = gauss_taps(sigma, radius, device)
    return g[:, None] * g[None, :]


def saddle_response(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """-det(Hessian) of the smoothed image: positive at X-junctions."""
    img = img.to(torch.float32)
    dev = img.device

    def taps(rows):
        return torch.tensor(rows, dtype=torch.float32, device=dev)

    sm = _conv2(img, _gauss_kernel(sigma, max(2, int(2 * sigma)), dev))
    dxx = _conv2(sm, taps([[1.0, -2.0, 1.0]]))
    dyy = _conv2(sm, taps([[1.0], [-2.0], [1.0]]))
    dxy = _conv2(sm, taps([[0.25, 0, -0.25], [0, 0, 0], [-0.25, 0, 0.25]]))
    return -(dxx * dyy - dxy * dxy)


def detect_saddles(img: torch.Tensor, max_corners: int, nms_radius: int = 5,
                   border: int = 4):
    """Top-K saddle points with window NMS and quadratic subpixel
    refinement.  Returns numpy (xy [K, 2], scores [K], valid [K])."""
    resp = saddle_response(img)
    H, W = resp.shape
    win = 2 * nms_radius + 1
    local_max = F.max_pool2d(resp[None, None], win, stride=1,
                             padding=nms_radius)[0, 0]
    yy = torch.arange(H, device=resp.device)[:, None]
    xx = torch.arange(W, device=resp.device)[None, :]
    inside = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    score = torch.where((resp >= local_max) & inside & (resp > 0), resp, -torch.inf)
    top_scores, top_idx = torch.topk(score.reshape(-1), max_corners)
    ys = (top_idx // W).to(torch.float32)
    xs = (top_idx % W).to(torch.float32)
    valid = torch.isfinite(top_scores)

    # The neighbours by rolls: a valid peak lies inside the border, where
    # they are the JAX function's; an invalid slot is dropped by the caller.
    planes = torch.stack([resp, resp.roll(1, 1), resp.roll(-1, 1),
                          resp.roll(1, 0), resp.roll(-1, 0)], -1)
    c, lf, rt, up, dn = planes.reshape(-1, 5)[top_idx].unbind(-1)
    dx = (rt - lf) / 2.0
    dy = (dn - up) / 2.0
    dxx = rt + lf - 2 * c
    dyy = dn + up - 2 * c
    zero = torch.zeros_like(dx)
    ox = torch.where(dxx.abs() > 1e-12, -dx / dxx, zero)
    oy = torch.where(dyy.abs() > 1e-12, -dy / dyy, zero)
    xy = torch.stack([xs + ox.clamp(-1.0, 1.0), ys + oy.clamp(-1.0, 1.0)], -1)
    return xy.cpu().numpy(), top_scores.cpu().numpy(), valid.cpu().numpy()


def _dlt(src: np.ndarray, dst: np.ndarray) -> torch.Tensor:
    return hops.dlt_homography(torch.as_tensor(src, dtype=torch.float32),
                               torch.as_tensor(dst, dtype=torch.float32))


def _apply(H: torch.Tensor, pts: np.ndarray) -> np.ndarray:
    return hops.apply_h(H, torch.as_tensor(pts, dtype=torch.float32)).numpy()


def order_grid(points: np.ndarray, cols: int, rows: int,
               tol_frac: float = 0.35):
    """Order detected corners into row-major (cols x rows) grid order by
    anchor-homography fitting.  Returns [rows * cols, 2] or None."""
    pts = np.asarray(points, np.float64)
    if len(pts) < cols * rows:
        return None
    # Anchor candidates: the extremal points along the two diagonals.
    s = pts[:, 0] + pts[:, 1]
    d = pts[:, 0] - pts[:, 1]
    anchors = np.array([pts[np.argmin(s)], pts[np.argmax(d)],
                        pts[np.argmax(s)], pts[np.argmin(d)]])  # TL, TR, BR, BL
    unit_corners = np.array([[0.0, 0.0], [cols - 1.0, 0.0],
                             [cols - 1.0, rows - 1.0], [0.0, rows - 1.0]])
    grid = np.stack(np.meshgrid(np.arange(cols), np.arange(rows)),
                    -1).reshape(-1, 2).astype(np.float64)
    best = None
    for rot in range(4):
        pred = _apply(_dlt(unit_corners, np.roll(anchors, -rot, axis=0)), grid)
        # Each grid node takes its nearest detection (all distinct).
        d2 = ((pred[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        assign = np.argmin(d2, axis=1)
        dmin = np.sqrt(d2[np.arange(len(grid)), assign])
        spacing = np.median(np.sqrt(((pred[1:cols] - pred[:cols - 1]) ** 2).sum(-1)))
        ok = (len(set(assign.tolist())) == len(grid)
              and (dmin < tol_frac * spacing).all())
        err = dmin.mean()
        if ok and (best is None or err < best[0]):
            best = (err, assign)
    if best is None:
        return None
    # Refine with a full-grid homography and assign once more.
    pred = _apply(_dlt(grid, pts[best[1]]), grid)
    d2 = ((pred[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    assign = np.argmin(d2, axis=1)
    if len(set(assign.tolist())) != len(grid):
        return None
    return pts[assign]


def find_chessboard_corners(img, cols: int, rows: int, nms_radius: int = 5,
                            device="cuda"):
    """``cv2.findChessboardCorners``: (found, corners [rows * cols, 2]
    row-major in float64, or None).  ``cols`` and ``rows`` count INNER
    corners.  ``img`` (a tensor or an array, [H, W] or [H, W, C], averaged)
    is detected on ``device``; pass ``device="cpu"`` for the host."""
    img = torch.as_tensor(img, device=device).to(torch.float32)
    if img.dim() == 3:
        img = img.mean(-1)
    n_need = cols * rows
    pts, scores, valid = detect_saddles(img, max_corners=2 * n_need,
                                        nms_radius=nms_radius)
    pts, scores = pts[valid], scores[valid]
    if len(pts) < n_need:
        return False, None
    # Board saddles dominate the response: keep the peaks within a factor of
    # the weakest expected corner, dropping background clutter.
    order = np.argsort(scores)[::-1]
    keep = scores >= 0.5 * scores[order[n_need - 1]]
    ordered = order_grid(pts[keep], cols, rows)
    if ordered is None:
        return False, None
    return True, ordered
