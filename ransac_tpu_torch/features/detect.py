"""Harris corner detection, the two-view front end (port of
``ransac_tpu.features.detect``).

Gradients and structure tensors are separable 'same' correlations with
zero padding (the JAX package writes each 1-D pass as a banded matmul;
``conv2d`` computes the same sums, in float32 on the card too: cuDNN's
TF32 is turned off around them), non-maximum suppression is a max-pool
window, and the corners are the exact top K of the masked response, with a
quadratic subpixel refinement.  Fixed output shape [max_keypoints] with a
valid mask.  JAX's default ``approx_topk=True`` is a TPU approximation;
the port always selects exactly (``torch.topk``), as JAX does with
``approx_topk=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    xy: torch.Tensor     # [K, 2] (x, y) pixel coordinates, subpixel refined
    score: torch.Tensor  # [K] Harris response (0 in invalid slots)
    valid: torch.Tensor  # [K] bool (slots beyond the real corners are False)


def _taps(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _sep_corr(img: torch.Tensor, row_taps: torch.Tensor,
              col_taps: torch.Tensor) -> torch.Tensor:
    """Separable 'same' correlation, zero padded: ``row_taps`` along axis 0
    (down columns), then ``col_taps`` along axis 1."""
    r = row_taps.shape[0] // 2
    c = col_taps.shape[0] // 2
    cudnn = torch.backends.cudnn
    # float32 sums, as the JAX package's: cuDNN may otherwise run the
    # convolutions in TF32 (its default allow_tf32 is True).
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        x = F.conv2d(img[None, None], row_taps.reshape(1, 1, -1, 1), padding=(r, 0))
        return F.conv2d(x, col_taps.reshape(1, 1, 1, -1), padding=(0, c))[0, 0]


def gauss_taps(sigma: float, radius: int, device="cpu") -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def harris_response(img: torch.Tensor, k: float = 0.04,
                    sigma: float = 1.5) -> torch.Tensor:
    """Harris corner response map of a [H, W] float image in [0, 1]:
    Sobel gradients (smooth [1, 2, 1] / 4, derivative [-1, 0, 1] / 2),
    Gaussian-weighted structure tensor, det - k trace^2."""
    img = img.to(torch.float32)
    smooth = _taps([0.25, 0.5, 0.25], img.device)
    deriv = _taps([-0.5, 0.0, 0.5], img.device)
    gx = _sep_corr(img, smooth, deriv)
    gy = _sep_corr(img, deriv, smooth)
    g = gauss_taps(sigma, max(2, int(2 * sigma)), img.device)
    sxx = _sep_corr(gx * gx, g, g)
    syy = _sep_corr(gy * gy, g, g)
    sxy = _sep_corr(gx * gy, g, g)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def detect_harris(img: torch.Tensor, max_keypoints: int = 512,
                  nms_radius: int = 4, k: float = 0.04,
                  border: int = 8) -> Keypoints:
    """Top-K Harris corners: strict window maxima (NMS over a
    (2 nms_radius + 1)^2 window) with positive response away from the
    border, the exact top K by response, and quadratic subpixel refinement
    on the response surface."""
    resp = harris_response(img, k)
    H, W = resp.shape
    win = 2 * nms_radius + 1
    local_max = F.max_pool2d(resp[None, None], win, stride=1,
                             padding=nms_radius)[0, 0]
    yy = torch.arange(H, device=resp.device)[:, None]
    xx = torch.arange(W, device=resp.device)[None, :]
    in_border = ((yy >= border) & (yy < H - border)
                 & (xx >= border) & (xx < W - border))
    score = torch.where((resp >= local_max) & in_border & (resp > 0), resp,
                        -torch.inf)
    top_scores, top_idx = torch.topk(score.reshape(-1), max_keypoints)
    ys = (top_idx // W).to(torch.float32)
    xs = (top_idx % W).to(torch.float32)
    valid = torch.isfinite(top_scores)

    planes = torch.stack([resp, resp.roll(1, 1), resp.roll(-1, 1),
                          resp.roll(1, 0), resp.roll(-1, 0)], -1)
    c, lf, rt, up, dn = planes.reshape(-1, 5)[top_idx].unbind(-1)
    dx = (rt - lf) / 2.0
    dy = (dn - up) / 2.0
    dxx = rt + lf - 2 * c
    dyy = dn + up - 2 * c
    zero = torch.zeros_like(dx)
    ox = torch.where(dxx.abs() > 1e-9, -dx / dxx, zero)
    oy = torch.where(dyy.abs() > 1e-9, -dy / dyy, zero)
    xy = torch.stack([torch.where(valid, xs + ox.clamp(-0.5, 0.5), zero),
                      torch.where(valid, ys + oy.clamp(-0.5, 0.5), zero)], -1)
    return Keypoints(xy=xy, score=torch.where(valid, top_scores, zero),
                     valid=valid)
