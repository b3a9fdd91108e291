"""Patch descriptors and mutual-nearest-neighbour matching (port of
``ransac_tpu.features.match``).

Descriptors are bilinearly sampled, zero-mean, unit-norm intensity
patches; matching is one similarity matmul with a mutual-NN check and a
Lowe ratio test, as masks over fixed-size [K1] match slots.  The matmul
must run in full float32 (TF32 off on the card), as the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Matches(NamedTuple):
    idx1: torch.Tensor   # [..., K1] indices into keypoints 1 (arange)
    idx2: torch.Tensor   # [..., K1] indices into keypoints 2
    valid: torch.Tensor  # [..., K1] bool


def patch_descriptors(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
                      patch: int = 8) -> torch.Tensor:
    """[K, patch^2] descriptors: the (patch+1)^2 window at each keypoint
    (clamped to the image) interpolated at the keypoint's fractional
    offset, zero-mean, unit-norm, zeroed for invalid keypoints.  The JAX
    package selects the window's columns with a one-hot matmul; indexing
    reads the same values."""
    img = img.to(torch.float32)
    H, W = img.shape
    r = patch // 2
    p1 = patch + 1
    fl = torch.floor(xy)
    x0 = torch.clamp(fl[:, 0].long() - r, 0, W - p1)
    y0 = torch.clamp(fl[:, 1].long() - r, 0, H - p1)
    fx = torch.clamp(xy[:, 0] - fl[:, 0], 0.0, 1.0)[:, None, None]
    fy = torch.clamp(xy[:, 1] - fl[:, 1], 0.0, 1.0)[:, None, None]
    off = torch.arange(p1, device=img.device)
    win = img[(y0[:, None] + off)[:, :, None], (x0[:, None] + off)[:, None, :]]
    v = (win[:, :-1, :-1] * (1 - fy) * (1 - fx)
         + win[:, 1:, :-1] * fy * (1 - fx)
         + win[:, :-1, 1:] * (1 - fy) * fx
         + win[:, 1:, 1:] * fy * fx)
    d = v.reshape(v.shape[0], -1)
    d = d - d.mean(-1, keepdim=True)
    norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d / torch.clamp(norm, min=1e-6) * valid[:, None]


def mutual_nn_match(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor,
                    valid2: torch.Tensor, ratio: float = 0.9) -> Matches:
    """Mutual nearest neighbours with the Lowe ratio test on the distance
    sqrt(2 - 2 sim), sim = d1 @ d2^T.  Argmaxes take the first maximum,
    as ``jnp.argmax``.  Leading batch dimensions are allowed (d1 [..., K1,
    D], valid1 [..., K1]): one batched matmul, as the JAX function under
    ``vmap``; every output then has shape [..., K1]."""
    neg = -1e9
    sim = torch.where(valid1[..., :, None] & valid2[..., None, :], d1 @ d2.mT,
                      torch.full((), neg, device=d1.device))
    best_sim = sim.amax(-1)
    best2 = sim.argmax(-1)
    cols = torch.arange(sim.shape[-1], device=sim.device)
    second_sim = torch.where(cols == best2[..., None], neg, sim).amax(-1)
    d_best = torch.sqrt(torch.clamp(2.0 - 2.0 * best_sim, min=0.0))
    d_second = torch.sqrt(torch.clamp(2.0 - 2.0 * second_sim, min=1e-12))
    rows = torch.arange(sim.shape[-2], device=sim.device).expand_as(best2)
    mutual = torch.gather(sim.argmax(-2), -1, best2) == rows
    ok = mutual & (d_best <= ratio * d_second) & valid1 & (best_sim > neg / 2)
    return Matches(idx1=rows, idx2=best2, valid=ok)
