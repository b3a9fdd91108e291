"""Explicit-generator sampling of minimal sets (port of
``ransac_tpu.utils.prng``).

Every random choice flows from an explicit ``torch.Generator`` (never the
global RNG), so runs are reproducible.  ``generator_for`` stands where
``key_for`` stood; the bits differ from ``jax.random``'s, so the port is
held to the JAX package by distributions, not by values.
"""

from __future__ import annotations

import torch

_M63 = (1 << 63) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


def fold_seed(seed: int, *folds: int) -> int:
    """A 63-bit seed mixed from ``seed`` and each fold in turn, on the host
    (a seed for a kernel, or for ``generator_for``)."""
    s = int(seed) & ((1 << 64) - 1)
    for f in folds:
        s = _splitmix64(s ^ (int(f) & ((1 << 64) - 1)))
    return s & _M63


def generator_for(seed: int, *folds: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` with each fold mixed
    in (the counterpart of ``key_for(seed, *folds)``)."""
    g = torch.Generator(device=device)
    g.manual_seed(fold_seed(seed, *folds))
    return g


def sample_without_replacement(
    generator: torch.Generator, num_samples: int, sample_size: int,
    num_points: int, point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """[S, k] int64 tensor of uniform k-subsets of the valid points, on the
    generator's device; with a ``point_mask`` of shape [..., N] the result
    is [..., S, k], one draw per leading index.

    Two paths, as in the JAX package:

    - no mask and k <= 8: Fisher-Yates index adjustment; draw r_j uniform
      over [0, n - j) and shift it past the earlier picks in ascending
      order (no sort over the hypothesis tensor);
    - otherwise: top-k of uniforms (the first k of a random permutation),
      with -inf priority on masked points (needs >= k valid points).
    """
    device = generator.device
    if point_mask is None and sample_size <= 8:
        return _fisher_yates_indices(generator, num_samples, sample_size,
                                     num_points)
    lead = () if point_mask is None else tuple(point_mask.shape[:-1])
    u = torch.rand((*lead, num_samples, num_points), generator=generator,
                   device=device)
    if point_mask is not None:
        u = torch.where(point_mask.to(device)[..., None, :] > 0, u, -torch.inf)
    return torch.topk(u, sample_size, dim=-1).indices


def _fisher_yates_indices(generator, num_samples: int, k: int, n: int):
    device = generator.device
    chosen: list[torch.Tensor] = []
    for j in range(k):
        r = torch.randint(0, n - j, (num_samples,), generator=generator,
                          device=device)
        sorted_prev: list[torch.Tensor] = []
        for p in chosen:
            inserted = p
            out = []
            for s in sorted_prev:
                out.append(torch.minimum(s, inserted))
                inserted = torch.maximum(s, inserted)
            out.append(inserted)
            sorted_prev = out
        for s in sorted_prev:
            r = r + (r >= s).long()
        chosen.append(r)
    return torch.stack(chosen, dim=1)
