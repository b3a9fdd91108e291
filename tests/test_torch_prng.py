"""The port's minimal-set sampler (``ransac_tpu_torch.utils.prng``) against
``ransac_tpu.utils.prng``, and the random branch of the port's RANSAC
engine against the JAX engine's.

``torch.Generator`` and ``jax.random`` give different bits from one seed,
so the sampler is held to distributions: no repeated index in a sample,
masked points never drawn, all C(n, k) subsets equally likely (chi-square
over 2^16 draws, p > 1e-3, on both paths, and a two-sample chi-square
against the JAX sampler's draws).  The engines, given the same easy
problems, must find the same inlier sets.
"""

from itertools import combinations
from math import comb

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ransac_tpu.models import ransac as jr
from ransac_tpu.utils import prng as jprng
from ransac_tpu.utils.config import RansacConfig as JRansacConfig
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.utils import prng as tprng
from ransac_tpu_torch.utils.config import RansacConfig
from tests.test_torch_ransac import _h_planted, _pnp_planted
from torch_threads import one_torch_thread  # noqa: F401

S = 1 << 16


def subset_counts(idx: np.ndarray, n: int) -> np.ndarray:
    """Histogram of the drawn k-subsets over all C(n, k) of them."""
    k = idx.shape[1]
    code = {c: i for i, c in enumerate(combinations(range(n), k))}
    keys = [code[tuple(row)] for row in np.sort(idx, 1).tolist()]
    return np.bincount(keys, minlength=comb(n, k))


def check_samples(idx: np.ndarray, n: int, allowed=None):
    srt = np.sort(idx, 1)
    assert (srt[:, 1:] != srt[:, :-1]).all()  # no repeated index
    assert idx.min() >= 0 and idx.max() < n
    if allowed is not None:
        assert np.isin(idx, allowed).all()


def test_fisher_yates_path_is_uniform_over_subsets():
    g = tprng.generator_for(0)
    idx = tprng.sample_without_replacement(g, S, 4, 13).numpy()
    assert idx.shape == (S, 4)
    check_samples(idx, 13)
    counts = subset_counts(idx, 13)
    assert len(counts) == 715
    assert stats.chisquare(counts).pvalue > 1e-3


def test_masked_path_never_draws_masked_points_and_is_uniform():
    mask = torch.ones(13)
    mask[[2, 7, 11]] = 0.0
    idx = tprng.sample_without_replacement(
        tprng.generator_for(1), S, 4, 13, mask).numpy()
    allowed = np.nonzero(mask.numpy())[0]
    check_samples(idx, 13, allowed)
    counts = subset_counts(np.searchsorted(allowed, idx), len(allowed))
    assert stats.chisquare(counts).pvalue > 1e-3


def test_batched_masks_draw_per_problem():
    mask = torch.ones(3, 10)
    mask[0, :4] = 0.0
    mask[2, 5:] = 0.0
    idx = tprng.sample_without_replacement(tprng.generator_for(2), 512, 3, 10, mask)
    assert idx.shape == (3, 512, 3)
    for b in range(3):
        check_samples(idx[b].numpy(), 10, np.nonzero(mask[b].numpy())[0])


def test_distribution_matches_jax_sampler():
    """Two-sample chi-square between the port's and the JAX sampler's
    subset histograms, both paths."""
    for mask in (None, np.array([1] * 5 + [0] + [1] * 7, np.float32)):
        t = tprng.sample_without_replacement(
            tprng.generator_for(3), S, 4, 13,
            None if mask is None else torch.from_numpy(mask)).numpy()
        j = np.asarray(jprng.sample_without_replacement(
            jprng.key_for(3), S, 4, 13, None if mask is None else jnp.asarray(mask)))
        ct, cj = subset_counts(t, 13), subset_counts(j, 13)
        keep = (ct + cj) > 0
        assert stats.chi2_contingency(np.stack([ct[keep], cj[keep]])).pvalue > 1e-3


def test_generator_for_is_deterministic_and_folds_differ():
    a = tprng.sample_without_replacement(tprng.generator_for(5, 1), 64, 4, 13)
    b = tprng.sample_without_replacement(tprng.generator_for(5, 1), 64, 4, 13)
    c = tprng.sample_without_replacement(tprng.generator_for(5, 2), 64, 4, 13)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_random_branch_homography_matches_jax():
    src, dst, mask = _h_planted(21, n=30, n_out=6)
    cfg = dict(threshold=75.0, num_hypotheses=2048, exhaustive=False)
    res_t = tr.ransac_homography(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(mask), RansacConfig(**cfg), 7)
    res_j = jr.ransac_homography(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(mask), JRansacConfig(**cfg),
                                 jax.random.key(7))
    assert res_t.num_hypotheses == res_j.num_hypotheses == 2048
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    assert int(res_t.num_inliers) == 24


@pytest.mark.parametrize("solver", ["p3p", "epnp"])
def test_random_branch_pnp_matches_jax(solver):
    X, pix, K, mask, R, t = _pnp_planted(22, n=13)
    cfg = dict(threshold=8.0, num_hypotheses=1024, exhaustive=False)
    res_t = tr.ransac_pnp(torch.from_numpy(X), torch.from_numpy(pix),
                          torch.from_numpy(K), torch.from_numpy(mask),
                          RansacConfig(**cfg), 4, solver=solver)
    res_j = jr.ransac_pnp(jnp.asarray(X), jnp.asarray(pix), jnp.asarray(K),
                          jnp.asarray(mask), JRansacConfig(**cfg),
                          jax.random.key(4), solver=solver)
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    assert int(res_t.num_inliers) == 10
    _, tt = tr.pnp_pose_from_result(res_t)
    np.testing.assert_allclose(tt.numpy(), t, atol=0.05)
