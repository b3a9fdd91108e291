"""The large-pool entry points of the port against the JAX package's,
with the Pallas kernels interpreted and their approximate reciprocal
swapped for the exact one: ``ransac_homography_sweep`` on a pool over 16
points (routed to the large-pool sweep, kernel row 6) and
``ransac_essential_sweep`` (row 8).  Decisions are compared: the inlier
mask and count, the hypotheses run, and the refit essential matrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.models import ransac as jr
from ransac_tpu.ops.pallas import sweep_large as jsl
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import sweep_essential_large as tsel
from ransac_tpu_torch.ops import sweep_large as tsl
from ransac_tpu_torch.utils.config import RansacConfig
from tests.test_torch_essential import THR as E_THR
from tests.test_torch_essential import _jcfg, planted_twoview
from tests.test_torch_sweep_large import THR, planted
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def exact_reciprocal(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jsl.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


def test_ransac_homography_sweep_large_pool_matches_jax(exact_reciprocal):
    """``ransac_homography_sweep`` routes a 100-point pool to the
    large-pool sweep on both sides; the winner's inlier mask and count
    agree, masked (poisoned) points are never inliers."""
    src, dst, n_in = planted(6, n=100, n_out=30)
    mask = np.ones(len(src), np.float32)
    mask[5:12] = 0.0
    src[5:12] = 1e6
    cfg = RansacConfig(threshold=THR, num_hypotheses=4096, exhaustive=False,
                       selection="count")
    res_j = jr.ransac_homography_sweep(jnp.asarray(src), jnp.asarray(dst),
                                       jnp.asarray(mask), _jcfg(cfg), 5, interpret=True)
    res_t = tr.ransac_homography_sweep(torch.from_numpy(src), torch.from_numpy(dst),
                                       torch.from_numpy(mask), cfg, 5)
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    assert int(res_t.num_inliers) == int(res_j.num_inliers) >= 0.9 * (n_in - 7)
    assert res_t.num_hypotheses == res_j.num_hypotheses == 4 * tsl.BLOCK_H
    assert not res_t.inlier_mask[5:12].any()


def test_ransac_essential_sweep_matches_jax_interpret(exact_reciprocal):
    """``ransac_essential_sweep`` on the same 80 correspondences (4 masked
    and poisoned): the same inlier mask as JAX's interpreted version, and
    refit essential matrices equal up to sign within 1e-3."""
    x1, x2, n_in, _, _ = planted_twoview(6, n=80, n_out=20)
    mask = np.ones(80, np.float32)
    mask[:4] = 0.0
    x1[:4] = 50.0
    cfg = RansacConfig(threshold=E_THR, num_hypotheses=4096, exhaustive=False)
    res_j = jr.ransac_essential_sweep(jnp.asarray(x1), jnp.asarray(x2),
                                      jnp.asarray(mask), _jcfg(cfg), 4, interpret=True)
    res_t = tr.ransac_essential_sweep(torch.from_numpy(x1), torch.from_numpy(x2),
                                      torch.from_numpy(mask), cfg, 4)
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    assert not res_t.inlier_mask[:4].any()
    assert int(res_t.num_inliers) >= 0.8 * (n_in - 4)
    assert res_t.num_hypotheses == res_j.num_hypotheses == 4 * tsel.BLOCK_H
    E_t, E_j = res_t.model.numpy(), np.asarray(res_j.model)
    assert min(np.abs(E_t - E_j).max(), np.abs(E_t + E_j).max()) < 1e-3
