"""The fused-sweep entry point ``ransac_homography_sweep`` of the port
against that of
``ransac_tpu.models.ransac``, with the Pallas kernels run in interpret mode
and their approximate reciprocal swapped for the exact one (as in
``test_torch_sweep.py`` and ``test_torch_sweep_pnp.py``).

Decisions are compared: the winning record, the per-record counts, the
inlier mask and count.  The refit model through its transfer errors on
the inliers (within 0.05 px; the LM valley of the refit is flat).
``ransac_pnp_sweep`` is held to the JAX package in
``test_torch_sweep_pnp_api.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.models import ransac as jr
from ransac_tpu.ops import homography as jh
from ransac_tpu.ops.pallas import sweep as jsw
from ransac_tpu.utils.config import RansacConfig as JRansacConfig
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import homography as th
from ransac_tpu_torch.utils.config import RansacConfig
from tests.test_torch_sweep import planted
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def exact_reciprocal(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jsw.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


def test_ransac_homography_sweep_matches_jax(exact_reciprocal):
    src, dst, mask = planted(0)
    res_j = jr.ransac_homography_sweep(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        JRansacConfig(threshold=75.0, num_hypotheses=4096), 3, interpret=True)
    res_t = tr.ransac_homography_sweep(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        RansacConfig(threshold=75.0, num_hypotheses=4096), 3)
    assert int(res_t.best_index) == int(res_j.best_index)
    np.testing.assert_array_equal(res_t.counts.numpy(), np.asarray(res_j.counts))
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    assert int(res_t.num_inliers) == int(res_j.num_inliers) == 10
    assert res_t.num_hypotheses == 4096
    inl = np.asarray(res_j.inlier_mask)
    e_t = th.transfer_errors(res_t.model, torch.from_numpy(src[inl]),
                             torch.from_numpy(dst[inl])).numpy()
    e_j = np.asarray(jh.transfer_errors(res_j.model, jnp.asarray(src[inl]),
                                        jnp.asarray(dst[inl])))
    np.testing.assert_allclose(e_t, e_j, atol=0.05)
