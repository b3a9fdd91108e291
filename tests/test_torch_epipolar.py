"""The two-view epipolar ops of the port (``ransac_tpu_torch.ops.epipolar``)
and the stage-wise essential-matrix engine (``models.ransac.ransac_essential``)
against the JAX package, on the planted correspondences of
``tests/test_torch_essential.py``.

The ops are held to JAX's (jitted) results within float32 tolerances.  The
engine draws its random 8-point samples from a torch generator, not JAX's
key, so the two pick different winners; they are held to the same
consensus quality and to poses within a few milliradians.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ransac_tpu.models import ransac as jr
from ransac_tpu.ops import epipolar as je
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import epipolar as te
from ransac_tpu_torch.ops.rotation import log_so3
from ransac_tpu_torch.utils.config import RansacConfig
from tests.test_torch_essential import THR, _jcfg, planted_twoview
from torch_threads import one_torch_thread  # noqa: F401


def test_ransac_essential_engine_matches_jax_consensus():
    """The stage-wise engine draws its random 8-point samples from another
    generator than JAX's, so the winners differ: both keep >= 60% of the
    planted inliers and no outlier, and the poses recovered from the refit
    essential matrices agree within 5 mrad with each other and 10 mrad
    with the truth."""
    x1, x2, n_in, R, t = planted_twoview(7, n=60, n_out=15, noise=0.25 / 600.0)
    mask = np.ones(60, np.float32)
    cfg = RansacConfig(threshold=THR, num_hypotheses=1024, exhaustive=False)
    res_j = jr.ransac_essential(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                _jcfg(cfg), jax.random.key(0))
    res_t = tr.ransac_essential(torch.from_numpy(x1), torch.from_numpy(x2),
                                torch.from_numpy(mask), cfg, 0)
    for m in (res_t.inlier_mask.numpy(), np.asarray(res_j.inlier_mask)):
        assert m[:n_in].sum() >= 0.6 * n_in and not m[n_in:].any()
    w = torch.from_numpy(np.ones(60, np.float32))
    w[n_in:] = 0.0
    R_t, t_t, _, _ = te.recover_pose(res_t.model, torch.from_numpy(x1),
                                     torch.from_numpy(x2), w)
    R_j, t_j, _, _ = jax.jit(je.recover_pose)(res_j.model, jnp.asarray(x1),
                                              jnp.asarray(x2), jnp.asarray(w.numpy()))
    assert float(torch.linalg.vector_norm(
        log_so3(R_t @ torch.from_numpy(np.asarray(R_j)).T))) < 5e-3
    assert float(torch.linalg.vector_norm(
        log_so3(R_t @ torch.from_numpy(R).float().T))) < 1e-2
    assert float(t_t @ torch.from_numpy(np.asarray(t_j))) > 0.999


def test_epipolar_ops_match_jax():
    """eight_point (weighted and not), sampson_distance, decompose_essential,
    recover_pose (triangulation, cheirality) and refine_relative_pose on the
    same inlier set: the port equals JAX (jitted) within float32
    tolerances."""
    x1, x2, n_in, R, t = planted_twoview(8, n=50, n_out=10)
    w = np.zeros(50, np.float32)
    w[:n_in] = 1.0
    a1, a2, aw = (torch.from_numpy(a) for a in (x1, x2, w))
    j1, j2, jw = (jnp.asarray(a) for a in (x1, x2, w))
    eight_point = jax.jit(je.eight_point)
    for weights in (None, w):
        E_t = te.eight_point(a1, a2, None if weights is None else aw)
        E_j = np.asarray(eight_point(j1, j2, None if weights is None else jw))
        assert min(np.abs(E_t.numpy() - E_j).max(), np.abs(E_t.numpy() + E_j).max()) < 2e-4
    E = E_j
    np.testing.assert_allclose(
        te.sampson_distance(torch.from_numpy(E), a1, a2).numpy(),
        np.asarray(jax.jit(je.sampson_distance)(jnp.asarray(E), j1, j2)),
        rtol=1e-4, atol=1e-12)
    Rs_t, ts_t = te.decompose_essential(torch.from_numpy(E))
    Rs_j, ts_j = jax.jit(je.decompose_essential)(jnp.asarray(E))
    np.testing.assert_allclose(Rs_t.numpy(), np.asarray(Rs_j), atol=2e-5)
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), atol=2e-5)
    R_t, t_t, X_t, n_t = te.recover_pose(torch.from_numpy(E), a1, a2, aw)
    R_j, t_j, X_j, n_j = jax.jit(je.recover_pose)(jnp.asarray(E), j1, j2, jw)
    assert int(n_t) == int(n_j) == n_in
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=2e-5)
    np.testing.assert_allclose(X_t.numpy()[:n_in], np.asarray(X_j)[:n_in], rtol=1e-3,
                               atol=1e-3)
    Rr_t, tr_t, _ = te.refine_relative_pose(R_t, t_t, a1, a2, aw)
    Rr_j, tr_j, _ = jax.jit(je.refine_relative_pose)(R_j, t_j, j1, j2, jw)
    np.testing.assert_allclose(Rr_t.numpy(), np.asarray(Rr_j), atol=1e-4)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), atol=1e-4)
    assert float(torch.linalg.vector_norm(
        log_so3(Rr_t.double() @ torch.from_numpy(R).T))) < 2e-2
