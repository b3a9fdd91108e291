"""The port's RANSAC engine (``ransac_tpu_torch.models.ransac``) against
``ransac_tpu.models.ransac`` on planted problems: the same winning sample
and inlier mask, and the refit model within tolerance (homography maps
rtol 1e-3 on the inliers; poses by geodesic < 1e-3 rad and translation
rtol 1e-3)."""

from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.models import ransac as jr
from ransac_tpu.ops import homography as jh
from ransac_tpu.utils.config import RansacConfig as JRansacConfig
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import homography as th
from ransac_tpu_torch.utils.config import RansacConfig
from ransac_tpu_torch.utils.prng import generator_for
from torch_threads import one_torch_thread  # noqa: F401


def f32(a):
    return np.asarray(a, np.float32)


def _h_planted(seed, n=13, n_out=3):
    rng = np.random.default_rng(seed)
    H = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0], [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, (n, 2))
    x, y = src[:, 0], src[:, 1]
    w = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    dst = np.stack([(H[0, 0] * x + H[0, 1] * y + H[0, 2]) / w,
                    (H[1, 0] * x + H[1, 1] * y + H[1, 2]) / w], 1)
    dst += rng.normal(scale=1.0, size=dst.shape)
    dst[n - n_out:] += 300.0
    mask = np.ones(n, np.float32)
    return f32(src), f32(dst), mask


@pytest.mark.parametrize("seed,masked", [(0, False), (1, True)])
def test_ransac_homography_matches_jax(seed, masked):
    src, dst, mask = _h_planted(seed)
    if masked:
        mask[[0, 4]] = 0.0
    cfg = RansacConfig(threshold=75.0)
    res_t = tr.ransac_homography(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(mask), cfg)
    res_j = jr.ransac_homography(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(mask), JRansacConfig(threshold=75.0),
                                 jax.random.key(0))
    assert int(res_t.best_index) == int(res_j.best_index)
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    np.testing.assert_array_equal(res_t.counts.numpy(), np.asarray(res_j.counts))
    assert res_t.num_hypotheses == res_j.num_hypotheses == 715
    inl = np.asarray(res_j.inlier_mask)
    np.testing.assert_allclose(
        th.apply_h(res_t.model, torch.from_numpy(src[inl])).numpy(),
        np.asarray(jh.apply_h(res_j.model, jnp.asarray(src[inl]))),
        rtol=1e-3, atol=0.05)
    assert not inl[10:].any() and inl[:10][mask[:10] > 0].all()


def test_ransac_homography_batch_equals_single():
    probs = [_h_planted(s) for s in (2, 3, 4)]
    src = torch.from_numpy(np.stack([p[0] for p in probs]))
    dst = torch.from_numpy(np.stack([p[1] for p in probs]))
    mask = torch.from_numpy(np.stack([p[2] for p in probs]))
    cfg = RansacConfig(threshold=75.0)
    batch = tr.ransac_homography(src, dst, mask, cfg)
    for b in range(3):
        one = tr.ransac_homography(src[b], dst[b], mask[b], cfg)
        assert int(one.best_index) == int(batch.best_index[b])
        assert torch.equal(one.inlier_mask, batch.inlier_mask[b])
        torch.testing.assert_close(one.model, batch.model[b], rtol=1e-5, atol=1e-4)


def _pnp_planted(seed, n=13, n_out=3):
    rng = np.random.default_rng(seed)
    rv = np.array([0.12, -0.18, 0.06])
    th_ = np.linalg.norm(rv)
    k = rv / th_
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th_) * Kx + (1 - np.cos(th_)) * Kx @ Kx
    t = np.array([0.25, -0.15, 6.5])
    X = rng.uniform(-2, 2, (n, 3)) * np.array([1, 1, 0.5])
    K = np.array([[900.0, 0, 400], [0, 1200.0, 300], [0, 0, 1.0]])
    Xc = X @ R.T + t
    pix = (Xc[:, :2] / Xc[:, 2:]) * [900.0, 1200.0] + [400.0, 300.0]
    pix += rng.normal(scale=0.5, size=pix.shape)
    pix[n - n_out:] += rng.uniform(120, 400, (n_out, 2))
    return f32(X), f32(pix), f32(K), np.ones(n, np.float32), R, t


@pytest.mark.parametrize("solver,seed", [("p3p", 5), ("p3p", 6), ("epnp", 7)])
def test_ransac_pnp_matches_jax(solver, seed):
    X, pix, K, mask, R, t = _pnp_planted(seed)
    cfg = RansacConfig(threshold=8.0)
    res_t = tr.ransac_pnp(torch.from_numpy(X), torch.from_numpy(pix),
                          torch.from_numpy(K), torch.from_numpy(mask), cfg,
                          solver=solver)
    res_j = jr.ransac_pnp(jnp.asarray(X), jnp.asarray(pix), jnp.asarray(K),
                          jnp.asarray(mask), JRansacConfig(threshold=8.0),
                          jax.random.key(0), solver=solver)
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    assert int(res_t.num_inliers) == int(res_j.num_inliers) == 10
    Rt, tt = tr.pnp_pose_from_result(res_t)
    Rj, tj = jr.pnp_pose_from_result(res_j)
    Rt, Rj = Rt.numpy().astype(np.float64), np.asarray(Rj, np.float64)
    ang = np.arccos(np.clip((np.trace(Rt.T @ Rj) - 1) / 2, -1, 1))
    assert ang < 1e-3, ang
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), t, rtol=0, atol=0.05)


def test_sample_tables_and_random_branch():
    table = tr.combinations_table(13, 4, "cpu")
    assert table.shape == (715, 4)
    np.testing.assert_array_equal(table.numpy(),
                                  np.array(list(combinations(range(13), 4))))
    assert tr.combinations_table(13, 4, torch.device("cpu")) is table  # cached
    # C(40,4) is past the exhaustive cap, and exhaustive=False forces the
    # random branch at 13 points: both draw seeded samples (utils/prng) and
    # find the planted consensus; one seed gives one result.
    src, dst, mask = _h_planted(8, n=40)
    res = tr.ransac_homography(torch.from_numpy(src), torch.from_numpy(dst),
                               torch.from_numpy(mask), RansacConfig(), 3)
    assert res.num_hypotheses == 4096
    assert res.inlier_mask[:37].all() and not res.inlier_mask[37:].any()
    args = (torch.from_numpy(src[:13]), torch.from_numpy(dst[:13]),
            torch.from_numpy(mask[:13]), RansacConfig(exhaustive=False))
    a = tr.ransac_homography(*args, 5)
    b = tr.ransac_homography(*args, generator_for(5))
    assert a.inlier_mask.all()  # the first 13 points are all inliers
    assert torch.equal(a.counts, b.counts)
