"""The two-view slice of the port (``features.detect``, ``features.match``,
``pipelines.twoview``, ``cli twoview``) against the JAX package on a
rendered 240 x 320 pair (the scene of ``tests/test_sfm_twoview.py``).

Harris responses agree within float32 tolerances (``conv2d`` and JAX's
banded matmuls sum in other orders); the corners are the exact top K on
both sides (JAX with ``approx_topk=False``).  The rendered images have flat
backgrounds whose responses are float noise around 0, so the weakest
corners (below 1e-4 of the strongest) come and go with the rounding and
are not compared.  Descriptors and matches are compared on the same
keypoints; the descriptors of near-flat patches, scaled up by their
normalization, agree within 1e-4.  The pipeline runs with the stage-wise
engine on both sides: the matches of the weak corners differ, and the
RANSAC samples come from different generators, so matches are compared as
sets (90% in common) and relative poses within a tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.features import detect as jd
from ransac_tpu.features import match as jm
from ransac_tpu.pipelines.twoview import two_view_pipeline as j_two_view
from ransac_tpu.utils.config import TwoViewConfig as JTwoViewConfig
from ransac_tpu_torch import cli
from ransac_tpu_torch.features import detect as td
from ransac_tpu_torch.features import match as tm
from ransac_tpu_torch.io.synthetic import two_view_pair
from ransac_tpu_torch.ops.rotation import log_so3
from ransac_tpu_torch.pipelines.twoview import two_view_pipeline
from ransac_tpu_torch.utils.config import TwoViewConfig
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(max_keypoints=256, match_ratio=0.95, patch_size=16)


@pytest.fixture(scope="module")
def pair():
    return two_view_pair((240, 320), n_points=120, seed=1, f=300.0)


def _rot_err(Ra, Rb):
    return float(torch.linalg.vector_norm(log_so3(
        torch.as_tensor(np.asarray(Ra), dtype=torch.float64)
        @ torch.as_tensor(np.asarray(Rb), dtype=torch.float64).T)))


def test_harris_and_topk_match_jax(pair):
    img = pair[0]
    r_t = td.harris_response(torch.from_numpy(img)).numpy()
    r_j = np.asarray(jax.jit(jd.harris_response)(jnp.asarray(img)))
    np.testing.assert_allclose(r_t, r_j, rtol=1e-3, atol=1e-7 * np.abs(r_j).max())
    kp_t = td.detect_harris(torch.from_numpy(img), 256)
    kp_j = jd.detect_harris(jnp.asarray(img), 256, approx_topk=False)
    s_j = np.asarray(kp_j.score)
    strong = int((s_j > 1e-4 * s_j.max()).sum())
    assert 60 <= strong < 256
    assert (kp_t.score.numpy()[:strong] > 1e-4 * s_j.max()).all()
    np.testing.assert_allclose(kp_t.xy.numpy()[:strong], np.asarray(kp_j.xy)[:strong],
                               atol=1e-3)
    np.testing.assert_allclose(kp_t.score.numpy()[:strong], s_j[:strong], rtol=1e-3)
    assert kp_t.valid.numpy()[:strong].all()


def test_descriptors_and_matches_match_jax(pair):
    img1, img2 = pair[:2]
    kp1 = jd.detect_harris(jnp.asarray(img1), 256, approx_topk=False)
    kp2 = jd.detect_harris(jnp.asarray(img2), 256, approx_topk=False)
    d_j = [np.asarray(jm.patch_descriptors(jnp.asarray(im), kp.xy, kp.valid, 16))
           for im, kp in ((img1, kp1), (img2, kp2))]
    d_t = [tm.patch_descriptors(torch.from_numpy(im), torch.from_numpy(np.asarray(kp.xy)),
                                torch.from_numpy(np.asarray(kp.valid)), 16)
           for im, kp in ((img1, kp1), (img2, kp2))]
    for a, b in zip(d_t, d_j):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4)
    m_j = jm.mutual_nn_match(jnp.asarray(d_j[0]), jnp.asarray(d_j[1]), kp1.valid,
                             kp2.valid, 0.95)
    m_t = tm.mutual_nn_match(torch.from_numpy(d_j[0]), torch.from_numpy(d_j[1]),
                             torch.from_numpy(np.asarray(kp1.valid)),
                             torch.from_numpy(np.asarray(kp2.valid)), 0.95)
    np.testing.assert_array_equal(m_t.valid.numpy(), np.asarray(m_j.valid))
    ok = m_t.valid.numpy()
    np.testing.assert_array_equal(m_t.idx2.numpy()[ok], np.asarray(m_j.idx2)[ok])
    assert ok.sum() > 40


def test_batched_matching_equals_pair_by_pair():
    """16 seeded pairs of descriptors, some keypoints invalid on either
    side (a whole side invalid in one pair): one batched call gives each
    pair's matches as the unbatched call does."""
    rng = np.random.default_rng(3)
    B, K1, K2, D = 16, 40, 48, 16
    d1 = torch.from_numpy(rng.normal(size=(B, K1, D)).astype(np.float32))
    d2 = torch.from_numpy(rng.normal(size=(B, K2, D)).astype(np.float32))
    d2[:, :20] = d1[:, :20] + 0.05 * torch.randn(B, 20, D, generator=torch.Generator().manual_seed(0))
    d1, d2 = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True) for d in (d1, d2))
    v1 = torch.from_numpy(rng.uniform(size=(B, K1)) > 0.2)
    v2 = torch.from_numpy(rng.uniform(size=(B, K2)) > 0.2)
    v2[5] = False
    m = tm.mutual_nn_match(d1, d2, v1, v2, 0.95)
    assert m.valid.shape == m.idx2.shape == m.idx1.shape == (B, K1)
    for b in range(B):
        m_b = tm.mutual_nn_match(d1[b], d2[b], v1[b], v2[b], 0.95)
        for got, want in zip(m, m_b):
            assert torch.equal(got[b], want)
    assert not m.valid[5].any() and not m.valid[~v1].any()
    assert m.valid.sum() > 100


@pytest.mark.cuda
def test_cuda_harris_is_float32_under_default_cudnn_flags(pair, monkeypatch):
    """Harris on the card with cuDNN's default flags (TF32 allowed) equals
    the CPU version within the tolerance of the JAX comparison: the module
    turns TF32 off around its convolutions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    img = torch.from_numpy(pair[0])
    r_c = td.harris_response(img.cuda()).cpu().numpy()
    assert torch.backends.cudnn.allow_tf32
    r_h = td.harris_response(img).numpy()
    np.testing.assert_allclose(r_c, r_h, rtol=1e-3, atol=1e-7 * np.abs(r_h).max())


def test_two_view_pipeline_matches_jax_stagewise(pair):
    """The whole slice on the rendered pair, stage-wise engine on both
    sides: more than 40 matches, 90% of them in common, relative poses
    within 0.01 rad of each other and 0.05 rad of the truth, |t . t_true| >
    0.98 (the bounds of tests/test_sfm_twoview.py)."""
    img1, img2, K, R_true, t_true = pair
    res_t = two_view_pipeline(img1, img2, K, TwoViewConfig(engine="stagewise", **CFG),
                              device="cpu")
    res_j = j_two_view(img1, img2, K, JTwoViewConfig(engine="stagewise", **CFG))
    assert res_t.matches.shape[0] > 40
    m_t = {tuple(int(i) for i in m) for m in res_t.matches}
    m_j = {tuple(int(i) for i in m) for m in res_j.matches}
    assert len(m_t & m_j) >= 0.9 * len(m_t | m_j)
    assert res_t.inliers.sum() > 25
    assert _rot_err(res_t.R, res_j.R) < 0.01
    assert _rot_err(res_t.R, R_true) < 0.05
    assert abs(float(res_t.t @ t_true)) > 0.98
    assert float(res_t.t @ res_j.t) > 0.999


def test_two_view_pipeline_sweep_engine_on_cpu(pair, tmp_path):
    """The fused engine's plain version on the CPU recovers the same pose;
    ``cli twoview`` reads .npy images and an intrinsics file."""
    img1, img2, K, R_true, t_true = pair
    res = two_view_pipeline(img1, img2, K, TwoViewConfig(engine="sweep", **CFG),
                            device="cpu")
    assert res.matches.shape[0] > 40 and res.inliers.sum() > 25
    assert _rot_err(res.R, R_true) < 0.05 and abs(float(res.t @ t_true)) > 0.98
    for name, a in (("a.npy", img1), ("b.npy", (img2 * 255).astype(np.uint8))):
        np.save(tmp_path / name, a)
    np.savetxt(tmp_path / "K.txt", K)
    rc = cli.main(["twoview", str(tmp_path / "a.npy"), str(tmp_path / "b.npy"),
                   "--intrinsics", str(tmp_path / "K.txt"), "--device", "cpu",
                   "--max-keypoints", "256", "--out", str(tmp_path / "out.npz")])
    assert rc == 0
    out = np.load(tmp_path / "out.npz")
    assert out["matches"].shape[0] > 40 and _rot_err(out["R"], R_true) < 0.05
