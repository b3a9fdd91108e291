"""The scoring ports (``ransac_tpu_torch.ops.score``) against the Pallas
kernels ``ransac_tpu.ops.pallas.score.homography_scores`` and
``pnp_scores`` run in interpret mode, and against the JAX package's
engine-path formulations ``homography_scores_ref`` / ``pnp_scores_ref``.

Both kernels divide exactly (no approximate reciprocal), so counts agree
exactly and MSAC within rtol 1e-5 (XLA contracts multiply-adds into FMAs
where PyTorch rounds each operation), NaN in the same places: the JAX
kernels score 16 rows, the padding a zero point of weight 0, so a model
with a non-finite entry that meets a zero coordinate has a NaN MSAC when
n < 16, and the port's scores keep that.  On the CPU the wrappers compute
the plain versions; the CUDA kernels are held against them on the card
(``chip_smoke.py`` and the ``cuda``-marked test).  The kernels' per-model
arithmetic (``csrc/score.cuh``), built for the host, equals the plain
versions bit for bit under its `Exact` policy; under the kernels' `Fused`
policy it holds ``ops.score.hold``'s criteria.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops.pallas import score as jsc
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import score as tsc
import torch_host_build  # tests/ is on sys.path under pytest
from torch_threads import one_torch_thread  # noqa: F401

H = 4096
THR = 75.0


def h_case(name):
    """(models [H,3,3], src, dst, mask): perturbations of the planted
    homography, so counts spread over 0..n."""
    rng = np.random.default_rng({"n13": 0, "n16": 1, "masked": 2}[name])
    n = 16 if name == "n16" else 13
    H_true = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0],
                       [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, (n, 2))
    p = np.c_[src, np.ones(n)] @ H_true.T
    dst = p[:, :2] / p[:, 2:] + rng.normal(scale=1.0, size=(n, 2))
    dst[n - 3:] += 300.0
    models = H_true[None] * (1 + rng.normal(scale=0.03, size=(H, 3, 3)))
    mask = np.ones(n, np.float32)
    if name == "masked":
        mask[[1, 5, 9]] = 0.0
    return (models.astype(np.float32), src.astype(np.float32),
            dst.astype(np.float32), mask)


def pnp_case(name):
    """(models [H,12], Xw, pix_n, mask, thr_n): poses around a planted one;
    "behind" flips a quarter of the poses so points fall behind them."""
    rng = np.random.default_rng({"n13": 3, "n16": 4, "masked": 5, "behind": 6}[name])
    n = 16 if name == "n16" else 13
    X = rng.uniform(-2, 2, (n, 3)) * [1, 1, 0.5]
    t = np.array([0.25, -0.15, 6.5])
    pix = (X[:, :2] + t[:2]) / (X[:, 2:] + t[2]) + rng.normal(scale=1e-3, size=(n, 2))
    pix[n - 3:] += 0.2
    models = np.zeros((H, 12))
    ang = rng.normal(scale=0.02, size=(H, 3))
    for k in range(H):  # small rotations (first order) and translations
        a = ang[k]
        R = np.eye(3) + np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        models[k, :9] = R.reshape(-1)
        models[k, 9:] = t + rng.normal(scale=0.05, size=3)
    if name == "behind":
        models[::4, 11] = -models[::4, 11] + 1.0
    mask = np.ones(n, np.float32)
    if name == "masked":
        mask[[0, 4]] = 0.0
    return (models.astype(np.float32), X.astype(np.float32),
            pix.astype(np.float32), mask, 8.0 / 900.0)


def check(counts_t, msac_t, counts_j, msac_j):
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(msac_t.numpy(), np.asarray(msac_j), rtol=1e-5)


def bitwise_equal(a, b):
    """a and b bit for bit, every NaN counted equal to every other NaN."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(
        a[~nan_a].view(torch.int32), b[~nan_b].view(torch.int32))


#: A non-finite model entry: (homography (row, col), pose index, value).
#: "zero_coord" multiplies a point's x (zero in the JAX kernels' padding),
#: "translation" multiplies 1, "nan" is a NaN.
NON_FINITE = {"zero_coord": ((0, 0), 0, np.inf),
              "translation": ((0, 2), 9, np.inf),
              "nan": ((1, 1), 4, np.nan)}


def non_finite(kind, n, entry, n_models=64):
    """The first n points of the kind's n16 case and n_models of its
    models, every second one given the non-finite ``entry``."""
    (r, c), k, value = NON_FINITE[entry]
    if kind == "homography":
        models, a, b, mask = h_case("n16")
        models = models[:n_models].copy()
        models[::2, r, c] = value
        return models, a[:n], b[:n], mask[:n], THR
    models, a, b, mask, thr = pnp_case("n16")
    models = models[:n_models].copy()
    models[::2, k] = value
    return models, a[:n], b[:n], mask[:n], thr


@pytest.mark.parametrize("name", ["n13", "n16", "masked"])
def test_homography_scores_match_pallas_and_ref(name):
    models, src, dst, mask = h_case(name)
    jargs = (jnp.asarray(models), jnp.asarray(src), jnp.asarray(dst),
             jnp.asarray(mask), THR)
    targs = (torch.from_numpy(models), torch.from_numpy(src),
             torch.from_numpy(dst), torch.from_numpy(mask), THR)
    counts, msac = tsc.homography_scores(*targs)
    assert counts.shape == msac.shape == (H,)
    check(counts, msac, *jsc.homography_scores(*jargs, interpret=True))
    check(*tsc.homography_scores_ref(*targs), *jsc.homography_scores_ref(*jargs))
    assert 0 < counts.min() < counts.max() <= mask.sum()
    # The fused score and the engine-path formulation decide alike.
    np.testing.assert_array_equal(counts.numpy(),
                                  tsc.homography_scores_ref(*targs)[0].numpy())


@pytest.mark.parametrize("name", ["n13", "n16", "masked", "behind"])
def test_pnp_scores_match_pallas_and_ref(name):
    models, X, pix, mask, thr = pnp_case(name)
    jargs = (jnp.asarray(models), jnp.asarray(X), jnp.asarray(pix),
             jnp.asarray(mask), thr)
    targs = (torch.from_numpy(models), torch.from_numpy(X),
             torch.from_numpy(pix), torch.from_numpy(mask), thr)
    counts, msac = tsc.pnp_scores(*targs)
    check(counts, msac, *jsc.pnp_scores(*jargs, interpret=True))
    check(*tsc.pnp_scores_ref(*targs), *jsc.pnp_scores_ref(*jargs))
    assert 0 <= counts.min() < counts.max() <= mask.sum()
    if name == "behind":
        # Every point is behind a flipped pose: no inliers, full penalty.
        thr_sq = np.float32(thr) ** 2
        assert (counts[::4] == 0).all()
        np.testing.assert_allclose(msac[::4].numpy(), thr_sq * mask.sum(), rtol=1e-6)


@pytest.mark.parametrize("entry", list(NON_FINITE))
@pytest.mark.parametrize("n", [4, 13, 16])
@pytest.mark.parametrize("kind", ["homography", "pose"])
def test_non_finite_models_match_pallas(kind, n, entry):
    """Models with a non-finite entry: the port's counts equal the JAX
    kernel's and its MSAC is NaN where the JAX kernel's is.  An infinite
    entry that meets the padding's zero coordinate gives NaN exactly when
    n < 16 (inf * 0 in the padding row); an infinite translation gives a
    finite MSAC."""
    args = non_finite(kind, n, entry)
    port, jax_fn = ((tsc.homography_scores, jsc.homography_scores) if kind == "homography"
                    else (tsc.pnp_scores, jsc.pnp_scores))
    counts, msac = port(*(torch.from_numpy(a) for a in args[:4]), args[4])
    counts_j, msac_j = jax_fn(*(jnp.asarray(a) for a in args[:4]), args[4], interpret=True)
    check(counts, msac, counts_j, msac_j)
    nan = np.isnan(msac.numpy())
    assert not nan[1::2].any()
    if entry == "zero_coord":
        assert (nan[::2] == (n < 16)).all()
    elif entry == "translation":
        assert not nan.any()
    else:
        assert nan[::2].all()


@pytest.mark.parametrize("n", [4, 13, 16])
def test_exact_header_host_build_matches_plain(n, tmp_path):
    """``score::homography<Exact>`` (the kernel's arithmetic), compiled for
    the host, on the first n points of a case with masked points: the
    plain version's counts and MSAC bit for bit, and the JAX kernel's
    decisions."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    models, src, dst, mask = h_case("n16")
    src, dst, mask = src[:n], dst[:n], mask[:n].copy()
    mask[[1, n - 2]] = 0.0
    models[::7, 2, :] = [1e-13, -1e-13, 0.0]  # w near 0: the |w| < 1e-12 guard
    for k, ((r, c), _, value) in enumerate(NON_FINITE.values()):
        models[3 + 11 * k::33, r, c] = value  # the zero row's NaN where n < 16
    targs = (torch.from_numpy(models), torch.from_numpy(src), torch.from_numpy(dst),
             torch.from_numpy(mask))
    count, msac = torch_host_build.homography_scores(lib, *targs, tsc._thr_sq(THR))
    c_p, m_p = tsc.homography_scores_plain(*targs, THR)
    assert bitwise_equal(count, c_p) and bitwise_equal(msac, m_p)
    c_j, m_j = jsc.homography_scores(*(jnp.asarray(a) for a in (models, src, dst, mask)),
                                     THR, interpret=True)
    np.testing.assert_array_equal(count.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(torch.isnan(msac).numpy(), np.isnan(np.asarray(m_j)))
    assert 0 <= count.min() < count.max() <= mask.sum()


@pytest.mark.parametrize("name", ["n13", "n16", "masked"])
def test_fused_header_host_build_holds_plain(name, tmp_path):
    """``score::homography<Fused>`` (the kernel's policy; the host divides
    where the card takes MUFU's reciprocal) against the plain version:
    ``ops.score.hold``'s criteria, flips explained by ``cut_margins``."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    args = tuple(torch.from_numpy(a) for a in h_case(name))
    out_k = torch_host_build.homography_scores(lib, *args, tsc._thr_sq(THR), fused=True)
    out_p = tsc.homography_scores_plain(*args, THR)
    held = tsc.hold(out_k, out_p, lambda h: tsc.cut_margins(*args, THR, h))
    assert held["failures"] == []
    assert held["msac_within_1e-4_fraction"] >= 0.999


def test_hold_explains_count_flips_by_points_at_the_cut():
    """``hold`` lets a count move only by the weight of its points at the
    inlier cut, in their direction: a threshold set on one point's error
    puts that point at the cut, and a count lowered by it holds while a
    count lowered by 2 fails."""
    models, src, dst, mask = (torch.from_numpy(a) for a in h_case("n13"))
    m = models[:1]
    thr = float(tsc.homography_scores_ref(m, src[:1], dst[:1], mask[:1], 1e9)[1]) ** 0.5
    out_p = tsc.homography_scores_plain(m, src, dst, mask, thr)
    margins = lambda h: tsc.cut_margins(m, src, dst, mask, thr, h)  # noqa: E731
    near_in, near_out = margins(torch.tensor([0]))
    assert float(near_in[0] + near_out[0]) >= 1.0
    d = -1.0 if float(near_in[0]) >= 1.0 else 1.0
    assert tsc.hold((out_p[0] + d, out_p[1]), out_p, margins)["failures"] == []
    assert tsc.hold((out_p[0] + 2 * d, out_p[1]), out_p, margins)["failures"] != []


def near_case(name):
    """(models, Xw, pix_n, mask, thr) of the pnp n13 case where point 0 sits
    on a decision under every pose: "at_cut", its reprojection error at
    the inlier threshold (t solved in float64, then rounded); "near_plane",
    its camera z at 1e-6 (0.7e-6 to 1.3e-6) with its projection near its
    pixel, and a threshold of 10 so that a point in front there is an
    inlier and one behind (e2 = 1e12) is not."""
    models, X, pix, mask, thr = pnp_case("n13")
    m = models.astype(np.float64)
    R = m[:, :9].reshape(-1, 3, 3)
    RX = R @ X[0].astype(np.float64)  # [H, 3]
    px, py = pix[0].astype(np.float64)
    if name == "at_cut":
        zc = RX[:, 2] + m[:, 11]
        sign = np.where(np.arange(len(m)) % 2 == 0, 1.0, -1.0)
        m[:, 9] = (px + sign * thr) * zc - RX[:, 0]
        m[:, 10] = py * zc - RX[:, 1]
    else:
        zc = 1e-6 * (1.0 + 0.3 * np.random.default_rng(7).uniform(-1, 1, len(m)))
        m[:, 9:] = np.stack([px * zc, py * zc, zc], -1) - RX
        thr = 10.0
    return m.astype(np.float32), X, pix, mask, thr


@pytest.mark.parametrize("n", [4, 13, 16])
def test_pose_exact_header_host_build_matches_plain(n, tmp_path):
    """``score::pose<Exact>`` compiled for the host, on the first n points
    of the n16 case with masked points, poses with points behind them and
    poses with non-finite entries: the plain version's counts and MSAC bit
    for bit (NaN where it is NaN), and the JAX kernel's counts and NaN."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    models, X, pix, mask, thr = pnp_case("n16")
    X, pix, mask = X[:n], pix[:n], mask[:n].copy()
    mask[[1, n - 2]] = 0.0
    models[::5, 11] = -models[::5, 11] + 1.0  # points behind the camera
    for k, (_, i, value) in enumerate(NON_FINITE.values()):
        models[3 + 11 * k::33, i] = value
    targs = tuple(torch.from_numpy(a) for a in (models, X, pix, mask))
    count, msac = torch_host_build.pnp_scores(lib, *targs, tsc._thr_sq(thr))
    c_p, m_p = tsc.pnp_scores_plain(*targs, thr)
    assert bitwise_equal(count, c_p) and bitwise_equal(msac, m_p)
    c_j, m_j = jsc.pnp_scores(*(jnp.asarray(a) for a in (models, X, pix, mask)), thr,
                              interpret=True)
    np.testing.assert_array_equal(count.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(torch.isnan(msac).numpy(), np.isnan(np.asarray(m_j)))
    assert bool(torch.isnan(msac).any()) and 0 <= count.min() < count.max() <= mask.sum()


@pytest.mark.parametrize("name", ["n13", "n16", "masked", "behind", "at_cut",
                                  "near_plane"])
def test_pose_fused_header_host_build_holds_plain(name, tmp_path):
    """``score::pose<Fused>`` (the kernel's policy; the host divides where
    the card takes MUFU's reciprocal) against the plain version:
    ``ops.score.hold``'s criteria, flips explained by ``pose_cut_margins``.
    "at_cut" puts a point at the inlier cut under every pose; under
    "near_plane" a point's camera z straddles 1e-6, and its behind-camera
    flags, which show in the counts there, are the plain version's."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    case = near_case(name) if name in ("at_cut", "near_plane") else pnp_case(name)
    args, thr = tuple(torch.from_numpy(a) for a in case[:4]), case[4]
    out_k = torch_host_build.pnp_scores(lib, *args, tsc._thr_sq(thr), fused=True)
    out_p = tsc.pnp_scores_plain(*args, thr)
    held = tsc.hold(out_k, out_p, lambda h: tsc.pose_cut_margins(*args, thr, h))
    assert held["failures"] == []
    assert held["msac_within_1e-4_fraction"] >= 0.999
    all_poses = torch.arange(args[0].shape[0])
    if name == "at_cut":
        near_in, near_out = tsc.pose_cut_margins(*args, thr, all_poses)
        assert float((near_in + near_out).min()) >= 1.0
    if name == "near_plane":
        e2_0, _ = next(tsc._pnp_errors(args[0], *args[1:]))
        behind = e2_0 == np.float32(1e12)
        assert 0.2 < float(behind.double().mean()) < 0.8
        assert torch.equal(out_k[0], out_p[0])


def test_hold_explains_pose_count_flips_by_points_at_the_cut():
    """``hold`` with ``pose_cut_margins`` lets a pose's count move by its one
    point at the inlier cut and not by two."""
    models, X, pix, mask = (torch.from_numpy(a) for a in pnp_case("n13")[:4])
    m = models[:1]
    thr = float(tsc.pnp_scores_ref(m, X[:1], pix[:1], mask[:1], 1e9)[1]) ** 0.5
    out_p = tsc.pnp_scores_plain(m, X, pix, mask, thr)
    margins = lambda h: tsc.pose_cut_margins(m, X, pix, mask, thr, h)  # noqa: E731
    near_in, near_out = margins(torch.tensor([0]))
    assert float(near_in[0] + near_out[0]) >= 1.0
    d = -1.0 if float(near_in[0]) >= 1.0 else 1.0
    assert tsc.hold((out_p[0] + d, out_p[1]), out_p, margins)["failures"] == []
    assert tsc.hold((out_p[0] + 2 * d, out_p[1]), out_p, margins)["failures"] != []


def test_plain_equals_wrapper_and_launches_stay_zero_on_cpu():
    models, src, dst, mask = h_case("n13")
    args = (torch.from_numpy(models), torch.from_numpy(src),
            torch.from_numpy(dst), torch.from_numpy(mask), THR)
    for a, b in zip(tsc.homography_scores(*args), tsc.homography_scores_plain(*args)):
        assert torch.equal(a, b)
    models, X, pix, mask, thr = pnp_case("n13")
    args = (torch.from_numpy(models), torch.from_numpy(X),
            torch.from_numpy(pix), torch.from_numpy(mask), thr)
    for a, b in zip(tsc.pnp_scores(*args), tsc.pnp_scores_plain(*args)):
        assert torch.equal(a, b)
    assert _build.LAUNCHES["homography_scores"] == _build.LAUNCHES["pnp_scores"] == 0


def test_kernel_entry_raises_for_cpu_tensors():
    models, src, dst, mask = h_case("n13")
    src_p, mask_p = tsc._pad_points(torch.from_numpy(src), torch.from_numpy(mask), 2)
    dst_p, _ = tsc._pad_points(torch.from_numpy(dst), torch.from_numpy(mask), 2)
    with pytest.raises(ValueError, match="CUDA"):
        tsc._h_kernel(torch.from_numpy(models).reshape(H, 9), src_p, dst_p,
                      mask_p, THR * THR)
    with pytest.raises(ValueError, match="at most 16"):
        tsc.homography_scores(torch.from_numpy(models), torch.zeros(17, 2),
                              torch.zeros(17, 2), torch.ones(17), THR)
    poses, X, pix, pmask, thr = (torch.as_tensor(a) for a in pnp_case("n13"))
    with pytest.raises(ValueError, match="CUDA"):
        tsc._pnp_kernel(poses, X, pix, pmask, tsc._thr_sq(thr))
    with pytest.raises(ValueError, match="at most 16"):
        tsc.pnp_scores(poses, torch.zeros(17, 3), torch.zeros(17, 2), torch.ones(17), thr)
    assert _build.LAUNCHES["homography_scores"] == _build.LAUNCHES["pnp_scores"] == 0


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    models, src, dst, mask = h_case("masked")
    args = [torch.from_numpy(a).cuda() for a in (models, src, dst, mask)]
    held = tsc.hold(tsc.homography_scores(*args, THR),
                    tsc.homography_scores_plain(*args, THR),
                    lambda h: tsc.cut_margins(*args, THR, h))
    assert held["failures"] == []
    models, X, pix, mask, thr = pnp_case("behind")
    args = [torch.from_numpy(a).cuda() for a in (models, X, pix, mask)]
    held = tsc.hold(tsc.pnp_scores(*args, thr), tsc.pnp_scores_plain(*args, thr),
                    lambda h: tsc.pose_cut_margins(*args, thr, h))
    assert held["failures"] == []
