"""The fused refits (``csrc/refit.cu``, arithmetic in ``csrc/refit_seed.cuh``)
against the plain refits ``models.ransac.refit_homography`` and
``_pnp_refit``.

The header, built for the host with its 32 lanes run one after another
(``lm::SerialLanes``), is held against the plain refits on the CPU; on the
card the two refits launch the kernels (``cuda``-marked tests), held against
the same plain refits and, for the homographies (no sin, cos or pow, whose
last bit the card's and the host's libraries may round apart), equal to the
host build bit for bit.  The cases: the engine's search refit (458
candidates x 13 landmarks of the planted scene, each candidate's inliers
from ``ransac_fit``, one candidate cut to exactly 4), a problem with no
inliers and one with a NaN point; the PnP refit on the film K and on
an anisotropic K (fy = 1.3 fx), with 13, 5 and 3 inliers (the seeds' gates:
DLT-PnP at 6, EPnP at 4) from a RANSAC winner turned by ~2.7 mrad and moved
by ~1 m, so that the linear seeds can win.

Limits (those of ``tests/test_torch_lm_kernel.py``).  Both sides round every
operation on its own in float32, but the header sums the points in its
lanes' order where torch takes its own, solves EPnP's eigenproblem by
Jacobi rotations where torch calls LAPACK, and takes det by cofactors, so
the two differ by float32 rounding: each is held to the float64 plain refit
from the same inputs as the float32 plain refit is, every point's projection
no further than ``SLACK`` times the float32 refit's largest distance plus
``PX_FLOOR`` px; NaN and the fallback where the float32 refit has them.  The
weighted DLT seed (no LM) is held candidate by candidate; after the 10-pass
LM, which has not converged on the weakly held candidates, over the batch,
as the LM kernel is.  The PnP seed choice equals the plain one unless the
two candidates' MSAC agree to 1e-4 (float32 rounding of sums of 13 squares
near the bound); EPnP's two kernel vectors span the float64 ``eigh``'s two
smallest within ``SLACK`` times the float32 ``eigh``'s distance plus
``SPAN_FLOOR`` (5 and 13 inliers; at 3 the kernel has 6 dimensions and
EPnP is gated off).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ransac_tpu_torch.io import synthetic
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import homography as th
from ransac_tpu_torch.ops import lm, pnp, projection
from ransac_tpu_torch.ops.projection import east_axis_plane_projection
from ransac_tpu_torch.ops.rotation import exp_so3
from ransac_tpu_torch.utils.config import LocalizeConfig
from ransac_tpu_torch.utils.logging import SYNCS
from ransac_tpu_torch.utils.profiling import EPNP_ROTATIONS
import torch_host_build  # tests/ is on sys.path under pytest
from test_torch_lm_kernel import PX_FLOOR, SLACK, _f32, _film_K, _planted_scene
from torch_threads import one_torch_thread  # noqa: F401

SPAN_FLOOR = 1e-5
MSAC_TIE = 1e-4
CFG = LocalizeConfig()
ITERS = CFG.ransac.refine_iters  # 10, the engine's
POSE_CASES = [f"{k}_{n}" for k in ("film", "aniso") for n in (13, 5, 3)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return torch_host_build.load(tmp_path_factory.mktemp("refit_host"),
                                 torch_host_build.REFIT_SHIM)


@pytest.fixture(scope="module")
def engine():
    """The search refit's inputs on the planted scene: (H_best [458, 3, 3],
    src, dst [458, 13, 2], inliers [458, 13]); candidate 0 keeps 4 of its
    inliers."""
    cams, X, pix, _, _ = _planted_scene()
    pos2, _ = east_axis_plane_projection(torch.from_numpy(X)[None], torch.from_numpy(cams))
    src, pix = _f32(pos2, pix)
    dst = pix.expand(len(cams), -1, -1)
    flat, _, _, _, best, inl = tr.ransac_fit(
        tr._h_solve, th.transfer_errors, src, dst, torch.ones(dst.shape[:2]), 4, CFG.ransac,
        degenerate_fn=tr._h_degenerate)
    four = torch.nonzero(inl[0])[:4, 0]
    inl[0] = False
    inl[0, four] = True
    return tr._take(flat, best), src, dst, inl


def degenerate():
    """Two problems: no inliers, and a NaN point."""
    rng = np.random.default_rng(3)
    H = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0], [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, (2, 13, 2))
    p = np.concatenate([src, np.ones((2, 13, 1))], -1) @ H.T
    dst = p[..., :2] / p[..., 2:] + rng.normal(scale=0.5, size=(2, 13, 2))
    H_best, src, dst = _f32(np.broadcast_to(H, (2, 3, 3)), src, dst)
    inl = torch.ones(2, 13, dtype=torch.bool)
    inl[0] = False
    src[1, 0, 0] = math.nan
    return H_best, src, dst, inl


def plain_h(H_best, src, dst, inl, iters, dtype):
    cfg = dataclasses.replace(CFG.ransac, refine_iters=iters)
    return tr.refit_homography(H_best.to(dtype), src.to(dtype), dst.to(dtype), inl, cfg)


def h_distances(H, H64, src):
    """Each problem's largest distance of a point's projection under H from
    its projection under H64, px [B]."""
    d = th.apply_h(H.double(), src.double()) - th.apply_h(H64, src.double())
    return d.abs().flatten(1).amax(-1)


def hold_h(H, args, iters, per_problem):
    """H [B, 3, 3] against the plain refit in float32 and float64: the
    fallback (H_best) and NaN where float32 has them, the projections by
    the module's limits, problem by problem or over the batch."""
    H32, H64 = (plain_h(*args, iters, d) for d in (torch.float32, torch.float64))
    H_best = args[0]
    assert torch.equal((H == H_best).all(-1).all(-1), (H32 == H_best).all(-1).all(-1))
    assert torch.equal(torch.isnan(H), torch.isnan(H32))
    ok = torch.isfinite(H32).all(-1).all(-1) & torch.isfinite(H64).all(-1).all(-1)
    d_k, d_32 = (h_distances(h[ok], H64[ok], args[1][ok]) for h in (H, H32))
    if not per_problem:
        d_k, d_32 = d_k.max(), d_32.max()
    assert (d_k <= SLACK * d_32 + PX_FLOOR).all(), (d_k.max(), d_32.max())


@pytest.mark.parametrize("iters", [0, ITERS])
def test_host_refit_homography_matches_plain(iters, host_lib, engine):
    """The header's homography refit against the plain one on the engine's
    search refit: the weighted DLT seed alone (0 passes) candidate by
    candidate, then with the engine's 10 LM passes over the batch."""
    if host_lib is None:
        pytest.skip("no host C++ compiler")
    H = torch_host_build.refit_homography(host_lib, *engine, iters)
    assert int(engine[3][0].sum()) == 4
    hold_h(H, engine, iters, per_problem=iters == 0)


@pytest.mark.parametrize("iters", [0, ITERS])
def test_host_refit_homography_degenerate(iters, host_lib):
    """No inliers (the DLT's nullspace of a zero matrix, which the LM
    cannot move) and a NaN point (the fallback): the plain refit's answers
    bit for bit."""
    if host_lib is None:
        pytest.skip("no host C++ compiler")
    args = degenerate()
    H = torch_host_build.refit_homography(host_lib, *args, iters)
    assert torch.equal(H[1], args[0][1])
    assert torch.equal(H, plain_h(*args, iters, torch.float32))


def pose_case(name):
    """(model_best [12], X [13, 3], pixels, pix_n [13, 2], K [3, 3], inliers
    [13], point mask [13], thr_n, ay) of a PnP refit: a planted camera seeing
    13 landmarks with 0.3 px noise through the film K (or fy = 1.3 fx), the
    RANSAC winner turned and moved, its first n inliers."""
    kind, n = name.split("_")
    K = _film_K()
    if kind == "aniso":
        K[1, 1] *= 1.3
    cams, X, _, _, planted = _planted_scene(seed=1 if kind == "film" else 2)
    Xc = (X - cams[planted]) @ synthetic.R_EAST.T
    pix = np.stack([K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2],
                    K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]], axis=1)
    pix += np.random.default_rng(11).normal(scale=0.3, size=pix.shape)
    X, pix, K = _f32(X, pix, K)
    mask = torch.ones(13)
    res = tr.ransac_pnp(X, pix, K, mask, CFG.pnp_ransac)
    inl = res.inlier_mask.clone()
    assert int(inl.sum()) == 13
    inl[int(n):] = False
    R = exp_so3(torch.tensor([2e-3, -1e-3, 1.5e-3])) @ res.raw_model[:9].reshape(3, 3)
    model_best = tr._as_model(R, res.raw_model[9:] + torch.tensor([0.5, -0.3, 0.8]))
    pix_n = projection.normalize_pixels(pix, K)
    fx, ay = tr._pnp_threshold_scales(K, pix_n.dtype)
    return model_best, X, pix, pix_n, K, inl, mask, CFG.pnp_ransac.threshold / fx, ay


def plain_pose(args, dtype):
    model_best, X, pix, pix_n, K, inl, mask, _, _ = args
    model_best, X, pix, pix_n, K, mask = (
        t.to(dtype) for t in (model_best, X, pix, pix_n, K, mask))
    fx, ay = tr._pnp_threshold_scales(K, dtype)
    return tr._pnp_refit(model_best, X, pix, pix_n, K, inl, mask,
                         CFG.pnp_ransac.threshold / fx, ay, CFG.pnp_ransac)


def plain_seed_scores(args):
    """The plain seed choice's candidates' truncated MSAC [4] and gate [4]
    (``_pnp_refit_seed``)."""
    model_best, X, _, pix_n, _, inl, mask, thr_n, ay = args
    w = inl.to(torch.float32)
    R_dlt, t_dlt = pnp.dlt_pnp(X, pix_n, w)
    R_ep, t_ep, v_ep = pnp.epnp(X, pix_n, w)
    cands = torch.stack([model_best, tr._as_model(R_dlt, t_dlt), *tr._as_model(R_ep, t_ep)])
    n_inl = int(inl.sum())
    gate = torch.tensor([True, n_inl >= 6, n_inl >= 4, n_inl >= 4]) & torch.cat(
        [torch.ones(2, dtype=torch.bool), v_ep])
    return tr._pnp_msac(cands, X, pix_n, mask, thr_n, ay), gate


def hold_pose(model, args):
    """model [12] against the plain refit in float32 and float64: the
    projection of every point of the mask (a pool's zero padding is no
    point) by the module's limits."""
    X, K, live = args[1].double(), args[4].double(), args[6] > 0

    def project(m):
        m = m.double()
        return projection.project_points(X, m[:9].reshape(3, 3), m[9:], K)[0][live]

    p64 = project(plain_pose(args, torch.float64))
    d_k = (project(model) - p64).abs().max()
    d_32 = (project(plain_pose(args, torch.float32)) - p64).abs().max()
    assert d_k <= SLACK * d_32 + PX_FLOOR, (float(d_k), float(d_32))


def span_distance(V, E2):
    """|| V - P V || of the columns V [12, 2] off the span of E2 [12, 2]."""
    return float(torch.linalg.norm(V - E2 @ (E2.T @ V)))


@pytest.mark.parametrize("name", POSE_CASES)
def test_host_pose_seed_choice(name, host_lib):
    """The header's seed choice against ``_pnp_refit_seed``'s: the same
    inlier count and gates, the same candidate unless the two candidates'
    MSAC agree to float32 rounding; EPnP's kernel vectors (the Jacobi
    eigensolver's two smallest) span ``eigh``'s; on 13 points, the
    eigensolver makes no fewer rotations than ``utils.profiling`` counts
    (``EPNP_ROTATIONS``), and at most a tenth more."""
    if host_lib is None:
        pytest.skip("no host C++ compiler")
    args = pose_case(name)
    _, trace = torch_host_build.refit_pose(host_lib, *args[:7], float(args[7]),
                                           float(args[8]), ITERS)
    scores, gate = plain_seed_scores(args)
    plain = int(torch.where(gate, scores, math.inf).argmin())
    assert trace["n_inl"] == int(args[5].sum())
    k = trace["choice"]
    assert gate[k]
    assert k == plain or abs(float(scores[k] - scores[plain])) <= MSAC_TIE * float(scores[plain])
    if int(args[5].sum()) >= 5:
        M = trace["mtm"].double()
        assert torch.equal(M, M.T)
        E64 = torch.linalg.eigh(M)[1][:, :2]
        E32 = torch.linalg.eigh(trace["mtm"])[1][:, :2].double()
        d_k = span_distance(trace["kernel"].double().T, E64)
        assert d_k <= SLACK * span_distance(E32, E64) + SPAN_FLOOR, d_k
    if name.endswith("_13"):
        rotations = trace["rotations"]
        assert EPNP_ROTATIONS <= rotations <= 1.1 * EPNP_ROTATIONS, rotations


@pytest.mark.parametrize("name", POSE_CASES)
def test_host_refit_pose_matches_plain(name, host_lib):
    """The header's whole PnP refit (seeds, choice, LM, fallback) against
    ``_pnp_refit``."""
    if host_lib is None:
        pytest.skip("no host C++ compiler")
    args = pose_case(name)
    model, _ = torch_host_build.refit_pose(host_lib, *args[:7], float(args[7]),
                                           float(args[8]), ITERS)
    hold_pose(model, args)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def same(a, b) -> bool:
    """a and b equal, NaN where the other is NaN."""
    a, b = a.cpu(), b.cpu()
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a[~a.isnan()], b[~b.isnan()])


def on_card(args, dtype=None):
    """args with every tensor on the card, its floats in ``dtype`` if given."""
    return [a if not isinstance(a, torch.Tensor)
            else a.cuda().to(dtype) if dtype and a.is_floating_point() else a.cuda()
            for a in args]


def card_h(args, iters=ITERS):
    cfg = dataclasses.replace(CFG.ransac, refine_iters=iters)
    return tr.refit_homography(*on_card(args), cfg)


def card_pose(args):
    return tr._pnp_refit(*on_card(args), CFG.pnp_ransac)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, ITERS])
def test_cuda_refit_homography(iters, cuda, host_lib, engine):
    """``refit_homography`` on the card (one launch) against the plain
    refit, and equal to the host build bit for bit, on the engine's refit;
    the plain refit's answers on the degenerate problems."""
    H = card_h(engine, iters).cpu()
    hold_h(H, engine, iters, per_problem=iters == 0)
    args = degenerate()
    assert torch.equal(card_h(args, iters).cpu(), plain_h(*args, iters, torch.float32))
    if host_lib is not None:
        assert same(H, torch_host_build.refit_homography(host_lib, *engine, iters))


@pytest.mark.cuda
@pytest.mark.parametrize("name", POSE_CASES)
def test_cuda_refit_pose(name, cuda):
    """``_pnp_refit`` on the card (one launch) against the plain refit."""
    args = pose_case(name)
    hold_pose(card_pose(args).cpu(), args)


def device_kernels(fn) -> list:
    """The names of the device kernels ``fn`` launches (the spans' own
    annotations on the device's timeline left out)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != "ransac.refit"
            and not e.name.startswith(("Memset", "Memcpy"))]


@pytest.mark.cuda
def test_cuda_one_launch_a_refit(cuda, engine):
    """Each refit is one launch: its ``_build.LAUNCHES`` entry + 1, ``passes``
    + its LM passes, no LM-only launch, no read; the profiler
    sees one device kernel, the refit's; the PnP refit waits for nothing
    (``host_sync`` counts none)."""
    h_args, p_args = on_card(engine), on_card(pose_case("film_13"))
    for name, fn, passes in (
            ("refit_homography", lambda: tr.refit_homography(*h_args, CFG.ransac), ITERS),
            ("refit_pose", lambda: tr._pnp_refit(*p_args, CFG.pnp_ransac), ITERS)):
        fn()
        before, launches, syncs = dict(lm.COUNTS), dict(_build.LAUNCHES), SYNCS["sync"]
        kernels = device_kernels(fn)
        assert len(kernels) == 1 and f"{name}_kernel" in kernels[0], kernels
        assert lm.COUNTS == {**before, "passes": before["passes"] + passes}
        assert _build.LAUNCHES == {**launches, name: launches[name] + 1}
        assert SYNCS["sync"] == syncs


@pytest.mark.cuda
def test_cuda_other_dtype_raises(cuda, engine):
    """A CUDA tensor that is not float32 raises; nothing falls back or
    launches."""
    h_args = on_card(engine, torch.float64)
    p_args = on_card(pose_case("film_13"), torch.float64)
    before, launches = dict(lm.COUNTS), dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        tr.refit_homography(*h_args, CFG.ransac)
    with pytest.raises(ValueError, match="float32"):
        tr._pnp_refit(*p_args, CFG.pnp_ransac)
    assert lm.COUNTS == before and _build.LAUNCHES == launches


@pytest.mark.cuda
def test_cuda_strided_inputs_equal_contiguous(cuda, engine):
    """An input whose items are not contiguous is copied, one shared by
    every item (stride 0) is read in place: the same answer as contiguous
    inputs, bit for bit."""
    H_best, src, dst, inl = on_card(engine)
    dst = dst[0].expand(src.shape[0], -1, -1)
    ref = tr.refit_homography(H_best, src, dst.contiguous(), inl, CFG.ransac)
    src_t = src.transpose(-1, -2).contiguous().transpose(-1, -2)
    H_t = H_best.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not src_t[0].is_contiguous() and dst.stride(0) == 0
    assert same(tr.refit_homography(H_t, src_t, dst, inl, CFG.ransac), ref)
