"""The port's geometry core (``ransac_tpu_torch.ops``) against the JAX
package on the same seeded inputs.

Tolerances: closed-form results rtol 1e-4 / atol 1e-5 (float32 on both
sides, operations in another order); LM-refined results rtol 1e-3; poses
by rotation geodesic < 1e-3 rad and translation rtol 1e-3.  Eigen- and
singular vectors are never compared directly (their sign is arbitrary):
nullspaces are compared up to sign, rotations built from them directly.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops import homography as jh
from ransac_tpu.ops import linalg as jl
from ransac_tpu.ops import lm as jlm
from ransac_tpu.ops import pnp as jp
from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops import rotation as jr
from ransac_tpu.utils import config as jcfg
from ransac_tpu_torch.ops import homography as th
from ransac_tpu_torch.ops import linalg as tl
from ransac_tpu_torch.ops import lm as tlm
from ransac_tpu_torch.ops import pnp as tp
from ransac_tpu_torch.ops import projection as tproj
from ransac_tpu_torch.ops import rotation as tr
from ransac_tpu_torch.utils import config as tcfg
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def f32(a):
    return np.asarray(a, np.float32)


def t(a):
    return torch.tensor(f32(a))


def j(a):
    return jnp.asarray(f32(a))


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def rotations(rng, k):
    return np.asarray(jr.exp_so3(j(rng.normal(scale=0.8, size=(k, 3)))))


# --------------------------------------------------------------------------
# linalg
# --------------------------------------------------------------------------
def test_solve_cubic_real():
    rng = np.random.default_rng(0)
    r = -3.0 + np.cumsum(rng.uniform(0.4, 2.0, (64, 3)), -1)
    r[32:, 1:] = 0.0  # x (x^2 + q): one real root plus a complex pair
    q = rng.uniform(0.5, 2.0, 32)
    a = np.ones(64)
    b = -(r[:, 0] + r[:, 1] + r[:, 2])
    c = r[:, 0] * r[:, 1] + r[:, 0] * r[:, 2] + r[:, 1] * r[:, 2]
    d = -r[:, 0] * r[:, 1] * r[:, 2]
    b[32:], c[32:], d[32:] = -r[32:, 0], q, -r[32:, 0] * q
    rj, vj = jax.jit(jl.solve_cubic_real)(j(a), j(b), j(c), j(d))
    rt, vt = tl.solve_cubic_real(t(a), t(b), t(c), t(d))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    close(rt, rj, atol=1e-4)


def test_solve_quartic_real():
    rng = np.random.default_rng(1)
    # Well-separated roots (spacing >= 0.4): clustered roots make the f32
    # closed form ill-conditioned on both sides.
    roots = -2.0 + np.cumsum(rng.uniform(0.4, 1.0, (64, 4)), -1)
    coefs = np.stack([np.poly(r) for r in roots])  # [64, 5]
    coefs[32:] = np.stack([np.polymul([1, -r[0]], np.polymul([1, -r[1]],
                                                            [1, 0, 1.5]))
                           for r in roots[32:]])  # two real roots
    rj, vj = jax.jit(jl.solve_quartic_real)(*(j(coefs[:, k]) for k in range(5)))
    rt, vt = tl.solve_quartic_real(*(t(coefs[:, k]) for k in range(5)))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    close(rt, rj, atol=1e-4)


def test_solve_unrolled_values_and_pivot_flag():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(32, 8, 8))
    A[5] = 0.0                       # no pivot at all
    A[7, 3] = 0.0                    # a zero row: the last pivot is exactly 0
    b = rng.normal(size=(32, 8))
    xj, okj = jax.jit(jl.solve_unrolled)(j(A), j(b))
    xt, okt = tl.solve_unrolled(t(A), t(b))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    good = np.asarray(okj)
    assert good.sum() == 30
    close(xt.numpy()[good], np.asarray(xj)[good], rtol=1e-3, atol=1e-4)


def test_nullspace_last_fast_up_to_sign():
    rng = np.random.default_rng(3)
    h = rng.normal(size=(16, 9))
    basis = rng.normal(size=(16, 18, 9))
    A = basis - (basis @ h[..., None]) * h[:, None, :] / (h * h).sum(-1)[:, None, None]
    A += rng.normal(scale=1e-4, size=A.shape)
    xj = np.asarray(jax.jit(jl.nullspace_last_fast)(j(A)))
    xt = tl.nullspace_last_fast(t(A)).numpy()
    close(np.abs((xj * xt).sum(-1)), np.ones(16), rtol=0, atol=1e-4)


def test_inv3x3_and_eigh_svd_spectra():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(32, 3, 3))
    close(tl.inv3x3(t(A)), jl.inv3x3(j(A)), rtol=1e-4, atol=1e-4)
    close(tl.inv3x3(t(A), eps=0.5), jl.inv3x3(j(A), eps=0.5), rtol=1e-4,
          atol=1e-4)
    S = A @ np.swapaxes(A, -1, -2)
    close(tl.eigh3x3(t(S))[0], jax.jit(jl.eigh3x3)(j(S))[0], atol=1e-4)
    close(tl.svd3x3(t(A))[1], jax.jit(jl.svd3x3)(j(A))[1], atol=1e-4)


# --------------------------------------------------------------------------
# rotation
# --------------------------------------------------------------------------
def test_hat_exp_log():
    rng = np.random.default_rng(5)
    w = rng.normal(scale=1.0, size=(32, 3))
    w[0] = 0.0
    w[1] = 1e-6
    close(tr.hat(t(w)), jr.hat(j(w)))
    close(tr.exp_so3(t(w)), jr.exp_so3(j(w)))
    R = rotations(rng, 32)
    close(tr.log_so3(t(R)), jax.jit(jr.log_so3)(j(R)), atol=1e-4)


def test_project_to_so3():
    rng = np.random.default_rng(6)
    R = rotations(rng, 16)
    M = R * rng.uniform(0.5, 2.0, (16, 1, 3)) + rng.normal(scale=0.05, size=R.shape)
    close(tr.project_to_so3(t(M)), jax.jit(jr.project_to_so3)(j(M)), atol=1e-4)


# --------------------------------------------------------------------------
# projection
# --------------------------------------------------------------------------
def test_intrinsics_and_pixel_normalization():
    Kj = jproj.intrinsics_from_physical(240, 127, 178, 2142, 1620, 982.67, 697.95)
    Kt = tproj.intrinsics_from_physical(240, 127, 178, 2142, 1620, 982.67, 697.95)
    close(Kt, Kj)
    pix = np.random.default_rng(7).uniform(0, 2000, (20, 2))
    close(tproj.normalize_pixels(t(pix), Kt), jproj.normalize_pixels(j(pix), Kj))


def test_project_points_and_east_axis_projection():
    rng = np.random.default_rng(8)
    X = rng.uniform(-2, 2, (4, 13, 3)) + [0, 0, 8]
    R = rotations(rng, 4) * 0 + np.eye(3)
    tv = rng.normal(scale=0.3, size=(4, 3))
    K = np.array([[900.0, 0, 400], [0, 880, 300], [0, 0, 1]])
    pj, zj = jproj.project_points(j(X), j(R), j(tv), j(K))
    pt, zt = tproj.project_points(t(X), t(R), t(tv), t(K))
    close(pt, pj, atol=1e-3)
    close(zt, zj)
    P = np.stack([rng.uniform(1500, 4000, 13), rng.uniform(-600, 600, 13),
                  rng.uniform(-50, 250, 13)], 1)
    cams = rng.normal(scale=50.0, size=(6, 3))
    (aj, dj), (at, dt) = (jproj.east_axis_plane_projection(j(P)[None], j(cams)),
                          tproj.east_axis_plane_projection(t(P)[None], t(cams)))
    close(at, aj)
    close(dt, dj)


# --------------------------------------------------------------------------
# homography
# --------------------------------------------------------------------------
def _h_problem(seed, n=13, batch=8):
    rng = np.random.default_rng(seed)
    H = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0], [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, (batch, n, 2))
    dst = np.asarray(jh.apply_h(j(H), j(src))) + rng.normal(scale=0.5, size=(batch, n, 2))
    w = (rng.uniform(size=(batch, n)) > 0.2).astype(np.float32)
    return f32(src), f32(dst), w, H


def test_normalization_apply_transfer():
    src, dst, w, H = _h_problem(9)
    close(th.normalization_transform(t(src), t(w)),
          jh.normalization_transform(j(src), j(w)))
    close(th.normalization_transform(t(src)), jh.normalization_transform(j(src)))
    close(th.apply_h(t(H), t(src)), jh.apply_h(j(H), j(src)), atol=1e-3)
    close(th.transfer_errors(t(H), t(src), t(dst)),
          jh.transfer_errors(j(H), j(src), j(dst)), rtol=1e-3, atol=1e-3)


def test_dlt_homography_weighted():
    src, dst, w, _ = _h_problem(10)
    Ht = th.dlt_homography(t(src), t(dst), t(w))
    Hj = jax.jit(jh.dlt_homography)(j(src), j(dst), j(w))
    # Compare the maps, not the 9 numbers: predictions on the points.
    close(th.apply_h(Ht, t(src)), jh.apply_h(Hj, j(src)), rtol=1e-4, atol=1e-2)


def test_dlt_homography_minimal_and_ok_flag():
    src, dst, _, _ = _h_problem(11, n=4, batch=32)
    src[3] = src[3, 0]  # one point four times: no pivot survives
    Ht, okt = th.dlt_homography_minimal(t(src), t(dst))
    Hj, okj = jax.jit(jh.dlt_homography_minimal)(j(src), j(dst))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    good = np.asarray(okj)
    assert not good[3] and good.sum() == 31
    close(Ht.numpy()[good], np.asarray(Hj)[good], rtol=1e-3, atol=1e-3)


def test_sample_is_degenerate():
    rng = np.random.default_rng(12)
    pts = rng.uniform(-1, 1, (64, 4, 2))
    pts[::4, 2] = 0.5 * (pts[::4, 0] + pts[::4, 1])  # collinear triple
    np.testing.assert_array_equal(th.sample_is_degenerate(t(pts)).numpy(),
                                  np.asarray(jax.jit(jh.sample_is_degenerate)(j(pts))))
    assert th.sample_is_degenerate(t(pts)).numpy()[::4].all()


# --------------------------------------------------------------------------
# pnp
# --------------------------------------------------------------------------
def _pnp_problem(seed, n):
    rng = np.random.default_rng(seed)
    R = rotations(rng, 1)[0]
    tv = np.array([0.2, -0.1, 6.0])
    X = rng.uniform(-2, 2, (n, 3)) * [1, 1, 0.5]
    Xc = X @ R.T + tv
    return f32(X), f32(Xc[:, :2] / Xc[:, 2:]), R, tv


def geodesic64(R1, R2):
    R1, R2 = (np.asarray(R, np.float64) for R in (R1, R2))
    tr_ = np.trace(R1.T @ R2)
    return float(np.arccos(np.clip((tr_ - 1.0) / 2.0, -1.0, 1.0)))


def assert_pose(R_port, t_port, R_ref, t_ref, rtol=1e-3):
    ang = geodesic64(R_port, R_ref)
    assert ang < 1e-3, ang
    np.testing.assert_allclose(np.asarray(t_port), np.asarray(t_ref), rtol=rtol,
                               atol=1e-3)


def test_bearings_triad_absolute_orientation():
    X, xn, R, tv = _pnp_problem(13, 8)
    close(tp.bearing_vectors(t(xn)), jp.bearing_vectors(j(xn)))
    Xc = f32(X @ R.T + tv)
    Rt, tt = tp.triad_orientation(t(X[:3]), t(Xc[:3]))
    Rj, tj = jax.jit(jp.triad_orientation)(j(X[:3]), j(Xc[:3]))
    assert_pose(Rt, tt, Rj, tj)
    w = np.ones(8, np.float32)
    w[2] = 0.0
    Rt, tt = tp.absolute_orientation(t(X), t(Xc), t(w))
    Rj, tj = jax.jit(jp.absolute_orientation)(j(X), j(Xc), j(w))
    assert_pose(Rt, tt, Rj, tj)
    assert_pose(Rt, tt, R, tv)


@pytest.mark.parametrize("seed", [14, 15, 16])
def test_p3p_grunert(seed):
    X, xn, R, tv = _pnp_problem(seed, 3)
    Rt, tt, vt = tp.p3p_grunert(t(X), t(xn))
    Rj, tj, vj = jax.jit(jp.p3p_grunert)(j(X), j(xn))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    for k in np.where(np.asarray(vj))[0]:
        assert_pose(Rt[k], tt[k], Rj[k], tj[k])
    # The true pose is among the valid roots.
    errs = [geodesic64(Rt[k], R) for k in np.where(vt.numpy())[0]]
    assert min(errs) < 1e-3


def test_epnp_and_dlt_pnp():
    X, xn, R, tv = _pnp_problem(17, 12)
    xn = xn + np.random.default_rng(17).normal(scale=1e-4, size=xn.shape).astype(np.float32)
    w = np.ones(12, np.float32)
    w[[3, 7]] = 0.0
    Rt, tt, vt = tp.epnp(t(X), t(xn), t(w))
    Rj, tj, vj = jax.jit(jp.epnp)(j(X), j(xn), j(w))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    for k in range(2):
        assert_pose(Rt[k], tt[k], Rj[k], tj[k])
    Rt, tt = tp.dlt_pnp(t(X), t(xn), t(w))
    Rj, tj = jax.jit(jp.dlt_pnp)(j(X), j(xn), j(w))
    assert_pose(Rt, tt, Rj, tj)


# --------------------------------------------------------------------------
# lm
# --------------------------------------------------------------------------
def test_refine_homography_batched_matches_jax():
    src, dst, w, _ = _h_problem(18, batch=4)
    H0 = np.asarray(jax.jit(jh.dlt_homography)(j(src), j(dst), j(w)))
    H0 = H0 * (1 + np.random.default_rng(18).normal(scale=1e-3, size=H0.shape))
    Ht, rt = tlm.refine_homography(t(H0), t(src), t(dst), t(w), max_iters=10)
    for b in range(4):
        Hj, rj = jax.jit(partial(jlm.refine_homography, max_iters=10))(
            j(H0[b]), j(src[b]), j(dst[b]), j(w[b]))
        close(th.apply_h(Ht[b], t(src[b])), jh.apply_h(Hj, j(src[b])),
              rtol=1e-3, atol=1e-2)
        close(rt.cost[b], rj.cost, rtol=1e-3)


def test_refine_pose_matches_jax():
    X, xn, R, tv = _pnp_problem(19, 10)
    K = np.array([[900.0, 0, 400], [0, 950, 300], [0, 0, 1]], np.float32)
    pix = f32(xn * [900.0, 950.0] + [400.0, 300.0])
    pix += np.random.default_rng(19).normal(scale=0.5, size=pix.shape).astype(np.float32)
    r0 = np.asarray(jax.jit(jr.log_so3)(j(R))) + 0.02
    t0 = f32(tv + [0.05, -0.03, 0.1])
    w = np.ones(10, np.float32)
    rj, tj, _ = jax.jit(partial(jlm.refine_pose, max_iters=10))(
        j(r0), j(t0), j(X), j(pix), j(K), j(w))
    rt, tt, res = tlm.refine_pose(t(r0)[None], t(t0)[None], t(X)[None],
                                  t(pix)[None], t(K)[None], t(w)[None],
                                  max_iters=10)
    assert_pose(tr.exp_so3(rt[0]).numpy(), tt[0], jr.exp_so3(rj), tj)
    assert res.x.dtype == torch.float32


def test_levenberg_marquardt_batch_equals_items():
    """The per-item done mask: a batch gives what each item gives alone."""
    src, dst, w, _ = _h_problem(20, batch=3)
    H0 = th.dlt_homography(t(src), t(dst), t(w))
    Hb, rb = tlm.refine_homography(H0, t(src), t(dst), t(w), max_iters=6)
    for b in range(3):
        Hi, ri = tlm.refine_homography(H0[b:b + 1], t(src[b:b + 1]),
                                       t(dst[b:b + 1]), t(w[b:b + 1]), max_iters=6)
        close(Hb[b], Hi[0], rtol=1e-5, atol=1e-5)
        assert int(rb.iterations[b]) == int(ri.iterations[0])


def test_config_carries_across():
    jc = jcfg.LocalizeConfig(ransac=jcfg.RansacConfig(threshold=40.0),
                             grid_code_min=7)
    tc = tcfg.from_dict(tcfg.LocalizeConfig, dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.ransac.threshold == 40.0 and tc.pnp_ransac.threshold == 30.0
    assert dataclasses.asdict(tcfg.LocalizeConfig()) == dataclasses.asdict(
        jcfg.LocalizeConfig())
