"""The LM kernel (``csrc/lm.cu``, ``csrc/lm.cuh``) against the plain loop
``ransac_tpu_torch.ops.lm.levenberg_marquardt``.

The kernels' arithmetic (``lm.cuh``), built for the host with its 32 lanes
run one after another (``lm::SerialLanes``), is held against the plain loop
on the CPU, for both models; on the card, ``refine_pose`` launches the pose
kernel (``cuda``-marked tests), which is held against the same loop.  The
homography LM runs on the card only inside the fused homography refit,
whose card tests (``tests/test_torch_refit_kernel.py``) hold it to the host
build bit for bit.
The cases: the engine's search refit (458 candidates x 13 landmarks of a
planted scene with two moved annotations, weighted by each candidate's
inliers, some rows 0), its PnP refit (1 x 13), a 1 x 1024 homography pool,
all-zero weights, a NaN start, a start with a point's w in the |w| < 1e-12
guard, and a rotation vector in ``exp_so3``'s Taylor region.

Limits.  Both sides round every operation on its own in float32, but the
kernel sums the points in its lanes' order (lane l takes points l, l + 32,
..., then a butterfly) where torch's matrix products and sums take their
own, so the normal equations differ by float32 rounding, and so does every
step after.  A 10-pass float32 LM ends near its cost's rounding floor, and
on the engine's weakly held candidates (6-8 inliers) two float32 orders of
summation end 0.05 px apart on the weighted points and 0.4 px on the
others, each as far from the float64 loop as the other.  So the kernel is
held to the float64 loop from the same start as the float32 loop is: the
projection of every point, and the final cost, no further from the
float64 loop's than ``SLACK`` times the float32 loop's largest distance,
plus ``PX_FLOOR`` px (where that is 0) and ``COST_FLOOR`` relative: a
float32 cost is a sum of squared residuals of pixels in the thousands,
each off by up to half an ulp (3e-5 px at 1000 px), which moves the PnP
case's 0.35 px^2 from 22 residuals of ~0.2 px by up to 8e-4 of itself
whatever x is; NaN in
the float32 loop's places, and its passes run and done exactly (at <= 12
passes no float32 item can finish, a step being taken only on a decrease
of at least an ulp, far above rtol 1e-10, but a NaN item, rejecting every
pass, reaches the damping cap at pass 11).
"""

import csv
import math

import numpy as np
import pytest
import torch
from torch.func import jacfwd

from ransac_tpu_torch.io import synthetic
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import homography as th
from ransac_tpu_torch.ops import lm
from ransac_tpu_torch.ops.projection import east_axis_plane_projection, project_points
from ransac_tpu_torch.ops.rotation import exp_so3, log_so3
from ransac_tpu_torch.utils.config import CameraIntrinsicsConfig
import torch_host_build  # tests/ is on sys.path under pytest
from torch_threads import one_torch_thread  # noqa: F401

SLACK = 2.0
PX_FLOOR = 1e-3
COST_FLOOR = 1e-3
CASES = ["engine_458x13", "pose_1x13", "homography_1x1024", "zero_weights",
         "nan_start", "w_guard", "rvec_taylor"]
POSE_CASES = ["pose_1x13", "rvec_taylor"]


def _f32(*arrays):
    return [torch.as_tensor(np.array(a), dtype=torch.float32) for a in arrays]


def _film_K():
    ic = CameraIntrinsicsConfig()
    W, H = synthetic.IMAGE_SIZE
    return np.array([[ic.focal_length_mm / ic.sensor_width_mm * W, 0.0, ic.cx],
                     [0.0, ic.focal_length_mm / ic.sensor_height_mm * H, ic.cy],
                     [0.0, 0.0, 1.0]])


def _planted_scene(seed=0, planted=200, n=13):
    """The planted scene of ``io.synthetic.write_planted_scene`` in arrays:
    (cameras [458, 3] and landmarks [n, 3] (E, N, z) centred on the
    landmarks, pixels [n, 2] with two annotations moved, the moved indices,
    the planted camera's index)."""
    with open(synthetic.GRID_CSV, encoding="utf-8") as f:
        grid = list(csv.DictReader(f))
    cams = np.array([[float(r["Z"]), float(r["X"]), float(r["Y"])] for r in grid])
    rng = np.random.default_rng(seed)
    X = cams[planted] + np.stack([rng.uniform(1500.0, 4000.0, n),
                                  rng.uniform(-600.0, 600.0, n),
                                  rng.uniform(-50.0, 250.0, n)], axis=1)
    Xc = (X - cams[planted]) @ synthetic.R_EAST.T
    K = _film_K()
    pix = np.stack([K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2],
                    K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]], axis=1)
    pix += rng.normal(scale=0.3, size=pix.shape)
    moved = np.sort(rng.choice(n, 2, replace=False))
    pix[moved] += np.array([260.0, -210.0])
    centre = X.mean(0)
    return cams - centre, X - centre, pix, moved, planted


def _homography_problem(seed, B, n=13, noise=0.5):
    rng = np.random.default_rng(seed)
    H = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0], [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, (B, n, 2))
    p = np.concatenate([src, np.ones((B, n, 1))], -1) @ H.T
    dst = p[..., :2] / p[..., 2:] + rng.normal(scale=noise, size=(B, n, 2))
    H0 = H * (1 + rng.normal(scale=1e-3, size=(B, 3, 3)))
    return _f32(H0, src, dst)


def case(name):
    """(model, args, max_iters): model "homography" with args (H0 [B,3,3],
    src, dst [B,n,2], w [B,n]), or "pose" with (rvec0, tvec0 [B,3], X
    [B,n,3], pixels [B,n,2], K [B,3,3], w [B,n])."""
    if name == "engine_458x13":
        cams, X, pix, _, _ = _planted_scene()
        pos2, _ = east_axis_plane_projection(torch.from_numpy(X)[None],
                                             torch.from_numpy(cams))
        src, pix = _f32(pos2, pix)
        dst = pix.expand(len(cams), -1, -1)  # shared, as the engine passes it
        # Each candidate's inliers at 75 px of its all-point fit, its seed the
        # weighted DLT on them, as the refit takes it.
        err = th.transfer_errors(th.dlt_homography(src, dst), src, dst)
        w = (err <= 75.0).to(torch.float32)
        return "homography", (th.dlt_homography(src, dst, w), src, dst, w), 10
    if name in ("pose_1x13", "rvec_taylor"):
        if name == "pose_1x13":
            cams, X, pix, moved, planted = _planted_scene(seed=1)
            R, c = synthetic.R_EAST, cams[planted]
            K = _film_K()
            w = np.ones(len(X))
            w[moved] = 0.0
            rvec = log_so3(torch.from_numpy(R)).numpy() + [0.01, -0.02, 0.015]
            tvec = -R @ c + [4.0, -3.0, 6.0]
        else:  # theta2 < 1e-8 at the start and at the answer
            rng = np.random.default_rng(2)
            X = rng.uniform(-2, 2, (13, 3)) * [1, 1, 0.5] + [0, 0, 6.0]
            K = np.array([[900.0, 0.0, 400.0], [0.0, 950.0, 300.0], [0.0, 0.0, 1.0]])
            R = exp_so3(torch.tensor([3e-5, -1e-5, 2e-5], dtype=torch.float64)).numpy()
            pix = (X @ R.T) @ K.T
            pix = pix[:, :2] / pix[:, 2:] + rng.normal(scale=0.3, size=(13, 2))
            w = np.ones(13)
            rvec, tvec = np.array([1e-5, -2e-5, 3e-5]), np.array([0.01, -0.02, 0.03])
        args = _f32(rvec[None], tvec[None], X[None], pix[None], K[None], w[None])
        return "pose", tuple(args), 10
    if name == "homography_1x1024":
        src, dst, n_in = synthetic.planted_homography_pool(1024)
        w = np.zeros(1024)
        w[:n_in] = 1.0
        src, dst, w = _f32(src[None], dst[None], w[None])
        H0 = th.dlt_homography(src, dst, w) * (1 + 1e-3 * torch.tensor(
            [[1.0, -1.0, 0.5], [0.5, 1.0, -0.5], [-1.0, 0.5, 0.0]]))
        return "homography", (H0, src, dst, w), 10
    H0, src, dst = _homography_problem({"zero_weights": 3, "nan_start": 4,
                                        "w_guard": 5}[name], B=3)
    w = torch.ones(src.shape[:2])
    if name == "zero_weights":
        return "homography", (H0, src, dst, torch.zeros_like(w)), 10
    if name == "nan_start":
        H0[1, 0, 2] = math.nan
        return "homography", (H0, src, dst, w), 12
    # Item 0's point 0 at (2, 0) with h31 = -0.5 h33: w = 0 at the start.
    src[:, 0] = torch.tensor([2.0, 0.0])
    H0[0, 2, 0] = -0.5 * H0[0, 2, 2]
    return "homography", (H0, src, dst, w), 10


def plain(model, args, max_iters, dtype=torch.float32):
    """The plain loop's (x, cost, iterations, converged) on the CPU, in
    ``dtype``."""
    args = [a.to(dtype) for a in args]
    if model == "homography":
        _, res = lm.refine_homography(*args, max_iters=max_iters)
    else:
        _, _, res = lm.refine_pose(*args, max_iters=max_iters)
    return res


def projections(model, x, args):
    """Each point's projection under each problem's x [B, n] -> [B, N, 2],
    in float64."""
    x, args = x.double(), [a.double() for a in args]
    if model == "homography":
        H = torch.cat([x, torch.ones_like(x[:, :1])], -1).reshape(-1, 3, 3)
        return th.apply_h(H, args[1])
    return project_points(args[2], exp_so3(x[:, :3]), x[:, 3:6], args[4])[0]


def hold(model, args, max_iters, out):
    """The kernel's (x, cost, iterations, converged) against the plain
    loop's in float32 and float64, by the limits of the module's
    docstring."""
    x, cost, it, conv = (t.cpu() for t in out)
    ref, ref64 = (plain(model, args, max_iters, d) for d in (torch.float32, torch.float64))
    assert torch.equal(it, ref.iterations) and torch.equal(conv, ref.converged)
    nan = ~torch.isfinite(x).all(-1)
    assert torch.equal(nan, ~torch.isfinite(ref.x).all(-1))
    assert torch.equal(torch.isnan(cost), torch.isnan(ref.cost))
    ok = ~nan
    a = [t[ok] for t in args]
    p64 = projections(model, ref64.x[ok], a)
    px_k = (projections(model, x[ok], a) - p64).abs().max()
    px_32 = (projections(model, ref.x[ok], a) - p64).abs().max()
    assert px_k <= SLACK * px_32 + PX_FLOOR, (float(px_k), float(px_32))
    c64 = ref64.cost[ok].clamp(min=1e-30)
    c_k = ((cost[ok].double() - c64).abs() / c64).max()
    c_32 = ((ref.cost[ok].double() - c64).abs() / c64).max()
    assert c_k <= SLACK * c_32 + COST_FLOOR, (float(c_k), float(c_32))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return torch_host_build.load(tmp_path_factory.mktemp("lm_host"))


@pytest.mark.parametrize("name", CASES)
def test_host_build_matches_plain_loop(name, host_lib):
    """``lm.cuh`` built for the host (the kernel's arithmetic and order of
    sums) against the plain loop, on every case."""
    if host_lib is None:
        pytest.skip("no host C++ compiler")
    model, args, max_iters = case(name)
    if model == "homography":
        _, out = torch_host_build.lm_homography(host_lib, *args, max_iters)
    else:
        out = torch_host_build.lm_pose(host_lib, *args, max_iters)
    hold(model, args, max_iters, out)
    if name == "nan_start":
        assert out[3].tolist() == [False, True, False]
        assert out[2].tolist() == [12, 11, 12]


def _residual_fn(model):
    return lm._homography_residuals if model == "homography" else lm._pose_residuals


def _x0(model, args):
    if model == "homography":
        H0 = args[0]
        h33 = H0[:, 2:3, 2:3]
        h33 = torch.where(h33.abs() < 1e-12, torch.ones_like(h33), h33)
        return (H0 / h33).reshape(-1, 9)[:, :8], args[1:]
    return torch.cat([args[0], args[1]], -1), args[2:]


@pytest.mark.parametrize("name", CASES)
def test_host_jacobian_matches_jacfwd(name, host_lib):
    """The kernel's forward-mode tangents (``lm::jacobian_rows``) at the
    start against ``jacfwd`` of the plain residual, on up to 16 problems of
    each case: the residuals bit for bit (the same operations in the same
    order), the Jacobian within 2e-6 of each row's largest entry (the
    tangents' products and quotients are formed in another order than
    torch's JVP formulas, a few float32 roundings)."""
    if host_lib is None:
        pytest.skip("no host C++ compiler")
    model, args, _ = case(name)
    x0, data = _x0(model, args)
    fn = _residual_fn(model)
    for b in range(min(16, x0.shape[0])):
        item = [d[b] for d in data]
        r_k, J_k = torch_host_build.lm_jacobian(host_lib, model, x0[b], *item)
        r_t = fn(x0[b:b + 1], *(d[None] for d in item))[0]
        J_t = jacfwd(lambda x: fn(x[None], *(d[None] for d in item))[0])(x0[b])
        assert torch.equal(torch.isnan(r_k), torch.isnan(r_t))
        fin = torch.isfinite(r_t)
        assert torch.equal(r_k[fin], r_t[fin])
        fin = torch.isfinite(J_t).all(-1)
        scale = J_t[fin].abs().amax(-1, keepdim=True)
        assert ((J_k[fin] - J_t[fin]).abs() <= 2e-6 * scale).all(), name
        if name == "w_guard" and b == 0:  # the guarded point: no tangent through w
            assert (J_k[:2, 6:] == 0).all() and (J_t[:2, 6:] == 0).all()


def same(a, b) -> bool:
    """a and b equal, NaN where the other is NaN."""
    a, b = a.cpu(), b.cpu()
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a[~a.isnan()], b[~b.isnan()])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", POSE_CASES)
def test_cuda_kernel_matches_plain_loop(name, cuda):
    """``refine_pose`` on CUDA float32 tensors (the kernel) against the
    plain loop."""
    model, args, max_iters = case(name)
    res = lm.refine_pose(*[a.cuda() for a in args], max_iters=max_iters)[2]
    hold(model, args, max_iters, tuple(res))


@pytest.mark.cuda
def test_cuda_counts_one_launch_a_call(cuda):
    """Each call is one launch: ``lm_pose``'s launch count + 1, ``passes`` +
    max_iters, no read of a done mask."""
    _, args, max_iters = case("pose_1x13")
    args = [a.cuda() for a in args]
    before, launches = dict(lm.COUNTS), dict(_build.LAUNCHES)
    lm.refine_pose(*args, max_iters=max_iters)
    assert lm.COUNTS == {**before, "passes": before["passes"] + max_iters}
    assert _build.LAUNCHES == {**launches, "lm_pose": launches["lm_pose"] + 1}


@pytest.mark.cuda
def test_cuda_other_dtype_raises(cuda):
    """A CUDA tensor that is not float32 raises; nothing falls back."""
    _, args, max_iters = case("pose_1x13")
    before, launches = dict(lm.COUNTS), dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        lm.refine_pose(*[a.cuda().double() for a in args], max_iters=max_iters)
    assert lm.COUNTS == before and _build.LAUNCHES == launches


@pytest.mark.cuda
def test_cuda_strided_inputs_equal_contiguous(cuda):
    """An input whose items are not contiguous is copied, one shared by
    every item (stride 0) is read in place: the same answer as contiguous
    inputs, bit for bit."""
    _, (rvec, tvec, X, pix, K, w), max_iters = case("pose_1x13")
    shift = torch.tensor([[0.0], [1e-2], [-1e-2]])
    rvec, tvec = (rvec + shift).cuda(), (tvec + 10.0 * shift).cuda()
    B = rvec.shape[0]
    X, pix, K, w = (a.cuda().expand(B, *a.shape[1:]) for a in (X, pix, K, w))  # one scene
    ref = lm.refine_pose(rvec, tvec, *(a.contiguous() for a in (X, pix, K, w)),
                         max_iters=max_iters)[2]
    rvec_t = rvec.T.contiguous().T  # items strided
    X_t = X.transpose(-1, -2).contiguous().transpose(-1, -2)  # items column-major
    assert not rvec_t[0].is_contiguous() and not X_t[0].is_contiguous()
    assert pix.stride(0) == 0
    out = lm.refine_pose(rvec_t, tvec, X_t, pix, K, w, max_iters=max_iters)[2]
    assert all(same(a, b) for a, b in zip(out, ref))
