"""The plain reference of the BAL deployment: the seeded problem, its own
BAL parser, BAL's camera model and the bundle adjuster's schedule, in
plain PyTorch.  Imports nothing of the program and nothing of JAX.

**The model** (Agarwal, Snavely, Seitz and Szeliski, "Bundle Adjustment
in the Large", ECCV 2010, grail.cs.washington.edu/projects/bal): a camera
is 9 numbers, a Rodrigues vector w, a translation t, a focal length f and
radial distortion k1, k2; a point X projects to

    P = R(w) X + t,   p = -P / P_z,   p' = f (1 + k1 |p|^2 + k2 |p|^4) p,

the camera looking down -z and the observations centred on the image.
R(w) is the matrix exponential of the skew matrix of w
(``torch.linalg.matrix_exp``), not the program's closed-form Rodrigues.
The residual is p' minus the observation; the cost 0.5 sum |r|^2.

**The solver** is Ceres Solver's ``examples/bundle_adjuster.cc`` on a BAL
problem: Levenberg-Marquardt, the reduced camera system solved
iteratively (conjugate gradients on the Schur complement) with a
camera block-Jacobi preconditioner, no robust loss.  Its schedule is the
program's, so that the two can be held pass for pass:

- Jacobians from autograd (``jacrev`` under ``vmap``): each
  observation's with respect to its camera's R, t, f, k1, k2 and its point,
  chained with each camera's dR/dw; observations in chunks;
- damping: U + lam diag(max(diag U, 1e-6)) and the same for V, from lam
  1e-3, x0.5 on an accepted step (cost lower), x4 on a rejected one,
  clamped to [1e-10, 1e8], done on an accepted step within rtol or at the
  cap; 1e-9 I is added to each damped V before it is inverted and 1e-8 I
  to each damped camera block before the preconditioner's inverse;
- camera 0 held fixed (its rows of the reduced system masked);
- PCG on the reduced camera system, a fixed count of iterations, warm
  started from the last accepted camera step (zero after a rejection),
  its iterate frozen once sum(r^2) <= tol |b|^2 (tol 1e-4: Ceres's
  forcing eta 1e-2 on the residual norm);
- points by back-substitution.

Departures from the published description: Ceres caps the PCG at 500
iterations and its trust-region radius is another schedule; here both are
the program's (a fixed count, the damping above), as the configuration's
``assumed`` says.  Ceres leaves the gauge free; here camera 0 is fixed.

``Prec`` sets the arithmetic: float64 is the reference; float32 with its
matrix products in TF32 (``tf32_round`` on both operands, as the tensor
cores take float32 products with TF32 on) is the control, the precision
step below the deployment's float32 with TF32 off.  The products inside
autograd's Jacobians stay float32 in the control (bit rounding has no
derivative); the Jacobians themselves enter every later product rounded.

**The problem** (``make_problem``) is made from a seed at a published
problem's counts, on the device: a scene of cameras on a sphere looking
at a shell of points about its centre, each point seen by the L cameras
nearest to it, L drawn from a discrete power law; see the
configuration's ``assumed``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Observations linearised at a time.
CHUNK = 1 << 19
DAMPING_MAX = 1e8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest,
    ties to even)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


@dataclass(frozen=True)
class Prec:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b


REFERENCE = Prec()
CONTROL = Prec(torch.float32, tf32=True)


# ------------------------------------------------------------ the BAL file
def parse_bal(text: str) -> dict:
    """BAL text -> {cameras [C, 9], points [P, 3], obs_cam, obs_pt [O],
    obs_uv [O, 2]} as float64 / int64 numpy arrays."""
    head, _, rest = text.partition("\n")
    n_cam, n_pt, n_obs = (int(v) for v in head.split())
    vals = np.array(rest.split(), dtype=np.float64)
    if vals.size != 4 * n_obs + 9 * n_cam + 3 * n_pt:
        raise ValueError("not a BAL problem")
    obs = vals[:4 * n_obs].reshape(n_obs, 4)
    return {"cameras": vals[4 * n_obs:4 * n_obs + 9 * n_cam].reshape(n_cam, 9),
            "points": vals[4 * n_obs + 9 * n_cam:].reshape(n_pt, 3),
            "obs_cam": obs[:, 0].astype(np.int64), "obs_pt": obs[:, 1].astype(np.int64),
            "obs_uv": obs[:, 2:].copy()}


# ------------------------------------------------------------ the model
def _skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def rotation(w: torch.Tensor) -> torch.Tensor:
    """R(w) [..., 3, 3] = exp of the skew matrix of w [..., 3]."""
    return torch.linalg.matrix_exp(_skew(w))


def project_rotated(R, rest, X, P: Prec = REFERENCE, ad: bool = False):
    """BAL's projection by rotations R [N, 3, 3] and the cameras' other
    parameters ``rest`` [N, 6] (t, f, k1, k2) of points X [N, 3] ->
    ([N, 2] pixels, [N] P_z).  ``ad``: inside autograd (plain products)."""
    RX = (R @ X[..., None]) if ad else P.mm(R, X[..., None])
    Pc = RX[..., 0] + rest[..., :3]
    p = -Pc[..., :2] / Pc[..., 2:3]
    r2 = (p * p).sum(-1, keepdim=True)
    return rest[..., 3:4] * (1.0 + rest[..., 4:5] * r2 + rest[..., 5:6] * r2 * r2) * p, Pc[..., 2]


@dataclass
class Problem:
    """Observations of a BAL problem on a device, in the precision's
    dtype."""
    obs_cam: torch.Tensor   # [O]
    obs_pt: torch.Tensor    # [O]
    obs_uv: torch.Tensor    # [O, 2]
    n_cam: int
    n_pt: int


def problem_of(parsed: dict, P: Prec, device) -> Problem:
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return Problem(t(parsed["obs_cam"]), t(parsed["obs_pt"]),
                   t(parsed["obs_uv"]).to(P.dtype), len(parsed["cameras"]),
                   len(parsed["points"]))


def _chunks(n: int):
    return [(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]


def cost(pb: Problem, cams: torch.Tensor, pts: torch.Tensor, P: Prec = REFERENCE):
    """0.5 sum |r|^2 (a 0-d tensor of the precision's dtype); each
    camera's R once."""
    R = rotation(cams[:, :3])
    total = torch.zeros((), dtype=P.dtype, device=cams.device)
    for a, b in _chunks(len(pb.obs_cam)):
        ci = pb.obs_cam[a:b]
        pix, _ = project_rotated(R[ci], cams[ci, 3:], pts[pb.obs_pt[a:b]], P)
        r = pix - pb.obs_uv[a:b]
        total = total + 0.5 * (r * r).sum()
    return total


def _residual_one(R9, rest, x, uv):
    pix, _ = project_rotated(R9.view(3, 3)[None], rest[None], x[None], ad=True)
    return pix[0] - uv


#: d r / d (R's 9 entries, t f k1 k2, X) of one observation, by reverse-mode
#: autograd; chained with d R / d w of its camera, also by autograd.
_jac = torch.func.vmap(torch.func.jacrev(_residual_one, argnums=(0, 1, 2)))
_dR_dw = torch.func.vmap(torch.func.jacrev(rotation))


def linearize(pb: Problem, cams, pts, a: int, b: int, R, dRdw, P: Prec):
    """(r [n, 2], Jc [n, 2, 9], Jp [n, 2, 3]) of observations a..b, given
    each camera's R and dR/dw."""
    ci = pb.obs_cam[a:b]
    X, rest = pts[pb.obs_pt[a:b]], cams[ci, 3:]
    JR, Jrest, Jp = _jac(R[ci].reshape(-1, 9), rest, X, pb.obs_uv[a:b])
    pix, _ = project_rotated(R[ci], rest, X, P)
    return pix - pb.obs_uv[a:b], torch.cat([JR @ dRdw[ci], Jrest], -1), Jp


# ------------------------------------------------------------ one LM step
def _damped(A: torch.Tensor, lam) -> torch.Tensor:
    d = torch.clamp(A.diagonal(dim1=-2, dim2=-1), min=1e-6)
    return A + torch.diag_embed(lam * d)


def _bmv(P: Prec, A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector products A [N, m, n] x [N, n] -> [N, m]."""
    return P.mm(A, x[..., None])[..., 0]


def step(pb: Problem, cams, pts, lam, dc_warm, cg_iters: int, cg_tol: float, P: Prec):
    """One damped Gauss-Newton step by PCG on the Schur complement:
    (dc [C, 9], dp [P, 3])."""
    dt, dev = cams.dtype, cams.device
    C, Np = pb.n_cam, pb.n_pt
    U = torch.zeros(C, 9, 9, dtype=dt, device=dev)
    V = torch.zeros(Np, 3, 3, dtype=dt, device=dev)
    gc = torch.zeros(C, 9, dtype=dt, device=dev)
    gp = torch.zeros(Np, 3, dtype=dt, device=dev)
    W = []
    R, dRdw = rotation(cams[:, :3]), _dR_dw(cams[:, :3]).reshape(-1, 9, 3)
    for a, b in _chunks(len(pb.obs_cam)):
        ci, pi = pb.obs_cam[a:b], pb.obs_pt[a:b]
        r, Jc, Jp = linearize(pb, cams, pts, a, b, R, dRdw, P)
        JcT, JpT = Jc.transpose(-1, -2), Jp.transpose(-1, -2)
        U.index_add_(0, ci, P.mm(JcT, Jc))
        V.index_add_(0, pi, P.mm(JpT, Jp))
        gc.index_add_(0, ci, -_bmv(P, JcT, r))
        gp.index_add_(0, pi, -_bmv(P, JpT, r))
        W.append(P.mm(JcT, Jp))                                 # [n, 9, 3]
    W = torch.cat(W)
    Ud = _damped(U, lam)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Vinv = torch.linalg.inv(_damped(V, lam) + 1e-9 * eye3)
    mask = (torch.arange(C, device=dev) > 0).to(dt)[:, None]
    Wt = W.transpose(-1, -2)

    def pt_sum(v):
        return torch.zeros(Np, 3, dtype=dt, device=dev).index_add_(0, pb.obs_pt, v)

    def cam_sum(v):
        return torch.zeros(C, 9, dtype=dt, device=dev).index_add_(0, pb.obs_cam, v)

    def S(x):
        x = x * mask
        u = _bmv(P, Vinv, pt_sum(_bmv(P, Wt, x[pb.obs_cam])))
        return (_bmv(P, Ud, x) - cam_sum(_bmv(P, W, u[pb.obs_pt]))) * mask

    b = (gc - cam_sum(_bmv(P, W, _bmv(P, Vinv, gp)[pb.obs_pt]))) * mask
    Minv = torch.linalg.inv(Ud + 1e-8 * torch.eye(9, dtype=dt, device=dev))
    dc = pcg(S, b, lambda r: _bmv(P, Minv, r), cg_iters, cg_tol, dc_warm) * mask
    dp = _bmv(P, Vinv, gp - pt_sum(_bmv(P, Wt, dc[pb.obs_cam])))
    return dc, dp


def pcg(S, b, prec, n_iters: int, tol: float, x0):
    """Preconditioned CG from x0, ``n_iters`` iterations, the iterate
    frozen once sum(r^2) <= tol |b|^2 (tested before each iteration)."""
    guard = lambda v: torch.where(v.abs() < 1e-30, torch.full_like(v, 1e-30), v)  # noqa: E731
    x, r = x0, b - S(x0)
    z = prec(r)
    d, rz = z, (r * z).sum()
    bound = tol * torch.clamp((b * b).sum(), min=1e-30)
    for _ in range(n_iters):
        go = (r * r).sum() > bound
        Sd = S(d)
        alpha = rz / guard((d * Sd).sum())
        x_new, r_new = x + alpha * d, r - alpha * Sd
        z = prec(r_new)
        rz_new = (r_new * z).sum()
        d_new = z + rz_new / guard(rz) * d
        x = torch.where(go, x_new, x)
        r = torch.where(go, r_new, r)
        d = torch.where(go, d_new, d)
        rz = torch.where(go, rz_new, rz)
    return x


# ------------------------------------------------------------ the schedule
def solve(pb: Problem, cams0, pts0, passes: int, cg_iters: int, cg_tol: float,
          rtol: float = 0.0, P: Prec = REFERENCE) -> dict:
    """LM from (cams0, pts0): {cameras, points, cost, initial_cost}
    after ``passes`` passes (fewer where it is done)."""
    cams, pts = cams0.to(P.dtype), pts0.to(P.dtype)
    c = c0 = cost(pb, cams, pts, P)
    lam = torch.tensor(1e-3, dtype=P.dtype, device=cams.device)
    dc_prev = torch.zeros_like(cams)
    for _ in range(passes):
        dc, dp = step(pb, cams, pts, lam, dc_prev, cg_iters, cg_tol, P)
        c_new = cost(pb, cams + dc, pts + dp, P)
        if bool(c_new < c):
            done = bool((c - c_new).abs() <= rtol * torch.clamp(c, min=1e-30))
            cams, pts, c = cams + dc, pts + dp, c_new
            lam, dc_prev = torch.clamp(lam * 0.5, min=1e-10), dc
        else:
            lam = torch.clamp(lam * 4.0, max=DAMPING_MAX)
            done, dc_prev = bool(lam >= DAMPING_MAX), torch.zeros_like(dc)
        if done:
            break
    return {"cameras": cams, "points": pts, "cost": float(c), "initial_cost": float(c0)}


# ------------------------------------------------------------ the problem
def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def track_lengths(n_pt: int, n_obs: int, lo: int, hi: int, exponent: float,
                  g: torch.Generator, device) -> torch.Tensor:
    """[n_pt] track lengths: the discrete power law p(L) ~ L^-exponent on
    [lo, hi] at jittered strata (i + u_i) / n_pt, in a seeded order, the
    last tracks then trimmed (or lengthened) one observation at a time,
    within [lo, hi], so that they sum to ``n_obs``."""
    L = torch.arange(lo, hi + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(L ** -exponent, 0)
    cdf = cdf / cdf[-1]
    u = (torch.arange(n_pt, dtype=torch.float64, device=device)
         + torch.rand(n_pt, generator=g, dtype=torch.float64, device=device)) / n_pt
    n = torch.searchsorted(cdf, u.clamp(max=cdf[-1])) + lo
    n = n[torch.randperm(n_pt, generator=g, device=device)]
    excess = int(n.sum()) - n_obs
    room = (n - lo) if excess > 0 else (hi - n)
    if abs(excess) > int(room.sum()):
        raise ValueError(f"{n_obs} observations cannot be {n_pt} tracks on [{lo}, {hi}]")
    before = torch.flip(torch.cumsum(torch.flip(room, [0]), 0), [0]) - room  # room after i
    take = (abs(excess) - before).clamp(min=0).minimum(room)
    return n - take if excess > 0 else n + take


def make_problem(scene: dict, n_cam: int, n_pt: int, n_obs: int, seed: int, device) -> dict:
    """The seeded problem: {cameras [C, 9], points [P, 3] (the truth,
    float64), obs_cam, obs_pt [O] (by point, cameras ascending in a
    track), obs_uv [O, 2] float32 (projections plus noise), longest
    track}.  ``scene`` is the configuration's ``scene``."""
    f64 = dict(dtype=torch.float64, device=device)
    g = _gen(seed, 1, device)
    # Cameras: a random orientation each, placed at ``camera_distance`` from
    # the centre along the direction they look (-z); then each turned off
    # that direction by ``look_jitter_rad`` (N(0, .) added to its rvec).
    axis = torch.randn(n_cam, 3, generator=g, **f64)
    angle = torch.rand(n_cam, 1, generator=g, **f64) * scene["max_rotation_rad"]
    w = axis / axis.norm(dim=1, keepdim=True) * angle
    centre = scene["camera_distance"] * rotation(w)[:, 2, :]
    w = w + torch.randn(n_cam, 3, generator=g, **f64) * scene["look_jitter_rad"]
    R = rotation(w)
    t = -(R @ centre[..., None])[..., 0]
    f = scene["focal_px"] * torch.exp(torch.randn(n_cam, 1, generator=g, **f64)
                                      * scene["focal_log_sd"])
    k1 = torch.randn(n_cam, 1, generator=g, **f64) * scene["k1_sd"]
    k2 = torch.randn(n_cam, 1, generator=g, **f64) * scene["k2_sd"]
    cams = torch.cat([w, t, f, k1, k2], 1)
    # Points: uniform in a spherical shell.
    d = torch.randn(n_pt, 3, generator=g, **f64)
    r0, r1 = (r ** 3 for r in scene["point_shell"])
    rad = (r0 + (r1 - r0) * torch.rand(n_pt, 1, generator=g, **f64)) ** (1.0 / 3.0)
    pts = d / d.norm(dim=1, keepdim=True) * rad
    # Tracks: each point seen by the L cameras nearest to it.
    law = scene["track_law"]
    L = track_lengths(n_pt, n_obs, law["min"], min(law["max"], n_cam), law["exponent"], g,
                      device)
    cam_idx, pt_idx = [], []
    step_pts = max(1, (1 << 27) // max(n_cam, 1))
    for a in range(0, n_pt, step_pts):
        b = min(a + step_pts, n_pt)
        d2 = torch.cdist(pts[a:b], centre)                        # [n, C]
        order = torch.argsort(d2, dim=1)
        near = torch.arange(n_cam, device=device)[None, :] < L[a:b, None]
        seen = torch.zeros_like(near).scatter_(1, order, near)
        nz = seen.nonzero()                                       # by point, then camera
        pt_idx.append(nz[:, 0] + a)
        cam_idx.append(nz[:, 1])
    obs_cam, obs_pt = torch.cat(cam_idx), torch.cat(pt_idx)
    pix, depth = project_rotated(R[obs_cam], cams[obs_cam, 3:], pts[obs_pt])
    if not bool((depth < -scene["min_depth"]).all()):
        raise ValueError("a point lies behind or too near a camera that sees it")
    noise = torch.randn(pix.shape, generator=g, **f64) * scene["noise_px"]
    return {"cameras": cams, "points": pts, "obs_cam": obs_cam, "obs_pt": obs_pt,
            "obs_uv": (pix + noise).to(torch.float32), "longest_track": int(L.max())}


def make_start(truth: dict, start: dict, seed: int, k: int) -> tuple:
    """Start ``k``: (cameras [C, 9], points [P, 3]) float32, the truth
    perturbed from (seed, k); camera 0 left at the truth."""
    cams, pts = truth["cameras"], truth["points"]
    g = _gen(seed, 100 + k, cams.device)
    n = lambda shape: torch.randn(shape, generator=g, dtype=cams.dtype,  # noqa: E731
                                  device=cams.device)
    sd = torch.tensor([start["rotation_rad"]] * 3 + [start["translation"]] * 3
                      + [0.0, start["k1"], start["k2"]], dtype=cams.dtype, device=cams.device)
    c = cams + n(cams.shape) * sd
    c[:, 6] = cams[:, 6] * torch.exp(n(cams.shape[:1]) * start["focal_rel"])
    c[0] = cams[0]
    p = pts + n(pts.shape) * start["point"]
    return c.to(torch.float32), p.to(torch.float32)

