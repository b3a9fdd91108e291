"""Bundle Adjustment in the Large (BAL) problem files.

The format of Agarwal, Snavely, Seitz and Szeliski (ECCV 2010,
grail.cs.washington.edu/projects/bal), as text or bzip2-compressed text
(a ``.bz2`` suffix):

    <n_cameras> <n_points> <n_observations>
    <camera> <point> <x> <y>          one line an observation
    <9 values a camera>               rvec (3), tvec (3), f, k1, k2
    <3 values a point>

Values are separated by any whitespace (the published files put one
camera or point value on a line).  Observations are pixels centred on the
image; the camera model is ``ba.schur_cg``'s.  Both functions are
vectorised: a file of millions of observations is one parse and one
format, with no Python loop a line.
"""

from __future__ import annotations

import bz2
import warnings

import numpy as np

from ransac_tpu_torch.ba.bundle import BAProblem, host

#: Rows formatted in one string at a time by ``write_bal``.
_CHUNK = 1 << 18


def _open(path: str, mode: str):
    if str(path).endswith(".bz2"):
        return bz2.open(path, mode + "t", encoding="ascii")
    return open(path, mode, encoding="ascii")


def read_bal(path: str) -> BAProblem:
    """A BAL file as a ``BAProblem`` of numpy arrays: cameras [C, 9] and
    points [P, 3] float32, observation indices int64, pixels [O, 2]
    float32, weights 1, K None.  Raises ``ValueError`` on a file that is
    not one."""
    with _open(path, "r") as f:
        text = f.read()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # unparsed text: sized below
        vals = np.fromstring(text, dtype=np.float64, sep=" ")
    if vals.size < 3:
        raise ValueError(f"{path}: no BAL header")
    n_cam, n_pt, n_obs = (int(v) for v in vals[:3])
    if min(n_cam, n_pt, n_obs) < 0 or not np.array_equal(vals[:3], [n_cam, n_pt, n_obs]):
        raise ValueError(f"{path}: bad BAL header {vals[:3].tolist()}")
    need = 3 + 4 * n_obs + 9 * n_cam + 3 * n_pt
    if vals.size != need:
        raise ValueError(f"{path}: {vals.size} numbers, a BAL problem of "
                         f"{n_cam} cameras, {n_pt} points and {n_obs} observations has {need}")
    obs = vals[3:3 + 4 * n_obs].reshape(n_obs, 4)
    cams = vals[3 + 4 * n_obs:3 + 4 * n_obs + 9 * n_cam].reshape(n_cam, 9)
    pts = vals[need - 3 * n_pt:].reshape(n_pt, 3)
    cam, pt = obs[:, 0].astype(np.int64), obs[:, 1].astype(np.int64)
    if (not np.array_equal(cam, obs[:, 0]) or not np.array_equal(pt, obs[:, 1])
            or n_obs and (cam.min() < 0 or cam.max() >= n_cam or pt.min() < 0
                          or pt.max() >= n_pt)):
        raise ValueError(f"{path}: observation indices outside the cameras or points")
    return BAProblem(cameras=cams.astype(np.float32), points=pts.astype(np.float32), K=None,
                     obs_cam=cam, obs_pt=pt, obs_uv=obs[:, 2:].astype(np.float32),
                     obs_w=np.ones(n_obs, np.float32))


def _lines(f, fmt: str, columns) -> None:
    """Write rows of ``columns`` (equal-length arrays) with ``fmt`` a row,
    ``_CHUNK`` rows a string."""
    n = len(columns[0])
    for i in range(0, n, _CHUNK):
        rows = [c[i:i + _CHUNK].tolist() for c in columns]
        f.write((fmt * len(rows[0])) % tuple(v for row in zip(*rows) for v in row))


def write_bal(path: str, problem: BAProblem) -> None:
    """Write a problem with BAL cameras ([C, 9]) as a BAL file (``.bz2``:
    compressed): its live observations (weight > 0) in their order, and
    every value as float32 at ``%.9g``, which reads back to the same
    float32."""
    cams = host(problem.cameras).astype(np.float32)
    if cams.ndim != 2 or cams.shape[1] != 9:
        raise ValueError(f"BAL cameras are [C, 9], not {list(cams.shape)}")
    pts = host(problem.points).astype(np.float32)
    live = np.flatnonzero(host(problem.obs_w) > 0)
    uv = host(problem.obs_uv)[live].astype(np.float32)
    with _open(path, "w") as f:
        f.write(f"{cams.shape[0]} {pts.shape[0]} {live.size}\n")
        _lines(f, "%d %d %.9g %.9g\n", [host(problem.obs_cam)[live].astype(np.int64),
                                         host(problem.obs_pt)[live].astype(np.int64),
                                         uv[:, 0], uv[:, 1]])
        _lines(f, "%.9g\n", [cams.reshape(-1)])
        _lines(f, "%.9g\n", [pts.reshape(-1)])
