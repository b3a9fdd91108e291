"""Loop closure of the port (``ransac_tpu_torch.pipelines.loop_closure``,
``pipelines.sfm._triangulate_pair_gated``) against the JAX package on the
CPU, on the JAX loop-closure tests' own scenes.

- ``loop_closure_pairs``: the same pairs on the JAX test's sliding
  visibility table.
- ``detect_closures_appearance``: fed JAX's front-end arrays of a small
  loop render (16 frames of 160 x 200): the same (fi, fj) pairs, >= 95% of
  their uv rows in common.
- ``_triangulate_pair_gated``: equal masks; points within rtol 1e-4 of
  their magnitude (float32 triangulation, each package's own rounding).
- ``closure_edge`` on the two-scale scene: the JAX test's bounds on both
  sides (rotation < 1 deg, |log s - ln 2| < 0.1, translation cos > 0.7, >=
  20 inliers, >= 20 fused pairs); port against JAX: rotation within 1 deg,
  log-scale within 0.05.  RANSAC draws differ (torch generators against
  ``jax.random``), so nothing tighter is held.
- ``apply_pose_graph`` on the drifted circuit: >= 1 loop edge on both
  sides; the port's ATE below half its start and within 20% of JAX's.
"""

import numpy as np
import pytest
import torch

from ransac_tpu_torch.pipelines import loop_closure as tlc
from ransac_tpu_torch.pipelines import sfm as tsfm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops of small CPU ops run on one torch thread: beside the
    other test workers, an intra-op thread pool costs far more than it
    gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def panning_pose(thk, r_c):
    """The JAX test's ``_panning_pose``: an outward-facing camera on a circle
    in the x-z plane."""
    c, s = np.cos(thk), np.sin(thk)
    R = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    center = np.array([r_c * np.sin(thk), 0.0, r_c * np.cos(thk)])
    return R, -R @ center


def both_maps(K, poses, points):
    """The same map as a JAX and a port ``SfmMap``."""
    from ransac_tpu.pipelines.sfm import SfmMap as JMap

    out = []
    for cls in (JMap, tsfm.SfmMap):
        m = cls(K=np.asarray(K, np.float64))
        m.camera_poses = {f: np.array(p) for f, p in poses.items()}
        m.points = {t: np.array(x) for t, x in points.items()}
        out.append(m)
    return out


def rot_deg(R1, R2):
    return float(np.degrees(np.arccos(np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1, 1))))


def test_loop_closure_pairs_match_jax():
    from ransac_tpu.pipelines.loop_closure import loop_closure_pairs

    frames = list(range(40))
    tracks = {}
    for f in frames:
        for t in range(2 * f, 2 * f + 40):
            tracks[(f, t % 80)] = np.array([1.0, 2.0])
    for kw in ({"min_gap": 16, "min_shared": 20}, {"min_gap": 8, "min_shared": 30},
               {"min_gap": 16, "min_shared": 20, "max_pairs": 1}):
        want = loop_closure_pairs(tracks, frames, **kw)
        assert want and tlc.loop_closure_pairs(tracks, frames, **kw) == want
    a, b = tlc.loop_closure_pairs(tracks, frames, min_gap=16, min_shared=20)[0]
    assert a <= 6 and b >= 33


def test_detect_closures_appearance_matches_jax():
    import jax.numpy as jnp

    from ransac_tpu.parallel.sharded_frontend import frontend_frames
    from ransac_tpu.pipelines.loop_closure import detect_closures_appearance
    from ransac_tpu.pipelines.sfm_demo import synth_trajectory_frames

    imgs = synth_trajectory_frames(F=16, H=160, W=200, n_pts=300, seed=0, loop=True)[0]
    xy, valid, desc = (np.asarray(a) for a in frontend_frames(jnp.asarray(imgs), 256, 3,
                                                              0.04, 8))
    want = detect_closures_appearance(xy, valid, desc, min_gap=8, min_matches=16)
    got = tlc.detect_closures_appearance(xy, torch.tensor(valid), torch.tensor(desc),
                                         min_gap=8, min_matches=16)
    assert [(a, b) for a, b, _, _ in got] == [(a, b) for a, b, _, _ in want]
    assert want and (want[0][0], want[0][1]) == (0, 14)
    for (_, _, ui, uj), (_, _, wi, wj) in zip(got, want):
        rows_t = {tuple(r) for r in np.concatenate([ui, uj], 1)}
        rows_j = [tuple(r) for r in np.concatenate([wi, wj], 1)]
        assert sum(r in rows_t for r in rows_j) >= 0.95 * len(rows_j)
        assert abs(len(ui) - len(wi)) <= 0.05 * len(wi)


def gated_scene(seed=0):
    """Two registered frames 0.5 apart and a third beside frame 0: 60
    points at 5-9 m (about 4 deg of parallax), 10 at 60 m (under 1 deg: the
    angle gate), 10 seen 20 px off in frame 2 (the reprojection gate)."""
    rng = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
    X = np.concatenate([
        np.stack([rng.uniform(-2, 2, 70), rng.uniform(-1.5, 1.5, 70),
                  rng.uniform(5, 9, 70)], 1),
        np.stack([rng.uniform(-15, 15, 10), rng.uniform(-10, 10, 10),
                  np.full(10, 60.0)], 1)])
    poses = {0: np.zeros(6), 2: np.array([0.0, 0.02, 0.0, -0.5, 0.0, 0.0]),
             1: np.array([0.0, 0.0, 0.0, -0.05, 0.0, 0.0])}
    tracks = {}
    for f, p in poses.items():
        R = tsfm._np_rodrigues(p[:3])
        pc = X @ R.T + p[3:]
        uv = (pc[:, :2] / pc[:, 2:]) @ K[:2, :2].T + K[:2, 2]
        uv += rng.normal(0, 0.3, uv.shape)
        if f == 2:
            uv[60:70] += 20.0
        for q in range(len(X)):
            tracks[(f, q)] = uv[q]
    return K, poses, tracks


def test_triangulate_pair_gated_matches_jax():
    import jax.numpy as jnp

    from ransac_tpu.pipelines.sfm import _triangulate_pair_gated

    K, poses, tracks = gated_scene()
    jm, tm = both_maps(K, poses, {})
    track_list = list(range(80))[::-1]
    gate_n = 2.0 * 4.0 / K[0, 0]
    for g1, g2, angle in ((0, 2, 1.0), (0, 2, 0.5), (0, 1, 1.0)):
        want = _triangulate_pair_gated(jm, tracks, g1, g2, track_list,
                                       jnp.asarray(K, jnp.float32), gate_n, angle)
        got = tsfm._triangulate_pair_gated(tm, tracks, g1, g2, track_list,
                                           torch.tensor(K, dtype=torch.float32), gate_n,
                                           angle)
        assert list(got) == list(want)
        for t, X in want.items():
            assert np.linalg.norm(got[t] - X) <= 1e-4 * np.linalg.norm(X), t
    # The gates bite: the far points by angle, the shifted ones by reprojection.
    kept = set(tsfm._triangulate_pair_gated(tm, tracks, 0, 2, track_list,
                                            torch.tensor(K, dtype=torch.float32), gate_n))
    assert kept <= set(range(60)) and len(kept) >= 55
    assert tsfm._triangulate_pair_gated(tm, tracks, 0, 2, [], None, gate_n) == {}


def two_scale_scene():
    """The JAX test's ``test_closure_edge_recovers_relative_similarity``
    scene: the loop ends' regions at map scales 1 and 2."""
    rng = np.random.default_rng(3)
    V, r_c = 64, 0.46
    th = 2 * np.pi * np.arange(V) / V
    K = np.array([[288.0, 0, 200.0], [0, 288.0, 160.0], [0, 0, 1.0]])
    n = 40
    rho = rng.uniform(r_c + 4, r_c + 9, n)
    phi = rng.uniform(-0.35, 0.35, n)
    yy = rng.uniform(-2.0, 2.0, n)
    X = np.stack([rho * np.sin(phi), yy, rho * np.cos(phi)], 1)
    poses, points, tracks = {}, {}, {}

    def add_region(f0, scale, tid0):
        for f in range(f0 - 2, f0 + 3):
            R, t = panning_pose(th[f % V], r_c)
            poses[f % V] = np.concatenate([tsfm._np_log_so3(R), scale * t])
            uv = (X @ R.T + t) @ K.T
            uv = uv[:, :2] / uv[:, 2:] + rng.normal(0, 0.3, (n, 2))
            for q in range(n):
                tracks[(f % V, tid0 + q)] = uv[q]
        for q in range(n):
            points[tid0 + q] = scale * X[q]
        return [tid0 + q for q in range(n)]

    tids_i = add_region(2, 1.0, 0)
    tids_j = add_region(60, 2.0, 1000)
    uv_pair = (np.stack([tracks[(0, t)] for t in tids_i]),
               np.stack([tracks[(62, t)] for t in tids_j]))
    R_i, t_i = panning_pose(th[0], r_c)
    R_j, t_j = panning_pose(th[62], r_c)
    R_rel = R_j @ R_i.T
    return K, poses, points, tracks, uv_pair, R_rel, 2.0 * (t_j - R_rel @ t_i)


def test_closure_edge_recovers_the_similarity_as_jax():
    from ransac_tpu.pipelines.loop_closure import closure_edge

    K, poses, points, tracks, uv_pair, R_rel, t_true = two_scale_scene()
    jm, tm = both_maps(K, poses, points)
    outs = [closure_edge(tracks, jm, K, 0, 62, seed=5, uv_pair=uv_pair),
            tlc.closure_edge(tracks, tm, K, 0, 62, seed=5, uv_pair=uv_pair, device="cpu")]
    for out in outs:
        assert out is not None, "closure rejected"
        z7, n_inl, fuse = out
        assert rot_deg(tsfm._np_rodrigues(z7[:3]), R_rel) < 1.0
        assert abs(z7[6] - np.log(2.0)) < 0.1, z7[6]
        cosang = np.dot(z7[3:6], t_true) / (np.linalg.norm(z7[3:6]) * np.linalg.norm(t_true))
        assert cosang > 0.7, (z7[3:6], t_true)
        assert n_inl >= 20 and len(fuse) >= 20
    (zj, _, _), (zt, _, _) = outs
    assert rot_deg(tsfm._np_rodrigues(zt[:3]), tsfm._np_rodrigues(zj[:3])) < 1.0
    assert abs(zt[6] - zj[6]) < 0.05, (zt[6], zj[6])


def test_closure_edge_takes_row_8_where_the_engine_is_the_sweep(monkeypatch):
    """On a CUDA device ``closure_edge`` runs the fused sweep (kernel row 8):
    the route is chosen by ``default_engine``, here made to answer "sweep"
    for CPU tensors, whose sweep is the kernel's plain version."""
    from ransac_tpu_torch.models import ransac as tr

    K, poses, points, tracks, uv_pair, R_rel, _ = two_scale_scene()
    _, tm = both_maps(K, poses, points)
    calls = []
    for name in ("ransac_essential", "ransac_essential_sweep"):
        real = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    tlc.closure_edge(tracks, tm, K, 0, 62, seed=5, uv_pair=uv_pair, device="cpu")
    assert calls == ["ransac_essential"]
    monkeypatch.setattr(tsfm, "default_engine", lambda device: "sweep")
    out = tlc.closure_edge(tracks, tm, K, 0, 62, seed=5, uv_pair=uv_pair, device="cpu")
    assert calls == ["ransac_essential", "ransac_essential_sweep"]
    assert out is not None and rot_deg(tsfm._np_rodrigues(out[0][:3]), R_rel) < 1.0


def drifted_circuit():
    """The JAX test's ``test_apply_pose_graph_commits_and_improves`` map: a
    panning circuit of 48 frames with 2.2x compounding scale drift, tracks
    from true pixels, the last frames re-seeing the first frames' tracks."""
    rng = np.random.default_rng(7)
    V, r_c = 48, 0.35
    th = 2 * np.pi * np.arange(V) / V
    K = np.array([[288.0, 0, 200.0], [0, 288.0, 160.0], [0, 0, 1.0]])
    g_step = 2.2 ** (1.0 / (V - 1))
    n_per = 30
    poses, points, tracks = {}, {}, {}
    tid = 0
    track_obs = []
    for f0 in range(0, V, 2):
        rho = rng.uniform(r_c + 4, r_c + 9, n_per)
        phi = th[f0] + rng.uniform(-0.3, 0.3, n_per)
        yy = rng.uniform(-2.0, 2.0, n_per)
        X = np.stack([rho * np.sin(phi), yy, rho * np.cos(phi)], 1)
        for q in range(n_per):
            track_obs.append((tid, X[q], f0))
            tid += 1
    for f in range(V):
        R, t = panning_pose(th[f], r_c)
        poses[f] = np.concatenate([tsfm._np_log_so3(R), g_step ** f * t])
    for (t_id, Xq, f0) in track_obs:
        obs_frames = [f for f in range(f0 - 2, f0 + 3) if 0 <= f < V]
        if f0 <= 2:
            obs_frames += [V - 2, V - 1]
        wrote = 0
        for f in obs_frames:
            R, t = panning_pose(th[f], r_c)
            pc = R @ Xq + t
            if pc[2] < 0.5:
                continue
            uv = (K[:2, :2] @ (pc[:2] / pc[2])) + K[:2, 2]
            if not (5 < uv[0] < 395 and 5 < uv[1] < 315):
                continue
            tracks[(f, t_id)] = uv + rng.normal(0, 0.3, 2)
            wrote += 1
        if wrote >= 2:
            points[t_id] = g_step ** f0 * Xq
    gt = np.stack([[r_c * np.sin(th[f]), 0.0, r_c * np.cos(th[f])] for f in range(V)])
    return K, poses, points, tracks, gt


def test_apply_pose_graph_repairs_drift_as_jax():
    from ransac_tpu.pipelines.loop_closure import apply_pose_graph
    from ransac_tpu_torch.pipelines.sfm_demo import _cam_centers, _umeyama_ate

    K, poses, points, tracks, gt = drifted_circuit()
    jm, tm = both_maps(K, poses, points)
    ate0 = _umeyama_ate(_cam_centers(tm.camera_poses), gt)
    tracks_j, tracks_t = dict(tracks), dict(tracks)
    n_j = apply_pose_graph(jm, tracks_j, K, min_gap=16, min_shared=10, seed=11)
    n_t = tlc.apply_pose_graph(tm, tracks_t, K, min_gap=16, min_shared=10, seed=11,
                               device="cpu")
    assert n_j >= 1 and n_t >= 1, (n_j, n_t)
    ate_j = _umeyama_ate(_cam_centers(jm.camera_poses), gt)
    ate_t = _umeyama_ate(_cam_centers(tm.camera_poses), gt)
    assert ate_t < 0.5 * ate0, (ate0, ate_t)
    assert abs(ate_t - ate_j) <= 0.2 * ate_j, (ate_t, ate_j)


def test_fuse_tracks_matches_jax():
    from ransac_tpu.pipelines.loop_closure import fuse_tracks

    rng = np.random.default_rng(1)
    tracks = {(f, t): rng.normal(size=2) for f in range(6) for t in range(12)
              if (f + t) % 3}
    points = {t: rng.normal(size=3) for t in range(12)}
    pairs = [(0, 5), (5, 7), (2, 3), (3, 2), (9, 1)]
    jm, tm = both_maps(np.eye(3), {}, points)
    tj, tt = dict(tracks), dict(tracks)
    assert tlc.fuse_tracks(tm, tt, pairs) == fuse_tracks(jm, tj, pairs) == 4
    assert list(tt) == list(tj) and all(np.array_equal(tt[k], tj[k]) for k in tj)
    assert sorted(tm.points) == sorted(jm.points)


def test_pairwise_scale_equals_jax():
    from ransac_tpu.pipelines.loop_closure import _pairwise_scale

    rng = np.random.default_rng(2)
    A = rng.normal(size=(120, 3))
    B = 1.7 * A + rng.normal(0, 0.01, A.shape)
    assert tlc._pairwise_scale(A, B, seed=3) == _pairwise_scale(A, B, seed=3)
    assert tlc._pairwise_scale(A[:2], B[:2]) == (None, None)


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K, poses, points, tracks, uv_pair, _, _ = two_scale_scene()
    _, tm = both_maps(K, poses, points)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlc.closure_edge(tracks, tm, K, 0, 62, uv_pair=uv_pair)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlc.apply_pose_graph(tm, tracks, K)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_closure_edge_launches_row_8_on_the_card():
    from ransac_tpu_torch.utils.profiling import launch_counts, reset_launch_counts

    K, poses, points, tracks, uv_pair, R_rel, _ = two_scale_scene()
    _, tm = both_maps(K, poses, points)
    reset_launch_counts()
    out = tlc.closure_edge(tracks, tm, K, 0, 62, seed=5, uv_pair=uv_pair, device="cuda")
    assert launch_counts()["essential_ransac_sweep_large"] == 1
    assert out is not None and rot_deg(tsfm._np_rodrigues(out[0][:3]), R_rel) < 1.0
