"""Incremental SfM of the port (``ransac_tpu_torch.pipelines.sfm``, ``cli
sfm``, ``utils.checkpointing``) against the JAX package on the CPU, on the
JAX SfM test's planted scene (``synth_tracks``: 6 frames, 80 points, 0.3 px
of noise), written by ``io.synthetic.write_sfm_tracks``.

Each package's ``cli sfm`` runs once, in a module fixture (the JAX one
~40 s of compiles).
RANSAC draws differ between the packages (torch generators against
``jax.random``), so parity is held at the decision level: the same
registered frames; both trajectories' ATE (similarity-aligned camera
centres) under 5% of the scene scale; the port's centres, aligned to
JAX's, within 1% of it.  ``prune_observations`` and the batched
triangulation are held to JAX's on the same inputs (equal masks; points
rtol 1e-4); the rescue stage, checkpoint resume and re-registration as
the JAX package's tests hold them.
"""

import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu import cli as jcli
from ransac_tpu.ba.bundle import BAProblem as JProblem
from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops.rotation import exp_so3 as jexp
from ransac_tpu.pipelines import sfm as jsfm
from ransac_tpu_torch import cli as tcli
from ransac_tpu_torch.ba.bundle import BAProblem
from ransac_tpu_torch.io.synthetic import sfm_tracks, write_sfm_tracks
from ransac_tpu_torch.pipelines import sfm as tsfm
from ransac_tpu_torch.utils.checkpointing import CheckpointManager
from torch_threads import one_torch_thread  # noqa: F401


def jax_synth_tracks(n_frames=6, n_pts=80, seed=2, noise=0.3):
    """The JAX test's ``synth_tracks`` (``tests/test_sfm_twoview.py``)."""
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    X = rng.uniform(-1, 1, size=(n_pts, 3)) * np.array([4, 3, 1.5]) + [0, 0, 10]
    tracks = {}
    for f in range(n_frames):
        rvec = rng.normal(size=3) * 0.03
        t = np.array([f * 0.7 - 2.0, rng.normal() * 0.05, rng.normal() * 0.05])
        pix, z = jproj.project_points(jnp.asarray(X), jexp(jnp.asarray(rvec)),
                                      jnp.asarray(t), jnp.asarray(K))
        pix = np.asarray(pix) + rng.normal(scale=noise, size=(n_pts, 2))
        for i in range(n_pts):
            if float(z[i]) > 0:
                tracks[(f, i)] = pix[i]
    return tracks


def umeyama_align(A, B):
    """Similarity aligning A -> B (the JAX test's ATE alignment)."""
    muA, muB = A.mean(0), B.mean(0)
    A0, B0 = A - muA, B - muB
    U, S, Vt = np.linalg.svd(B0.T @ A0 / len(A))
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (A0 ** 2).mean(0).sum()
    return s, R, muB - s * R @ muA


def aligned_rms(A, B):
    s, R, t = umeyama_align(A, B)
    return float(np.sqrt(((B - (s * A @ R.T + t)) ** 2).sum(1).mean()))


def centers(poses):
    return np.array([tsfm._cam_center(p) for p in poses])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The planted scene written for ``cli sfm``, and each package's ``cli
    sfm`` on it: (tracks, JAX's .npz, the port's .npz, the port's output
    lines)."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("sfm6")
    st = write_sfm_tracks(str(d))
    jax_npz, port_npz = str(d / "jax.npz"), str(d / "port.npz")
    assert jcli.main(["sfm", "--tracks", st.tracks_npz, "--intrinsics", st.intrinsics_txt,
                      "--out", jax_npz]) in (0, None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["sfm", "--tracks", st.tracks_npz, "--intrinsics",
                          st.intrinsics_txt, "--out", port_npz, "--device", "cpu"]) == 0
    return st, dict(np.load(jax_npz)), port_npz, buf.getvalue().splitlines()


def test_sfm_tracks_are_the_jax_scene():
    tracks, K, poses, X = sfm_tracks()
    ref = jax_synth_tracks()
    assert set(tracks) == set(ref)
    assert max(np.abs(tracks[k] - ref[k]).max() for k in ref) < 1e-3
    assert K[0, 0] == 600.0 and poses.shape == (6, 6) and X.shape == (80, 3)


def test_incremental_sfm_matches_jax(scene):
    """``incremental_sfm`` through each package's ``cli sfm`` (seed 0)."""
    st, jax_out, port_npz, _ = scene
    port = np.load(port_npz)
    assert list(port["frames"]) == list(jax_out["frames"]) == list(range(6))
    assert len(port["track_ids"]) > 50
    C_true = centers(st.poses)
    scale = np.abs(C_true).max()
    C_port = centers(port["poses"])
    C_jax = centers(jax_out["poses"])
    assert aligned_rms(C_port, C_true) < 0.05 * scale
    assert aligned_rms(C_jax, C_true) < 0.05 * scale
    assert aligned_rms(C_port, C_jax) < 0.01 * scale


def test_cli_sfm_writes_the_jax_keys(scene, tmp_path):
    st, jax_out, port_npz, lines = scene
    assert lines[0].startswith("registered 6/6 frames, ")
    assert sum(ln.startswith("  frame ") for ln in lines) == 6
    assert lines[-1] == f"wrote {port_npz}"
    port = np.load(port_npz)
    assert set(port.files) == set(jax_out) == {"frames", "poses", "track_ids", "points"}
    for k in port.files:
        assert port[k].dtype.kind == jax_out[k].dtype.kind, k
        assert port[k].shape[1:] == jax_out[k].shape[1:], k
    # The .json table gives the same tracks.
    tracks = tcli._read_tracks(st.tracks_npz)
    path = tmp_path / "tracks.json"
    path.write_text(json.dumps({f"{f},{t}": list(uv) for (f, t), uv in tracks.items()}))
    again = tcli._read_tracks(str(path))
    assert set(again) == set(tracks)
    assert all(np.array_equal(again[k], tracks[k]) for k in tracks)


def test_triangulation_matches_jax():
    """The batched per-track DLT with its gates against JAX's on 64 tracks
    of the planted scene (views 0 and 3, the last 8 rows padding)."""
    tracks, K, poses, X = sfm_tracks()
    T, n = 64, 56
    R1 = np.stack([tsfm._np_rodrigues(poses[0, :3])] * T).astype(np.float32)
    R2 = np.stack([tsfm._np_rodrigues(poses[3, :3])] * T).astype(np.float32)
    t1 = np.tile(poses[0, 3:], (T, 1)).astype(np.float32)
    t2 = np.tile(poses[3, 3:], (T, 1)).astype(np.float32)
    x1 = np.zeros((T, 2), np.float32)
    x2 = np.zeros((T, 2), np.float32)
    x1[:n] = np.stack([tracks[(0, i)] for i in range(n)])
    x2[:n] = np.stack([tracks[(3, i)] for i in range(n)])
    x2[5] += 40.0                                   # fails the reprojection gate
    valid = np.arange(T) < n
    cos_min, gate = np.cos(np.deg2rad(1.0)), 2.0 * 4.0 / 600.0
    Kj = jnp.asarray(K, jnp.float32)
    Xj, okj = jsfm._tri_tracks_jit(
        jproj.normalize_pixels(jnp.asarray(x1), Kj), jproj.normalize_pixels(jnp.asarray(x2), Kj),
        jnp.asarray(R1), jnp.asarray(t1), jnp.asarray(R2), jnp.asarray(t2),
        jnp.asarray(valid), jnp.float32(cos_min), jnp.float32(gate))
    Kt = torch.tensor(K, dtype=torch.float32)
    out = tsfm._tri_tracks(
        tsfm.normalize_pixels(torch.tensor(x1), Kt), tsfm.normalize_pixels(torch.tensor(x2), Kt),
        torch.tensor(R1), torch.tensor(t1), torch.tensor(R2), torch.tensor(t2),
        torch.tensor(valid), torch.tensor(cos_min, dtype=torch.float32),
        torch.tensor(gate, dtype=torch.float32)).numpy()
    ok = out[:, 3] > 0.5
    np.testing.assert_array_equal(ok, np.asarray(okj))
    assert ok.sum() == n - 1 and not ok[5]
    np.testing.assert_allclose(out[ok, :3], np.asarray(Xj)[ok], rtol=1e-4)


def test_prune_observations_matches_jax():
    tracks, K, poses, X = sfm_tracks()
    keys = sorted(tracks)
    uv = np.stack([tracks[k] for k in keys]).astype(np.float32)
    uv[::9] += 25.0
    arrays = (poses.astype(np.float32), X.astype(np.float32), K.astype(np.float32),
              np.array([f for f, _ in keys], np.int32), np.array([t for _, t in keys], np.int32),
              uv, np.ones(len(keys), np.float32))
    pj, nj = jsfm.prune_observations(JProblem(*map(jnp.asarray, arrays)), 4.0)
    pt, nt = tsfm.prune_observations(BAProblem(*arrays), 4.0)
    assert nt == nj == len(uv[::9])
    np.testing.assert_array_equal(pt.obs_w, np.asarray(pj.obs_w))
    pt2, _ = tsfm.prune_observations(BAProblem(*map(torch.tensor, arrays)), 4.0)
    assert isinstance(pt2.obs_w, torch.Tensor)
    np.testing.assert_array_equal(pt2.obs_w.numpy(), pt.obs_w)


def test_incremental_sfm_rescue_registers_stalled_tail():
    """The JAX package's rescue test: band b (12 points) is seen only from
    frames b..b+2, so with 6-frame windows the windowed passes stall after
    a few frames by construction; the frame-by-frame rescue stage walks
    the tail to every frame, its poses real (aligned ATE < 0.10)."""
    rng = np.random.default_rng(3)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    n_frames, per_band = 14, 12
    t_true = {f: np.array([-(f * 0.35), 0.0, 0.0]) for f in range(n_frames)}
    tracks, tid = {}, 0
    for b in range(n_frames - 1):
        Xb = rng.uniform(-1, 1, size=(per_band, 3)) * np.array([1.5, 1.2, 0.8]) \
            + [b * 0.35 + 0.2, 0, 9.0]
        for i in range(per_band):
            for f in range(b, min(b + 3, n_frames)):
                xc = Xb[i] + t_true[f]
                tracks[(f, tid)] = K[:2, :2] @ (xc[:2] / xc[2]) + K[:2, 2] \
                    + rng.normal(scale=0.05, size=2)
            tid += 1
    m = tsfm.incremental_sfm(tracks, K, list(range(n_frames)), seed=0, ba_every=6,
                             engine="stage", device="cpu")
    assert sorted(m.camera_poses) == list(range(n_frames))
    assert m.rescued_frames
    C_true = np.stack([-t_true[f] for f in range(n_frames)])
    assert aligned_rms(centers([m.camera_poses[f] for f in range(n_frames)]), C_true) < 0.10


def test_incremental_sfm_checkpoint_resume(tmp_path):
    """The JAX test, on 5 frames of 40 points: a run over frames 0-2
    snapshots after every BA; a run over all 5 resumes from it (the poses
    of frames 0-2 come back as saved) and grows the map."""
    tracks, K, _, _ = sfm_tracks(n_frames=5, n_pts=40, seed=7)
    ck = str(tmp_path / "ckpt")
    m1 = tsfm.incremental_sfm(tracks, K, [0, 1, 2], seed=0, checkpoint_dir=ck, device="cpu")
    assert len(m1.camera_poses) == 3
    state = CheckpointManager(ck).restore()
    assert list(state["frames"]) == [0, 1, 2]
    np.testing.assert_array_equal(state["poses"], np.stack([m1.camera_poses[f]
                                                            for f in range(3)]))
    m2 = tsfm.incremental_sfm(tracks, K, list(range(5)), seed=0, checkpoint_dir=ck,
                              device="cpu")
    assert len(m2.camera_poses) == 5
    assert len(m2.points) >= len(m1.points)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    ck = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert ck.restore() is None and ck.latest_step() is None
    for step in (1, 2, 5):
        ck.save(step, {"x": torch.full((3,), float(step)), "n": np.array([step])})
    assert ck.steps() == [2, 5]
    assert ck.restore()["x"].tolist() == [5.0] * 3 and int(ck.restore(2)["n"][0]) == 2


def test_reregister_outlier_frames_repairs_broken_pose():
    """The JAX test: a frame shoved 2 units off is re-localized by PnP
    against the map and kept only because its median error falls."""
    rng = np.random.default_rng(5)
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
    X = np.stack([rng.uniform(-2, 2, 60), rng.uniform(-2, 2, 60), rng.uniform(5, 9, 60)], 1)
    m = tsfm.SfmMap(K=K)
    tracks = {}
    for f in range(6):
        t = np.array([0.05 * f, 0.0, 0.0])
        m.camera_poses[f] = np.concatenate([np.zeros(3), -t])
        pc = X - t
        uv = (K[:2, :2] @ (pc[:, :2] / pc[:, 2:]).T).T + K[:2, 2]
        for q in range(60):
            tracks[(f, q)] = uv[q] + rng.normal(0, 0.2, 2)
    for q in range(60):
        m.points[q] = X[q]
    m.camera_poses[2] = m.camera_poses[2] + np.array([0, 0, 0, 0.7, -0.4, 2.0])
    assert tsfm.frame_reproj_errors(m, tracks)[2] > 20.0
    assert tsfm.reregister_outlier_frames(m, tracks, device="cpu") == 1
    errs = tsfm.frame_reproj_errors(m, tracks)
    assert all(errs[f] < 1.0 for f in range(6)), errs


def test_sfm_entry_points_default_to_the_card(scene):
    for fn in (tsfm.incremental_sfm, tsfm.reregister_outlier_frames):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert tsfm.default_engine("cuda") == "sweep" and tsfm.default_engine("cpu") == "stage"
    if not torch.cuda.is_available():
        st = scene[0]
        assert tcli.main(["sfm", "--tracks", st.tracks_npz, "--intrinsics",
                          st.intrinsics_txt]) == 2
        tracks, K, _, _ = sfm_tracks()
        with pytest.raises((AssertionError, RuntimeError)):
            tsfm.incremental_sfm(tracks, K, list(range(6)))
