"""The fused P3P entry point ``ransac_pnp_sweep`` of the port against that
of ``ransac_tpu.models.ransac``, with the Pallas kernel run in interpret
mode and its approximate reciprocal swapped for the exact one (as in
``test_torch_sweep_pnp.py``), on that file's anisotropic scene (fy = 0.54
fx).

Decisions are compared: the winning minimal sample as a point set (a sweep
may surface any ordering of a triple, whose records differ only by float
rounding), the inlier mask and count; the refit pose within 1e-3 rad and
1e-3 |t|, and within 0.05 of the planted translation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ransac_tpu.models import ransac as jr
from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops.pallas import sweep_pnp as jsp
from ransac_tpu.utils.config import RansacConfig as JRansacConfig
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import score as tsc
from ransac_tpu_torch.ops import sweep_pnp as tsp
from ransac_tpu_torch.utils.config import RansacConfig
from tests.test_torch_sweep_pnp import scene
from torch_threads import one_torch_thread  # noqa: F401


def triple(packed):
    p = int(packed)
    return sorted([p & 15, (p >> 4) & 15, (p >> 8) & 15])


@pytest.fixture
def exact_reciprocal(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jsp.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


def test_ransac_pnp_sweep_matches_jax(exact_reciprocal):
    X, pix, K, mask, thr, R_true, t_true = scene("aniso")
    res_j = jr.ransac_pnp_sweep(
        jnp.asarray(X), jnp.asarray(pix), jnp.asarray(K), jnp.asarray(mask),
        JRansacConfig(threshold=thr, num_hypotheses=1024), 5, interpret=True)
    res_t = tr.ransac_pnp_sweep(
        torch.from_numpy(X), torch.from_numpy(pix), torch.from_numpy(K),
        torch.from_numpy(mask), RansacConfig(threshold=thr, num_hypotheses=1024), 5)
    assert res_t.num_hypotheses == 4 * 1024
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    assert int(res_t.num_inliers) == int(res_j.num_inliers) >= 11
    # The winning record holds the same triple on both sides (the records'
    # packed samples, from the same kernel calls as inside the sweeps).
    Kj = jnp.asarray(K)
    pixn = jproj.normalize_pixels(jnp.asarray(pix), Kj)
    thr_n, ay = thr / Kj[0, 0], Kj[1, 1] / Kj[0, 0]  # traced as the sweep traces them
    p_j = np.asarray(jsp.pnp_ransac_sweep(
        5, jnp.asarray(X), pixn, jnp.asarray(mask), thr_n,
        n_hyp=1024, interpret=True, block_h=1024, ay=ay)[2][0])
    p_t = tsp.pnp_ransac_sweep(
        5, torch.from_numpy(X), torch.from_numpy(np.asarray(pixn)),
        torch.from_numpy(mask), float(thr_n), 1024, block_h=1024,
        ay=float(ay))[2][0].numpy()
    assert (triple(p_t[int(res_t.best_index)])
            == triple(p_j[int(res_j.best_index)]))
    Rt, tt = (a.numpy().astype(np.float64) for a in tr.pnp_pose_from_result(res_t))
    Rj, tj = (np.asarray(a, np.float64) for a in jr.pnp_pose_from_result(res_j))
    ang = np.arccos(np.clip((np.trace(Rt.T @ Rj) - 1) / 2, -1, 1))
    assert ang < 1e-3, ang
    assert np.linalg.norm(tt - tj) <= 1e-3 * np.linalg.norm(tj)
    np.testing.assert_allclose(tt, t_true, atol=0.05)


class _HostReads(TorchDispatchMode):
    """Records every tensor-to-number read (``item``, ``float``, ``int``,
    ``bool`` and indexing by a 0-d tensor all reach
    ``aten._local_scalar_dense``) while ``armed``."""

    def __init__(self):
        super().__init__()
        self.armed, self.reads = True, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.armed and func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def test_sweep_path_reads_nothing_back_before_the_refit(monkeypatch):
    """``ransac_pnp_sweep`` forms the kernels' threshold and y-scale as 0-d
    tensors from K where K lies and takes no tensor-to-number path from its
    start to its refit (on the card: no ``aten::item`` and no stream
    synchronize, ``chip_smoke.py``), nor in its refit, which picks its seed
    and its score by ``index_select``; watching it changes nothing.  (The
    refit's one read, the info check inside ``torch.linalg.eigh``, happens
    below the dispatch mode: ``test_refit_reads_only_the_eigh_info``.)"""
    X, pix, K, mask, thr, _, _ = scene("aniso")
    args = (torch.from_numpy(X), torch.from_numpy(pix), torch.from_numpy(K),
            torch.from_numpy(mask), RansacConfig(threshold=thr, num_hypotheses=1024), 5)
    ref = tr.ransac_pnp_sweep(*args)
    mode = _HostReads()
    refit = tr._pnp_sweep_result
    before = []

    def note_then_refit(*a, **kw):
        before.append(mode.reads)
        return refit(*a, **kw)

    monkeypatch.setattr(tr, "_pnp_sweep_result", note_then_refit)
    with mode:
        res = tr.ransac_pnp_sweep(*args)
    assert before == [0], "the refit was not reached, or reads came before it"
    assert mode.reads == 0
    for a, b in zip(res, ref):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_refit_reads_only_the_eigh_info():
    """The reads of a whole ``ransac_pnp_sweep`` call, by the profiler (which
    also sees reads made inside an operator): one, the info check of
    ``torch.linalg.eigh`` on EPnP's 12 x 12 M^T M in the refit's seed.  EPnP's
    3 x 3 covariance goes through the closed-form ``eigh3x3``, and the seed
    and score are picked by ``index_select``, so those read nothing."""
    from torch.profiler import ProfilerActivity, profile

    X, pix, K, mask, thr, _, _ = scene("aniso")
    args = (torch.from_numpy(X), torch.from_numpy(pix), torch.from_numpy(K),
            torch.from_numpy(mask), RansacConfig(threshold=thr, num_hypotheses=1024), 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.ransac_pnp_sweep(*args)
    chains = []
    for ev in prof.events():
        if ev.name == "aten::item":
            chain, p = [], ev.cpu_parent
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            chains.append(chain)
    assert len(chains) == 1, chains
    assert chains[0][:3] == ["aten::_linalg_check_errors", "aten::_linalg_eigh",
                             "aten::linalg_eigh"], chains
    assert "ransac.refit" in chains[0]


def test_kernel_scalars_keep_their_float32_values():
    """The 0-d tensors that the row 3, 4 and 5 kernels read when K is a
    tensor (``prepare``'s thr_sq and ay, from ``_pnp_threshold_scales`` of a
    float32 K) hold the float32 values that those kernels take by value for
    the same numbers, ``_thr_sq(threshold / fx)`` and fl(fy / fx), bit for
    bit; a number goes by value as its float32 rounding, a tensor by
    pointer."""
    rng = np.random.default_rng(0)
    X, pix = torch.zeros(5, 3), torch.zeros(5, 2)
    for _ in range(500):
        K = torch.from_numpy(np.diag([rng.uniform(50, 8000), rng.uniform(50, 8000),
                                      1.0]).astype(np.float32))
        thr = float(rng.uniform(0.1, 200.0))
        fx, ay = tr._pnp_threshold_scales(K, torch.float32)
        thr_n = thr / fx
        *_, thr_sq, ay_t = tsp.prepare(X, pix, torch.ones(5), thr_n, ay)
        assert thr_sq.dtype == ay_t.dtype == torch.float32
        assert thr_sq.shape == ay_t.shape == ()
        assert float(thr_sq) == tsc._thr_sq(float(thr_n))
        assert float(ay_t) == float(np.float32(float(ay)))
        *_, thr_sq_f, ay_f = tsp.prepare(X, pix, torch.ones(5), float(thr_n), float(ay))
        assert (thr_sq_f, ay_f) == (float(thr_sq), float(ay_t))
        assert _build.f32_arg(thr, "cpu") == (float(np.float32(thr)), None)
    value, t = _build.f32_arg(thr_sq, "cpu")
    assert value == 0.0 and t.dtype == torch.float32 and t.shape == () and float(t) == float(thr_sq)
