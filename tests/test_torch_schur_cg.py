"""Matrix-free CG Schur bundle adjustment of the port
(``ransac_tpu_torch.ba.schur_cg``) against the JAX package on the CPU, on
the same numpy-seeded inputs: the JAX test's ``synth_problem`` (6 cameras,
60 points, 30% of the observations dropped).

Tolerances: ``from_ba_problem`` equal arrays; ``slot_cost`` rtol 1e-6;
``_slot_blocks`` (r, Jc, Jp, every slot) rtol 1e-5, atol 1e-6 of the magnitude each entry is formed at (r: its
pixel; a Jacobian entry: its slot's block; see ``test_torch_ba.py``); one ``_schur_cg_step`` at lambda 1e-3: dc and dp
rtol 1e-3 (entries below 1e-3 of the step's largest held to that);
``bundle_adjust_cg`` over 15 passes (plain, and Huber 4 px with 1 in 15
observations shifted 80 px): cost rtol 5e-2 / atol 1e-4, the non-gauge
cameras atol 5e-3, the same pass count.  The CG exit, a freeze, is held
to an exact early exit bit for bit, and its host reads are counted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ba import bundle as jb
from ransac_tpu.ba import schur_cg as jc
from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops.rotation import exp_so3 as jexp
from ransac_tpu.utils.config import BundleAdjustConfig as JConfig
from ransac_tpu_torch.ba import bundle as tb
from ransac_tpu_torch.ba import schur_cg as tc
from ransac_tpu_torch.utils.config import BundleAdjustConfig
from torch_threads import one_torch_thread  # noqa: F401


def synth_problem(n_cam=6, n_pt=60, noise=0.01, seed=0, drop=0.3):
    """The JAX test's ``synth_problem`` (``tests/test_schur_cg.py``): (JAX
    BAProblem, the same arrays as numpy)."""
    rng = np.random.default_rng(seed)
    K = np.array([[700.0, 0, 320.0], [0, 700.0, 240.0], [0, 0, 1.0]])
    pts = rng.uniform(-2, 2, size=(n_pt, 3)) * np.array([3, 3, 1]) + [0, 0, 8]
    cams, obs_cam, obs_pt, obs_uv = [], [], [], []
    for c in range(n_cam):
        cam6 = np.concatenate([rng.normal(size=3) * 0.05, [c * 2.0 / n_cam - 1.0, 0.0, 0.0]])
        cams.append(cam6)
        pix, z = jproj.project_points(jnp.asarray(pts), jexp(jnp.asarray(cam6[:3])),
                                      jnp.asarray(cam6[3:]), jnp.asarray(K))
        keep = np.where(np.asarray(z) > 0)[0]
        keep = keep[rng.random(len(keep)) > drop]
        for i in keep:
            obs_cam.append(c)
            obs_pt.append(i)
            obs_uv.append(np.asarray(pix)[i])
    cams = np.array(cams)
    cams[1:] += rng.normal(scale=0.004, size=cams[1:].shape)
    arrays = (cams.astype(np.float32),
              (pts + rng.normal(scale=noise, size=pts.shape)).astype(np.float32),
              K.astype(np.float32), np.array(obs_cam, np.int32), np.array(obs_pt, np.int32),
              np.array(obs_uv, np.float32), np.ones(len(obs_cam), np.float32))
    return jb.BAProblem(*map(jnp.asarray, arrays)), tb.BAProblem(*arrays)


CASES = {"plain": 0.0, "huber": 4.0}


def slot_pair(jp, tp, max_slots=None):
    return (jc.from_ba_problem(jp, max_slots),
            tc.to_device(tc.from_ba_problem(tp, max_slots), "cpu"))


@pytest.fixture(scope="module")
def problems():
    jp, tp = synth_problem()
    jo, to = synth_problem(seed=3)
    uv = np.array(to.obs_uv)
    uv[::15] += 80.0
    jo, to = jo._replace(obs_uv=jnp.asarray(uv)), to._replace(obs_uv=uv)
    return {"plain": (jp, tp) + slot_pair(jp, tp), "huber": (jo, to) + slot_pair(jo, to)}


@pytest.mark.parametrize("max_slots", [None, 3])
def test_from_ba_problem_equals_jax(problems, max_slots):
    jp, tp, _, _ = problems["plain"]
    sj, st = slot_pair(jp, tp, max_slots)
    assert st.slot_cam.shape == tuple(sj.slot_cam.shape)
    for name, a, b in zip(jc.BASlotProblem._fields, sj, st):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_slot_cost_matches_jax(problems, case):
    jp, tp, sj, st = problems[case]
    s = CASES[case]
    cj = float(jc.slot_cost(sj, sj.cameras, sj.points, s))
    ct = tc.slot_cost(st, st.cameras, st.points, s)
    assert ct.dtype == torch.float32
    np.testing.assert_allclose(float(ct), cj, rtol=1e-6)
    # The slot layout's cost is the observation list's.
    np.testing.assert_allclose(float(ct), float(tb.cost_fn(tb.to_device(tp, "cpu"),
                                                           st.cameras, st.points, s)),
                               rtol=1e-6)


def test_padding_slots_contribute_nothing(problems):
    """A zero-weight slot (camera 0, uv 0) adds nothing: its residual and
    blocks are zero, and the step is that of the problem with the padding
    cut to the longest track (rtol 1e-3, as against JAX: the sums over D
    group differently)."""
    _, tp, _, st = problems["plain"]
    live = st.slot_w > 0
    assert 0 < int(live.sum()) < live.numel()       # the synth problem has padding
    r, Jc, Jp = tc._slot_blocks(st, st.cameras, st.points, 0.0)
    for x in (r, Jc, Jp):
        assert not x[..., ~live].any()
    padded = tc.to_device(tc.from_ba_problem(tp, st.slot_cam.shape[0] + 3), "cpu")
    assert padded.slot_w.shape[0] == st.slot_w.shape[0] + 3
    C = st.cameras.shape[0]
    steps = [tc._schur_cg_step(q, *tc._slot_blocks(q, q.cameras, q.points, 0.0),
                               torch.tensor(1e-3), C, True, 24) for q in (st, padded)]
    for a, b in zip(*steps):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-3 * float(a.abs().max()))


@pytest.mark.parametrize("case", CASES)
def test_slot_blocks_match_jax(problems, case):
    _, _, sj, st = problems[case]
    rj, Jcj, Jpj = jc._slot_blocks(sj, sj.cameras, sj.points, CASES[case])
    rt, Jct, Jpt = tc._slot_blocks(st, st.cameras, st.points, CASES[case])
    for name, j, t in (("r", rj, rt), ("Jc", np.stack(Jcj), Jct), ("Jp", np.stack(Jpj), Jpt)):
        j, t = np.asarray(j), t.numpy()
        assert t.dtype == np.float32 and t.shape == j.shape, name
        if name == "r":
            scale = np.abs(st.slot_uv.numpy())
        else:   # the slot's 2 x 6 or 2 x 3 block
            scale = np.abs(j).max((0, 1), keepdims=True)
        bad = np.abs(t - j) > 1e-6 + 1e-5 * scale
        assert not bad.any(), (name, np.abs(t - j)[bad].max(), bad.sum())


@pytest.mark.parametrize("fix_first", [True, False])
def test_schur_cg_step_matches_jax(problems, fix_first):
    _, _, sj, st = problems["plain"]
    C = st.cameras.shape[0]
    dc_j, dp_j = jc._schur_cg_step(sj, *jc._slot_blocks(sj, sj.cameras, sj.points, 0.0),
                                   1e-3, C, fix_first, 24)
    dc_t, dp_t = tc._schur_cg_step(st, *tc._slot_blocks(st, st.cameras, st.points, 0.0),
                                   torch.tensor(1e-3), C, fix_first, 24)
    for j, t in ((dc_j, dc_t), (dp_j, dp_t)):
        j = np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-3, atol=1e-3 * np.abs(j).max())


@pytest.mark.parametrize("case", CASES)
def test_bundle_adjust_cg_matches_jax(problems, case):
    _, _, sj, st = problems[case]
    s = CASES[case]
    rj = jc.bundle_adjust_cg(sj, JConfig(max_iters=15, huber_scale=s), cg_iters=40)
    tb.reset_counts()
    rt = tc.bundle_adjust_cg(st, BundleAdjustConfig(max_iters=15, huber_scale=s),
                             cg_iters=40, device="cpu")
    assert float(rt.cost) < float(rt.initial_cost)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=5e-2, atol=1e-4)
    np.testing.assert_allclose(rt.cameras[1:].numpy(), np.asarray(rj.cameras)[1:], atol=5e-3)
    np.testing.assert_array_equal(rt.cameras[0].numpy(), st.cameras[0].numpy())
    assert int(rt.iterations) == int(rj.iterations) == 15
    assert tb.COUNTS == {"passes": 15, "reads": 0}


def test_cg_matches_the_ports_dense_schur(problems):
    """The JAX test's CG-against-dense check, on the port: both reach the
    optimum of the same objective."""
    _, tp, _, st = problems["plain"]
    cfg = BundleAdjustConfig(max_iters=15)
    dense = tb.bundle_adjust(tp, cfg, device="cpu")
    cg = tc.bundle_adjust_cg(st, cfg, cg_iters=40, device="cpu")
    assert float(cg.cost) < 0.05 * float(cg.initial_cost)
    np.testing.assert_allclose(float(cg.cost), float(dense.cost), rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(cg.cameras.numpy(), dense.cameras.numpy(), rtol=0.05, atol=5e-3)


def host_reads(fn):
    """``fn()``'s result and the host reads (``aten::item``) it made."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name == "aten::item" for e in prof.events())


def exact_pcg(S_apply, b, Minv, n_iters, tol, x0):
    """JAX's PCG loop as written: the exit test read before each
    iteration.  Returns x and the iterations run."""
    def prec(r):
        return (Minv @ r[..., None])[..., 0]

    x, r = x0, b - S_apply(x0)
    z = prec(r)
    d = z
    rz = (r * z).sum()
    bound = tol * torch.clamp((b * b).sum(), min=1e-30)
    for i in range(n_iters):
        if not bool((r * r).sum() > bound):
            return x, i
        Sd = S_apply(d)
        alpha = rz / tc._guard((d * Sd).sum())
        x = x + alpha * d
        r = r - alpha * Sd
        z = prec(r)
        rz_new = (r * z).sum()
        d = z + rz_new / tc._guard(rz) * d
        rz = rz_new
    return x, n_iters


@pytest.mark.parametrize("tol", [1e-4, 1e-2])
def test_cg_exit_frozen_or_read_equals_exact_exit(problems, monkeypatch, tol):
    """JAX's PCG tests ``sum(r*r) > tol * |b|^2`` before every iteration and
    exits.  The port runs the fixed count with the iterate frozen past the
    exit and reads nothing; its x is the exact early exit's (read every
    iteration) bit for bit."""
    _, _, _, st = problems["plain"]
    C = st.cameras.shape[0]
    r, Jc, Jp = tc._slot_blocks(st, st.cameras, st.points, 0.0)
    n_iters = 24
    calls = []
    real = tc._pcg
    monkeypatch.setattr(tc, "_pcg", lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    tc._schur_cg_step(st, r, Jc, Jp, torch.tensor(1e-3), C, True, n_iters, cg_tol=tol,
                      dc_warm=torch.zeros_like(st.cameras))
    (S_apply, b, Minv, n), kw = calls[0]
    assert n == n_iters and kw["tol"] == tol
    x_frozen, frozen_reads = host_reads(lambda: real(S_apply, b, Minv, n, **kw))
    (x_exact, ran), exact_reads = host_reads(
        lambda: exact_pcg(S_apply, b, Minv, n, kw["tol"], kw["x0"]))
    assert 0 < ran < n_iters                      # the exit fires inside the count
    assert exact_reads == ran + 1 and frozen_reads == 0
    assert torch.equal(x_frozen, x_exact)


def test_cg_reads_nothing_at_tol_0(problems):
    """With cg_tol 0 (and at any tolerance) the CG step makes no host read."""
    _, _, _, st = problems["plain"]
    C = st.cameras.shape[0]
    r, Jc, Jp = tc._slot_blocks(st, st.cameras, st.points, 0.0)
    for tol in (0.0, 1e-4):
        _, reads = host_reads(lambda: tc._schur_cg_step(
            st, r, Jc, Jp, torch.tensor(1e-3), C, True, 16, cg_tol=tol,
            dc_warm=torch.zeros_like(st.cameras)))
        assert reads == 0, tol


def test_cg_scale_smoke_medium():
    """The JAX test's medium smoke (24 cameras, 800 points, 75% dropped,
    8 slots): three LM passes lower the cost."""
    _, tp = synth_problem(n_cam=24, n_pt=800, seed=5, drop=0.75)
    st = tc.from_ba_problem(tp, max_slots=8)
    res = tc.bundle_adjust_cg(st, BundleAdjustConfig(max_iters=3), cg_iters=16, device="cpu")
    assert np.isfinite(float(res.cost)) and float(res.cost) < float(res.initial_cost)
