"""The fused P3P sweep port (``ransac_tpu_torch.ops.sweep_pnp``) and
``ransac_pnp_sweep`` against the Pallas kernel
``ransac_tpu.ops.pallas.sweep_pnp.pnp_ransac_sweep``, on the scenes of
``tests/test_sweep.py`` (one of them with the anisotropic y scale
``ay = fy / fx`` of a film camera).

The sampling is the JAX kernel's counter PRNG bit for bit, so the packed
samples agree exactly.  The Pallas kernel takes approximate reciprocals
(bfloat16 in interpret mode); the port divides exactly, so the comparisons
swap the exact reciprocal into the JAX kernel.

``test_kernel_body_op_by_op_matches_plain`` is the exact check: the JAX
kernel body run one operation at a time (``pallas_op_by_op``), with rsqrt
taken as 1/sqrt on both sides, gives the plain version's records bit for
bit, full and reduced: Grunert's quartic, the depth polish, the triads
and the scoring are the JAX kernel's, operation for operation.

``test_pnp_sweep_full_records_match_pallas_interpret`` runs the JAX
function as users call it: jitted, with the kernel interpreted.  Two
things then differ from the port, neither of them the port's arithmetic:
XLA's CPU backend contracts multiply-adds into FMAs, and XLA's rsqrt is
not torch's (on uniform float32 inputs it is correctly rounded for 86% of
values, torch's CPU rsqrt for 72%).  Grunert's quartic is ill-conditioned
for some triples, so a last-place change can move a root's validity,
count or MSAC.  Measured on these scenes: validity agrees on 97.7-99.0%
of (sample, root) entries, counts on 96.8-97.4%, MSAC within rtol 1e-3
(relative to max(|MSAC|, thr^2)) on 95.4-98.4% of the entries that agree
on both.  That test holds validity to >= 97%, counts to >= 96% and MSAC to
>= 95%, and the winner under both selection rules exactly: the same
3-point set (the kernel may surface any ordering of a triple, whose poses
are the same), the same count, MSAC within 1e-3.  The kernel's own
arithmetic (``csrc/sweep_pnp.cuh``), built for the host with the plain
version's rsqrt swapped for the host's, agrees with the plain version bit
for bit under the ``Exact`` score policy, and by ``ops.sweep_pnp.hold_full``
/ ``hold_reduced`` under the kernel's ``Fused`` one; the CUDA kernel itself
is held by those criteria on the card (``chip_smoke.py``, ``cuda`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops.pallas import sweep_pnp as jsp
from ransac_tpu.ops.rotation import exp_so3
from ransac_tpu_torch.io.synthetic import planted_pnp_pool
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep as tsw
from ransac_tpu_torch.ops import sweep_pnp as tsp
from ransac_tpu_torch.ops import sweep_pnp_large as tspl
from ransac_tpu_torch.utils.config import RansacConfig
import pallas_op_by_op  # tests/ is on sys.path under pytest
import torch_host_build
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 1024  # small block: interpret-mode cost scales with it


def scene(name):
    """(X, pix, K, mask, thr_px, R_true, t_true) of ``tests/test_sweep.py``'s
    P3P scenes; "aniso" is the third with fy = 0.54 fx (ay of the
    reference's film camera)."""
    rv, t, seed, n, f, shift, n_out, thr = {
        "n13": ([0.1, -0.2, 0.05], [0.2, -0.1, 6.0], 5, 13, 900.0, 200.0, 3, 30.0),
        "n12_masked": ([0.1, 0.2, -0.07], [0.1, 0.3, 5.0], 12, 12, 800.0, 0.0, 0, 20.0),
        "aniso": ([0.15, -0.1, 0.08], [0.3, -0.2, 7.0], 9, 14, 900.0, 150.0, 3, 8.0),
    }[name]
    rng = np.random.default_rng(seed)
    R_true = np.asarray(exp_so3(jnp.asarray(np.array(rv))))
    t_true = np.array(t)
    X = rng.uniform(-2, 2, (n, 3)) * np.array([1, 1, 0.5])
    fy = 0.54 * f if name == "aniso" else f
    K = np.array([[f, 0, 400], [0, fy, 300], [0, 0, 1]])
    pix, _ = jproj.project_points(jnp.asarray(X), jnp.asarray(R_true),
                                  jnp.asarray(t_true), jnp.asarray(K))
    # 0.5 px of noise (the scenes of tests/test_sweep.py are noise-free),
    # so that the data, not float rounding, decides between good samples.
    pix = np.array(pix) + rng.normal(scale=0.5, size=(n, 2))
    pix[n - n_out:] += shift
    mask = np.ones(n, np.float32)
    if name == "n12_masked":
        mask[4] = 0.0
    return (X.astype(np.float32), pix.astype(np.float32), K.astype(np.float32),
            mask, thr, R_true, t_true)


def kernel_inputs(name):
    X, pix, K, mask, thr, _, _ = scene(name)
    pixn = np.asarray(jproj.normalize_pixels(jnp.asarray(pix), jnp.asarray(K)))
    return X, pixn, mask, thr / K[0, 0], np.float32(K[1, 1] / K[0, 0])


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The interpreted Pallas kernel with an exact reciprocal; jit caches
    are cleared around it so the kernel is traced anew each way."""
    jax.clear_caches()
    monkeypatch.setattr(jsp.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


def winners(msac, counts, packed):
    """(sorted 3-point set, count, MSAC) of the min-MSAC and the (max
    count, min MSAC) winners over root-major full records."""
    out = []
    for k in (int(np.argmin(msac)), int(np.lexsort((msac, -counts))[0])):
        p = int(packed[k])
        out.append((sorted([p & 15, (p >> 4) & 15, (p >> 8) & 15]),
                    counts[k], msac[k]))
    return out


@pytest.mark.parametrize("name", ["n13", "n12_masked", "aniso"])
def test_pnp_sweep_full_records_match_pallas_interpret(name, exact_reciprocal):
    X, pixn, mask, thr_n, ay = kernel_inputs(name)
    m_j, c_j, p_j = (np.asarray(a) for a in jsp.pnp_ransac_sweep(
        3, jnp.asarray(X), jnp.asarray(pixn), jnp.asarray(mask), thr_n,
        n_hyp=BLOCK, interpret=True, full_records=True, ay=ay))
    m_t, c_t, p_t = (a.numpy() for a in tsp.pnp_ransac_sweep(
        3, torch.from_numpy(X), torch.from_numpy(pixn), torch.from_numpy(mask),
        thr_n, BLOCK, full_records=True, ay=ay))
    assert m_t.shape == m_j.shape == (4 * BLOCK,)
    np.testing.assert_array_equal(p_t, p_j)
    valid_t, valid_j = m_t < 3e38, m_j < 3e38
    assert (valid_t == valid_j).mean() >= 0.97
    assert (c_t == c_j).mean() >= 0.96
    both = valid_t & valid_j & (c_t == c_j)
    thr_sq = np.float32(thr_n) ** 2
    rel = np.abs(m_t[both] - m_j[both]) / np.maximum(np.abs(m_j[both]), thr_sq)
    assert (rel <= 1e-3).mean() >= 0.95
    for (s_t, n_t, e_t), (s_j, n_j, e_j) in zip(winners(m_t, c_t, p_t),
                                                winners(m_j, c_j, p_j)):
        assert s_t == s_j and n_t == n_j
        assert abs(e_t - e_j) <= 1e-3 * max(abs(e_j), thr_sq)
    assert c_t.max() >= mask.sum() - (0 if name == "n12_masked" else 3)
    if name == "n12_masked":  # masked point 4 invalidates its samples
        decoded = np.stack([(p_t >> s) & 15 for s in (0, 4, 8)])
        assert not valid_t[np.isin(decoded, [4]).any(0)].any()


def test_pnp_sweep_reduced_records_are_the_reduction_of_full():
    """The two-row block reduction picks, per record, what the sublane
    reduction of the full records picks (root id in bits 12-13)."""
    X, pixn, mask, thr_n, ay = kernel_inputs("n12_masked")
    args = (7, torch.from_numpy(X), torch.from_numpy(pixn),
            torch.from_numpy(mask), thr_n, 2 * BLOCK)
    m_r, c_r, p_r = tsp.pnp_ransac_sweep(*args, block_h=BLOCK)
    m_f, c_f, p_f = tsp.pnp_ransac_sweep(*args, block_h=BLOCK, full_records=True)
    B = 2 * BLOCK // 8
    msacs = list(m_f.reshape(4, 8, B))
    counts = list(c_f.reshape(4, 8, B))
    packed = p_f[:2 * BLOCK].reshape(8, B).long()
    am, ac, ar, bm, bc, br = tsp._best_roots(msacs, counts)
    fa, pa = tsw.reduce_records(am, ac, packed + ar * 4096, tsp.BIG)
    fb, pb = tsw.reduce_records(bm, bc, packed + br * 4096, tsp.BIG)
    assert torch.equal(m_r, torch.stack([fa[0], fb[2]]))
    assert torch.equal(c_r, torch.stack([fa[1], fb[3]]))
    assert torch.equal(p_r, torch.stack([pa[0], pb[1]]))
    assert ((p_r & 15) != 4).all() and (((p_r >> 4) & 15) != 4).all()


def test_plain_equals_wrapper_and_launches_stay_zero_on_cpu():
    X, pixn, mask, thr_n, ay = kernel_inputs("n13")
    args = (1, torch.from_numpy(X), torch.from_numpy(pixn),
            torch.from_numpy(mask), thr_n, BLOCK)
    for a, b in zip(tsp.pnp_ransac_sweep(*args, ay=ay),
                    tsp.pnp_ransac_sweep_ref(*args, ay=ay)):
        assert torch.equal(a, b)
    assert _build.LAUNCHES["pnp_ransac_sweep"] == 0
    assert list(tsp.unpack_sample3(3 + 16 * 7 + 256 * 12 + 4096 * 2)) == [3, 7, 12]


def test_kernel_entry_raises_for_cpu_tensors_and_large_pools(monkeypatch):
    """The kernel entry refuses CPU tensors; a pool over 16 points is routed
    to the large-pool sweep (kernel row 9, ``ops.sweep_pnp_large``)."""
    z = torch.zeros(16, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tsp._sweep_kernel(z, z, torch.zeros(16, 2), torch.ones(16), 1e-4, 1.0,
                          tsw.draw_seeds(0, 3), 13, 13, BLOCK, BLOCK, False)
    assert _build.LAUNCHES["pnp_ransac_sweep"] == 0
    calls = []
    large = tspl.pnp_ransac_sweep_large
    monkeypatch.setattr(tspl, "pnp_ransac_sweep_large",
                        lambda *a, **k: calls.append(a[1].shape) or large(*a, **k))
    X, pix, K, _, _, _ = planted_pnp_pool(20, seed=0)
    res = tr.ransac_pnp_sweep(torch.from_numpy(X), torch.from_numpy(pix),
                              torch.from_numpy(K), torch.ones(20),
                              RansacConfig(threshold=10.0), 0)
    assert calls == [(20, 3)]
    assert res.num_hypotheses == tspl.BLOCK_H * 4
    assert int(res.num_inliers) >= 12


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ["n13", "n12_masked", "aniso"])
def test_kernel_body_op_by_op_matches_plain(name, full, monkeypatch):
    """The JAX kernel body, every operation rounded on its own, exact
    reciprocals and rsqrt as 1/sqrt (correctly rounded sqrt, then an exact
    division) on both sides: the plain version's records bit for bit."""
    monkeypatch.setattr(jsp.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(tsp, "_rsqrt", lambda x: 1.0 / tsp._sqrt(x))
    X, pixn, mask, thr_n, ay = kernel_inputs(name)
    n = len(X)
    prep = tsp.prepare(torch.from_numpy(X), torch.from_numpy(pixn),
                       torch.from_numpy(mask), thr_n, ay)
    seeds = tsw.draw_seeds(3, 3)
    lan = BLOCK // 8
    shapes = ([((8, 8, lan), np.float32), ((1, 8, lan), np.int32)] if full
              else [((4, lan), np.float32), ((2, lan), np.int32)])
    f_j, i_j = pallas_op_by_op.run_kernel(
        monkeypatch, jsp._make_kernel(n, n, not full, BLOCK), 2,
        [a.numpy() for a in prep[:4]]
        + [np.array(prep[4:], np.float32), np.array(seeds, np.uint32),
           tsw.sample_bitmask(prep[3]).numpy()], shapes)
    f_t, i_t = tsp._sweep_plain(*prep, seeds, n, n, 2 * BLOCK, BLOCK, full)
    if full:  # JAX interleaves (msac, count) per root; the port lists 4 + 4
        f_j = f_j[[0, 2, 4, 6, 1, 3, 5, 7]]
        f_t, i_t = f_t.reshape(8, 8, -1), i_t.reshape(1, 8, -1)
    np.testing.assert_array_equal(f_j, f_t.numpy())
    np.testing.assert_array_equal(i_j, i_t.numpy())


@pytest.mark.parametrize("name", ["n13", "n12_masked", "aniso"])
def test_kernel_arithmetic_host_build_matches_plain(name, tmp_path, monkeypatch):
    """``csrc/sweep_pnp.cuh`` compiled for the host gives the plain
    version's records bit for bit, once the plain version's rsqrt is the
    host build's 1/sqrt (on the card both are rsqrtf)."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(tsp, "_rsqrt", lambda x: 1.0 / tsp._sqrt(x))
    X, pixn, mask, thr_n, ay = kernel_inputs(name)
    n = len(X)
    prep = tsp.prepare(torch.from_numpy(X), torch.from_numpy(pixn),
                       torch.from_numpy(mask), thr_n, ay)
    seeds = tsw.draw_seeds(3, 3)
    f_ref, i_ref = tsp._sweep_plain(*prep, seeds, n, n, 2 * BLOCK, BLOCK, True)
    f_h, i_h = torch_host_build.sweep_pnp_full(
        lib, *prep, int(tsw.sample_bitmask(prep[3])[0]), seeds, n, n,
        2 * BLOCK, BLOCK)
    assert torch.equal(i_h, i_ref)
    same = (f_h == f_ref) | (torch.isnan(f_h) & torch.isnan(f_ref))
    assert same.all()


def full_of(f, i, n_hyp):
    """Full records (msac, counts, keys [4 n_hyp]) of a (f [8, n_hyp], i
    [n_hyp]) core output, keyed as the reduced records (packed + root *
    4096)."""
    return f[:4].reshape(-1), f[4:].reshape(-1), tsp.full_keys(i, n_hyp)


def reduce_full(full, n_hyp):
    """The kernel's record reduction of full records: (msac, counts, keys)
    [2, B]."""
    msac, counts, keys = (t.reshape(4, 8, n_hyp // 8) for t in full)
    am, ac, ar, bm, bc, br = tsp._best_roots(list(msac), list(counts))
    packed = keys[0]
    fa, pa = tsw.reduce_records(am, ac, packed + ar * 4096, tsp.BIG)
    fb, pb = tsw.reduce_records(bm, bc, packed + br * 4096, tsp.BIG)
    return (torch.stack([fa[0], fb[2]]), torch.stack([fa[1], fb[3]]),
            torch.stack([pa[0], pb[1]]).long())


def hold(full_k, plain, n_hyp):
    """hold_full and hold_reduced of a kernel's full records against the
    plain version's (``plain``: the ``_sweep_plain`` arguments but
    ``full``); the failures of both."""
    full_p = full_of(*tsp._sweep_plain(*plain, True), n_hyp)
    held = tsp.hold_full(full_k, full_p, lambda h: tsp.cut_margins(*plain[:-1], h))
    red_p = tsp._sweep_plain(*plain, False)
    red_p = (red_p[0][0::2], red_p[0][1::2], red_p[1].long())
    held_r = tsp.hold_reduced(reduce_full(full_k, n_hyp), red_p, full_k, held["flipped"])
    return held["failures"] + held_r["failures"], held


@pytest.mark.parametrize("name", ["n13", "n12_masked", "aniso"])
def test_fused_host_build_holds_plain(name, tmp_path, monkeypatch):
    """The kernels' arithmetic, built for the host with the ``Fused`` score
    (FMA where the card issues one; the host's exact reciprocal), holds the
    plain version by ``hold_full`` / ``hold_reduced``: samples and validity
    equal, every count flip explained by points at the cut, MSAC within
    1e-4 on >= 99% of the valid pairs and 1e-3 on all, the winners kept."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(tsp, "_rsqrt", lambda x: 1.0 / tsp._sqrt(x))
    X, pixn, mask, thr_n, ay = kernel_inputs(name)
    n, n_hyp = len(X), 2 * BLOCK
    prep = tsp.prepare(torch.from_numpy(X), torch.from_numpy(pixn),
                       torch.from_numpy(mask), thr_n, ay)
    seeds = tsw.draw_seeds(3, 3)
    f_h, i_h = torch_host_build.sweep_pnp_full(
        lib, *prep, int(tsw.sample_bitmask(prep[3])[0]), seeds, n, n, n_hyp,
        BLOCK, fused=True)
    fails, held = hold(full_of(f_h, i_h, n_hyp), (*prep, seeds, n, n, n_hyp, BLOCK),
                       n_hyp)
    assert not fails
    assert held["valid_pairs"] > n_hyp and held["msac_within_1e-4_fraction"] == 1.0


@pytest.mark.parametrize("change", ["twice_the_cut_points", "no_point_at_the_cut"])
def test_hold_full_explains_count_flips_by_points_at_the_cut(change):
    """``cut_margins`` gives the weight of a pair's points at the inlier cut.
    With the bound set at an inlier of the plain winner's pose, that point
    sits at the cut of the pairs that share the pose: a count lowered by its
    weight holds; one lowered by twice as much, or a count moved where no
    point sits at the cut, fails."""
    X, pixn, mask, _, ay = kernel_inputs("n13")
    n, n_hyp = len(X), BLOCK
    prep = list(tsp.prepare(torch.from_numpy(X), torch.from_numpy(pixn),
                            torch.from_numpy(mask), 0.03, ay))
    seeds = tsw.draw_seeds(3, 3)
    plain = (*prep, seeds, n, n, n_hyp, BLOCK)
    full_p = full_of(*tsp._sweep_plain(*plain, True), n_hyp)
    w = int(full_p[0].argmin())
    # The bound at the largest inlier residual r2 / z2 of the winner's pose.
    k, o = divmod(w, n_hyp)
    B, lan = n_hyp // 8, BLOCK // 8
    flat = torch.tensor([(o % B) // lan * BLOCK + (o // B) * lan + (o % B) % lan])
    idx = tsw.draw_sample(flat, seeds, n)
    P = [[prep[0][i, c] for c in range(3)] for i in idx]
    F = [[prep[1][i, c] for c in range(3)] for i in idx]
    pose = tsp.solve_poses(P, F, torch.tensor([True]), torch.tensor(prep[5]))[0][k]
    ratios = [float(r2 / t2) for r2, t2, _ in
              (tsp._point_terms(pose, m, torch.tensor(1.0), prep[0], prep[2])
               for m in range(n))]
    prep[4] = float(np.float32(max(r for r in ratios if r <= prep[4])))
    plain = (*prep, seeds, n, n, n_hyp, BLOCK)
    full_p = full_of(*tsp._sweep_plain(*plain, True), n_hyp)

    def margins(h):
        return tsp.cut_margins(*plain, h)
    near_in, near_out = margins(torch.arange(4 * n_hyp))
    assert float(near_in[w]) >= 1.0
    at_cut = torch.nonzero(near_in > 0).flatten()
    h = int(at_cut[at_cut != w][0])
    counts = full_p[1].clone()
    counts[h] -= near_in[h]
    assert not tsp.hold_full((full_p[0], counts, full_p[2]), full_p, margins)["failures"]
    if change == "twice_the_cut_points":
        counts[h] -= near_in[h]
    else:
        counts = full_p[1].clone()
        off = (full_p[1] > 0) & (near_in + near_out == 0)
        off[w] = False
        counts[int(torch.nonzero(off)[0, 0])] += 1
    held = tsp.hold_full((full_p[0], counts, full_p[2]), full_p, margins)
    assert held["failures"] == ["1 count flips off the inlier cut"]


@pytest.mark.parametrize("n_points", range(3, 17))
def test_draw_sample_fast_matches_plain(n_points, tmp_path):
    """The kernel's 3-point draw (``rt::draw_sample_fast``, remainders by
    multiply-high) gives ``draw_sample``'s samples."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    flat = np.random.default_rng(n_points).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    flat[:3] = [0, 2 ** 32 - 1, 2 ** 31]
    seeds = tsw.draw_seeds(n_points, 3)
    idx = torch_host_build.draw_fast(lib, 3, flat, seeds, n_points)
    ref = tsw.draw_sample(torch.from_numpy(flat.astype(np.int64)), seeds, n_points)
    np.testing.assert_array_equal(idx, torch.stack(ref, -1).numpy())


def test_valid_root_share_counts_valid_pairs(tmp_path, monkeypatch):
    """``valid_root_share`` is the share of (sample, root) pairs the kernel's
    arithmetic finds valid (its full records' counts >= 0)."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(tsp, "_rsqrt", lambda x: 1.0 / tsp._sqrt(x))
    X, pixn, mask, thr_n, ay = kernel_inputs("n12_masked")
    args = [torch.from_numpy(a) for a in (X, pixn, mask)]
    share = tsp.valid_root_share(3, *args, thr_n, BLOCK, block_h=BLOCK, ay=ay)
    prep = tsp.prepare(*args, thr_n, ay)
    f_h, _ = torch_host_build.sweep_pnp_full(
        lib, *prep, int(tsw.sample_bitmask(prep[3])[0]), tsw.draw_seeds(3, 3),
        len(X), len(X), BLOCK, BLOCK)
    assert share == float((f_h[4:] >= 0).double().mean())
    assert 0.3 < share < 0.7


@pytest.mark.cuda
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_cuda_kernel_matches_plain(full):
    """The kernel holds its plain version on the card: full records by
    ``hold_full``, reduced by ``hold_reduced`` (the kernel's full records
    of the same call beside them); samples and validity bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, pixn, mask, thr_n, ay = kernel_inputs("aniso")
    args = [torch.from_numpy(a).cuda() for a in (X, pixn, mask)]
    n, n_hyp = len(X), 4 * tsp.BLOCK_H
    prep = tsp.prepare(*args, thr_n, ay)
    core = (*prep, tsw.draw_seeds(2, 3), n, n, n_hyp, tsp.BLOCK_H)
    before = _build.LAUNCHES["pnp_ransac_sweep"]
    f, i = tsp._sweep_kernel(*core, True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pnp_ransac_sweep"] == before + 1
    full_k = full_of(f, i, n_hyp)
    fails, held = hold(full_k, core, n_hyp)
    assert not fails
    if not full:
        red = tsp._sweep_kernel(*core, False)
        red_k = (red[0][0::2], red[0][1::2], red[1].long())
        red_p = tsp._sweep_plain(*core, False)
        red_p = (red_p[0][0::2], red_p[0][1::2], red_p[1].long())
        assert not tsp.hold_reduced(red_k, red_p, full_k, held["flipped"])["failures"]
