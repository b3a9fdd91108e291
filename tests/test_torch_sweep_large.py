"""The windowed counter sampler of the large-pool sweeps and the large-pool
homography sweep (``ransac_tpu_torch.ops.sweep_large``) against
``ransac_tpu.ops.pallas.sweep_large``.

The sampler is the JAX one bit for bit: window bases, the shuffled
valid-first pool order and the replayed pool slots of every flat id agree
exactly with the XLA functions of all three large-pool kernels, masked and
unmasked, below, at and above the 64-slot window.

``test_kernel_body_op_by_op_matches_plain`` is the exact check of row 6:
the JAX kernel body run one operation at a time (``pallas_op_by_op``,
exact reciprocal) on the port's table gives the plain version's records
bit for bit.  The kernel's own arithmetic (``csrc/sweep_large.cuh`` under
its `Exact` policy, 1, 2 or 4 hypotheses a thread, and the prep's pairwise
sums and the pool ranks), built for the host, agrees with the plain
version bit for bit too; under the kernel's `Fused` policy it holds the
decision-level criteria of ``ops.sweep.hold_full`` / ``hold_reduced``.
The jitted, interpreted JAX sweep normalizes with XLA's
sums and contracts FMAs, so against it the port is held to the same
decisions: the winners' counts and near-equal MSAC.  The entry points are
compared in ``tests/test_torch_sweep_large_api.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops import homography as jh
from ransac_tpu.ops.pallas import sweep_essential_large as jsel
from ransac_tpu.ops.pallas import sweep_large as jsl
from ransac_tpu.ops.pallas import sweep_pnp_large as jspl
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import homography as th
from ransac_tpu_torch.ops import sweep as tsw
from ransac_tpu_torch.ops import sweep_essential_large as tsel
from ransac_tpu_torch.ops import sweep_large as tsl
from ransac_tpu_torch.ops import sweep_pnp_large as tspl
from ransac_tpu_torch.utils.config import RansacConfig
import pallas_op_by_op  # tests/ is on sys.path under pytest
import torch_host_build
from torch_threads import one_torch_thread  # noqa: F401

THR = 75.0


def planted(seed=0, n=100, n_out=30, noise=1.0):
    """``tests/test_sweep.py``'s planted homography problem at pool size n."""
    rng = np.random.default_rng(seed)
    H_true = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0],
                       [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, size=(n, 2)).astype(np.float32)
    dst = np.array(jh.apply_h(jnp.asarray(H_true), jnp.asarray(src)))
    dst = (dst + rng.normal(scale=noise, size=dst.shape)).astype(np.float32)
    dst[n - n_out:] += 300.0
    return src, dst, n - n_out


def pool_mask(n, masked):
    mask = np.ones(n, np.float32)
    if masked:
        mask[np.random.default_rng(n).choice(n, n // 5, replace=False)] = 0.0
    return mask


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("n", [13, 64, 65, 300, 1024])
def test_sampler_matches_jax_bit_for_bit(n, masked):
    """Window bases, pool order and the replayed slots of every flat id of
    several blocks, for rows 6 (4 draws), 9 (3 draws, block_h 512) and 8
    (8 draws, block_h 512): equal to the JAX functions, exactly."""
    mask = pool_mask(n, masked)
    n_valid = int((mask > 0).sum())
    for k, seed, block_h, window_seed in ((4, 11, jsl.BLOCK_H, 4),
                                          (3, 12, 512, 3), (8, 13, 512, 8)):
        seeds_j = jsl._draw_seeds_n(seed, k + 2)
        seeds_t = tsw.draw_seeds(seed, k + 2)
        assert [int(s) for s in np.asarray(seeds_j)] == seeds_t
        order_j = np.asarray(jsl._shuffle_order_hash(seeds_j[k + 1], jnp.asarray(mask)))
        order_t = tsl.shuffle_order(seeds_t[k + 1], torch.from_numpy(mask))
        np.testing.assert_array_equal(order_t.numpy(), order_j)
        n_blocks = 6
        wb_j = np.asarray(jsl._window_bases_hash(
            seeds_j[window_seed], n_blocks, jnp.int32(n_valid), jsl.WINDOW))
        wb_t = tsl.window_bases(seeds_t[window_seed], torch.arange(n_blocks), n_valid)
        np.testing.assert_array_equal(wb_t.numpy(), wb_j)
        flat = np.arange(n_blocks * block_h, dtype=np.int32)
        if k == 4:
            slots_j = jsl.sample_indices_for(jnp.asarray(flat), seeds_j, n_valid)
            slots_t = tsl.sample_indices_for(torch.from_numpy(flat), seeds_t, n_valid)
        elif k == 3:
            slots_j = jspl.sample_indices3_for(jnp.asarray(flat), seeds_j, n_valid,
                                               block_h=block_h)
            slots_t = tspl.sample_indices3_for(torch.from_numpy(flat), seeds_t,
                                               n_valid, block_h=block_h)
        else:
            slots_j = jsel.sample_indices_for8(jnp.asarray(flat), seeds_j, n_valid,
                                               block_h=block_h)
            slots_t = tsel.sample_indices_for8(torch.from_numpy(flat), seeds_t,
                                               n_valid, block_h=block_h)
        slots_t = slots_t.numpy()
        np.testing.assert_array_equal(slots_t, np.asarray(slots_j))
        assert (np.diff(np.sort(slots_t, 1), axis=1) != 0).all()
        assert slots_t.min() >= 0 and slots_t.max() < n_valid
        if n_valid <= jsl.WINDOW:
            assert (wb_t == 0).all()


def _table_inputs(name):
    """(src, dst, mask) of the row 6 kernel-body cases: unwindowed (n <=
    64, one block), the smallest windowed pool (65), and a masked pool
    whose masked rows are poisoned."""
    n = {"n40": 40, "n65": 65, "n90_masked": 90}[name]
    src, dst, _ = planted(3, n=n, n_out=n // 4)
    mask = np.ones(n, np.float32)
    if name == "n90_masked":
        mask[5:15] = 0.0
        src[5:15] = 1e6  # sampling a masked row would blow up
    return src, dst, mask


@pytest.mark.parametrize("name", ["n40", "n65", "n90_masked"])
def test_kernel_body_op_by_op_matches_plain(name, monkeypatch):
    """Row 6's JAX kernel body, every operation rounded on its own, exact
    reciprocal, on the port's table: the plain version's records bit for
    bit (unscaled)."""
    monkeypatch.setattr(jsl.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    src, dst, mask = _table_inputs(name)
    n = len(src)
    seeds = tsw.draw_seeds(9, tsl.N_SEEDS)
    table, thr_sq, _, n_valid, _ = tsl._prepare(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        THR, seeds)
    n_hyp = tsl.n_hyp_for(1, n, tsl.BLOCK_H)
    n_blocks = n_hyp // tsl.BLOCK_H
    wb = tsl.window_bases(seeds[4], torch.arange(n_blocks), n_valid)
    f_j, i_j = pallas_op_by_op.run_kernel(
        monkeypatch, jsl._make_kernel(n, table.shape[0]), n_blocks,
        [table.numpy(), thr_sq.reshape(1).numpy(), np.array(seeds, np.uint32),
         np.array([int(n_valid)], np.int32), wb.numpy().astype(np.int32)],
        [((4, tsl.LAN), np.float32), ((2, tsl.LAN), np.int32)])
    f_t, i_t = tsl._score_plain(table, thr_sq, seeds, n_valid, n_hyp)
    np.testing.assert_array_equal(f_j, f_t.numpy())
    np.testing.assert_array_equal(i_j, i_t.numpy())
    assert (f_t[3] >= 0).any()


@pytest.mark.parametrize("name", ["n40", "n65", "n90_masked"])
def test_kernel_arithmetic_host_build_matches_plain(name, tmp_path):
    """``csrc/sweep_large.cuh`` and the prep's tree sums, compiled for the
    host, give the plain version's table, order and every hypothesis'
    (MSAC, count) bit for bit; reduced like the kernel, its records."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    src, dst, mask = (torch.from_numpy(a) for a in _table_inputs(name))
    seeds = tsw.draw_seeds(5, tsl.N_SEEDS)
    n_hyp = tsl.n_hyp_for(1, len(src), tsl.BLOCK_H)
    f_ref, i_ref, n_valid, order = tsl._sweep_plain(src, dst, mask, THR, seeds, n_hyp)
    table_ref, _, inv_s2, _, _ = tsl._prepare(src, dst, mask, THR, seeds)
    table, order_h, msac, count = torch_host_build.sweep_large_full(
        lib, src, dst, mask, THR, seeds, n_hyp)
    assert torch.equal(table, table_ref)
    assert torch.equal(order_h, order)
    flat = tsw.record_flat_ids(0, n_hyp // 8, tsl.LAN, "cpu")
    f, i = tsw.reduce_records(msac[flat], count[flat], flat)
    f = torch.stack([tsl.rescale(f[0], inv_s2), f[1], tsl.rescale(f[2], inv_s2), f[3]])
    assert torch.equal(f, f_ref) and torch.equal(i, i_ref)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = torch_host_build.load(tmp_path_factory.mktemp("host_build"))
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


def _host_records(lib, src, dst, mask, seeds, n_hyp, fused, k):
    """The host build's reduced records (f [4, B] rescaled, i [2, B]), as
    the kernel reduces them."""
    inv_s2 = tsl._prepare(src, dst, mask, THR, seeds)[2]
    _, _, msac, count = torch_host_build.sweep_large_full(
        lib, src, dst, mask, THR, seeds, n_hyp, fused, k)
    flat = tsw.record_flat_ids(0, n_hyp // 8, tsl.LAN, "cpu")
    f, i = tsw.reduce_records(msac[flat], count[flat], flat)
    return torch.stack([tsl.rescale(f[0], inv_s2), f[1], tsl.rescale(f[2], inv_s2),
                        f[3]]), i


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["n40", "n65", "n90_masked"])
def test_exact_header_k_hypotheses_a_thread_matches_plain(name, k, host_lib):
    """``sweep_large::eval<Exact, K>`` with K = 2 or 4 hypotheses a thread
    (the kernel's thread mapping, each table row scored against K
    homographies) gives the plain version's records bit for bit."""
    src, dst, mask = (torch.from_numpy(a) for a in _table_inputs(name))
    seeds = tsw.draw_seeds(5, tsl.N_SEEDS)
    n_hyp = tsl.n_hyp_for(1, len(src), tsl.BLOCK_H)
    f_ref, i_ref = tsl._sweep_plain(src, dst, mask, THR, seeds, n_hyp)[:2]
    f, i = _host_records(host_lib, src, dst, mask, seeds, n_hyp, False, k)
    assert torch.equal(f, f_ref) and torch.equal(i, i_ref)


def _fused_inputs(name):
    """(src, dst, mask, n_hyp): the check cases at 4 blocks, and planted
    pools of 256 and 1024 points (30% outliers) at 4 blocks."""
    if name.startswith("planted"):
        n = int(name[len("planted"):])
        src, dst, _ = planted(7, n=n, n_out=int(0.3 * n))
        mask = np.ones(n, np.float32)
    else:
        src, dst, mask = _table_inputs(name)
    return (*(torch.from_numpy(a) for a in (src, dst, mask)), 4 * tsl.BLOCK_H)


@pytest.mark.parametrize("name", ["n40", "n65", "n90_masked", "planted256",
                                  "planted1024"])
def test_fused_host_build_holds_plain(name, host_lib):
    """The kernel's policy (`Fused` score, exact solve, 4 hypotheses a
    thread; the host divides where the card takes MUFU's reciprocal): full
    and reduced records held to the plain version's by ``ops.sweep``'s
    criteria, flips explained by ``sweep_large.cut_margins``; the solve is
    exact, so validity never moves."""
    src, dst, mask, n_hyp = _fused_inputs(name)
    seeds = tsw.draw_seeds(3, tsl.N_SEEDS)
    full_k = torch_host_build.sweep_large_full_records(host_lib, src, dst, mask,
                                                       THR, seeds, n_hyp)
    f_p, i_p = tsl._sweep_plain(src, dst, mask, THR, seeds, n_hyp, True)[:2]
    held = tsw.hold_full(full_k, (f_p[0], f_p[1], i_p),
                         lambda h: tsl.cut_margins(src, dst, mask, THR, seeds, n_hyp, h))
    assert held["failures"] == [] and held["validity_flips"] == 0
    B = n_hyp // 8
    red = tsw.reduce_records(full_k[0].reshape(8, B), full_k[1].reshape(8, B),
                             full_k[2].reshape(8, B).long())
    f_r, i_r = tsl._sweep_plain(src, dst, mask, THR, seeds, n_hyp)[:2]
    held_r = tsw.hold_reduced((red[0][0::2], red[0][1::2], red[1]),
                              (f_r[0::2], f_r[1::2], i_r), full_k, held["flipped"])
    assert held_r["failures"] == []


@pytest.mark.parametrize("name", ["n40", "n90_masked"])
def test_full_records_reduce_to_records(name):
    """The plain version's full records (s * B + r order, flat ids) reduce,
    by the TPU kernels' rule, to its reduced records, as the kernel's full
    mode must."""
    src, dst, mask = (torch.from_numpy(a) for a in _table_inputs(name))
    seeds = tsw.draw_seeds(2, tsl.N_SEEDS)
    n_hyp = tsl.n_hyp_for(1, len(src), tsl.BLOCK_H)
    B = n_hyp // 8
    f, i, nv_f, order_f = tsl._sweep_plain(src, dst, mask, THR, seeds, n_hyp, True)
    assert f.shape == (2, n_hyp) and i.shape == (n_hyp,)
    flat = tsw.record_flat_ids(0, B, tsl.LAN, "cpu").reshape(-1)
    assert torch.equal(i.long(), flat)
    red_f, red_i = tsw.reduce_records(f[0].reshape(8, B), f[1].reshape(8, B),
                                      i.reshape(8, B).long())
    f_r, i_r, nv_r, order_r = tsl._sweep_plain(src, dst, mask, THR, seeds, n_hyp)
    assert torch.equal(red_f, f_r) and torch.equal(red_i, i_r)
    assert int(nv_f) == int(nv_r) and torch.equal(order_f, order_r)


def test_cut_margins_replay_the_full_records(monkeypatch):
    """``cut_margins`` replays the hypotheses of the full records: with the
    cut band widened to everything, a valid hypothesis' points within it as
    inliers weigh its plain count, and both bands together the pool's
    weight."""
    src, dst, mask = (torch.from_numpy(a) for a in _table_inputs("n90_masked"))
    seeds = tsw.draw_seeds(4, tsl.N_SEEDS)
    n_hyp = tsl.n_hyp_for(1, len(src), tsl.BLOCK_H)
    f, _ = tsl._sweep_plain(src, dst, mask, THR, seeds, n_hyp, True)[:2]
    hyp = torch.arange(0, n_hyp, 97)
    monkeypatch.setattr(tsw, "COUNT_CUT", float("inf"))
    near_in, near_out, det_margin = tsl.cut_margins(src, dst, mask, THR, seeds,
                                                    n_hyp, hyp)
    valid = f[1][hyp] >= 0
    assert valid.any() and (det_margin[valid] > 0).all()
    assert torch.equal(near_in[valid], f[1][hyp][valid])
    assert torch.equal((near_in + near_out)[valid],
                       torch.full_like(near_in[valid], float(mask.sum())))


@pytest.mark.parametrize("case", ["unmasked", "masked", "colliding_keys"])
def test_pool_sort_matches_shuffle_order(case, host_lib):
    """The prep kernels' ranks of the words key << 32 | row (host form of
    ``large::pool_slot``: a row's slot is the count of smaller words) give
    ``shuffle_order``'s pool order on unmasked and masked pools of several
    sizes, and the stable order where keys collide (equal keys keep their
    row order)."""
    for n in (1, 13, 64, 300, 1000, 1024):
        if case == "colliding_keys":
            rng = np.random.default_rng(n)
            keys = rng.integers(0, max(n // 8, 2), n).astype(np.uint32)
            keys[rng.random(n) < 0.2] += np.uint32(0x80000000)
            expected = np.argsort(keys, kind="stable")
        else:
            mask = pool_mask(n, case == "masked")
            seed = tsw.draw_seeds(n, 6)[5]
            iota = np.arange(n, dtype=np.uint64)
            keys = np.array([tsw.fmix32(int(i) ^ seed) & 0x7FFFFFFF if m > 0
                             else 0x80000000 + int(i) for i, m in zip(iota, mask)],
                            dtype=np.uint32)
            expected = tsl.shuffle_order(seed, torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(torch_host_build.pool_sort(host_lib, keys),
                                      expected)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The interpreted Pallas kernel with an exact reciprocal (interpret
    mode lowers the approximate one to bfloat16); jit caches are cleared
    around it so the kernel is traced anew each way."""
    jax.clear_caches()
    monkeypatch.setattr(jsl.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


def test_records_match_pallas_interpret(exact_reciprocal):
    """The jitted, interpreted JAX sweep and the port on the same pool (96
    points, 4 blocks): records keep the same flat id almost everywhere
    (another member of a near-tie elsewhere: XLA's sums and FMAs move the
    normalized points in the last place), counts are equal where they
    do, and the winners under both rules have the same count and MSAC
    within 1e-4."""
    src, dst, n_in = planted(4, n=96, n_out=24)
    mask = np.ones(len(src), np.float32)
    mask[[3, 50]] = 0.0
    out_j = jsl.homography_ransac_sweep_large(
        21, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), THR,
        n_hyp=1, interpret=True)
    m_j, c_j, f_j = (np.asarray(a) for a in out_j[:3])
    m_t, c_t, f_t, _ = tsl.homography_ransac_sweep_large(
        21, torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        THR, 1)
    m_t, c_t, f_t = m_t.numpy(), c_t.numpy(), f_t.numpy()
    assert m_t.shape == m_j.shape == (2, 4 * tsl.LAN)
    same = f_t == f_j
    assert same.mean() >= 0.98
    np.testing.assert_array_equal(c_t[same], c_j[same])
    a_t, a_j = int(np.argmin(m_t[0])), int(np.argmin(m_j[0]))
    b_t, b_j = (int(np.lexsort((m[1], -c[1]))[0]) for m, c in ((m_t, c_t), (m_j, c_j)))
    for row, k_t, k_j in ((0, a_t, a_j), (1, b_t, b_j)):
        assert c_t[row, k_t] == c_j[row, k_j]
        assert abs(m_t[row, k_t] / m_j[row, k_j] - 1.0) <= 1e-4
    assert c_t[1, b_t] >= 0.9 * (n_in - 2)


def test_ransac_homography_sweep_200_points_finds_planted_consensus():
    """200 points with 30% outliers on the CPU: the fused entry point now
    routes past 16 points and returns the planted consensus; the replayed
    winner re-solves to its recorded count within 2 (float boundary)."""
    src, dst, n_in = planted(2, n=200, n_out=60)
    cfg = RansacConfig(threshold=THR, num_hypotheses=8192, exhaustive=False)
    res = tr.ransac_homography_sweep(torch.from_numpy(src), torch.from_numpy(dst),
                                     torch.ones(200), cfg, 11)
    assert int(res.num_inliers) >= 0.9 * n_in
    assert not res.inlier_mask[n_in:].any()
    errs = th.transfer_errors(res.model, torch.from_numpy(src), torch.from_numpy(dst))
    assert float(errs[:n_in].median()) < 3.0
    m, c, flat, (seeds, n_valid, order) = tsl.homography_ransac_sweep_large(
        11, torch.from_numpy(src), torch.from_numpy(dst), torch.ones(200), THR, 8192)
    b = int(m[0].argmin())
    sample = order[tsl.sample_indices_for(flat[0, b], seeds, n_valid)]
    Hm, _ = th.dlt_homography_minimal(torch.from_numpy(src)[sample],
                                      torch.from_numpy(dst)[sample])
    e = th.transfer_errors(Hm, torch.from_numpy(src), torch.from_numpy(dst))
    assert abs(int((e <= THR).sum()) - float(c[0, b])) <= 2


def test_plain_equals_wrapper_and_launches_stay_zero_on_cpu():
    src, dst, _ = planted(1, n=70, n_out=10)
    args = (3, torch.from_numpy(src), torch.from_numpy(dst), torch.ones(70), THR, 1)
    out, ref = tsl.homography_ransac_sweep_large(*args), tsl.homography_ransac_sweep_large_ref(*args)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert _build.LAUNCHES["homography_ransac_sweep_large"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tsl._sweep_kernel(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.ones(70), THR, tsw.draw_seeds(0, 6), tsl.BLOCK_H)
    assert _build.LAUNCHES["homography_ransac_sweep_large"] == 0


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The kernel (`Fused` score) against the plain version on the card:
    pool order and n_valid equal, full and reduced records held by
    ``ops.sweep.hold_full`` / ``hold_reduced``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src, dst, mask = (torch.from_numpy(a).cuda() for a in _table_inputs("n90_masked"))
    before = _build.LAUNCHES["homography_ransac_sweep_large"]
    out = tsl.homography_ransac_sweep_large(4, src, dst, mask, THR, 4 * tsl.BLOCK_H)
    ref = tsl.homography_ransac_sweep_large_ref(4, src, dst, mask, THR, 4 * tsl.BLOCK_H)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["homography_ransac_sweep_large"] == before + 1
    assert int(out[3][1]) == int(ref[3][1])
    assert torch.equal(out[3][2].cpu(), ref[3][2].cpu())
    core = (src, dst, mask, THR, tsw.draw_seeds(4, tsl.N_SEEDS), 4 * tsl.BLOCK_H)
    f_k, i_k = tsl._sweep_kernel(*core, full=True)[:2]
    f_p, i_p = tsl._sweep_plain(*core, full=True)[:2]
    full_k = (f_k[0], f_k[1], i_k)
    held = tsw.hold_full(full_k, (f_p[0], f_p[1], i_p),
                         lambda h: tsl.cut_margins(*core, h))
    assert held["failures"] == []
    held_r = tsw.hold_reduced(out[:3], ref[:3], full_k, held["flipped"])
    assert held_r["failures"] == []
