"""The large-pool P3P sweep port (``ransac_tpu_torch.ops.sweep_pnp_large``)
and ``ransac_pnp_sweep`` on pools over 16 points, against
``ransac_tpu.ops.pallas.sweep_pnp_large.pnp_ransac_sweep_large``.

``test_kernel_body_op_by_op_matches_plain`` is the exact check: the JAX
kernel body run one operation at a time (``pallas_op_by_op``), with exact
reciprocals and rsqrt taken as 1/sqrt on both sides, gives the plain
version's records bit for bit on the port's table.  The kernel's own
arithmetic, built for the host, agrees with the plain version bit for bit
under the ``Exact`` score policy, and by ``ops.sweep_pnp.hold_full`` /
``hold_reduced`` under the kernel's ``Fused`` one.  Against the jitted, interpreted JAX function (XLA contracts FMAs and
its rsqrt is not torch's; Grunert's quartic is ill-conditioned for some
triples) the port is held to the same decisions: the winners' 3-point sets
and counts.  The sampler itself is compared in
``tests/test_torch_sweep_large.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops.pallas import sweep_pnp as jsp
from ransac_tpu.ops.pallas import sweep_pnp_large as jspl
from ransac_tpu_torch.io.synthetic import planted_pnp_pool
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep as tsw
from ransac_tpu_torch.ops import sweep_large as tsl
from ransac_tpu_torch.ops import sweep_pnp as tsp
from ransac_tpu_torch.ops import sweep_pnp_large as tspl
from ransac_tpu_torch.ops.rotation import log_so3
from ransac_tpu_torch.utils.config import RansacConfig
import pallas_op_by_op  # tests/ is on sys.path under pytest
import torch_host_build
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 512  # small block: interpret-mode cost scales with it


def pool(name):
    """(X, pix_n, mask, thr_n, ay, K, pixels, n_in, R, t): 40 points (one
    unwindowed block), 70 (windowed, 4 blocks), 80 with poisoned masked
    rows, all with 30% outliers; "aniso" has fy = 0.54 fx."""
    n, seed = {"n40": (40, 1), "n70": (70, 2), "n80_masked": (80, 3),
               "aniso": (48, 4)}[name]
    X, pix, K, R, t, n_in = planted_pnp_pool(n, seed=seed)
    mask = np.ones(n, np.float32)
    if name == "n80_masked":
        mask[:6] = 0.0
        X[:6] = 1e6  # sampling a masked row would blow up
    if name == "aniso":
        K[1, 1] *= 0.54
        pix[:, 1] = (pix[:, 1] - K[1, 2]) * 0.54 + K[1, 2]
    pixn = np.asarray(jproj.normalize_pixels(jnp.asarray(pix), jnp.asarray(K)))
    return (X, pixn, mask, 10.0 / K[0, 0], np.float32(K[1, 1] / K[0, 0]), K, pix,
            n_in, R, t)


@pytest.mark.parametrize("name", ["n40", "n70", "n80_masked", "aniso"])
def test_kernel_body_op_by_op_matches_plain(name, monkeypatch):
    """Row 9's JAX kernel body, every operation rounded on its own, exact
    reciprocals, rsqrt as 1/sqrt on both sides, on the port's table: the
    plain version's records bit for bit."""
    monkeypatch.setattr(jsp.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(tsp, "_rsqrt", lambda x: 1.0 / tsp._sqrt(x))
    X, pixn, mask, thr_n, ay = pool(name)[:5]
    n = len(X)
    seeds = tsw.draw_seeds(7, tspl.N_SEEDS)
    table, n_valid, _ = tspl._prepare(torch.from_numpy(X), torch.from_numpy(pixn),
                                      torch.from_numpy(mask), float(ay), seeds)
    n_hyp = tspl.n_hyp_for(1, n, BLOCK)
    n_blocks = n_hyp // BLOCK
    thr_sq = tspl._thr_sq(thr_n)
    wb = tsl.window_bases(seeds[3], torch.arange(n_blocks), n_valid)
    f_j, i_j = pallas_op_by_op.run_kernel(
        monkeypatch, jspl._make_kernel(n, BLOCK, table.shape[0]), n_blocks,
        [table.numpy(), np.array([thr_sq, ay], np.float32),
         np.array(seeds, np.uint32), np.array([int(n_valid)], np.int32),
         wb.numpy().astype(np.int32)],
        [((4, BLOCK // 8), np.float32), ((2, BLOCK // 8), np.int32)])
    f_t, i_t = tspl._score_plain(table, thr_sq, float(ay), seeds, n_valid, n_hyp,
                                 BLOCK)
    np.testing.assert_array_equal(f_j, f_t.numpy())
    np.testing.assert_array_equal(i_j, i_t.numpy())
    assert (f_t[3] >= 0).any()


@pytest.mark.parametrize("name", ["n40", "n70", "n80_masked", "aniso"])
def test_kernel_arithmetic_host_build_matches_plain(name, tmp_path, monkeypatch):
    """The prep and ``sweep_pnp.cuh``'s solve-and-score on the large
    sampler, compiled for the host, give the plain version's table, order
    and records bit for bit (the plain rsqrt taken as the host's 1/sqrt;
    on the card both are rsqrtf)."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(tsp, "_rsqrt", lambda x: 1.0 / tsp._sqrt(x))
    X, pixn, mask, thr_n, ay = pool(name)[:5]
    n = len(X)
    seeds = tsw.draw_seeds(5, tspl.N_SEEDS)
    n_hyp = tspl.n_hyp_for(1, n, BLOCK)
    thr_sq = tspl._thr_sq(thr_n)
    args = [torch.from_numpy(a) for a in (X, pixn, mask)]
    f_ref, i_ref, _, order = tspl._sweep_plain(*args, thr_sq, float(ay), seeds,
                                               n_hyp, BLOCK)
    table_ref = tspl._prepare(*args, float(ay), seeds)[0]
    table, order_h, msac, count = torch_host_build.sweep_pnp_large_full(
        lib, *args, thr_sq, float(ay), seeds, n_hyp, BLOCK)
    assert torch.equal(table, table_ref) and torch.equal(order_h, order)
    flat = tsw.record_flat_ids(0, n_hyp // 8, BLOCK // 8, "cpu")
    am, ac, ar, bm, bc, br = tsp._best_roots(list(msac[:, flat]), list(count[:, flat]))
    fa, pa = tsw.reduce_records(am, ac, flat * 4 + ar, tspl.BIG)
    fb, pb = tsw.reduce_records(bm, bc, flat * 4 + br, tspl.BIG)
    assert torch.equal(torch.stack([fa[0], fa[1], fb[2], fb[3]]), f_ref)
    assert torch.equal(torch.stack([pa[0], pb[1]]), i_ref)


def _winner_sets(msac, counts, packed, seeds, n_valid, order):
    """(sorted input rows, count) of the min-MSAC and max-count winners."""
    out = []
    for row, k in ((0, int(np.argmin(msac[0]))),
                   (1, int(np.lexsort((msac[1], -counts[1]))[0]))):
        flat = int(packed[row, k]) >> 2
        slots = tspl.sample_indices3_for(torch.tensor([flat]), seeds, n_valid,
                                         block_h=BLOCK)[0]
        out.append((sorted(np.asarray(order)[slots.numpy()].tolist()),
                    float(counts[row, k])))
    return out


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The interpreted Pallas kernel with an exact reciprocal; jit caches
    are cleared around it so the kernel is traced anew each way."""
    jax.clear_caches()
    monkeypatch.setattr(jsp.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", ["n70", "n80_masked"])
def test_winners_match_pallas_interpret(name, exact_reciprocal):
    """The jitted, interpreted JAX sweep (block_h 512, 4 blocks, exact
    reciprocal) and the port pick the same 3-point sets with the same
    counts under both rules."""
    X, pixn, mask, thr_n, ay = pool(name)[:5]
    out_j = jspl.pnp_ransac_sweep_large(
        4, jnp.asarray(X), jnp.asarray(pixn), jnp.asarray(mask), thr_n,
        n_hyp=1, interpret=True, block_h=BLOCK, ay=ay)
    out_t = tspl.pnp_ransac_sweep_large(
        4, torch.from_numpy(X), torch.from_numpy(pixn), torch.from_numpy(mask),
        thr_n, 1, block_h=BLOCK, ay=ay)
    seeds, n_valid, order = out_t[3]
    np.testing.assert_array_equal(order.numpy(), np.asarray(out_j[3][2]))
    w_j = _winner_sets(*(np.asarray(a) for a in out_j[:3]), seeds, n_valid,
                       np.asarray(out_j[3][2]))
    w_t = _winner_sets(*(a.numpy() for a in out_t[:3]), seeds, n_valid, order)
    assert w_t == w_j
    if name == "n80_masked":  # masked rows 0-5 never enter a sample
        assert min(w_t[0][0] + w_t[1][0]) >= 6


@pytest.mark.parametrize("name", ["n80_masked", "aniso"])
def test_ransac_pnp_sweep_routes_large_pools_and_finds_the_pose(name):
    """Pools over 16 points go to the large-pool sweep; on the CPU (plain
    version) the planted pose comes back within 0.01 rad and 0.05 m and
    >= 85% of the planted inliers are kept (tests/test_sweep.py:505-508)."""
    X, _, mask, _, _, K, pix, n_in, R_true, t_true = pool(name)
    n = len(X)
    res = tr.ransac_pnp_sweep(torch.from_numpy(X), torch.from_numpy(pix),
                              torch.from_numpy(K), torch.from_numpy(mask),
                              RansacConfig(threshold=10.0, num_hypotheses=5000), 5)
    assert res.num_hypotheses == tspl.n_hyp_for(8192, n, tspl.BLOCK_H) * 4
    m = res.inlier_mask.numpy()
    assert not m[mask == 0].any()
    assert m[:n_in][mask[:n_in] > 0].mean() >= 0.85
    Rm, t = tr.pnp_pose_from_result(res)
    R_err = float(torch.linalg.vector_norm(log_so3(
        Rm.double() @ torch.from_numpy(R_true).T)))
    assert R_err < 0.01, R_err
    np.testing.assert_allclose(t.numpy(), t_true, atol=0.05)


def test_plain_equals_wrapper_and_launches_stay_zero_on_cpu():
    X, pixn, mask, thr_n, ay = pool("n40")[:5]
    args = (1, torch.from_numpy(X), torch.from_numpy(pixn), torch.from_numpy(mask),
            thr_n, 1024)
    for a, b in zip(tspl.pnp_ransac_sweep_large(*args, block_h=BLOCK, ay=ay)[:3],
                    tspl.pnp_ransac_sweep_large_ref(*args, block_h=BLOCK, ay=ay)[:3]):
        assert torch.equal(a, b)
    assert _build.LAUNCHES["pnp_ransac_sweep_large"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tspl._sweep_kernel(*args[1:4], 1e-4, 1.0, tsw.draw_seeds(0, 5), BLOCK, BLOCK)
    assert _build.LAUNCHES["pnp_ransac_sweep_large"] == 0


def full_of(f, i, n_hyp):
    """Full records (msac, counts, keys [4 n_hyp]) of a full-mode output
    (f [8, n_hyp], flat ids i [n_hyp]), keyed as the reduced records (flat *
    4 + root)."""
    return f[:4].reshape(-1), f[4:].reshape(-1), tspl.full_keys(i, n_hyp)


def hold(full_k, red_k, plain, n_hyp):
    """hold_full and hold_reduced of a kernel's full and reduced records
    against the plain version's (``plain``: the ``_sweep_plain`` arguments
    but ``full``); the failures of both."""
    f_p, i_p = tspl._sweep_plain(*plain, full=True)[:2]
    held = tsp.hold_full(full_k, full_of(f_p, i_p, n_hyp),
                         lambda h: tspl.cut_margins(*plain, h))
    f_r, i_r = tspl._sweep_plain(*plain)[:2]
    held_r = tsp.hold_reduced(red_k, (f_r[0::2], f_r[1::2], i_r.long()), full_k,
                              held["flipped"])
    return held["failures"] + held_r["failures"], held


def test_plain_full_records_reduce_to_the_records():
    """The plain version's full records (every (sample, root), flat ids)
    reduce to its reduced records."""
    X, pixn, mask, thr_n, ay = pool("n70")[:5]
    args = [torch.from_numpy(a) for a in (X, pixn, mask)]
    seeds = tsw.draw_seeds(5, tspl.N_SEEDS)
    n_hyp = tspl.n_hyp_for(1, len(X), BLOCK)
    core = (*args, tspl._thr_sq(thr_n), float(ay), seeds, n_hyp, BLOCK)
    f, i = tspl._sweep_plain(*core, full=True)[:2]
    f_r, i_r = tspl._sweep_plain(*core)[:2]
    assert torch.equal(i, tsw.record_flat_ids(0, n_hyp // 8, BLOCK // 8, "cpu")
                       .reshape(-1).to(torch.int32))
    B = n_hyp // 8
    am, ac, ar, bm, bc, br = tsp._best_roots(list(f[:4].reshape(4, 8, B)),
                                             list(f[4:].reshape(4, 8, B)))
    flat = i.reshape(8, B).long()
    fa, pa = tsw.reduce_records(am, ac, flat * 4 + ar, tspl.BIG)
    fb, pb = tsw.reduce_records(bm, bc, flat * 4 + br, tspl.BIG)
    assert torch.equal(torch.stack([fa[0], fa[1], fb[2], fb[3]]), f_r)
    assert torch.equal(torch.stack([pa[0], pb[1]]), i_r)


@pytest.mark.parametrize("name", ["n40", "n70", "n80_masked", "aniso"])
def test_fused_host_build_holds_plain(name, tmp_path, monkeypatch):
    """The prep, solve and ``Fused`` score built for the host (FMA where the
    card issues one; the host's exact reciprocal) hold the plain version by
    ``hold_full`` / ``hold_reduced``: table and validity bit for bit, every
    count flip explained by points at the cut, MSAC within 1e-4 on >= 99%
    of the valid pairs and 1e-3 on all."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(tsp, "_rsqrt", lambda x: 1.0 / tsp._sqrt(x))
    X, pixn, mask, thr_n, ay = pool(name)[:5]
    args = [torch.from_numpy(a) for a in (X, pixn, mask)]
    seeds = tsw.draw_seeds(5, tspl.N_SEEDS)
    n_hyp = tspl.n_hyp_for(1, len(X), BLOCK)
    core = (*args, tspl._thr_sq(thr_n), float(ay), seeds, n_hyp, BLOCK)
    _, _, msac, count = torch_host_build.sweep_pnp_large_full(
        lib, *core[:6], n_hyp, BLOCK, fused=True)
    flat = tspl._sweep_plain(*core, full=True)[1].long()
    full_k = (msac[:, flat].reshape(-1), count[:, flat].reshape(-1),
              tspl.full_keys(flat, n_hyp))
    B = n_hyp // 8
    am, ac, ar, bm, bc, br = tsp._best_roots(list(msac[:, flat].reshape(4, 8, B)),
                                             list(count[:, flat].reshape(4, 8, B)))
    fa, pa = tsw.reduce_records(am, ac, flat.reshape(8, B) * 4 + ar, tspl.BIG)
    fb, pb = tsw.reduce_records(bm, bc, flat.reshape(8, B) * 4 + br, tspl.BIG)
    red_k = (torch.stack([fa[0], fb[2]]), torch.stack([fa[1], fb[3]]),
             torch.stack([pa[0], pb[1]]).long())
    fails, held = hold(full_k, red_k, core, n_hyp)
    assert not fails
    assert held["valid_pairs"] > n_hyp


def test_fused_host_build_holds_plain_near_the_camera_plane(tmp_path, monkeypatch):
    """``chip_smoke.py``'s 256-point pool (30 px) at 2^18 samples, where bad
    poses put points near the camera plane: there a camera coordinate is a
    small difference of O(1) terms, and with FMAs in the camera point one
    pair's MSAC moved by 1.4e-3.  The kernels' score keeps the plain order
    for the camera point, and every pair holds."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(tsp, "_rsqrt", lambda x: 1.0 / tsp._sqrt(x))
    X, pix, K, _, _, _ = planted_pnp_pool(256, seed=11)
    pixn = jproj.normalize_pixels(jnp.asarray(pix), jnp.asarray(K))
    args = [torch.from_numpy(np.asarray(a)) for a in (X, pixn, np.ones(256, np.float32))]
    n_hyp = 1 << 18
    core = (*args, tspl._thr_sq(30.0 / 900.0), 1.0, tsw.draw_seeds(0, tspl.N_SEEDS),
            n_hyp, tspl.BLOCK_H)
    f_p, i_p = tspl._sweep_plain(*core, full=True)[:2]
    flat = i_p.long()
    _, _, msac, count = torch_host_build.sweep_pnp_large_full(
        lib, *core[:6], n_hyp, tspl.BLOCK_H, fused=True)
    full_k = (msac[:, flat].reshape(-1), count[:, flat].reshape(-1),
              tspl.full_keys(flat, n_hyp))
    held = tsp.hold_full(full_k, full_of(f_p, i_p, n_hyp),
                         lambda h: tspl.cut_margins(*core, h))
    assert not held["failures"]
    assert held["max_rel_err"] < 1e-5


def test_valid_root_share_counts_valid_pairs():
    """``valid_root_share`` over every sample of a call is the share of its
    full records' valid pairs; its default slice of 2^14 samples spread
    over every window reads close to it."""
    X, pixn, mask, thr_n, ay = pool("aniso")[:5]
    args = [torch.from_numpy(a) for a in (X, pixn, mask)]
    n_hyp = tspl.n_hyp_for(1, len(X), BLOCK)
    f = tspl._sweep_plain(*args, tspl._thr_sq(thr_n), float(ay),
                          tsw.draw_seeds(4, tspl.N_SEEDS), n_hyp, BLOCK, full=True)[0]
    share = tspl.valid_root_share(4, *args, n_hyp, block_h=BLOCK, ay=ay,
                                  n_samples=n_hyp)
    assert share == float((f[4:] >= 0).double().mean())
    assert abs(tspl.valid_root_share(4, *args, 1 << 16, block_h=BLOCK, ay=ay)
               - share) < 0.05


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The kernel holds its plain version on the card by ``hold_full`` /
    ``hold_reduced`` (its full-records mode beside its records); the pool
    order and n_valid bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, pixn, mask, thr_n, ay = pool("n80_masked")[:5]
    args = [torch.from_numpy(a).cuda() for a in (X, pixn, mask)]
    core = (*args, tspl._thr_sq(thr_n), float(ay), tsw.draw_seeds(2, tspl.N_SEEDS),
            8192, BLOCK)
    before = _build.LAUNCHES["pnp_ransac_sweep_large"]
    f, i, n_valid, order = tspl._sweep_kernel(*core)
    f_full, flat = tspl._sweep_kernel(*core, full=True)[:2]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pnp_ransac_sweep_large"] == before + 2
    ref = tspl._sweep_plain(*core)
    assert int(n_valid) == int(ref[2]) and torch.equal(order, ref[3])
    fails, _ = hold(full_of(f_full, flat, 8192), (f[0::2], f[1::2], i.long()), core, 8192)
    assert not fails
