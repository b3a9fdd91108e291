"""Essential-matrix RANSAC and the epipolar ops of the port
(``ransac_tpu_torch.ops.sweep_essential_large``, ``ops.epipolar``,
``models.ransac.ransac_essential*``) against the JAX package.

``test_kernel_body_op_by_op_matches_plain`` is the exact check of row 8:
the JAX kernel body run one operation at a time (``pallas_op_by_op``),
exact reciprocal and rsqrt as 1/sqrt on both sides, gives the plain
version's records bit for bit on the port's table; ``minimal_f_canonical``
(an eager jnp function) equals the port's bit for bit under the same swap.
The kernel's own arithmetic, built for the host, agrees with the plain
version bit for bit.  Against the jitted, interpreted JAX functions the
port is held to the same decisions (winners' 8-point sets and counts,
inlier masks); ``ransac_essential_sweep`` in
``tests/test_torch_sweep_large_api.py``, the epipolar ops and the
stage-wise engine in ``tests/test_torch_epipolar.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops.pallas import sweep_essential_large as jsel
from ransac_tpu.utils.config import RansacConfig as JRansacConfig
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep as tsw
from ransac_tpu_torch.ops import sweep_essential_large as tsel
from ransac_tpu_torch.ops import sweep_large as tsl
from ransac_tpu_torch.ops.rotation import exp_so3
import pallas_op_by_op  # tests/ is on sys.path under pytest
import torch_host_build
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 512
THR = (2.0 / 600.0) ** 2   # 2 px at f = 600, squared normalized Sampson units


def planted_twoview(seed=5, n=100, n_out=30, noise=0.5 / 600.0):
    """``tests/test_sweep.py``'s planted two-view correspondences with
    noise: (x1, x2, n_in, R, t unit)."""
    rng = np.random.default_rng(seed)
    Xw = rng.uniform(-1, 1, size=(n, 3)) * np.array([2, 2, 1]) + [0, 0, 5]
    R = exp_so3(torch.tensor(rng.normal(size=3) * 0.1)).numpy()
    t = np.array([1.0, 0.05, 0.1])
    t /= np.linalg.norm(t)
    x1 = Xw[:, :2] / Xw[:, 2:]
    Xc2 = Xw @ R.T + t
    x2 = Xc2[:, :2] / Xc2[:, 2:]
    x1 = (x1 + rng.normal(scale=noise, size=x1.shape)).astype(np.float32)
    x2 = (x2 + rng.normal(scale=noise, size=x2.shape)).astype(np.float32)
    x2[n - n_out:] += (rng.uniform(0.1, 0.3, size=(n_out, 2))
                       * rng.choice([-1, 1], (n_out, 2))).astype(np.float32)
    return x1, x2, n - n_out, R, t


def case(name):
    n, seed = {"n40": (40, 1), "n70": (70, 2), "n90_masked": (90, 3)}[name]
    x1, x2, n_in, _, _ = planted_twoview(seed, n=n, n_out=n // 4)
    mask = np.ones(n, np.float32)
    if name == "n90_masked":
        mask[:5] = 0.0
        x1[:5] = 50.0  # sampling a masked row would blow up
    return x1, x2, mask, n_in


@pytest.fixture
def rsqrt_as_division(monkeypatch):
    monkeypatch.setattr(jsel.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(tsel, "_rsqrt", lambda x: 1.0 / tsw.sqrt_rn(x))


@pytest.mark.parametrize("name", ["n40", "n70", "n90_masked"])
def test_kernel_body_op_by_op_matches_plain(name, monkeypatch, rsqrt_as_division):
    """Row 8's JAX kernel body op by op on the port's table: the plain
    version's records bit for bit (unscaled)."""
    x1, x2, mask, _ = case(name)
    n = len(x1)
    seeds = tsw.draw_seeds(8, tsel.N_SEEDS)
    table, thr, _, n_valid, _, _ = tsel._prepare(
        torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask), THR, seeds)
    n_hyp = tsl.n_hyp_for(1, n, BLOCK)
    n_blocks = n_hyp // BLOCK
    wb = tsl.window_bases(seeds[8], torch.arange(n_blocks), n_valid)
    f_j, i_j = pallas_op_by_op.run_kernel(
        monkeypatch, jsel._make_kernel(n, BLOCK, table.shape[0]), n_blocks,
        [table.numpy(), thr.reshape(1).numpy(), np.array(seeds, np.uint32),
         np.array([int(n_valid)], np.int32), wb.numpy().astype(np.int32)],
        [((4, BLOCK // 8), np.float32), ((2, BLOCK // 8), np.int32)])
    f_t, i_t = tsel._score_plain(table, thr, seeds, n_valid, n_hyp, BLOCK)
    np.testing.assert_array_equal(f_j, f_t.numpy())
    np.testing.assert_array_equal(i_j, i_t.numpy())
    assert (f_t[3] >= 0).any()


def test_minimal_f_canonical_matches_jax_bit_for_bit(rsqrt_as_division):
    """The eager JAX replica of the kernel's solve and the port's, on 64
    random normalized 8-point samples: validity equal, and F bit for bit
    wherever it is valid.  (An invalid F has |F|^2 <= 1e-30, a sum of
    squares in float32's subnormal range, which the JAX replica takes with
    ``jnp.sum`` on XLA, flushing subnormals, and the kernel and the port
    take one by one.)"""
    rng = np.random.default_rng(0)
    x1s = rng.normal(size=(64, 8, 2)).astype(np.float32)
    x2s = (x1s + rng.normal(scale=0.05, size=x1s.shape)).astype(np.float32)
    x1s[3, 1] = x1s[3, 0]  # a degenerate frame
    F_t, ok_t = tsel.minimal_f_canonical(torch.from_numpy(x1s), torch.from_numpy(x2s))
    for k in range(64):
        F_j, ok_j = jsel.minimal_f_canonical(jnp.asarray(x1s[k]), jnp.asarray(x2s[k]))
        assert bool(ok_t[k]) == bool(ok_j)
        if bool(ok_j):
            np.testing.assert_array_equal(F_t[k].numpy(), np.asarray(F_j))
    assert not bool(ok_t[3]) and bool(ok_t.sum() >= 60)


@pytest.mark.parametrize("name", ["n40", "n70", "n90_masked"])
def test_kernel_arithmetic_host_build_matches_plain(name, tmp_path, monkeypatch):
    """The prep and ``csrc/sweep_essential_large.cuh``, compiled for the
    host, give the plain version's table, order, normalization and records
    bit for bit (the plain rsqrt taken as the host's 1/sqrt)."""
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(tsel, "_rsqrt", lambda x: 1.0 / tsw.sqrt_rn(x))
    x1, x2, mask, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                       for a in case(name))
    seeds = tsw.draw_seeds(3, tsel.N_SEEDS)
    n_hyp = tsl.n_hyp_for(1, len(x1), BLOCK)
    table_ref, thr, inv_s2, n_valid, order, (m1, m2, s) = tsel._prepare(
        x1, x2, mask, THR, seeds)
    f_ref, i_ref = tsel._score_plain(table_ref, thr, seeds, n_valid, n_hyp, BLOCK)
    table, order_h, norm, msac, count = torch_host_build.sweep_essential_large_full(
        lib, x1, x2, mask, THR, seeds, n_hyp, BLOCK)
    assert torch.equal(table, table_ref) and torch.equal(order_h, order)
    assert torch.equal(norm, torch.stack([m1[0], m1[1], m2[0], m2[1], s, thr]))
    flat = tsw.record_flat_ids(0, n_hyp // 8, BLOCK // 8, "cpu")
    f, i = tsw.reduce_records(msac[flat], count[flat], flat)
    assert torch.equal(f, f_ref) and torch.equal(i, i_ref)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jsel.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", ["n70", "n90_masked"])
def test_winners_match_pallas_interpret(name, exact_reciprocal):
    """The jitted, interpreted JAX sweep (block_h 512, 4 blocks) and the
    port: the same pool order, and the same 8-point sets and counts of the
    winners under both rules."""
    x1, x2, mask, n_in = case(name)
    out_j = jsel.essential_ransac_sweep_large(
        6, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), THR, n_hyp=1,
        interpret=True, block_h=BLOCK)
    out_t = tsel.essential_ransac_sweep_large(
        6, torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask),
        THR, 1, block_h=BLOCK)
    seeds, n_valid, order, _ = out_t[3]
    np.testing.assert_array_equal(order.numpy(), np.asarray(out_j[3][2]))

    def winners(msac, counts, flat):
        out = []
        for row, k in ((0, int(np.argmin(msac[0]))),
                       (1, int(np.lexsort((msac[1], -counts[1]))[0]))):
            slots = tsel.sample_indices_for8(torch.tensor([int(flat[row, k])]),
                                             seeds, n_valid, block_h=BLOCK)[0]
            out.append((sorted(order[slots].tolist()), float(counts[row, k])))
        return out

    w_t = winners(*(a.numpy() for a in out_t[:3]))
    assert w_t == winners(*(np.asarray(a) for a in out_j[:3]))
    assert w_t[1][1] >= 0.85 * (n_in - (5 if name == "n90_masked" else 0))


def _jcfg(cfg):
    return JRansacConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_plain_equals_wrapper_and_launches_stay_zero_on_cpu():
    x1, x2, mask, _ = case("n40")
    args = (1, torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask),
            THR, 1024)
    for a, b in zip(tsel.essential_ransac_sweep_large(*args, block_h=BLOCK)[:3],
                    tsel.essential_ransac_sweep_large_ref(*args, block_h=BLOCK)[:3]):
        assert torch.equal(a, b)
    assert _build.LAUNCHES["essential_ransac_sweep_large"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tsel._sweep_kernel(*args[1:5], tsw.draw_seeds(0, 10), BLOCK, BLOCK)
    assert _build.LAUNCHES["essential_ransac_sweep_large"] == 0


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The kernel against its plain version on the card: one launch, the
    pool order, n_valid and normalization bit for bit, and the records by
    ``ops.sweep.hold_full`` / ``hold_reduced`` with ``cut_margins`` (the
    kernel's Sampson score is fused)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x1, x2, mask, _ = case("n90_masked")
    args = [torch.from_numpy(a).cuda() for a in (x1, x2, mask)]
    before = _build.LAUNCHES["essential_ransac_sweep_large"]
    out = tsel.essential_ransac_sweep_large(2, *args, THR, 8192, block_h=BLOCK)
    ref = tsel.essential_ransac_sweep_large_ref(2, *args, THR, 8192, block_h=BLOCK)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["essential_ransac_sweep_large"] == before + 1
    (_, nv_k, order_k, norm_k), (_, nv_p, order_p, norm_p) = out[3], ref[3]
    assert int(nv_k) == int(nv_p) and torch.equal(order_k, order_p)
    for a, b in zip(norm_k, norm_p):
        assert torch.equal(a, b.reshape(a.shape))
    core = (*args, THR, tsw.draw_seeds(2, tsel.N_SEEDS), tsl.n_hyp_for(8192, 90, BLOCK),
            BLOCK)
    f_k, i_k = tsel._sweep_kernel(*core, full=True)[:2]
    f_p, i_p = tsel._sweep_plain(*core, full=True)[:2]
    full_k = (f_k[0], f_k[1], i_k)
    held = tsw.hold_full(full_k, (f_p[0], f_p[1], i_p), lambda h: tsel.cut_margins(*core, h))
    held_r = tsw.hold_reduced(out[:3], ref[:3], full_k, held.pop("flipped"))
    assert not held["failures"] and not held_r["failures"], (held, held_r)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = torch_host_build.load(tmp_path_factory.mktemp("host_build"))
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


@pytest.mark.parametrize("n", [1, 7, 31, 32, 33, 100, 480, 512, 1000, 1024])
def test_prep_column_tree_sum_matches_plain(n, host_lib):
    """``large::tree_sum_cols``, the column order in which the prep kernels
    take the pairwise tree sum (``large::tree_sums``: by warp, then across
    the 32 column sums), equals the plain version's ``tree_sum`` bit for
    bit on values of mixed sign and scale."""
    lib = host_lib
    rng = np.random.default_rng(n)
    for scale in (1e-3, 1.0, 1e3):
        x = torch.from_numpy((rng.normal(size=n) * scale).astype(np.float32))
        assert torch.equal(torch_host_build.tree_sum_cols(lib, x), tsl.tree_sum(x))


def _pool(name):
    """The check cases, and a two-view pool of the main path's kind: 1000
    match slots, 479 of them valid (the rest masked and poisoned)."""
    if name != "n1000_nvalid479":
        return tuple(torch.from_numpy(a) for a in case(name)[:3])
    x1, x2, _, _, _ = planted_twoview(9, n=1000, n_out=250)
    mask = np.zeros(1000, np.float32)
    mask[np.random.default_rng(9).choice(1000, 479, replace=False)] = 1.0
    x1[mask == 0] = 50.0
    return torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask)


def assoc_rtol(n: int) -> float:
    """The relative MSAC tolerance of the kernel's layout under ``Exact``
    against the plain version on a pool of ``n`` points, whose table has
    n_rows = n rounded up to 16 rows: both sum the same n_rows non-negative
    terms in two associations (32 lanes and a tree; 4 pairs), each within
    (n_rows - 1) 2^-24 of the exact sum, so within twice that of each other;
    the rescale by 1 / s^2 rounds each once more."""
    n_rows = -(-n // 16) * 16
    return (2 * (n_rows - 1) + 2) * 2.0 ** -24


def _rel(a, b):
    """|a / b - 1| in float64, 0 where a == b."""
    a, b = a.double(), b.double()
    return torch.where(a == b, 0.0, (a - b).abs() / b.abs())


def hold_assoc(full_k, full_p, red_k, red_p, rtol):
    """The kernel's layout under ``Exact`` against the plain version: flat
    ids, validity and counts of the full records (msac, counts, flat ids)
    equal and MSAC within ``rtol``; the reduced records' count row equal,
    MSAC within ``rtol``, and where a record keeps another flat id, the plain
    one a near-tie in the full records (its count, MSAC within ``rtol`` of
    the record's).  Returns the failures."""
    (m_k, c_k, p_k), (m_p, c_p, p_p) = full_k, full_p
    fails = []
    if not (torch.equal(p_k, p_p) and torch.equal(m_k >= 3e38, m_p >= 3e38)
            and torch.equal(c_k, c_p)):
        fails.append("samples, validity or counts differ")
    if float(_rel(m_k, m_p).max()) > rtol:
        fails.append("full records' MSAC")
    (mr_k, cr_k, pr_k), (mr_p, cr_p, pr_p) = red_k, red_p
    B = mr_k.shape[1]
    mf, cf, pf = (t.reshape(8, B) for t in full_k)
    if not torch.equal(cr_k[1], cr_p[1]) or float(_rel(mr_k, mr_p).max()) > rtol:
        fails.append("reduced records' count row or MSAC")
    for row, r in torch.nonzero(pr_k != pr_p).tolist():
        s = torch.nonzero(pf[:, r] == pr_p[row, r]).flatten()
        if not (len(s) and float(cf[s[0], r]) == float(cr_p[row, r])
                and float(_rel(mf[s[0], r], mr_k[row, r])) <= rtol):
            fails.append(f"row {row} record {r}: another sample, not a near-tie")
    return fails


def _host_full(lib, x1, x2, mask, seeds, n_hyp, fused):
    """The host build's full records (msac rescaled, counts, flat ids) in s
    * B + r order, its reduced records, and the table, order and norm."""
    table, order, norm, msac, count = torch_host_build.sweep_essential_large_full(
        lib, x1, x2, mask, THR, seeds, n_hyp, BLOCK, grouped=True, fused=fused)
    flat = tsw.record_flat_ids(0, n_hyp // 8, BLOCK // 8, "cpu").reshape(-1)
    s = norm[4]
    full = (tsl.rescale(msac[flat], 1.0 / (s * s)), count[flat], flat.to(torch.int32))
    B = n_hyp // 8
    red = tsw.reduce_records(*(t.reshape(8, B) for t in full[:2]), flat.reshape(8, B))
    return full, (red[0][0::2], red[0][1::2], red[1]), (table, order, norm)


@pytest.mark.parametrize("name", ["n40", "n70", "n90_masked", "n1000_nvalid479"])
def test_grouped_score_host_build_holds_plain(name, host_lib, monkeypatch):
    """The kernel's layout, built for the host under ``Exact``: one solve a
    hypothesis, then 32 lanes a hypothesis, lane l summing rows l, l + 32,
    ..., added by the shuffle tree.  Against the plain version (4
    accumulator pairs): the table, pool order and normalization bit for
    bit, samples, validity and counts equal, MSAC within ``assoc_rtol`` (the
    association alone differs), on the full records and on the records
    they reduce to."""
    monkeypatch.setattr(tsel, "_rsqrt", lambda x: 1.0 / tsw.sqrt_rn(x))
    x1, x2, mask = _pool(name)
    seeds = tsw.draw_seeds(3, tsel.N_SEEDS)
    n_hyp = tsl.n_hyp_for(1, len(x1), BLOCK)
    args = (x1, x2, mask, THR, seeds, n_hyp, BLOCK)
    f_p, i_p, _, order_p, (m1, m2, s) = tsel._sweep_plain(*args, full=True)
    full_k, red_k, (table, order, norm) = _host_full(host_lib, x1, x2, mask, seeds,
                                                     n_hyp, False)
    table_p, thr = tsel._prepare(x1, x2, mask, THR, seeds)[:2]
    assert torch.equal(table, table_p) and torch.equal(order, order_p)
    assert torch.equal(norm, torch.stack([m1[0], m1[1], m2[0], m2[1], s, thr]))
    f_r, i_r = tsel._sweep_plain(*args)[:2]
    fails = hold_assoc(full_k, (f_p[0], f_p[1], i_p), red_k, (f_r[0::2], f_r[1::2], i_r),
                       assoc_rtol(len(x1)))
    assert not fails, fails
    assert (full_k[1] >= 0).any()


@pytest.mark.parametrize("name", ["n40", "n70", "n90_masked", "n1000_nvalid479"])
def test_fused_score_host_build_holds_plain(name, host_lib, monkeypatch):
    """The kernel's arithmetic, built for the host: 32 lanes a hypothesis
    and the ``Fused`` Sampson score (the host's exact reciprocal for
    MUFU's).  Against the plain version by ``ops.sweep.hold_full`` /
    ``hold_reduced`` with ``cut_margins``: samples and validity equal, a
    count moved only by points at the Sampson cut, MSAC within 1e-4 on >=
    99% and 1e-3 on all; records keep the plain sample or a near-tie."""
    monkeypatch.setattr(tsel, "_rsqrt", lambda x: 1.0 / tsw.sqrt_rn(x))
    x1, x2, mask = _pool(name)
    seeds = tsw.draw_seeds(3, tsel.N_SEEDS)
    n_hyp = tsl.n_hyp_for(1, len(x1), BLOCK)
    args = (x1, x2, mask, THR, seeds, n_hyp, BLOCK)
    f_p, i_p = tsel._sweep_plain(*args, full=True)[:2]
    full_k, red_k, _ = _host_full(host_lib, x1, x2, mask, seeds, n_hyp, True)
    held = tsw.hold_full(full_k, (f_p[0], f_p[1], i_p),
                         lambda h: tsel.cut_margins(*args, h))
    flipped = held.pop("flipped")
    f_r, i_r = tsel._sweep_plain(*args)[:2]
    held_r = tsw.hold_reduced(red_k, (f_r[0::2], f_r[1::2], i_r), full_k, flipped)
    assert not held["failures"] and not held_r["failures"], (held, held_r)
    assert held["validity_flips"] == 0 and held["max_rel_err"] < 1e-4


def test_plain_full_records_reduce_to_records():
    """``_sweep_plain(..., full=True)`` is every hypothesis' record in the
    kernel's s * B + r order: reduced by record, the plain records."""
    x1, x2, mask = _pool("n90_masked")
    seeds = tsw.draw_seeds(2, tsel.N_SEEDS)
    args = (x1, x2, mask, THR, seeds, 4 * BLOCK, BLOCK)
    f, i = tsel._sweep_plain(*args, full=True)[:2]
    B = 4 * BLOCK // 8
    red = tsw.reduce_records(f[0].reshape(8, B), f[1].reshape(8, B),
                             i.long().reshape(8, B))
    f_r, i_r = tsel._sweep_plain(*args)[:2]
    assert torch.equal(red[0], f_r) and torch.equal(red[1], i_r)
    assert torch.equal(i, tsw.record_flat_ids(0, B, BLOCK // 8, "cpu")
                       .reshape(-1).to(torch.int32))
