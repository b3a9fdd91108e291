"""The fused homography sweep port (``ransac_tpu_torch.ops.sweep``) and
``ransac_homography_sweep`` against the Pallas kernel
``ransac_tpu.ops.pallas.sweep.homography_ransac_sweep``, on the scenes of
``tests/test_sweep.py``.

On the CPU the wrapper computes the kernel's plain version.  The sampling
is the JAX kernel's counter PRNG bit for bit, so both sides score the same
hypotheses and records compare element for element.  The Pallas kernel
scores MSAC with ``pl.reciprocal(approx=True)``, which interpret mode
lowers to a bfloat16 reciprocal (relative error up to 2^-8); the port
divides exactly, so the comparisons swap the exact reciprocal into the JAX
kernel (the JAX package is unchanged).

``test_kernel_body_op_by_op_matches_plain`` is the exact check: the JAX
kernel body run one operation at a time (``pallas_op_by_op``) on the
port's normalized points gives the plain version's records bit for bit,
full and reduced.  The other comparisons run the whole JAX function as
users call it: jitted, with the kernel interpreted.  There XLA's CPU
backend contracts a * b + c into fused multiply-adds, in the kernel and in
the wrapper's normalization (whose points then differ from the unfused
ones in the last place), and the frame determinants of near-degenerate
samples amplify that (measured: 0.2-0.5% of hypotheses beyond rtol 1e-4,
at most 7.2e-4).  So those hold packed samples and counts exactly and
MSAC within rtol 1e-4 on at least 99% of hypotheses and 1e-3 on all.
Reduced records inherit this: a record whose eight hypotheses hold a
near-tie (often the same 4-subset drawn twice in another order) can keep
another sample, so reduced records compare their counts exactly and their
other samples as near-ties.  One test holds the port against the
unmodified kernel within the bfloat16 reciprocal's 2^-8.  The kernel's own
arithmetic (``csrc/sweep.cuh``, its normalizing prologue included), built
for the host, is held against the plain version: bit for bit under the
``Exact`` policy (every operation rounded on its own), by the decision-level
criteria of ``ops.sweep.hold_full`` / ``hold_reduced`` under the kernel's
``Fused`` policy (FMAs), which also meets the jitted JAX function's
criteria; the magic-number remainder and the draws it feeds are held to
``%`` and the plain draws.  The CUDA kernel itself is held against the
plain version on the card (``chip_smoke.py`` and the ``cuda``-marked
test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops import homography as jh
from ransac_tpu.ops.pallas import sweep as jsw
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep as tsw
from ransac_tpu_torch.ops import sweep_large as tsl
from ransac_tpu_torch.utils.config import RansacConfig
import pallas_op_by_op  # tests/ is on sys.path under pytest
import torch_host_build
from torch_threads import one_torch_thread  # noqa: F401

THR = 75.0
N_HYP = 2 * tsw.BLOCK_H


def planted(seed=0, n=13, n_out=3, noise=1.0):
    """``tests/test_sweep.py``'s planted homography problem."""
    rng = np.random.default_rng(seed)
    H_true = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0],
                       [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, size=(n, 2)).astype(np.float32)
    dst = np.array(jh.apply_h(jnp.asarray(H_true), jnp.asarray(src)))
    dst = (dst + rng.normal(scale=noise, size=dst.shape)).astype(np.float32)
    dst[n - n_out:] += 300.0
    return src, dst, np.ones(n, np.float32)


def case(name):
    """(src, dst, mask, n_points) of each checked case."""
    if name == "n16":
        return (*planted(1, n=16), None)
    if name == "n_points_12_of_16":
        return (*planted(2, n=16), 12)
    src, dst, mask = planted(0)
    if name == "masked_duplicate":
        # Masked points never enter a valid sample, and src point 1
        # duplicates point 0: every sample holding both has a zero frame
        # determinant (exactly zero on both sides, where a merely collinear
        # triple would sit at the 1e-7 cut and flip with the rounding).
        # Both score the 3.4e38 sentinel with count -1.
        mask[[5, 9]] = 0.0
        src[1] = src[0]
    return src, dst, mask, None


def assert_msac_close(m_t, m_j):
    """Invalid sentinels equal; MSAC within rtol 1e-4 on >= 99% of entries
    and rtol 1e-3 on all (XLA's FMA contraction, module doc)."""
    invalid = m_j >= 3e38
    np.testing.assert_array_equal(m_t >= 3e38, invalid)
    rel = np.abs(m_t[~invalid] / m_j[~invalid] - 1.0)
    assert (rel <= 1e-4).mean() >= 0.99, (rel <= 1e-4).mean()
    assert rel.max() <= 1e-3, rel.max()


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The interpreted Pallas kernel with an exact reciprocal; jit caches
    are cleared around it so the kernel is traced anew each way."""
    jax.clear_caches()
    monkeypatch.setattr(jsw.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


def jax_sweep(src, dst, mask, n_points, full, seed=7):
    out = jsw.homography_ransac_sweep(
        seed, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), THR,
        n_hyp=N_HYP, n_points=n_points, interpret=True, full_records=full)
    return [np.asarray(a) for a in out]


def port_sweep(src, dst, mask, n_points, full, seed=7):
    out = tsw.homography_ransac_sweep(
        seed, torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(mask), THR, N_HYP, n_points=n_points,
        full_records=full)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("name", ["masked_duplicate"])
def test_sweep_full_records_match_pallas_interpret(name, exact_reciprocal):
    src, dst, mask, n_points = case(name)
    m_j, c_j, p_j = jax_sweep(src, dst, mask, n_points, True)
    m_t, c_t, p_t = port_sweep(src, dst, mask, n_points, True)
    assert m_t.shape == m_j.shape == (N_HYP,)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(c_t, c_j)
    assert_msac_close(m_t, m_j)
    if name == "masked_duplicate":
        invalid = m_t >= 3e38
        decoded = np.stack([(p_t >> s) & 15 for s in (0, 4, 8, 12)])
        bad = np.isin(decoded, [5, 9]).any(0) | (np.isin(decoded, [0]).any(0)
                                                 & np.isin(decoded, [1]).any(0))
        np.testing.assert_array_equal(invalid, bad)
        assert (c_t[invalid] == -1).all()


@pytest.mark.parametrize("name", ["n13", "n16", "masked_duplicate",
                                  "n_points_12_of_16"])
def test_sweep_reduced_records_match_pallas_interpret(name, exact_reciprocal):
    """Reduced records: the max count per record exactly, both rows' MSAC
    within the full-record tolerance, and where the two sides keep another
    sample of a record, the JAX sample is a near-tie of the port's (its
    MSAC in the port's own full records within rtol 1e-3, same count)."""
    src, dst, mask, n_points = case(name)
    m_j, c_j, p_j = jax_sweep(src, dst, mask, n_points, False)
    m_t, c_t, p_t = port_sweep(src, dst, mask, n_points, False)
    mf, cf, pf = port_sweep(src, dst, mask, n_points, True)
    B = N_HYP // 8
    assert m_t.shape == m_j.shape == (2, B)
    np.testing.assert_array_equal(c_t[1], c_j[1])
    for row in (0, 1):
        assert_msac_close(m_t[row], m_j[row])
    mf, cf, pf = mf.reshape(8, B), cf.reshape(8, B), pf.reshape(8, B)
    # The port's reduced records are the sublane reduction of its full ones.
    f, i = tsw.reduce_records(torch.from_numpy(mf), torch.from_numpy(cf),
                              torch.from_numpy(pf).long())
    np.testing.assert_array_equal(f.numpy()[0::2], m_t)
    np.testing.assert_array_equal(f.numpy()[1::2], c_t)
    np.testing.assert_array_equal(i.numpy(), p_t)
    for row in (0, 1):
        for r in np.nonzero(p_t[row] != p_j[row])[0]:
            s = np.nonzero(pf[:, r] == p_j[row][r])[0]
            assert len(s) and np.isclose(mf[s[0], r], m_t[row][r], rtol=1e-3)
            assert cf[s[0], r] == c_j[row][r]
    if n_points is not None:
        decoded = np.stack([(p_t >> s) & 15 for s in (0, 4, 8, 12)])
        assert decoded.max() < n_points


def test_sweep_plain_vs_pallas_bf16_reciprocal():
    """Against the unmodified interpreted kernel: the same max count per
    record (the inlier test has no reciprocal) and min MSAC per record
    within the bfloat16 reciprocal's 2^-8 relative error."""
    src, dst, mask, _ = case("n13")
    m_j, c_j, _ = jax_sweep(src, dst, mask, None, False)
    m_t, c_t, _ = port_sweep(src, dst, mask, None, False)
    np.testing.assert_array_equal(c_t[1], c_j[1])
    np.testing.assert_allclose(m_t[0], m_j[0], rtol=2.0 ** -8)


def test_ransac_homography_sweep_count_rule_matches_engine():
    """Selection by count: the sweep's winner has the consensus of the
    exhaustive engine (same inlier mask), and its record counts are the
    counts of the decoded samples."""
    src, dst, mask = planted(1)
    args = (torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask))
    cfg = RansacConfig(threshold=THR, num_hypotheses=N_HYP, selection="count")
    res = tr.ransac_homography_sweep(*args, cfg, 4)
    eng = tr.ransac_homography(*args, RansacConfig(threshold=THR, selection="count"))
    assert torch.equal(res.inlier_mask, eng.inlier_mask)
    assert int(res.num_inliers) == int(res.counts.max()) == 10


def test_sweep_ref_equals_wrapper_and_launches_stay_zero_on_cpu():
    src, dst, mask, _ = case("masked_duplicate")
    args = (5, torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(mask), THR, N_HYP)
    for a, b in zip(tsw.homography_ransac_sweep(*args),
                    tsw.homography_ransac_sweep_ref(*args)):
        assert torch.equal(a, b)
    assert _build.LAUNCHES["homography_ransac_sweep"] == 0
    assert list(tsw.unpack_sample(1 + 2 * 16 + 3 * 256 + 15 * 4096)) == [1, 2, 3, 15]


def test_kernel_entry_raises_for_cpu_tensors():
    src, dst, mask, _ = case("n13")
    with pytest.raises(ValueError, match="CUDA"):
        tsw._sweep_kernel(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(mask), THR, tsw.draw_seeds(1, 4), 13,
                          N_HYP, False)
    assert _build.LAUNCHES["homography_ransac_sweep"] == 0


def test_pools_over_16_points_raise(monkeypatch):
    """Pools over 16 points no longer raise: they are routed to the
    large-pool sweep (kernel row 6, ``ops.sweep_large``); the packed
    16-point kernel still refuses them."""
    src, dst, mask = planted(3, n=20)
    with pytest.raises(ValueError, match="at most 16 points"):
        tsw.homography_ransac_sweep(0, torch.from_numpy(src), torch.from_numpy(dst),
                                    torch.from_numpy(mask), THR, N_HYP)
    calls = []
    large = tsl.homography_ransac_sweep_large
    monkeypatch.setattr(tsl, "homography_ransac_sweep_large",
                        lambda *a, **k: calls.append(a[1].shape) or large(*a, **k))
    res = tr.ransac_homography_sweep(torch.from_numpy(src), torch.from_numpy(dst),
                                     torch.from_numpy(mask), RansacConfig(), 0)
    assert calls == [(20, 2)]
    assert res.num_hypotheses == tsl.BLOCK_H * 2
    assert int(res.num_inliers) == 17


def test_prng_matches_jax_bits():
    seeds = tsw.draw_seeds(123456789, 4)
    np.testing.assert_array_equal(
        np.array(seeds, np.uint32),
        np.asarray(jsw._fmix(jnp.uint32(123456789) + jnp.arange(1, 5, dtype=jnp.uint32)
                             * jnp.uint32(0x9E3779B9))))
    x = np.random.default_rng(0).integers(0, 2 ** 32, 1000, dtype=np.uint64)
    np.testing.assert_array_equal(
        tsw.fmix(torch.from_numpy(x.astype(np.int64))).numpy().astype(np.uint32),
        np.asarray(jsw._fmix(jnp.asarray(x.astype(np.uint32)))))


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ["n13", "n16", "masked_duplicate",
                                  "n_points_12_of_16"])
def test_kernel_body_op_by_op_matches_plain(name, full, monkeypatch):
    """The JAX kernel body, every operation rounded on its own and the
    reciprocal exact, on the port's normalized points: the plain version's
    records bit for bit."""
    monkeypatch.setattr(jsw.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    src, dst, mask, n_points = case(name)
    n = len(src)
    n_points = n if n_points is None else n_points
    src_p, dst_p, mask_p, thr, _ = tsw._normalize(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        THR, n_points)
    seeds = tsw.draw_seeds(7, 4)
    vmask = tsw.sample_bitmask(mask_p)
    lan = tsw.LAN
    shapes = ([((2, 8, lan), np.float32), ((1, 8, lan), np.int32)] if full
              else [((4, lan), np.float32), ((2, lan), np.int32)])
    f_j, i_j = pallas_op_by_op.run_kernel(
        monkeypatch, jsw._make_kernel(n_points, n, not full), N_HYP // tsw.BLOCK_H,
        [a.numpy() for a in (src_p, dst_p, mask_p, thr)]
        + [np.array(seeds, np.uint32), vmask.numpy()], shapes)
    f_t, i_t = tsw._score_plain(src_p, dst_p, mask_p, thr, seeds, n_points, n,
                                N_HYP, full)
    if full:
        f_t, i_t = f_t.reshape(2, 8, -1), i_t.reshape(1, 8, -1)
    np.testing.assert_array_equal(f_j, f_t.numpy())
    np.testing.assert_array_equal(i_j, i_t.numpy())


def host_lib(tmp_path):
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


def hold(full_k, full_p, red_k, red_p, margins):
    """``ops.sweep.hold_full`` and ``hold_reduced``; their readings."""
    held = tsw.hold_full(full_k, full_p, margins)
    held_r = tsw.hold_reduced(red_k, red_p, full_k, held.pop("flipped"))
    assert not held["failures"] and not held_r["failures"], (held, held_r)
    return held, held_r


def reduce_full(f, i):
    """Reduced records (msac, counts, packed) [2, B] of full records."""
    B = f.shape[1] // 8
    red, packed = tsw.reduce_records(*(t.reshape(8, B) for t in f), i.reshape(8, B).long())
    return red[0::2], red[1::2], packed


@pytest.mark.parametrize("name", ["n13", "masked_duplicate", "n_points_12_of_16"])
def test_kernel_arithmetic_host_build_matches_plain(name, tmp_path):
    """``csrc/sweep.cuh`` under the kernel's ``Fused`` policy, compiled for
    the host (FMAs where the source writes them; the host divides where the
    card takes MUFU's reciprocal), from the raw points through the
    normalizing prologue to the rescaled records, holds the plain version's
    decisions (``ops.sweep.hold_full`` / ``hold_reduced``): the same samples
    and validity, the same counts but where a point sits at the inlier cut
    (one hypothesis of the 12-of-16 case, (r2 - t) / t = 4.3e-5), MSAC within
    rtol 1e-4 on >= 99% and 1e-3 on all."""
    lib = host_lib(tmp_path)
    src, dst, mask, n_points = case(name)
    n_points = len(src) if n_points is None else n_points
    args = [torch.from_numpy(a) for a in (src, dst, mask)]
    seeds = tsw.draw_seeds(11, 4)
    plain = (*args, THR, seeds, n_points, N_HYP)
    f, i = torch_host_build.sweep_full(lib, *args, THR, seeds, n_points, N_HYP)
    held, _ = hold((f[0], f[1], i), tsw._sweep_plain(*plain, True), reduce_full(f, i),
                   tsw._sweep_plain(*plain, False), lambda h: tsw.cut_margins(*plain, h))
    assert held["validity_flips"] == 0
    assert held["count_flips"] == (1 if name == "n_points_12_of_16" else 0)


@pytest.mark.parametrize("change", ["twice_the_cut_points", "off_the_cut"])
def test_hold_full_explains_count_flips_by_points_at_the_cut(change, tmp_path):
    """``ops.sweep.hold_full`` passes the fused host build's one count flip
    on the 12-of-16 case (a point at the inlier cut) and fails a count that
    moves by more than its points at the cut, or where none sits there."""
    lib = host_lib(tmp_path)
    src, dst, mask, n_points = case("n_points_12_of_16")
    args = [torch.from_numpy(a) for a in (src, dst, mask)]
    plain = (*args, THR, tsw.draw_seeds(11, 4), n_points, N_HYP)
    f, i = torch_host_build.sweep_full(lib, *args, THR, plain[4], n_points, N_HYP)
    full_p = tsw._sweep_plain(*plain, True)

    def margins(h):
        return tsw.cut_margins(*plain, h)
    assert not tsw.hold_full((f[0], f[1], i), full_p, margins)["failures"]
    h = int(torch.nonzero(f[1] != full_p[1])[0, 0])
    near_in, near_out, _ = margins(torch.tensor([h]))
    counts = f[1].clone()
    if change == "twice_the_cut_points":
        counts[h] = full_p[1][h] + 2 * (near_out[0] if counts[h] > full_p[1][h] else -near_in[0])
    else:
        h = int(torch.nonzero((full_p[1] > 0) & (counts == full_p[1]))[0, 0])
        assert float(sum(margins(torch.tensor([h]))[:2])) == 0.0
        counts[h] += 1
    held = tsw.hold_full((f[0], counts, i), full_p, margins)
    assert held["failures"] == ["1 count or validity flips off a cut"]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["n13", "masked_duplicate", "n_points_12_of_16"])
def test_exact_policy_host_build_matches_plain_bitwise(name, k, tmp_path):
    """``csrc/sweep.cuh`` under the ``Exact`` policy, k hypotheses a thread
    (the redesigned kernel's arithmetic and thread mapping, every operation
    rounded on its own), gives the plain version's full records bit for
    bit."""
    lib = host_lib(tmp_path)
    src, dst, mask, n_points = case(name)
    n_points = len(src) if n_points is None else n_points
    args = [torch.from_numpy(a) for a in (src, dst, mask)]
    seeds = tsw.draw_seeds(11, 4)
    msac, counts, i_ref = tsw._sweep_plain(*args, THR, seeds, n_points, N_HYP, True)
    f, i = torch_host_build.sweep_full(lib, *args, THR, seeds, n_points, N_HYP,
                                       fused=False, k=k)
    assert torch.equal(i, i_ref)
    assert torch.equal(f, torch.stack([msac, counts]))


@pytest.mark.parametrize("d", list(range(1, 17)))
def test_divider_remainder_matches_modulo(d, tmp_path):
    """``rt::Divider`` (multiply-high with the add fix-up) gives n mod d for
    the edge numerators and 10^5 seeded random 32-bit ones."""
    lib = host_lib(tmp_path)
    rng = np.random.default_rng(d)
    num = np.concatenate([np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint64),
                          rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64)]).astype(np.uint32)
    np.testing.assert_array_equal(torch_host_build.umod(lib, d, num), num % np.uint32(d))


@pytest.mark.parametrize("k,n_points", [(4, 13), (8, 16)])
def test_draw_sample_fast_matches_plain(k, n_points, tmp_path):
    """``rt::draw_sample_fast`` (divisors made once) draws the plain
    ``ops.sweep.draw_sample``'s samples for 2^16 flat ids."""
    lib = host_lib(tmp_path)
    flat = np.arange(1 << 16, dtype=np.uint32) * np.uint32(2654435761)
    seeds = tsw.draw_seeds(21, k)
    ref = torch.stack(tsw.draw_sample(torch.from_numpy(flat.astype(np.int64)), seeds,
                                      n_points), 1).numpy()
    np.testing.assert_array_equal(torch_host_build.draw_fast(lib, k, flat, seeds, n_points),
                                  ref)


@pytest.mark.parametrize("name", ["n13", "masked_duplicate"])
def test_fused_host_build_matches_pallas_interpret(name, exact_reciprocal, tmp_path):
    """The kernel's ``Fused`` arithmetic (host build) against the jitted,
    interpreted JAX function with an exact reciprocal, by the full-record
    criteria the plain version meets there: packed samples and counts
    exactly, MSAC within rtol 1e-4 on >= 99% and 1e-3 on all.  The fused
    port is as close to JAX as the plain one.  (On the 12-of-16 case both
    differ from JAX in 4-5 counts at a cut, from XLA's normalization, and are
    held by reduced records only.)"""
    lib = host_lib(tmp_path)
    src, dst, mask, n_points = case(name)
    m_j, c_j, p_j = jax_sweep(src, dst, mask, n_points, True, seed=11)
    n_points = len(src) if n_points is None else n_points
    f, i = torch_host_build.sweep_full(lib, *(torch.from_numpy(a) for a in (src, dst, mask)),
                                       THR, tsw.draw_seeds(11, 4), n_points, N_HYP)
    np.testing.assert_array_equal(i.numpy(), p_j)
    np.testing.assert_array_equal(f[1].numpy(), c_j)
    assert_msac_close(f[0].numpy(), m_j)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_cuda_kernel_matches_plain(full):
    """The kernel against the plain version on the card by its
    decision-level criteria (``ops.sweep.hold_full`` / ``hold_reduced``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src, dst, mask, _ = case("masked_duplicate")
    args = [torch.from_numpy(a).cuda() for a in (src, dst, mask)]
    before = _build.LAUNCHES["homography_ransac_sweep"]
    out = tsw.homography_ransac_sweep(9, *args, THR, 1 << 16, full_records=full)
    ref = tsw.homography_ransac_sweep_ref(9, *args, THR, 1 << 16, full_records=full)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["homography_ransac_sweep"] == before + 1
    full_k = out if full else tsw.homography_ransac_sweep(9, *args, THR, 1 << 16,
                                                          full_records=True)
    full_p = ref if full else tsw.homography_ransac_sweep_ref(9, *args, THR, 1 << 16,
                                                              full_records=True)
    seeds = tsw.draw_seeds(9, 4)
    plain = (*args, THR, seeds, len(src), 1 << 16)
    held = tsw.hold_full(full_k, full_p, lambda h: tsw.cut_margins(*plain, h))
    assert not held["failures"], held
    if not full:
        held_r = tsw.hold_reduced(out, ref, full_k, held["flipped"])
        assert not held_r["failures"], held_r
