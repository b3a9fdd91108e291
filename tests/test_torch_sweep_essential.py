"""The <= 16-point fused essential sweep port
(``ransac_tpu_torch.ops.sweep_essential``) against the Pallas kernel
``ransac_tpu.ops.pallas.sweep_essential.essential_ransac_sweep``.

On the CPU the wrapper computes the kernel's plain version.  The sampling
is the JAX kernel's counter PRNG bit for bit, so both sides score the same
hypotheses.  The Pallas kernel scores MSAC with ``pl.reciprocal(approx=
True)`` (a bfloat16 reciprocal in interpret mode); the port divides
exactly, so every comparison swaps the exact reciprocal into the JAX kernel
(the JAX package is unchanged).

- ``test_kernel_body_op_by_op_matches_plain`` is the exact check: the JAX
  kernel body run one operation at a time (``pallas_op_by_op``, rsqrt as
  1/sqrt on both sides) on the port's normalized points gives the plain
  version's records bit for bit, full and reduced, including the packed
  samples that are negative int32s and the unsigned tie-break among them.
- The kernel's own arithmetic (``csrc/sweep_essential.cuh`` and its prep),
  built for the host, equals the plain version bit for bit under the
  ``Exact`` policy, and holds its decisions under the kernel's ``Fused``
  policy (FMAs in the Sampson score, the canonical solve exact;
  ``ops.sweep_essential.hold_full`` / ``hold_reduced``), by which the fused
  arithmetic also meets the jitted JAX function.
- Against the jitted, interpreted JAX function (as users call it) the
  sampling is exact: packed samples and validity equal everywhere.  XLA's
  FMA contraction, its sums in the normalization and its rsqrt move F in
  the last places, and the canonical solve amplifies that (MSAC of one
  hypothesis up to 80% apart on ill-conditioned samples, 7% on a winner;
  measured over seeds 7-12).  So those tests hold counts equal on >= 95%
  of hypotheses (the 13-point case with a 10-point pool: 95.8-97.2%,
  the others >= 98.9%), the best count equal, the count of JAX's min-MSAC
  hypothesis equal, the min MSAC within 10%, and records whose eight
  hypotheses are all invalid (pure tie-breaks) to the same samples.  With
  0.5 px of noise the winning samples themselves are near-ties and may
  differ.

The CUDA kernel itself is held against the plain version on the card
(``chip_smoke.py`` and the ``cuda``-marked test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops.pallas import sweep_essential as jse
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep as tsw
from ransac_tpu_torch.ops import sweep_essential as tse
from ransac_tpu_torch.ops import sweep_essential_large as tsel
from ransac_tpu_torch.ops.rotation import exp_so3
import pallas_op_by_op  # tests/ is on sys.path under pytest
import torch_host_build
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 512
N_HYP = 2 * BLOCK
THR = (2.0 / 600.0) ** 2   # 2 px at f = 600, squared normalized Sampson units


def planted(seed=3, n=16, n_out=4, noise=0.0):
    """``tests/test_sweep.py``'s planted two-view scene (x1, x2 normalized;
    the last n_out of x2 shifted by 0.1-0.3)."""
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
    return x1, x2


CASES = {  # name -> (n, n_points, masked rows)
    "n16": (16, None, []),
    "n13_n_points_10": (13, 10, []),
    "n16_masked": (16, None, [1, 6]),
    "n16_mostly_masked": (16, None, [0, 5, 9, 12]),
}


def case(name):
    """(x1, x2, mask, n_points): 0.5 px noise at f = 600, a quarter outliers."""
    n, n_points, masked = CASES[name]
    x1, x2 = planted(seed=n + len(masked), n=n, n_out=n // 4, noise=0.5 / 600.0)
    mask = np.ones(n, np.float32)
    mask[masked] = 0.0
    return x1, x2, mask, n_points


@pytest.fixture
def rsqrt_as_division(monkeypatch):
    monkeypatch.setattr(jse.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(tsel, "_rsqrt", lambda x: 1.0 / tsw.sqrt_rn(x))


def signed_tie_breaks(f_full, p_full, B):
    """Records whose eight hypotheses are all invalid and hold at least one
    negative packed sample: there the unsigned and signed orders pick
    different samples.  f_full [2, 8B], p_full [8B] in s * B + r order."""
    invalid = (f_full[0] >= 3e38).reshape(8, B).all(0)
    negative = (p_full < 0).reshape(8, B).any(0)
    return invalid & negative


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_body_op_by_op_matches_plain(name, monkeypatch, rsqrt_as_division):
    """Row 7's JAX kernel body op by op on the port's normalized points:
    the plain version's records bit for bit (unscaled), full and
    reduced."""
    x1, x2, mask, n_points = case(name)
    n = len(x1)
    n_points = n if n_points is None else n_points
    seeds = tsw.draw_seeds(5, 8)
    x1_p, x2_p, mask_p, thr, _ = tse._normalize(
        torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask), THR,
        n_points)
    inputs = [x1_p.numpy(), x2_p.numpy(), mask_p.numpy(), thr.numpy(),
              np.array(seeds, np.uint32), tsw.sample_bitmask(mask_p).numpy()]
    lan = BLOCK // 8
    B = N_HYP // 8
    out = {}
    for full in (True, False):
        shapes = ([((2, 8, lan), np.float32), ((1, 8, lan), np.int32)] if full
                  else [((4, lan), np.float32), ((2, lan), np.int32)])
        f_j, i_j = pallas_op_by_op.run_kernel(
            monkeypatch, jse._make_kernel(n_points, n, not full, BLOCK),
            N_HYP // BLOCK, inputs, shapes)
        f_t, i_t = tse._score_plain(x1_p, x2_p, mask_p, thr, seeds, n_points, n,
                                    N_HYP, BLOCK, full)
        if full:
            f_j, i_j = f_j.reshape(2, -1), i_j.reshape(-1)
        np.testing.assert_array_equal(f_j, f_t.numpy())
        np.testing.assert_array_equal(i_j, i_t.numpy())
        out[full] = (f_t, i_t)
    f_full, p_full = out[True]
    assert (p_full < 0).any()  # samples with a last index >= 8
    if name == "n16_mostly_masked":
        assert signed_tie_breaks(f_full, p_full, B).sum() >= 10


def host_lib(tmp_path):
    lib = torch_host_build.load(tmp_path)
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


def host_args(name, seed):
    x1, x2, mask, n_points = case(name)
    t = [torch.from_numpy(a) for a in (x1, x2, mask)]
    n_points = len(x1) if n_points is None else n_points
    return (*t, THR, tsw.draw_seeds(seed, 8), n_points, N_HYP, BLOCK)


def host_reduced(f, i):
    """Reduced records (msac, counts, packed) [2, B] of full records."""
    B = f.shape[1] // 8
    red, packed = tsw.reduce_records(*(t.reshape(8, B) for t in f),
                                     (i.long() & 0xFFFFFFFF).reshape(8, B),
                                     sentinel=tse.UNSIGNED_SENTINEL)
    return red[0::2], red[1::2], packed


@pytest.mark.parametrize("name", ["n16", "n13_n_points_10", "n16_masked"])
def test_kernel_arithmetic_host_build_matches_plain(name, tmp_path, monkeypatch):
    """``csrc/sweep_essential.cuh`` and the prep's normalization under the
    kernel's ``Fused`` policy, compiled for the host (FMAs where the score's
    source writes them, the canonical solve rounded op by op; the host
    divides where the card takes MUFU's reciprocal; the plain rsqrt taken as
    the host's 1/sqrt), hold the plain version's decisions
    (``ops.sweep_essential.hold_full`` / ``hold_reduced``): samples and
    validity equal, counts equal on >= 95% (measured: all), the best count
    and the plain min-MSAC hypothesis' count equal, the min MSAC within
    10%."""
    lib = host_lib(tmp_path)
    monkeypatch.setattr(tsel, "_rsqrt", lambda x: 1.0 / tsw.sqrt_rn(x))
    args = host_args(name, 9)
    f_h, i_h = torch_host_build.sweep_essential_full(lib, *args)
    f_p, i_p = tse._sweep_plain(*args, True)
    held = tse.hold_full((f_h[0], f_h[1], i_h), (f_p[0], f_p[1], i_p))
    r_p = tse._sweep_plain(*args, False)
    held_r = tse.hold_reduced(host_reduced(f_h, i_h), (r_p[0][0::2], r_p[0][1::2], r_p[1]))
    assert not held["failures"] and not held_r["failures"], (held, held_r)
    assert held["counts_equal_fraction"] == 1.0  # F is the plain version's
    assert (i_h < 0).any()


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["n16", "n13_n_points_10", "n16_masked"])
def test_exact_policy_host_build_matches_plain_bitwise(name, k, tmp_path, monkeypatch):
    """The same header under the ``Exact`` policy, k hypotheses a thread
    (the redesigned kernel's arithmetic and thread mapping, every operation
    rounded on its own), gives the plain version's full records bit for bit
    (the plain rsqrt taken as the host's 1/sqrt)."""
    lib = host_lib(tmp_path)
    monkeypatch.setattr(tsel, "_rsqrt", lambda x: 1.0 / tsw.sqrt_rn(x))
    args = host_args(name, 9)
    f_h, i_h = torch_host_build.sweep_essential_full(lib, *args, fused=False, k=k)
    f_p, i_p = tse._sweep_plain(*args, True)
    assert torch.equal(f_h, f_p) and torch.equal(i_h, i_p)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jse.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


def both(name, full, seed=7):
    x1, x2, mask, n_points = case(name)
    out_j = jse.essential_ransac_sweep(
        seed, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), THR,
        n_hyp=N_HYP, n_points=n_points, interpret=True, full_records=full,
        block_h=BLOCK)
    out_t = tse.essential_ransac_sweep(
        seed, torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask),
        THR, N_HYP, n_points=n_points, full_records=full, block_h=BLOCK)
    return [np.asarray(a) for a in out_j], [a.numpy() for a in out_t]


@pytest.mark.parametrize("name", ["n16", "n13_n_points_10", "n16_masked"])
def test_full_records_match_pallas_interpret(name, exact_reciprocal):
    """Full records: packed samples (negative ones included) and validity
    exactly; counts on >= 95% of hypotheses, the best count, the count of
    JAX's min-MSAC hypothesis and the min MSAC within 10% (module doc)."""
    (m_j, c_j, p_j), (m_t, c_t, p_t) = both(name, True)
    assert m_t.shape == m_j.shape == (N_HYP,)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(m_t >= 3e38, m_j >= 3e38)
    assert (c_t == c_j).mean() >= 0.95
    assert c_t.max() == c_j.max()
    b = int(np.argmin(m_j))
    assert c_t[b] == c_j[b]
    assert abs(m_t.min() / m_j.min() - 1.0) <= 0.1
    assert (p_t < 0).any()
    _, _, mask, _ = case(name)
    decoded = np.stack([tse.unpack_sample8(p) for p in p_t])
    touches_masked = np.isin(decoded, np.flatnonzero(mask == 0)).any(1)
    assert (m_t[touches_masked] >= 3e38).all() and (c_t[touches_masked] == -1).all()


@pytest.mark.parametrize("name", ["n16", "n13_n_points_10", "n16_masked"])
def test_fused_host_build_matches_pallas_interpret(name, exact_reciprocal, tmp_path):
    """The kernel's ``Fused`` arithmetic (host build) against the jitted,
    interpreted JAX function with an exact reciprocal, by the criteria the
    plain version meets there on the same cases
    (``test_full_records_match_pallas_interpret``,
    ``ops.sweep_essential.hold_full``: samples and validity equal, counts on
    >= 95%, the best count and the count of JAX's min-MSAC hypothesis equal,
    the min MSAC within 10%): the fused port is as close to JAX as the plain
    one."""
    lib = host_lib(tmp_path)
    (m_j, c_j, p_j), _ = both(name, True)
    f_h, i_h = torch_host_build.sweep_essential_full(lib, *host_args(name, 7))
    held = tse.hold_full((f_h[0], f_h[1], i_h), tuple(torch.tensor(a) for a in
                                                       (m_j, c_j, p_j)))
    assert not held["failures"], held


@pytest.mark.parametrize("name", ["n16", "n13_n_points_10", "n16_mostly_masked"])
def test_reduced_records_match_pallas_interpret(name, exact_reciprocal):
    """Reduced records: the same best count under the count rule, and on
    records whose eight hypotheses are all invalid (ties broken by the
    unsigned packed order alone) the same samples under both rules."""
    (m_j, c_j, p_j), (m_t, c_t, p_t) = both(name, False)
    assert m_t.shape == (2, N_HYP // 8)
    assert c_t[1].max() == c_j[1].max()
    tie = (m_j[0] >= 3e38) & (m_t[0] >= 3e38)
    np.testing.assert_array_equal(p_t[:, tie], p_j[:, tie])
    if name == "n16_mostly_masked":
        assert tie.sum() >= 10


def test_unsigned_tie_break_on_negative_samples():
    """``reduce_records`` with the unsigned sentinel against the TPU
    kernel's rule (sweep_essential.py:272-286) written out in numpy: a
    group of tied hypotheses whose samples straddle the sign bit keeps the
    smallest as an unsigned number, a positive one, where a signed
    comparison would take the negative one."""
    packed_u = np.array([[0xF0000001, 0x10000002, 0x80000003, 0x7FFFFFFF],
                         [0x00000004, 0xE0000005, 0x90000006, 0x0000000F]] * 4,
                        dtype=np.int64)  # [8, 4]: two hypotheses tied per record
    msac = np.full(packed_u.shape, 3.4e38, np.float32)
    count = np.full(packed_u.shape, -1.0, np.float32)
    f, p = tsw.reduce_records(torch.from_numpy(msac), torch.from_numpy(count),
                              torch.from_numpy(packed_u),
                              sentinel=tse.UNSIGNED_SENTINEL)
    pcmp = (packed_u.astype(np.uint32).view(np.int32) ^ np.int32(-2 ** 31))
    expect = (pcmp.min(0) ^ np.int32(-2 ** 31)).astype(np.int32)
    np.testing.assert_array_equal(p[0].numpy(), expect)
    np.testing.assert_array_equal(p[1].numpy(), expect)
    assert (expect == np.array([4, 0x10000002, 0x80000003 - 2 ** 32, 15])).all()
    assert (packed_u.astype(np.uint32).view(np.int32).min(0) != expect).any()


def test_essential_sweep_finds_consensus():
    """The port's counterpart of ``tests/test_sweep.py``'s
    ``test_essential_sweep_finds_consensus``: 16 exact correspondences, the
    last 4 outliers; the min-MSAC hypothesis of 1024 holds >= 12 inliers
    and an outlier-free sample of 8 distinct points."""
    x1, x2 = planted(seed=3, n=16, n_out=4)
    msac, counts, packed = tse.essential_ransac_sweep(
        3, torch.from_numpy(x1), torch.from_numpy(x2), torch.ones(16), THR,
        N_HYP, full_records=True, block_h=BLOCK)
    b = int(msac.argmin())
    assert counts[b] >= 12
    s = tse.unpack_sample8(packed[b])
    assert len(set(s.tolist())) == 8
    assert all(i < 12 for i in s)


def test_plain_equals_wrapper_and_launches_stay_zero_on_cpu():
    x1, x2, mask, _ = case("n16")
    args = (1, torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask),
            THR, 1000)
    out = tse.essential_ransac_sweep(*args)
    for a, b in zip(out, tse.essential_ransac_sweep_ref(*args)):
        assert torch.equal(a, b)
    assert out[0].shape == (2, 1000 // 8)  # block_h 1000: one block
    assert _build.LAUNCHES["essential_ransac_sweep"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tse._sweep_kernel(*args[1:5], tsw.draw_seeds(0, 8), 16, BLOCK, BLOCK, False)
    with pytest.raises(ValueError, match="at most 16"):
        tse.essential_ransac_sweep(1, torch.zeros(17, 2), torch.zeros(17, 2),
                                   torch.ones(17), THR, BLOCK)
    assert _build.LAUNCHES["essential_ransac_sweep"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_cuda_kernel_matches_plain(full):
    """The kernel against the plain version on the card by its
    decision-level criteria (``ops.sweep_essential.hold_full`` /
    ``hold_reduced``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x1, x2, mask, _ = case("n16_masked")
    args = [torch.from_numpy(a).cuda() for a in (x1, x2, mask)]
    before = _build.LAUNCHES["essential_ransac_sweep"]
    out = tse.essential_ransac_sweep(2, *args, THR, 8192, full_records=full,
                                     block_h=BLOCK)
    ref = tse.essential_ransac_sweep_ref(2, *args, THR, 8192, full_records=full,
                                         block_h=BLOCK)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["essential_ransac_sweep"] == before + 1
    if full:
        held = tse.hold_full(out, ref)
    else:
        held = tse.hold_reduced(out, ref)
    assert not held["failures"], held
