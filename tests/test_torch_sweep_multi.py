"""The candidate-sweep port (``ransac_tpu_torch.ops.sweep_multi``) against
the Pallas kernel ``ransac_tpu.ops.pallas.sweep_multi.multi_candidate_sweep``
run in interpret mode, taken to its per-candidate winner as
``localize.score_candidates_sweep`` does (argmin over lanes, then the
packed sample and count at that lane).

On the CPU the wrapper computes the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py``.  The kernel's header (``csrc/sweep_multi.cuh``), built
for the host, equals the plain version bit for bit under ``Exact`` and
holds it by ``ops.sweep_multi.hold`` under the kernel's ``Fused`` score.

The Pallas kernel scores MSAC with ``pl.reciprocal(approx=True)``, which
interpret mode lowers to a bfloat16 reciprocal (relative error up to
2^-8); the port divides exactly.  So the exact comparison swaps the exact
reciprocal into the interpreted kernel (the JAX package is unchanged):
MSAC rtol 1e-4 (XLA and PyTorch sum the normalization in another order),
counts and samples exactly.  A second test holds the port against the
unmodified kernel within the bfloat16 reciprocal's error.
"""

from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ops.pallas import sweep_multi as jsm
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep_multi as tsm
from ransac_tpu_torch.pipelines.localize import sweep_sample_table
import torch_host_build  # tests/ is on sys.path under pytest
from torch_threads import one_torch_thread  # noqa: F401

C = 16
THR = 75.0


def _sample_table(n):
    """The JAX package's table (localize.py:130-135), built with numpy."""
    combos = np.array(list(combinations(range(n), 4)), dtype=np.int32)
    H = -(-len(combos) // jsm.BLOCK_H) * jsm.BLOCK_H
    idx = np.zeros((4, H), np.int32)
    idx[:, :len(combos)] = combos.T
    idx[:, len(combos):] = combos.T[:, :1]
    return idx


def _scene(seed, n, n_out=2):
    """C candidates near a camera looking east at n landmarks 1.5-4 km
    away: plane points (dz/dE, dN/dE) per candidate and the true
    camera's pixels with 0.3 px noise and n_out outliers."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(1500, 4000, n), rng.uniform(-600, 600, n),
                  rng.uniform(-50, 250, n)], 1)
    cams = rng.normal(scale=40.0, size=(C, 3))
    cams[3] = 0.0
    p = X[None] - cams[:, None]
    src = np.stack([p[..., 2] / p[..., 0], p[..., 1] / p[..., 0]], -1)
    pix = np.stack([-4048.0 * X[:, 1] / X[:, 0] + 982.7,
                    -2183.8 * X[:, 2] / X[:, 0] + 698.0], 1)
    pix += rng.normal(scale=0.3, size=pix.shape)
    pix[rng.choice(n, n_out, replace=False)] += [260.0, -210.0]
    return src.astype(np.float32), pix.astype(np.float32), np.ones(n, np.float32)


def _jax_winner(src, dst, mask, idx):
    msac, counts, packed = jsm.multi_candidate_sweep(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        jnp.asarray(idx), THR, interpret=True)
    msac, counts, packed = (np.asarray(a) for a in (msac, counts, packed))
    lane = np.argmin(msac, axis=1)
    rows = np.arange(len(lane))
    return msac[rows, lane], counts[rows, lane], packed[rows, lane]


def _decode(packed):
    return np.stack([(packed >> s) & 15 for s in (0, 4, 8, 12)], 1)


def _case(name):
    if name == "n16":
        return _scene(1, 16)
    src, dst, mask = _scene(0, 13)
    if name == "masked":
        mask[[1, 5, 9]] = 0.0
    elif name == "collinear":
        # Pixels 0..3 on one line: every sample holding three of them has
        # an invalid frame and scores the 3.4e38 sentinel.
        dst[1:4] = dst[0] + np.arange(1, 4, dtype=np.float32)[:, None] * [37.0, -11.0]
    return src, dst, mask


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The interpreted Pallas kernel with an exact reciprocal; jit caches
    are cleared around it so the kernel is traced anew each way."""
    jax.clear_caches()
    monkeypatch.setattr(jsm.pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", ["n13", "n16", "masked", "collinear"])
def test_sweep_plain_matches_pallas_interpret(name, exact_reciprocal):
    src, dst, mask = _case(name)
    idx = _sample_table(len(dst))
    m_j, c_j, p_j = _jax_winner(src, dst, mask, idx)
    m_t, c_t, p_t = tsm.multi_candidate_sweep(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        torch.from_numpy(idx), THR)
    np.testing.assert_array_equal(_decode(p_t.numpy()), _decode(p_j))
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=1e-4)
    assert (m_t.numpy() < 3e38).all()
    if name == "collinear":
        assert (np.isin(_decode(p_t.numpy()), [0, 1, 2, 3]).sum(1) < 3).all()
    if name == "masked":
        # The mask weights the scoring only: masked points count nowhere.
        assert (c_t.numpy() <= mask.sum()).all()


def _port_msac_of(src, dst, mask, samples):
    """The port's exact MSAC of one given sample per candidate."""
    idx = torch.from_numpy(samples.T.astype(np.int32))
    out = []
    for c in range(len(samples)):  # a table of one sample, padded by copies
        table = idx[:, c:c + 1].expand(4, tsm.BLOCK_H).contiguous()
        m, _, _ = tsm.multi_candidate_sweep(
            torch.from_numpy(src[c:c + 1]), torch.from_numpy(dst),
            torch.from_numpy(mask), table, THR)
        out.append(float(m[0]))
    return np.array(out)


def test_sweep_plain_vs_pallas_bf16_reciprocal():
    """Against the unmodified interpreted kernel: its MSAC of its own
    winner is within the bfloat16 reciprocal's 2^-8 of the exact MSAC of
    that sample, and the port's exact minimum is never above it."""
    src, dst, mask = _case("n13")
    idx = _sample_table(13)
    m_j, _, p_j = _jax_winner(src, dst, mask, idx)
    m_t, _, _ = tsm.multi_candidate_sweep(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        torch.from_numpy(idx), THR)
    exact_j = _port_msac_of(src, dst, mask, _decode(p_j))
    np.testing.assert_allclose(m_j, exact_j, rtol=2.0 ** -8)
    assert (m_t.numpy() <= exact_j * (1 + 1e-6)).all()


def test_sweep_ref_equals_wrapper_and_table_matches_jax():
    src, dst, mask = _case("n13")
    args = (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(mask), sweep_sample_table(13, "cpu"), THR)
    np.testing.assert_array_equal(sweep_sample_table(13, "cpu").numpy(),
                                  _sample_table(13))
    for a, b in zip(tsm.multi_candidate_sweep(*args),
                    tsm.multi_candidate_sweep_ref(*args)):
        assert torch.equal(a, b)


def test_launch_counter_stays_zero_on_cpu():
    before = _build.LAUNCHES["sweep_multi"]
    src, dst, mask = _case("n13")
    tsm.multi_candidate_sweep(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(mask),
                              sweep_sample_table(13, "cpu"), THR)
    assert _build.LAUNCHES["sweep_multi"] == before == 0


def test_kernel_entry_raises_for_cpu_tensors():
    src, dst, mask = _case("n13")
    args = tsm._normalize(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(mask), THR)[:4]
    with pytest.raises(ValueError, match="CUDA"):
        tsm._sweep_kernel(*args, sweep_sample_table(13, "cpu"), 13)
    assert _build.LAUNCHES["sweep_multi"] == 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compile failure' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="fake compile failure"):
        _build.build()
    assert not list((tmp_path / "kernels").glob("*.so"))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = torch_host_build.load(tmp_path_factory.mktemp("host_build"))
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


def _core(src, dst, mask, idx):
    """The kernel core's arguments: the wrapper's normalization, the sample
    table and the point count."""
    dst = torch.as_tensor(dst)
    return tsm._normalize(torch.as_tensor(src), dst, torch.as_tensor(mask),
                          THR)[:4] + (torch.as_tensor(idx), dst.shape[0])


def _hold_exact_bit_for_bit(core, host_lib):
    """The host build of ``csrc/sweep_multi.cuh`` under ``Exact`` on the
    kernel core's arguments ``core``: every sample's MSAC and count, and the
    per-candidate records they reduce to, equal the plain version's."""
    m_p, c_p, p_p = tsm._sweep_plain(*core, full=True)
    m_k, c_k = torch_host_build.sweep_multi_full(host_lib, *core[:3], float(core[3][0]),
                                                 core[4], core[5], fused=False)
    assert torch.equal(m_k, m_p) and torch.equal(c_k, c_p)
    for a, b in zip(tsm.reduce_candidates(m_k, c_k, p_p), tsm._sweep_plain(*core)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["n13", "n16", "masked", "collinear"])
def test_exact_header_matches_plain_bit_for_bit(name, host_lib):
    """``csrc/sweep_multi.cuh`` under ``Exact``, built for the host, a
    sample at a time: every sample's MSAC and count equal the plain
    version's bit for bit, and so do the per-candidate records they reduce
    to."""
    src, dst, mask = _case(name)
    _hold_exact_bit_for_bit(_core(src, dst, mask, _sample_table(len(dst))), host_lib)


@pytest.fixture(scope="module")
def planted_cases(tmp_path_factory):
    """``chip_smoke.check_sweep_multi``'s cases on the CPU: the planted
    458-candidate scenes at 13 and 16 points, 13 with three points masked,
    and 13 with pixels 0..3 collinear."""
    import chip_smoke

    return chip_smoke.sweep_multi_cases(tmp_path_factory.mktemp("scenes"), "cpu")


@pytest.mark.parametrize("name", ["n13", "n16", "n13_masked", "n13_degenerate"])
def test_exact_header_matches_plain_on_planted_scenes(name, planted_cases, host_lib):
    """The same bit-for-bit hold of the ``Exact`` header on the planted
    458-candidate scenes of ``chip_smoke.check_sweep_multi``, the
    localization search's own shapes (the table's padding included)."""
    pos2, dst, mask, idx = planted_cases[name]
    _hold_exact_bit_for_bit(_core(pos2, dst, mask, idx), host_lib)


@pytest.mark.parametrize("name", ["n13", "n16", "n13_masked", "n13_degenerate"])
def test_fused_header_holds_plain(name, planted_cases, host_lib):
    """The kernel's arithmetic (``Fused`` score, exact solve and
    projection; the host's exact reciprocal for MUFU's), a sample a thread,
    on the planted 458-candidate scenes: ``ops.sweep_multi.hold`` (samples
    and validity equal, a count moved only by points at the inlier cut,
    MSAC within 1e-4 on >= 99% and 1e-3 on all; every candidate's winner
    the plain one or a near-tie in the kernel's full records).  The full
    records, reduced per candidate, are the kernel's records."""
    pos2, dst, mask, idx = planted_cases[name]
    core = _core(pos2, dst, mask, idx)
    out_p = tsm._sweep_plain(*core, full=True)
    m_k, c_k = torch_host_build.sweep_multi_full(host_lib, *core[:3], float(core[3][0]),
                                                 core[4], core[5])
    out_k = (m_k, c_k, out_p[2])
    red_k = tsm.reduce_candidates(*out_k)
    held, held_r = tsm.hold(out_k, out_p, red_k, tsm._sweep_plain(*core),
                             lambda h: tsm.cut_margins(*core, h))
    assert not held["failures"] and not held_r["failures"], (held, held_r)
    assert held["max_rel_err"] < 1e-5


def test_plain_full_records_reduce_to_records():
    src, dst, mask = _case("masked")
    core = _core(src, dst, mask, _sample_table(13))
    full = tsm._sweep_plain(*core, full=True)
    assert full[0].shape == (C, _sample_table(13).shape[1])
    for a, b in zip(tsm.reduce_candidates(*full), tsm._sweep_plain(*core)):
        assert torch.equal(a, b.to(a.dtype))


def _records(msac, count, packed):
    return (torch.tensor(msac), torch.tensor(count),
            torch.tensor(packed, dtype=torch.int32))


@pytest.mark.parametrize("kept, flip, failure", [
    (1, 0, None),  # another sample kept; the flip is the plain winner
    (1, 3, "candidate 0: another sample, not a near-tie"),  # a flip far off
    (0, 4, None),  # the winner kept with another count; the flip is it
    (0, 7, "a kept winner's count or MSAC differs"),  # a flip far off
])
def test_hold_reduced_exempts_only_flips_that_reach_the_record(kept, flip, failure):
    """``ops.sweep_multi.hold_reduced`` on hand-made records, two candidates
    of four samples (MSAC 1-4; the plain winner is sample 0 at count 5):
    a count that differs from the plain record's is excused by a flip at
    the plain or the kernel's winner, not by one elsewhere in the
    candidate.  ``kept`` 1: candidate 0 keeps sample 1, and its sample 0
    counts 4 in the kernel's full records; ``kept`` 0: candidate 1 keeps
    sample 0 with count 4.  ``flip`` is the flat index c * 4 + h of the one
    flipped sample."""
    full_k = (torch.tensor([[1.0, 2.0, 3.0, 4.0]] * 2),
              torch.tensor([[4.0, 5.0, 5.0, 5.0], [4.0, 5.0, 5.0, 5.0]]),
              torch.arange(4, dtype=torch.int32).expand(2, 4))
    red_p = _records([1.0, 1.0], [5.0, 5.0], [0, 0])
    red_k = (_records([2.0, 1.0], [5.0, 5.0], [1, 0]) if kept
             else _records([1.0, 1.0], [5.0, 4.0], [0, 0]))
    held = tsm.hold_reduced(red_k, red_p, full_k, torch.tensor([flip]))
    assert held["failures"] == ([failure] if failure else [])
