"""The candidate-sweep port (``ransac_tpu_torch.ops.sweep_multi``) against
the Pallas kernel ``ransac_tpu.ops.pallas.sweep_multi.multi_candidate_sweep``
run in interpret mode, taken to its per-candidate winner as
``localize.score_candidates_sweep`` does (argmin over lanes, then the
packed sample and count at that lane).

On the CPU the wrapper computes the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py``.

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
    before = tsm.LAUNCHES
    src, dst, mask = _case("n13")
    tsm.multi_candidate_sweep(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(mask),
                              sweep_sample_table(13, "cpu"), THR)
    assert tsm.LAUNCHES == before == 0


def test_kernel_entry_raises_for_cpu_tensors():
    src, dst, mask = _case("n13")
    args = tsm._normalize(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(mask), THR)[:4]
    with pytest.raises(ValueError, match="CUDA"):
        tsm._sweep_kernel(*args, sweep_sample_table(13, "cpu"), 13)
    assert tsm.LAUNCHES == 0


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
