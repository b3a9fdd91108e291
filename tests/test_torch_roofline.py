"""The roofline probes' port (``ransac_tpu_torch.ops.roofline``) against the
JAX package's Pallas bodies ``roofline._fma_kernel``, ``_mixed_kernel`` and
``_mxu_kernel``.

``_run_chain`` and ``_run_mxu`` take no ``interpret`` flag, so the tests
build their own ``pl.pallas_call(..., interpret=True)`` around the bodies,
as the JAX package's calls are built (one SMEM seed in, one VMEM [8, 512]
tile out); the JAX package is unchanged.  Each body also runs op by op
(``pallas_op_by_op``).  Measured on this CPU:

- "fma": op by op, the JAX body equals the plain version bit for bit (both
  round x * a + b twice).  Jitted, XLA contracts it into a fused
  multiply-add, as the CUDA kernel does, and differs from the plain version
  by at most 3e-6 relative at 4 trips (128 steps per chain); the tolerance
  is ``FMA_RTOL`` = 2e-5, one rounding of 2^-23 per step.
- "mixed": op by op bit for bit; jitted within one ulp (XLA contracts the
  tile pattern e * scale + offset).
- "mxu": the JAX body and the float32 plain version within 2e-6 up to 10
  steps (sums in another order).  The chain scales by about 5e-4 a step:
  the plain version's entries are subnormal at steps 11-12 and exactly 0
  from step 13; XLA flushes subnormals, so the JAX body is 0 from step 11.

The CUDA kernels (TF32 for "mxu") are held against the plain versions on
the card (``chip_smoke.py`` and the ``cuda``-marked tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ransac_tpu.ops.pallas import roofline as jr
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import roofline as tr
import pallas_op_by_op  # tests/ is on sys.path under pytest
from torch_threads import one_torch_thread  # noqa: F401


def interpreted(body, seed):
    """The body through an interpreted pallas_call built as the JAX
    package builds it (roofline.py:110-115, :219-224)."""
    return np.asarray(pl.pallas_call(
        body,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((jr.SUB, jr.LAN), jnp.float32),
        interpret=True)(jnp.asarray([seed], jnp.float32)))


def op_by_op(monkeypatch, body, seed):
    return pallas_op_by_op.run_kernel(
        monkeypatch, body, 1, [np.array([seed], np.float32)],
        [((jr.SUB, jr.LAN), np.float32)])[0]


def rel_err(a, b):
    return float(np.abs(a / b - 1.0).max())


@pytest.mark.parametrize("seed", [0.0, 3.0])
@pytest.mark.parametrize("n_iters", [1, 4])
def test_fma_body_matches_plain(seed, n_iters, monkeypatch):
    plain = tr.run_chain(seed, n_iters, "fma", device="cpu")[0].numpy()
    np.testing.assert_array_equal(op_by_op(monkeypatch, jr._fma_kernel(n_iters), seed),
                                  plain)
    assert rel_err(interpreted(jr._fma_kernel(n_iters), seed), plain) <= tr.FMA_RTOL


@pytest.mark.parametrize("seed", [0.0, 3.0])
@pytest.mark.parametrize("n_iters", [1, 4])
def test_mixed_body_matches_plain(seed, n_iters, monkeypatch):
    plain = tr.run_chain(seed, n_iters, "mixed", device="cpu")[0].numpy()
    np.testing.assert_array_equal(
        op_by_op(monkeypatch, jr._mixed_kernel(n_iters), seed), plain)
    np.testing.assert_array_max_ulp(interpreted(jr._mixed_kernel(n_iters), seed),
                                    plain, maxulp=1)


@pytest.mark.parametrize("n_iters", [1, 4, 8])
def test_mxu_body_matches_plain(n_iters):
    body = jr._mxu_kernel(n_iters, tr.MXU_DIM, tr.MXU_DIM, tr.MXU_DIM)
    got = interpreted(body, 2.0)
    plain = tr.run_mxu(2.0, n_iters, device="cpu")[0, :jr.SUB].numpy()
    assert (plain > 0).all()
    assert rel_err(got, plain) <= 2e-6


def test_mxu_chain_underflows_to_zero_at_step_13():
    """The probe's chain (kept as the JAX package defines it) scales by
    about 5e-4 a step: all positive at 10 steps, subnormal at 12, exactly 0
    from 13 in the plain version; the JAX body (XLA flushes subnormals) is
    0 from 11.  At the probe's 4096 steps the tensor cores multiply
    zeros."""
    dim = tr.MXU_DIM
    at = {k: tr.run_mxu(0.0, k, device="cpu")[0] for k in (10, 12, 13)}
    assert (at[10] > 1e-38).all()
    assert (at[12] > 0).any() and (at[12] < 1.2e-38).all()
    assert (at[13] == 0).all()
    assert (interpreted(jr._mxu_kernel(10, dim, dim, dim), 0.0) > 0).all()
    assert (interpreted(jr._mxu_kernel(11, dim, dim, dim), 0.0) == 0).all()
    assert (interpreted(jr._mxu_kernel(13, dim, dim, dim), 0.0) == 0).all()


@pytest.mark.parametrize("kind", ["fma", "mixed"])
def test_tiles_are_copies_from_consecutive_seeds(kind):
    many = tr.run_chain(2.0, 1, kind, tiles=3, device="cpu")
    assert many.shape == (3, tr.SUB, tr.LAN)
    for i in range(3):
        assert torch.equal(many[i], tr.run_chain(2.0 + i, 1, kind, device="cpu")[0])
    mxu = tr.run_mxu(1.0, 1, replicas=2, device="cpu")
    assert mxu.shape == (2, tr.MXU_DIM, tr.MXU_DIM)
    assert torch.equal(mxu[1], tr.run_mxu(2.0, 1, device="cpu")[0])


def test_work_counts_are_the_jax_packages():
    assert tr.fma_flops(131072, 1) == 2.0 * 131072 * jr.UNROLL * jr.CHAINS * jr.SUB * jr.LAN
    assert tr.mixed_ops(131072, 1) == 131072 * (jr.UNROLL // 4) * 5 * jr.CHAINS * jr.SUB * jr.LAN
    assert tr.mxu_flops(4096, 1) == 2.0 * 512 ** 3 * 4096
    assert tr.fma_flops(1, 33) == 33 * tr.fma_flops(1, 1)


def test_plain_on_cpu_and_probes_need_the_card(monkeypatch):
    before = dict(_build.LAUNCHES)
    tr.run_chain(0.0, 1, "fma", device="cpu")
    tr.run_mxu(0.0, 1, device="cpu")
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError):
        tr.run_chain(0.0, 1, "other", device="cpu")
    with pytest.raises(ValueError):
        tr.run_mxu(0.0, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for probe in (tr.measure_vpu_fma_peak, tr.measure_vpu_op_peak,
                  tr.measure_mxu_peak, tr.measure_hbm_bw, tr.measure_all):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            probe()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fma", "mixed"])
def test_cuda_chain_matches_plain(kind, card):
    before = _build.LAUNCHES[f"roofline_{kind}"]
    out = tr.run_chain(1.0, 4, kind, tiles=3, device=card)
    ref = tr.run_chain_plain(1.0, 4, kind, tiles=3, device=card)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"roofline_{kind}"] == before + 1
    if kind == "mixed":
        assert torch.equal(out, ref)
    else:
        assert float((out / ref - 1).abs().max()) <= tr.FMA_RTOL


@pytest.mark.cuda
def test_cuda_mxu_matches_plain(card):
    before = _build.LAUNCHES["roofline_mxu"]
    out = tr.run_mxu(1.0, 8, replicas=2, device=card)
    ref = tr.run_mxu_plain(1.0, 8, replicas=2, device=card)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["roofline_mxu"] == before + 1
    assert bool((ref > 0).all())
    assert float((out / ref - 1).abs().max()) <= tr.MXU_RTOL
