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
from ransac_tpu_torch.ops import sweep as tsw
from ransac_tpu_torch.ops import sweep_essential_large as tsel
from ransac_tpu_torch.ops import sweep_large as tsl
from ransac_tpu_torch.ops.rotation import exp_so3
import pallas_op_by_op  # tests/ is on sys.path under pytest
import torch_host_build

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
    assert tsel.LAUNCHES == 0
    with pytest.raises(ValueError, match="CUDA"):
        tsel._sweep_kernel(*args[1:5], tsw.draw_seeds(0, 10), BLOCK, BLOCK)
    assert tsel.LAUNCHES == 0


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x1, x2, mask, _ = case("n90_masked")
    args = [torch.from_numpy(a).cuda() for a in (x1, x2, mask)]
    before = tsel.LAUNCHES
    out = tsel.essential_ransac_sweep_large(2, *args, THR, 8192, block_h=BLOCK)
    ref = tsel.essential_ransac_sweep_large_ref(2, *args, THR, 8192, block_h=BLOCK)
    torch.cuda.synchronize()
    assert tsel.LAUNCHES == before + 1
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
