"""BAL problems through the port on the CPU: the reader and writer
(``io.bal``), BAL's 9-parameter camera in ``ba.schur_cg`` (projection,
Jacobians, the solve in the flat layout) held against the benchmark's
plain reference (``benchmark/lib/reference_ba.py``, float64, imported by
path), the flat layout against the slot layout, the vectorised slot
packing against the loop it replaced, the BA spans and counters, and
``cli ba``.

Tolerances: the projection and its 12 partials in float64, 1e-10 of each
block's largest entry (the closed-form Rodrigues against the matrix
exponential agree to rounding); a float32 solve's initial cost rtol
1e-5 (float32 pixels of ~700 px carry ~6e-5 px against ~1 px residuals)
and its final cost against the reference's float64 one, 1e-5 of the
decrease, the cell's limit on ``cost_gap`` (the readings at this size are
~1e-8; the float32 and TF32 control reads 3e-4); the flat against the slot layout, which sum the same
terms in another order, rtol 1e-3 of each step's largest entry, as
``test_torch_schur_cg.py`` holds a regrouped sum.
"""

import bz2
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ransac_tpu_torch.ba import bundle as tb
from ransac_tpu_torch.ba import schur_cg as sc
from ransac_tpu_torch.ba.bundle import BAProblem, host
from ransac_tpu_torch.io.bal import read_bal, write_bal
from ransac_tpu_torch.utils.config import BundleAdjustConfig
from ransac_tpu_torch.utils.logging import metrics
from tests.test_torch_schur_cg import synth_problem
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_ba", ROOT / "benchmark" / "lib" / "reference_ba.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "bal-venice1778.json").read_text())
SCENE, START = CONFIG["scene"], CONFIG["start"]
SEED = 2**31 + 2**30 + 777


def bal_problem(n_cam=16, n_pt=400, n_obs=1700, seed=SEED, start=0):
    """A seeded heavy-tailed BAL problem (tracks 2..n_cam) as a numpy
    ``BAProblem`` and the reference's parse of the same arrays."""
    truth = ref.make_problem(SCENE, n_cam, n_pt, n_obs, seed, "cpu")
    cams, pts = ref.make_start(truth, START, seed, start)
    p = BAProblem(cams.numpy(), pts.numpy(), None, truth["obs_cam"].numpy(),
                  truth["obs_pt"].numpy(), truth["obs_uv"].numpy(), np.ones(n_obs, np.float32))
    parsed = {"cameras": p.cameras.astype(np.float64), "points": p.points.astype(np.float64),
              "obs_cam": p.obs_cam, "obs_pt": p.obs_pt, "obs_uv": p.obs_uv.astype(np.float64)}
    return p, parsed


# ------------------------------------------------------------ io.bal
TWO_CAMERAS = """2 3 4
0 0 -385.989990 387.120000
1 0 -38.440000 492.120000
0 2 383.880000 -15.429999
1 1 1e2 -2.5E-1
0.0157 -0.0128 -0.0044
-0.0341 -0.1080 -1.2845
399.75 -3.177e-07 5.882e-13
1 2 3 4 5 6 7 8 9
-0.612 0.572 -1.847
1 2 3
4 5 6
"""


def test_a_hand_written_file_parses_to_known_arrays(tmp_path):
    path = tmp_path / "two.txt"
    path.write_text(TWO_CAMERAS)
    p = read_bal(str(path))
    np.testing.assert_array_equal(p.obs_cam, [0, 1, 0, 1])
    np.testing.assert_array_equal(p.obs_pt, [0, 0, 2, 1])
    np.testing.assert_array_equal(p.obs_uv, np.float32([[-385.98999, 387.12], [-38.44, 492.12],
                                                        [383.88, -15.429999], [100.0, -0.25]]))
    np.testing.assert_array_equal(p.cameras, np.float32(
        [[0.0157, -0.0128, -0.0044, -0.0341, -0.1080, -1.2845, 399.75, -3.177e-07, 5.882e-13],
         list(range(1, 10))]))
    np.testing.assert_array_equal(p.points, np.float32([[-0.612, 0.572, -1.847], [1, 2, 3],
                                                        [4, 5, 6]]))
    assert p.K is None and p.cameras.dtype == np.float32 and p.obs_cam.dtype == np.int64
    np.testing.assert_array_equal(p.obs_w, np.ones(4, np.float32))


@pytest.mark.parametrize("text", [TWO_CAMERAS.rsplit("\n", 2)[0] + "\n",       # a value short
                                  TWO_CAMERAS.replace("1 1 1e2", "1 3 1e2"),   # point 3 of 3
                                  TWO_CAMERAS.replace("0 2 383", "0.5 2 383")])
def test_a_malformed_file_is_refused(tmp_path, text):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError):
        read_bal(str(path))


@pytest.mark.parametrize("name", ["p.txt", "p.txt.bz2"])
def test_write_then_read_is_exact(tmp_path, name):
    p, _ = bal_problem()
    path = str(tmp_path / name)
    write_bal(path, p)
    if name.endswith(".bz2"):
        assert bz2.open(path, "rt").readline() == "16 400 1700\n"
    q = read_bal(path)
    for field, a, b in zip(BAProblem._fields, p, q):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(b, a, err_msg=field)
            assert b.dtype == a.dtype or field in ("obs_cam", "obs_pt"), field
    # The reference's own parser reads the same numbers (its float64 reading
    # of the 9 digits rounds to the same float32).
    text = bz2.open(path, "rt").read() if name.endswith(".bz2") else open(path).read()
    parsed = ref.parse_bal(text)
    for key in ("cameras", "points", "obs_uv"):
        np.testing.assert_array_equal(parsed[key].astype(np.float32), getattr(p, key), key)
    np.testing.assert_array_equal(parsed["obs_pt"], p.obs_pt)


# ------------------------------------------------------------ the BAL camera
def test_bal_projection_and_its_12_partials_match_the_reference():
    """float64: the program's residuals and its per-observation blocks
    (one ``jvp`` over 12 tangents) against the reference's matrix
    exponential and autograd Jacobians."""
    p, parsed = bal_problem(n_cam=8, n_pt=60, n_obs=200)
    rng = np.random.default_rng(5)
    cams = torch.tensor(parsed["cameras"])
    cams[:, :3] = torch.tensor(rng.normal(size=(8, 3)) * 0.8)       # rotations of all sizes
    cams[:, 7:] = torch.tensor(rng.normal(size=(8, 2)) * 0.05)
    pts = torch.tensor(parsed["points"])
    fp = sc.flat_from_ba_problem(p._replace(cameras=cams.numpy(), points=pts.numpy(),
                                            obs_uv=parsed["obs_uv"], obs_w=np.ones(200)))
    assert fp.cameras.dtype == fp.obs_uv.dtype == torch.float64
    r, Jc, Jp = sc._slot_blocks(fp, fp.cameras, fp.points, 0.0)
    pb = ref.problem_of(parsed, ref.REFERENCE, "cpu")
    R, dRdw = ref.rotation(cams[:, :3]), ref._dR_dw(cams[:, :3]).reshape(-1, 9, 3)
    r_ref, Jc_ref, Jp_ref = ref.linearize(pb, cams, pts, 0, 200, R, dRdw, ref.REFERENCE)
    assert Jc.shape == (9, 2, 200) and Jp.shape == (3, 2, 200)
    for got, want in ((r.T, r_ref), (Jc.permute(2, 1, 0), Jc_ref), (Jp.permute(2, 1, 0), Jp_ref)):
        scale = want.abs().amax(dim=tuple(range(1, want.dim())), keepdim=True)
        assert float(((got - want).abs() / scale).max()) <= 1e-10


def _solve_both(p, parsed, passes=5, cg_iters=24):
    tb.reset_counts()
    res = sc.bundle_adjust_cg(sc.flat_from_ba_problem(p),
                              BundleAdjustConfig(max_iters=passes, rtol=0.0),
                              cg_iters=cg_iters, device="cpu")
    pb = ref.problem_of(parsed, ref.REFERENCE, "cpu")
    r = ref.solve(pb, torch.tensor(parsed["cameras"]), torch.tensor(parsed["points"]), passes,
                  cg_iters, 1e-4)
    c64 = float(ref.cost(pb, res.cameras.double(), res.points.double()))
    return res, r, (c64 - r["cost"]) / (r["initial_cost"] - r["cost"])


def test_bundle_adjust_cg_on_a_bal_problem_matches_the_reference():
    """A heavy-tailed 9-parameter problem (16 cameras, 400 points, tracks
    2-16) in the flat layout: 5 passes reach the reference's float64 cost
    after its 5 passes, camera 0 unmoved."""
    p, parsed = bal_problem()
    res, r, gap = _solve_both(p, parsed)
    assert float(res.cost) < 0.2 * float(res.initial_cost)
    np.testing.assert_allclose(float(res.initial_cost), r["initial_cost"], rtol=1e-5)
    assert abs(gap) <= 1e-5, gap
    np.testing.assert_array_equal(res.cameras[0].numpy(), p.cameras[0])
    assert tb.COUNTS == {"passes": 5, "reads": 0}


def test_the_same_solve_with_k2_dropped_fails(monkeypatch):
    real = sc._project_bal_lanes

    def no_k2(cam9, X):
        return real(torch.cat([cam9[:8], torch.zeros_like(cam9[8:])]), X)

    monkeypatch.setattr(sc, "_project_bal_lanes", no_k2)
    p, parsed = bal_problem()
    _, _, gap = _solve_both(p, parsed)
    assert gap > 1e-5, gap      # the bound the sound solve keeps (7.5e-4 here)


# ------------------------------------------------------------ the two layouts
@pytest.mark.parametrize("seed,fix_first", [(0, True), (3, False), (5, True)])
def test_flat_and_slot_layouts_give_the_same_step(seed, fix_first):
    """On the existing 6-parameter problems: cost, blocks' sums and one
    Schur-CG step (dc, dp) of the two layouts agree."""
    _, tp = synth_problem(seed=seed)
    slots = sc.from_ba_problem(tp)
    flat = sc.flat_from_ba_problem(tp)
    assert flat.slots == int((slots.slot_w > 0).sum()) < slots.slots
    np.testing.assert_allclose(float(sc.slot_cost(flat, flat.cameras, flat.points)),
                               float(sc.slot_cost(slots, slots.cameras, slots.points)), rtol=1e-6)
    C = tp.cameras.shape[0]
    steps = []
    for q in (slots, flat):
        r, Jc, Jp = sc._slot_blocks(q, q.cameras, q.points, 0.0)
        steps.append(sc._schur_cg_step(q, r, Jc, Jp, torch.tensor(1e-3), C, fix_first, 24,
                                       dc_warm=torch.zeros_like(q.cameras)))
    for a, b in zip(*steps):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-3 * float(a.abs().max()))


def _from_ba_problem_loop(p, max_slots=None):
    """The slot packing as a loop over every observation (the form the
    vectorised ``from_ba_problem`` replaced)."""
    obs_pt, obs_cam, obs_uv, obs_w = host(p.obs_pt), host(p.obs_cam), host(p.obs_uv), host(p.obs_w)
    n_pt = int(p.points.shape[0])
    counts = np.zeros(n_pt, np.int64)
    live = obs_w > 0
    for q in obs_pt[live]:
        counts[q] += 1
    D = max(int(counts.max()) if max_slots is None else int(max_slots), 1)
    slot_cam = np.zeros((D, n_pt), np.int32)
    slot_uv = np.zeros((2, D, n_pt), np.float32)
    slot_w = np.zeros((D, n_pt), np.float32)
    fill = np.zeros(n_pt, np.int64)
    for o in np.where(live)[0]:
        q = obs_pt[o]
        d = fill[q]
        if d >= D:
            continue
        slot_cam[d, q] = obs_cam[o]
        slot_uv[:, d, q] = obs_uv[o]
        slot_w[d, q] = obs_w[o]
        fill[q] = d + 1
    return slot_cam, slot_uv, slot_w


def _shuffled_with_padding(p, seed):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(p.obs_cam))
    w = np.ones(len(order), np.float32)
    w[rng.random(len(order)) < 0.2] = 0.0
    return p._replace(obs_cam=p.obs_cam[order], obs_pt=p.obs_pt[order], obs_uv=p.obs_uv[order],
                      obs_w=w)


@pytest.mark.parametrize("case", ["synth0", "synth3", "bal", "bal_shuffled_padded"])
@pytest.mark.parametrize("max_slots", [None, 3])
def test_vectorised_slot_packing_equals_the_loop(case, max_slots):
    if case.startswith("synth"):
        _, p = synth_problem(seed=int(case[-1]))
    else:
        p, _ = bal_problem()
        if case == "bal_shuffled_padded":
            p = _shuffled_with_padding(p, 11)
    got = sc.from_ba_problem(p, max_slots)
    want = _from_ba_problem_loop(p, max_slots)
    for name, a, b in zip(("slot_cam", "slot_uv", "slot_w"), (got.slot_cam, got.slot_uv,
                                                              got.slot_w), want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


# ------------------------------------------------------------ spans and counters
def _spans_of_one_solve(fn):
    n0 = len(metrics.all())
    fn()
    recs = metrics.all()[n0:]
    (root,) = [r for r in recs if r["name"] == "bundle_adjust"]
    return root, recs


def test_a_solve_under_spans():
    """The root ``bundle_adjust``, its five children on every pass (the
    initial cost too under ``ba.cost``), ``ba.cg_iters`` = passes x
    cg_iters and ``ba.obs`` = passes x rows; no host sync in a float32
    run, and ``ba.done`` reads counted where a run can finish early."""
    p, _ = bal_problem()
    fp = sc.flat_from_ba_problem(p)
    root, recs = _spans_of_one_solve(lambda: sc.bundle_adjust_cg(
        fp, BundleAdjustConfig(max_iters=3, rtol=0.0), cg_iters=7, device="cpu"))
    assert root["parent"] is None and root["request"] == root["id"]
    kids = [r for r in recs if r["parent"] == root["id"]]
    names = [r["name"] for r in kids]
    for name in ("ba.linearize", "ba.assemble", "ba.pcg", "ba.backsub"):
        assert names.count(name) == 3, name
    assert names.count("ba.cost") == 4 and len(kids) == 16
    assert all(r["request"] == root["id"] for r in kids)
    c = root["counts"]
    assert (c["ba.passes"], c["ba.cg_iters"], c["ba.obs"], c["ba.reads"]) == (3, 21, 3 * 1700, 0)
    assert c["sync"] == 0

    p64 = p._replace(cameras=p.cameras.astype(np.float64), points=p.points.astype(np.float64),
                     obs_uv=p.obs_uv.astype(np.float64), obs_w=np.ones(1700))
    root, _ = _spans_of_one_solve(lambda: sc.bundle_adjust_cg(
        sc.flat_from_ba_problem(p64), BundleAdjustConfig(max_iters=12), cg_iters=7, device="cpu"))
    reads = root["counts"]["ba.reads"]
    assert reads >= 1 and root["counts"]["sync:ba.done"] == reads == root["counts"]["sync"]


def test_a_solve_inside_an_open_span_is_its_child():
    from ransac_tpu_torch.utils.logging import timed

    p, _ = bal_problem(n_cam=8, n_pt=60, n_obs=200)
    with timed("sfm.outer") as outer:
        sc.bundle_adjust_cg(sc.flat_from_ba_problem(p), BundleAdjustConfig(max_iters=1),
                            cg_iters=2, device="cpu")
    (ba,) = [r for r in metrics.all() if r["name"] == "bundle_adjust" and r["parent"] == outer.id]
    assert ba["request"] == outer.id


# ------------------------------------------------------------ cli ba
def test_cli_ba_on_a_tiny_file(tmp_path, capsys):
    from ransac_tpu_torch import cli

    p, _ = bal_problem(n_cam=8, n_pt=60, n_obs=200)
    src, out = str(tmp_path / "in.txt.bz2"), str(tmp_path / "out.txt")
    write_bal(src, p)
    assert cli.main(["ba", src, "--iters", "4", "--cg-iters", "8", "--device", "cpu",
                     "--out", out]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith("8 cameras, 60 points, 200 observations")
    c0 = float(lines[1].split()[-1])
    c1 = float(lines[2].split()[2])
    assert lines[2].endswith("after 4 LM passes") and c1 < 0.5 * c0
    q = read_bal(out)
    np.testing.assert_array_equal(q.obs_uv, p.obs_uv)
    np.testing.assert_array_equal(q.cameras[0], p.cameras[0])
    assert not np.array_equal(q.points, p.points)
    assert cli.main(["ba", str(tmp_path / "missing.txt"), "--device", "cpu"]) == 2
