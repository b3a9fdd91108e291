"""The program's spans and counted host syncs (``utils/logging``): one
planted ``localize`` and one ``pixel_to_geo`` request on the CPU, each a
tree of spans with the names, parents and nesting of the port's layers,
their counters equal to the modules' own, their syncs equal to the sites
the request passes, and each span an annotation of torch.profiler's trace
on its clock.  The ``cuda`` test holds the sync count to
``torch.cuda.set_sync_debug_mode`` on the card.
"""

import warnings

import numpy as np
import pytest
import torch

from ransac_tpu_torch.io import tables
from ransac_tpu_torch.io.dem import center_elevations, load_geotiff, resample_to_utm
from ransac_tpu_torch.io.synthetic import write_planted_dem, write_planted_scene
from ransac_tpu_torch.ops import lm
from ransac_tpu_torch.pipelines import raycast
from ransac_tpu_torch.pipelines.localize import localize
from ransac_tpu_torch.utils.logging import (EPOCH_OFFSET_NS, SYNCS, host_sync,
                                            metrics, timed)
from torch_threads import one_torch_thread  # noqa: F401

#: Each request's spans: name -> the name of its parent.
TREES = {
    "localize": {"localize": None, "localize.search": "localize",
                 "ransac.fit": ("localize.search", "localize.pnp"),
                 "ransac.refit": ("localize.search", "localize.pnp"),
                 "localize.pnp": "localize"},
    "pixel_to_geo": {"pixel_to_geo": None, "geo.rays": "pixel_to_geo",
                     "geo.march": "pixel_to_geo", "geo.march_setup": "geo.march"},
}
#: The host syncs of an engine-route ``localize`` request, by site.
LOCALIZE_SITES = {"sample_is_degenerate": 2, "localize.best_err2": 1,
                  "localize.search": 7, "localize.best_location": 1,
                  "intrinsics_from_physical": 1, "epnp.eigh": 1,
                  "localize.pnp_inliers": 1, "localize.pose": 3, "localize.K": 1}
PIXELS = np.random.default_rng(0).uniform([0.0, 0.0], [2142.0, 1620.0], (21, 2))


def _process_counts():
    return {"sync": SYNCS["sync"], "lm.passes": lm.COUNTS["passes"],
            "raycast.trips": raycast.COUNTS["trips"]}


def _request(call):
    """(the request's span records, the process counters' deltas) of one
    ``call``, after a warm one."""
    call()
    before = _process_counts()
    call()
    delta = {k: v - before[k] for k, v in _process_counts().items()}
    request = metrics.all()[-1]["request"]
    return [r for r in metrics.all() if r.get("request") == request], delta


def _planted(directory, device):
    ps = write_planted_scene(directory, seed=0)
    scene = tables.build_scene(
        tables.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y),
        tables.read_camera_locations(ps.cameras_csv), device=device)
    return ps, scene


def _inverter(directory, ps, scene, res, device):
    tif, _ = write_planted_dem(directory, ps)
    dem = center_elevations(resample_to_utm(load_geotiff(tif), scene.frame,
                                            spacing_m=10.0))
    return raycast.localized_inverter(scene, res, dem, device=device)


@pytest.fixture(scope="module")
def requests_(tmp_path_factory):
    """{root name: (spans, counter deltas)} and the two calls."""
    d = tmp_path_factory.mktemp("tracing")
    ps, scene = _planted(d, "cpu")
    res = localize(scene, ps.image_size, device="cpu")
    inv = _inverter(d, ps, scene, res, "cpu")
    calls = {"localize": lambda: localize(scene, ps.image_size, device="cpu"),
             "pixel_to_geo": lambda: inv.pixel_to_geo(PIXELS)}
    return {k: _request(c) for k, c in calls.items()}, calls


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


@pytest.mark.parametrize("root", list(TREES))
def test_a_request_is_one_tree_of_the_layers_spans(requests_, root):
    spans, _ = requests_[0][root]
    by_id = {s["id"]: s for s in spans}
    tree = TREES[root]
    (top,) = [s for s in spans if s["parent"] is None]
    assert top["name"] == root and all(s["request"] == top["id"] for s in spans)
    names = _by_name(spans)
    assert set(names) == set(tree)
    if root == "localize":  # a fit and a refit in each of search and PnP
        assert sorted(by_id[s["parent"]]["name"] for s in names["ransac.refit"]) == [
            "localize.pnp", "localize.search"]
        assert len(names["ransac.fit"]) == 2
    for s in spans:
        assert s["profiled"] is False and s["unit"] == "s"
        assert s["end_ns"] >= s["start_ns"]
        assert s["value"] == pytest.approx((s["end_ns"] - s["start_ns"]) * 1e-9, abs=1e-9)
        if s["parent"] is None:
            continue
        parent = by_id[s["parent"]]
        want = tree[s["name"]]
        assert parent["name"] in (want if isinstance(want, tuple) else (want,))
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    for s in spans:  # self time: the span less its children
        kids = [c for c in spans if c["parent"] == s["id"]]
        assert s["value"] - sum(c["value"] for c in kids) >= 0, s["name"]


@pytest.mark.parametrize("root,span,key", [
    ("localize", "localize", "lm.passes"),
    ("pixel_to_geo", "geo.march", "raycast.trips"),
    ("pixel_to_geo", "pixel_to_geo", "raycast.trips"),
])
def test_span_counts_are_the_module_counters_deltas(requests_, root, span, key):
    spans, delta = requests_[0][root]
    (s,) = [s for s in spans if s["name"] == span]
    assert s["counts"][key] == delta[key] > 0


@pytest.mark.parametrize("root", list(TREES))
def test_the_sync_count_is_the_sites_the_request_passes(requests_, root):
    spans, delta = requests_[0][root]
    (top,) = [s for s in spans if s["parent"] is None]
    sites = {k[5:]: v for k, v in top["counts"].items() if k.startswith("sync:")}
    want = LOCALIZE_SITES if root == "localize" else {
        "geo.upload": 2, "raycast.read": top["counts"]["raycast.reads"], "geo.answer": 2}
    assert sites == want
    assert top["counts"]["sync"] == sum(want.values()) == delta["sync"]
    assert top["counts"]["sync_wait_ns"] > 0
    for s in spans:  # a child's syncs are part of its parent's
        kids = [c for c in spans if c["parent"] == s["id"]]
        assert sum(c["counts"]["sync"] for c in kids) <= s["counts"]["sync"]


def test_search_and_pnp_keep_their_seconds(requests_):
    spans, _ = requests_[0]["localize"]
    names = _by_name(spans)
    (top,) = names["localize"]
    for name in ("localize.search", "localize.pnp"):
        (s,) = names[name]
        assert set(s) >= {"name", "value", "unit"} and s["unit"] == "s"
        assert 0 < s["value"] < top["value"] < 60  # seconds, not ns or ms


def test_host_sync_counts_n_on_the_root_outside_and_inside_spans():
    s0 = SYNCS["sync"]
    with host_sync("outside", n=2):
        pass
    with timed("tracing.root") as root:
        with timed("tracing.child"):
            with host_sync("inside", n=3):
                pass
    rec = [r for r in metrics.all("tracing.root") if r["id"] == root.id][0]
    child = [r for r in metrics.all("tracing.child") if r["parent"] == root.id][0]
    assert SYNCS["sync"] - s0 == 5
    assert rec["counts"]["sync"] == child["counts"]["sync"] == 3
    assert rec["counts"]["sync:inside"] == 3 and "sync:inside" not in child["counts"]
    assert "sync:outside" not in rec["counts"]


@pytest.mark.parametrize("root", list(TREES))
def test_spans_are_annotations_of_the_profilers_trace(requests_, root):
    from torch.profiler import ProfilerActivity, profile

    call = requests_[1][root]
    # A process's first annotation pays the profiler's set-up after its
    # stamp (~0.9 ms on the CPU): one throwaway span takes it.
    with profile(activities=[ProfilerActivity.CPU]), timed("tracing.warm"):
        pass
    n0 = len(metrics.all())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans = [r for r in metrics.all()[n0:] if r.get("profiled")]
    assert {s["name"] for s in spans} == set(TREES[root])
    notes = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            notes.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    note_of = {}
    for s in spans:
        start = min(notes[s["name"]], key=lambda n: abs(n[0] - s["start_ns"]))
        assert abs(start[0] - s["start_ns"]) < 1_000_000, s["name"]
        note_of[s["id"]] = start
    for s in spans:  # nested as the program nests them
        if s["parent"] is not None:
            (ps, pe), (cs, ce) = note_of[s["parent"]], note_of[s["id"]]
            assert ps <= cs <= ce <= pe, s["name"]
    assert EPOCH_OFFSET_NS > 0


@pytest.mark.cuda
@pytest.mark.parametrize("root", list(TREES))
def test_sync_debug_mode_sees_the_counted_syncs(tmp_path, root):
    """On the card, one warm request of each path: the synchronizing
    operations that ``torch.cuda.set_sync_debug_mode("warn")`` reports
    are the request's counted ``sync``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ps, scene = _planted(tmp_path, "cuda")
    res = localize(scene, ps.image_size, device="cuda")
    if root == "localize":
        def call():
            localize(scene, ps.image_size, device="cuda")
    else:
        inv = _inverter(tmp_path, ps, scene, res, "cuda")

        def call():
            inv.pixel_to_geo(PIXELS)
    call()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        # The mode's one-time notice that it is a prototype comes here.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            call()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    warned = [w for w in seen if "synchroniz" in str(w.message).lower()]
    top = metrics.all(root)[-1]
    assert len(warned) == top["counts"]["sync"] > 0, (
        [f"{w.filename}:{w.lineno}" for w in warned], top["counts"])
