"""Device time and idle by program span (``lib/tracing.by_span``), on
hand-made intervals, and through ``tracing.read`` on hand-made profiler
events: the CPU cannot trace a card.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE / "lib")]

import tracing  # noqa: E402

#: A request's spans on the host (ns): search with its refit, then PnP
#: with its refit, under the root; nothing runs in a span after 300.
NOTES = [(0, 300, "localize"), (10, 100, "localize.search"), (60, 90, "ransac.refit"),
         (120, 280, "localize.pnp"), (200, 260, "ransac.refit")]
SEARCH_REFIT = "localize/localize.search/ransac.refit"
PNP = "localize/localize.pnp"
PNP_REFIT = "localize/localize.pnp/ransac.refit"


def busy_and_idle(ops):
    segments = tracing._merge(sorted((s, e) for s, e, _ in ops))
    busy = sum(e - s for s, e in segments) * 1e-9
    return busy, [(s1 - e0) * 1e-9 for (_, e0), (s1, _) in zip(segments, segments[1:])]


def test_a_kernel_counts_under_the_innermost_span_of_its_launch():
    ops = [(70, 80, 65), (130, 140, 125), (210, 230, 205), (20, 25, 15)]
    device, _ = tracing.by_span(ops, NOTES)
    assert device == pytest.approx({SEARCH_REFIT: 10e-9, PNP: 10e-9, PNP_REFIT: 20e-9,
                                    "localize/localize.search": 5e-9})


def test_a_kernel_launched_outside_any_span_counts_under_no_span():
    device, _ = tracing.by_span([(400, 420, 350), (410, 430, 310), (5, 8, None)], NOTES)
    assert device == pytest.approx({tracing.NO_SPAN: 30e-9, tracing.NO_LAUNCH: 3e-9})


def test_a_kernel_that_runs_after_its_span_closed_counts_under_it():
    device, idle = tracing.by_span([(95, 150, 85), (400, 500, 255)], NOTES)
    assert device == pytest.approx({SEARCH_REFIT: 55e-9, PNP_REFIT: 100e-9})
    assert idle == pytest.approx({PNP: 250e-9})  # the stretch's middle, 275


OPS = [(12, 30, 11), (25, 40, 20), (61, 64, 61), (66, 90, 65), (95, 98, 92),
       (130, 131, 125), (150, 170, 140), (210, 212, 205), (214, 240, 212),
       (250, 290, 258), (295, 330, 299), (340, 350, 320)]


def test_busy_over_all_paths_sums_to_the_devices_busy_time():
    device, _ = tracing.by_span(OPS, NOTES)
    busy, _ = busy_and_idle(OPS)
    assert sum(device.values()) == pytest.approx(busy, rel=1e-12)
    assert device[PNP_REFIT] == pytest.approx((2 + 26 + 40) * 1e-9)
    assert device["localize/localize.search"] == pytest.approx((40 - 12 + 3) * 1e-9)


def test_idle_over_all_paths_sums_to_the_idle_stretches():
    _, idle = tracing.by_span(OPS, NOTES)
    _, gaps = busy_and_idle(OPS)
    assert sum(idle.values()) == pytest.approx(sum(gaps), rel=1e-12)
    # Stretches 40-61, 64-66, 90-95 (its middle past the refit's end),
    # 98-130, 131-150, 170-210, 212-214, 240-250, 290-295, 330-340.
    assert idle == pytest.approx({"localize/localize.search": 21e-9 + 5e-9, SEARCH_REFIT: 2e-9,
                                  "localize": 32e-9 + 5e-9, PNP: 19e-9 + 40e-9,
                                  PNP_REFIT: 2e-9 + 10e-9, tracing.NO_SPAN: 10e-9})


@dataclass
class Event:
    """What ``tracing.read`` reads of a profiler event."""

    name_: str
    start: int
    end: int
    kind: str           # where it ran: "host", "card", "note", "card_note"
    corr: int = 0

    def name(self):
        return self.name_

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def correlation_id(self):
        return self.corr

    def device_type(self):
        on_card = self.kind.startswith("card")
        return torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.kind.endswith("note")


class Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()


def test_read_finds_each_launch_by_its_correlation_id():
    """Kernels join their runtime launch by correlation id (not a host
    op's id that happens to equal it); the device's copies of the spans
    are left out; the other fields read as before."""
    events = [Event(n, s, e, "note") for s, e, n in NOTES]
    events += [Event("ransac.refit", 210, 260, "card_note"),
               Event("aten::mm", 60, 70, "host", corr=7),
               Event("cudaLaunchKernel", 61, 63, "host", corr=7),
               Event("cudaMemcpyAsync", 205, 206, "host", corr=8),
               Event("aten::copy_", 255, 258, "host", corr=9),
               Event("cuLaunchKernel", 310, 312, "host", corr=9),
               Event("gemm", 70, 80, "card", corr=7),
               Event("Memcpy HtoD", 220, 250, "card", corr=8),
               Event("late", 330, 340, "card", corr=9),
               Event("orphan", 345, 346, "card", corr=10)]
    t = tracing.read(Profile(events), 1, 1e-6)
    assert t.ops == 4 and t.busy_s == pytest.approx(51e-9)
    assert t.device_s_by_span == pytest.approx({SEARCH_REFIT: 10e-9, PNP_REFIT: 30e-9,
                                                tracing.NO_SPAN: 10e-9,
                                                tracing.NO_LAUNCH: 1e-9})
    assert t.idle_s_by_span == pytest.approx({PNP: 140e-9, "localize": 80e-9,
                                              tracing.NO_SPAN: 5e-9})
    assert sum(t.idle_s_by_span.values()) == pytest.approx(sum(t.idle_by_host.values()))
    assert set(t.by_name) == {"gemm", "Memcpy HtoD", "late", "orphan"}
