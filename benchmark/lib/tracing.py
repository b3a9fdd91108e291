"""Reading a torch.profiler trace of a few requests.

From the profiler's raw events (``kineto_results.events()``: building
``key_averages`` takes minutes on 10^5 kernels), as the repository's
``chip_smoke.trace_events`` reads them, copied here so that the yardstick
does not move: the device's operations, with the spans of
``record_function`` that the profiler also puts on the device's timeline
left out; the device's busy time as the union of its operations'
intervals; and each idle stretch of the device named by what the host was
doing in its middle (the innermost host operation then running).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

#: Idle stretches shorter than this are summed under one name.
SHORT_GAP_NS = 10_000
TOP = 10


@dataclass
class Trace:
    requests: int
    window_s: float              # wall time of the traced requests
    busy_s: float                # union of the device's operation intervals
    ops: int                     # device operations (kernels, copies, sets)
    by_name: dict = field(default_factory=dict)   # name -> [count, seconds]
    idle_by_host: dict = field(default_factory=dict)  # host op -> seconds

    def breakdown(self) -> dict:
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in
                               top({k: s for k, (_, s) in self.by_name.items()})],
                "idle_gaps": [[k, v] for k, v in top(self.idle_by_host)]}


def traced(fn, inputs, cuda: bool = True) -> tuple[list, Trace]:
    """Run ``fn`` on each input under torch.profiler, ending in a
    synchronize; returns (outputs, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        outs = [fn(x) for x in inputs]
        sync()
        wall = time.perf_counter() - t0
    return outs, read(prof, len(inputs), wall)


def read(prof, requests: int, wall: float) -> Trace:
    dev, host, by_name = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            dev.append((start, start + dur))
            row = by_name.setdefault(ev.name()[:80], [0, 0.0])
            row[0] += 1
            row[1] += dur * 1e-9
        elif not ev.is_user_annotation():
            host.append((start, start + dur, ev.name()[:80]))
    dev.sort()
    busy, segments = 0, []
    for s, e in dev:
        if segments and s <= segments[-1][1]:
            segments[-1][1] = max(segments[-1][1], e)
        else:
            segments.append([s, e])
    busy = sum(e - s for s, e in segments)
    return Trace(requests, wall, busy * 1e-9, len(dev), by_name,
                 _idle_by_host(segments, host))


def _idle_by_host(segments, host) -> dict:
    """Seconds of the device's idle stretches between its busy segments, by
    the innermost host operation running at each stretch's middle."""
    host.sort()
    starts = [h[0] for h in host]
    out: dict = {}
    for (_, e0), (s1, _) in zip(segments, segments[1:]):
        gap = s1 - e0
        if gap < SHORT_GAP_NS:
            name = f"(stretches under {SHORT_GAP_NS // 1000} us)"
        else:
            mid = e0 + gap // 2
            name = "(python between host operations)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 200, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
        out[name] = out.get(name, 0.0) + gap * 1e-9
    return out
