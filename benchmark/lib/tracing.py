"""Reading a torch.profiler trace of a few requests.

From the profiler's raw events (``kineto_results.events()``: building
``key_averages`` takes minutes on 10^5 kernels), as the repository's
``chip_smoke.trace_events`` reads them, copied here so that the yardstick
does not move: the device's operations, with the spans of
``record_function`` that the profiler also puts on the device's timeline
left out; the device's busy time as the union of its operations'
intervals; and each idle stretch of the device named by what the host was
doing in its middle (the innermost host operation then running).

The same operations and stretches are also named by the program's spans
(``by_span``): the ``record_function`` annotations that a span opens
under a profiler, on the host, nested as the program nests them.  An
operation counts under the innermost annotation around its launch (the
CUDA API call that shares its correlation id), so a kernel
that runs after its span has closed on the host still counts under it;
an idle stretch under the innermost annotation at its middle.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

#: Idle stretches shorter than this are summed under one name.
SHORT_GAP_NS = 10_000
TOP = 10
#: The name of work and idle outside any program span.
NO_SPAN = "(no span)"
#: The name of device operations whose launch the trace does not hold.
NO_LAUNCH = "(launch not traced)"
#: The names of host events that can launch device work: the CUDA API's
#: calls (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``,
#: ...), whose correlation ids are those of the device operations they
#: launch; a torch operation's id is of another count.
LAUNCH_PREFIX = "cu"


@dataclass
class Trace:
    requests: int
    window_s: float              # wall time of the traced requests
    busy_s: float                # union of the device's operation intervals
    ops: int                     # device operations (kernels, copies, sets)
    by_name: dict = field(default_factory=dict)   # name -> [count, seconds]
    idle_by_host: dict = field(default_factory=dict)  # host op -> seconds
    device_s_by_span: dict = field(default_factory=dict)  # span path -> busy seconds
    idle_s_by_span: dict = field(default_factory=dict)    # span path -> idle seconds

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
    corr, notes, launches = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            dev.append((start, start + dur))
            corr.append(ev.correlation_id())
            row = by_name.setdefault(ev.name()[:80], [0, 0.0])
            row[0] += 1
            row[1] += dur * 1e-9
        elif not ev.is_user_annotation():
            host.append((start, start + dur, ev.name()[:80]))
            if ev.name().startswith(LAUNCH_PREFIX):
                launches[ev.correlation_id()] = start
        else:
            notes.append((start, start + dur, ev.name()))
    ops = [(s, e, launches.get(c)) for (s, e), c in zip(dev, corr)]
    dev.sort()
    segments = _merge(dev)
    busy = sum(e - s for s, e in segments)
    device_s, idle_s = by_span(ops, notes)
    return Trace(requests, wall, busy * 1e-9, len(dev), by_name,
                 _idle_by_host(segments, host), device_s, idle_s)


def _merge(intervals) -> list:
    """The union of sorted (start, end) intervals as [start, end] segments."""
    segments = []
    for s, e in intervals:
        if segments and s <= segments[-1][1]:
            segments[-1][1] = max(segments[-1][1], e)
        else:
            segments.append([s, e])
    return segments


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


def by_span(ops, notes) -> tuple[dict, dict]:
    """({span path: busy seconds}, {span path: idle seconds}) of the device.

    ``ops`` are the device's operations as (start_ns, end_ns, launch_ns),
    ``launch_ns`` None where the launch is not known; ``notes`` the
    program's spans as (start_ns, end_ns, name) on the host.  A path joins
    the names of the spans around a moment, outermost first, with ``/``.
    Each operation counts under the path at its launch, and a path's busy
    seconds are the union of its operations' intervals, so over all paths
    they sum to the device's busy time where operations of different paths
    do not overlap (one stream).  Each idle stretch between the device's
    busy segments counts under the path at its middle."""
    path_at = _paths(notes)
    grouped: dict = {}
    for s, e, launch in ops:
        key = NO_LAUNCH if launch is None else path_at(launch)
        grouped.setdefault(key, []).append((s, e))
    device = {k: 1e-9 * sum(e - s for s, e in _merge(sorted(iv)))
              for k, iv in grouped.items()}
    idle: dict = {}
    segments = _merge(sorted((s, e) for s, e, _ in ops))
    for (_, e0), (s1, _) in zip(segments, segments[1:]):
        key = path_at(e0 + (s1 - e0) // 2)
        idle[key] = idle.get(key, 0.0) + (s1 - e0) * 1e-9
    return device, idle


def _paths(notes):
    """A function from a moment to the path of the spans around it."""
    notes = sorted(notes, key=lambda n: (n[0], -n[1]))
    starts = [n[0] for n in notes]
    parent, paths, stack = [], [], []
    for k, (s, e, name) in enumerate(notes):
        while stack and notes[stack[-1]][1] < e:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        paths.append(f"{paths[stack[-1]]}/{name}" if stack else name)
        stack.append(k)

    def path_at(t: int) -> str:
        k = bisect.bisect_right(starts, t) - 1
        while k >= 0 and notes[k][1] < t:
            k = parent[k]
        return paths[k] if k >= 0 else NO_SPAN

    return path_at
