"""Structured logging (the logger of ``ransac_tpu.utils.logging`` under
the ``ransac_tpu_torch`` name), the program's spans and its counted host
syncs.

**Spans.** Every ``timed`` block is a span, recorded in ``metrics`` when it
closes: ``name``, ``value`` (seconds), ``unit`` and the block's tags, plus

- ``id``; ``parent``, the id of the enclosing open span (None at a root);
  ``request``, the id of the outermost open span: a span opened with none
  open starts a request;
- ``start_ns`` / ``end_ns``: ``time.perf_counter_ns()`` shifted by
  ``EPOCH_OFFSET_NS`` onto the Unix-epoch nanoseconds of torch.profiler's
  events;
- ``profiled``: a torch profiler was on at the span's start.  The span then
  also opens ``torch.profiler.record_function(name)``, so it sits on the
  trace's clock nested as the program nests it (with no profiler on, it
  is not entered: it costs far more than the check);
- ``counts``: the deltas over the span of every registered process counter
  (``register_counters``: ``sync``, ``sync_wait_ns``, ``lm.*``,
  ``raycast.*``, and once ``ba`` is imported ``ba.passes``, ``ba.reads``,
  ``ba.cg_iters``, ``ba.obs``); a root's also holds ``sync:<site>``, its syncs by site.

Spans are always recorded; the open spans are per process (the port's host
work is one thread).

**Host syncs.** Each point at which the host waits for the device's queue
(``.cpu()``, ``.item()``, ``.tolist()``, ``bool()`` / ``int()`` of a device
tensor, a blocking host-to-device copy, an op that checks its errors on the
host) runs inside ``host_sync(site, n)``, which adds ``n`` to ``SYNCS["sync"]``
and the host nanoseconds spent in the block to ``SYNCS["sync_wait_ns"]``.
A site counts where the program passes it, on any device.
"""

from __future__ import annotations

import logging
import sys
import time
from itertools import chain, count
from operator import sub
from typing import Any, Dict

import torch

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"

#: ``time.perf_counter_ns() + EPOCH_OFFSET_NS`` is Unix-epoch nanoseconds,
#: the clock of torch.profiler's (kineto's) event stamps.
EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

#: Host syncs in this process (``host_sync``): how many, and the host
#: nanoseconds spent waiting in them.
SYNCS = {"sync": 0, "sync_wait_ns": 0}


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"ransac_tpu_torch.{name}")
    if not logging.getLogger("ransac_tpu_torch").handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("ransac_tpu_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logger


class Metrics:
    """Append-only registry of span records.  A closed span leaves its raw
    readings here; reading the registry makes them records, so that the
    span itself only reads the clock and the counters."""

    def __init__(self) -> None:
        self._records: list = []
        self._settled = 0  # the entries before this index are records

    def all(self, name: str | None = None) -> list[Dict[str, Any]]:
        recs = self._records
        for i in range(self._settled, len(recs)):
            recs[i] = _span_record(*recs[i])
        self._settled = len(recs)
        if name is None:
            return list(recs)
        return [r for r in recs if r["name"] == name]


metrics = Metrics()

# The registered counters as (names, live values views of their dicts),
# replaced (never mutated) on registration, so that a span diffs the same
# entries it read at its start.
_counters: tuple = ((), ())
_open: list = []          # the open spans, outermost first
_ids = count(1)
_now = time.perf_counter_ns
_profiler_on = torch._C._autograd._profiler_enabled


def register_counters(prefix: str, counts: dict) -> None:
    """Carry each key of the process counter dict ``counts`` (its keys
    fixed, its values kept and reset in place by its module) in every
    span's ``counts`` as ``<prefix>.<key>``, or ``<key>`` with an empty
    prefix."""
    global _counters
    names, views = _counters
    new = tuple(f"{prefix}.{k}" if prefix else k for k in counts)
    _counters = (names + new, views + (counts.values(),))


register_counters("", SYNCS)


class timed:
    """A span of the block under ``name`` (the module's docstring), with
    ``tags`` in its record in ``registry``."""

    __slots__ = ("name", "registry", "tags", "id", "parent", "request",
                 "sites", "counters", "c0", "t0", "fn")

    def __init__(self, name: str, registry: Metrics = metrics, **tags: Any):
        self.name, self.registry, self.tags = name, registry, tags

    def __enter__(self):
        self.id = i = next(_ids)
        if _open:
            outer = _open[-1]
            self.parent, self.request, self.sites = outer.id, outer.request, None
        else:
            self.parent, self.request, self.sites = None, i, {}
        _open.append(self)
        self.fn = None
        if _profiler_on():
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.counters = _counters
        self.c0 = tuple(chain(*_counters[1]))
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        c1 = tuple(chain(*self.counters[1]))
        if self.fn is not None:
            self.fn.__exit__(*exc)
        _open.pop()
        self.registry._records.append((self, t1, c1))
        return False


def _span_record(span: timed, t1: int, c1: tuple) -> dict:
    counts = dict(zip(span.counters[0], map(sub, c1, span.c0)))
    if span.sites:
        counts.update(span.sites)
    t0 = span.t0
    return {"name": span.name, "value": (t1 - t0) * 1e-9, "unit": "s",
            "id": span.id, "parent": span.parent, "request": span.request,
            "start_ns": t0 + EPOCH_OFFSET_NS, "end_ns": t1 + EPOCH_OFFSET_NS,
            "profiled": span.fn is not None, "counts": counts, **span.tags}


class host_sync:
    """``with host_sync(site, n):`` around ``n`` host waits for the device
    (the module's docstring): counted in ``SYNCS`` and, by ``site``, on the
    open request's root."""

    __slots__ = ("site", "n", "t0")

    def __init__(self, site: str, n: int = 1):
        self.site, self.n = site, n

    def __enter__(self):
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        SYNCS["sync_wait_ns"] += _now() - self.t0
        SYNCS["sync"] += self.n
        if _open:
            key = "sync:" + self.site
            sites = _open[0].sites
            sites[key] = sites.get(key, 0) + self.n
        return False
