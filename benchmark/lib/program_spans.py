"""Reading the program's spans (``ransac_tpu_torch.utils.logging``: each
``timed`` block's record in its ``metrics`` registry, with ``id``,
``parent``, ``request``, ``profiled`` and ``counts``) over a run's window.

The window's requests are the last ``run.requests`` root spans named after
the mix's kind (``localize``, ``pixel_to_geo``) that ran with no profiler
on: that leaves out a cell's set-up (the DEM cell's ``localize``), the warm
requests before the window and the traced requests after it.  Each reader
returns None where there are fewer such roots, or none at all: a program
whose spans carry no request ids reads nothing.
"""

from __future__ import annotations


def requests(run):
    """[(root, [its spans])] of the window's requests, or None."""
    kind = run.traffic.get("kind")
    if not run.requests or not kind:
        return None
    from ransac_tpu_torch.utils.logging import metrics

    records = metrics.all()
    roots = [r for r in records if r["name"] == kind and "request" in r
             and r.get("parent") is None and r.get("profiled") is False]
    if len(roots) < run.requests:
        return None
    roots = roots[len(roots) - run.requests:]
    spans = {r["id"]: [] for r in roots}
    for r in records:
        if r.get("request") in spans:
            spans[r["request"]].append(r)
    return [(root, spans[root["id"]]) for root in roots]


def _under(span, ancestor: str, by_id: dict) -> bool:
    p = by_id.get(span["parent"])
    while p is not None:
        if p["name"] == ancestor:
            return True
        p = by_id.get(p["parent"])
    return False


def span_ms(run, name: str, under: str):
    """Mean a request of the summed seconds of the spans ``name`` that lie
    under a span ``under``, in ms; None where no request has one."""
    reqs = requests(run)
    if not reqs:
        return None
    total, found = 0.0, False
    for _, spans in reqs:
        by_id = {s["id"]: s for s in spans}
        for s in spans:
            if s["name"] == name and _under(s, under, by_id):
                total += s["value"]
                found = True
    return 1e3 * total / len(reqs) if found else None


def root_count(run, key: str, scale: float = 1.0):
    """Mean a request of the root's ``counts[key]``, times ``scale``."""
    reqs = requests(run)
    if not reqs or any(key not in root["counts"] for root, _ in reqs):
        return None
    return scale * sum(root["counts"][key] for root, _ in reqs) / len(reqs)
