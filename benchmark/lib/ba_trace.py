"""Reading a ``bundle_adjust`` cell's traced requests: device time by the
program's BA spans, and the traced requests' root spans."""

from __future__ import annotations


def device_ms(run, span: str):
    """Device time a traced request of the operations launched under the
    spans ``span`` (every path of ``device_s_by_span`` ending in it), ms;
    None where the trace has none."""
    t = run.trace
    if not t or not t.requests:
        return None
    found = [s for path, s in t.device_s_by_span.items() if path.rsplit("/", 1)[-1] == span]
    return 1e3 * sum(found) / t.requests if found else None


def traced_roots(run):
    """The traced requests' root spans (the last ``trace.requests`` roots
    named after the mix's kind that ran under the profiler), or None."""
    t = run.trace
    kind = run.traffic.get("kind")
    if not t or not t.requests or not kind:
        return None
    from ransac_tpu_torch.utils.logging import metrics

    roots = [r for r in metrics.all() if r["name"] == kind and r.get("parent") is None
             and r.get("profiled") is True]
    return roots[-t.requests:] if len(roots) >= t.requests else None
