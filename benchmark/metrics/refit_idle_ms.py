"""Candidate search and PnP refits (``models/ransac``: the refits' seeds
and LMs): the device's idle time a traced request under the program's
``ransac.refit`` spans (the trace's idle stretches by the innermost span
at their middle, every path ending in ``ransac.refit``), ms."""


def read(run):
    t = run.trace
    if not t or not t.requests:
        return None
    idle = [s for path, s in t.idle_s_by_span.items()
            if path.rsplit("/", 1)[-1] == "ransac.refit"]
    return 1e3 * sum(idle) / t.requests if idle else None
