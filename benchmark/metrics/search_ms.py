"""Candidate search (``pipelines/localize.score_candidates[_sweep]``,
``models/ransac``, ``ops/sweep_multi``): the mean of the program's
``localize.search`` span over the window's requests, ms.  The span ends in
the search's device read, so it covers the device work it waited for."""


def read(run):
    spans = run.spans.get("localize.search")
    return 1e3 * sum(spans) / len(spans) if spans else None
