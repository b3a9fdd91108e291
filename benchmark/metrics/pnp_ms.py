"""PnP (``models/ransac.ransac_pnp``, ``ops/pnp``, ``ops/lm``): the mean of
the program's ``localize.pnp`` span over the window's requests, ms.  The
span ends in the pose's device read."""


def read(run):
    spans = run.spans.get("localize.pnp")
    return 1e3 * sum(spans) / len(spans) if spans else None
