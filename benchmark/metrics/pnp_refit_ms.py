"""PnP's refit (``models/ransac._pnp_refit``: the DLT-PnP and EPnP seeds,
their MSAC, the pose LM): the mean a request of the program's
``ransac.refit`` spans under ``localize.pnp``, ms."""

import program_spans


def read(run):
    return program_spans.span_ms(run, "ransac.refit", under="localize.pnp")
