"""Candidate search's refit (``models/ransac.refit_homography``: the
458-batch weighted DLT and the homography LM): the mean a request of the
program's ``ransac.refit`` spans under ``localize.search``, ms."""

import program_spans


def read(run):
    return program_spans.span_ms(run, "ransac.refit", under="localize.search")
