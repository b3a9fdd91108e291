"""LM (``ops/lm``): passes of the LM loops a request, the program's
``lm.passes`` counter on each request's root span, mean over the window."""

import program_spans


def read(run):
    return program_spans.root_count(run, "lm.passes")
