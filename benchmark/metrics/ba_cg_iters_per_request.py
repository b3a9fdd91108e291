"""BA PCG: PCG iterations launched a request (the program's
``ba.cg_iters`` counter on each request's root span), mean over the
window."""

import program_spans


def read(run):
    return program_spans.root_count(run, "ba.cg_iters")
