"""Host-device syncs: the host's time blocked in them a request, the
program's ``sync_wait_ns`` counter on each request's root span, mean over
the window, ms."""

import program_spans


def read(run):
    return program_spans.root_count(run, "sync_wait_ns", scale=1e-6)
