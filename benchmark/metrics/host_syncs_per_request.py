"""Host-device syncs: the points at which a request's host waits for the
card's queue (device reads, blocking uploads, ops that check errors on the
host), the program's ``sync`` counter on each request's root span, mean
over the window."""

import program_spans


def read(run):
    return program_spans.root_count(run, "sync")
