"""Host dispatch: the device operations (kernels, copies, sets; the
profiler's annotation spans left out) of the traced requests, a request."""


def read(run):
    t = run.trace
    return t.ops / t.requests if t and t.ops else None
