"""Device: the share of the traced requests' wall time in which no
operation ran on the card, %."""


def read(run):
    t = run.trace
    if not t or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
