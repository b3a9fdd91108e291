"""BA linearize (``ba.schur_cg._slot_blocks``: residuals and the per-
observation Jacobian blocks by one ``jvp`` under ``vmap``): the device
time a traced request of the operations launched under the program's
``ba.linearize`` spans, ms."""

import ba_trace


def read(run):
    return ba_trace.device_ms(run, "ba.linearize")
