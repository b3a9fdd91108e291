"""BA PCG (``ba.schur_cg._pcg``: the matrix-free Schur operator's passes
over the observations, the block-Jacobi preconditioner): the device time
a traced request of the operations launched under the program's
``ba.pcg`` spans (the trace's ``device_s_by_span``, every path ending in
``ba.pcg``), ms."""

import ba_trace


def read(run):
    return ba_trace.device_ms(run, "ba.pcg")
