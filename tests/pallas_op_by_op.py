"""Run a Pallas kernel body op by op, without XLA's fusion.

An interpreted Pallas kernel of the JAX package runs as one XLA program,
and XLA's CPU backend contracts ``a * b + c`` into fused multiply-adds
inside it.  Called under ``jax.disable_jit()`` on array-backed refs, the
same kernel body runs one operation at a time: each is its own XLA
computation and rounds on its own, as the port's plain versions do.
``run_kernel`` calls the body once per grid step, with ``pl.program_id``
and ``pltpu.bitcast`` swapped (through ``monkeypatch``) for their plain
counterparts; the JAX package itself is unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu


class ArrayRef:
    """A kernel ref backed by a numpy array: reads give jnp arrays, writes
    store into the array."""

    def __init__(self, a):
        self.a = np.array(a)

    def __getitem__(self, index):
        return jnp.asarray(self.a[index])

    def __setitem__(self, index, value):
        self.a[index] = np.asarray(value)


def run_kernel(monkeypatch, kernel, n_blocks, inputs, out_shapes):
    """Outputs of ``kernel`` over a 1-D grid of ``n_blocks`` steps, each
    output's per-step blocks joined along its last axis.  ``inputs`` are
    arrays, ``out_shapes`` the (shape, dtype) of each output block."""
    block = [0]
    monkeypatch.setattr(pl, "program_id", lambda axis: jnp.int32(block[0]))
    monkeypatch.setattr(pltpu, "bitcast",
                        lambda x, dtype: jax.lax.bitcast_convert_type(x, dtype))
    per_block = []
    for b in range(n_blocks):
        block[0] = b
        outs = [ArrayRef(np.zeros(shape, dtype)) for shape, dtype in out_shapes]
        with jax.disable_jit():
            kernel(*(ArrayRef(a) for a in inputs), *outs)
        per_block.append([o.a for o in outs])
    return [np.concatenate(parts, -1) for parts in zip(*per_block)]
