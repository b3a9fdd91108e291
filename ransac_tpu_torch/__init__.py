"""ransac_tpu_torch — the PyTorch + CUDA port of ``ransac_tpu``.

The JAX package ``ransac_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``pipelines/``, ``io/``, ``utils/``,
``cli.py``) and its function names, and imports neither ``jax`` nor
anything under ``ransac_tpu``.  Plain tensor code is PyTorch; each Pallas
TPU kernel on the ported path is a CUDA kernel written by hand for Hopper
(``csrc/``), built with ``nvcc`` on first use.

Ported so far: the ``localize`` slice (CSV ingest and geodesy, the
458-candidate homography search on both routes, PnP-RANSAC with LM, the
location CSV) and its one kernel, ``ops.sweep_multi``.
"""

__version__ = "0.1.0"
