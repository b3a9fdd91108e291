"""ransac_tpu_torch — the PyTorch + CUDA port of ``ransac_tpu``.

The JAX package ``ransac_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``pipelines/``, ``io/``, ``utils/``,
``cli.py``, ``bench.py``) and its function names, and imports neither
``jax`` nor anything under ``ransac_tpu``.  Plain tensor code is PyTorch;
each Pallas TPU kernel on the ported paths is a CUDA kernel written by
hand for Hopper (``csrc/``), built with ``nvcc`` on first use.

Ported so far: the ``localize`` slice (CSV ingest and geodesy, the
458-candidate homography search on both routes, PnP-RANSAC with LM, the
location CSV), the random-sampling engine branch (``utils.prng``), the
fused sweeps ``ransac_homography_sweep`` and ``ransac_pnp_sweep`` for
pools of any size, the headline ``bench``, and the two-view slice
(``pipelines.twoview``, ``ransac_essential``, ``ransac_essential_sweep``),
``cli profile`` (``profile``, ``utils.profiling``), ``localize --report``
(``analytics``, ``viz``, ``io.export``) and the DEM geo-inversion
(``io.tiff``, ``io.dem``, ``pipelines.raycast``: ``localize --dem``); kernels
``ops.sweep_multi``, ``ops.sweep``, ``ops.score`` (homography and PnP),
``ops.sweep_pnp``, ``ops.sweep_essential``, ``ops.sweep_large``,
``ops.sweep_pnp_large``, ``ops.sweep_essential_large`` and the roofline
probes ``ops.roofline``: every Pallas kernel of the JAX package.  Then
calibration (``models.calibration``, ``features.chessboard``,
``pipelines.intrinsics_search``), bundle adjustment (``ba``: dense and
matrix-free CG Schur, SE(3) / Sim(3) pose graphs, ``ba.bench``) and
incremental SfM (``pipelines.sfm``, ``cli sfm``), loop closure
(``pipelines.loop_closure``), the multi-frame demo (``pipelines.sfm_demo``,
``cli sfm --demo / --loop``) with its keyframe front end
(``parallel.sharded_frontend``), and the native CSV reader
(``io.native``) with the ``planar`` schema of ``io.tables``.  Last, the
multi-device paths on ``torch.distributed`` (``parallel.mesh``,
``parallel.multihost``, ``parallel.sharded_search``, the sharded front
end, ``parallel.dist_ba``, ``parallel.dist_posegraph``, ``utils.scaling``,
``cli profile --scaling``): the port now covers the JAX package.
"""

__version__ = "0.6.0"


def __getattr__(name):
    """Lazy top-level API (keeps ``import ransac_tpu_torch`` light)."""
    if name in ("localize", "score_candidates", "score_candidates_sweep"):
        from ransac_tpu_torch.pipelines import localize as _m

        return getattr(_m, name)
    if name in ("build_scene", "read_camera_locations", "read_points_data"):
        from ransac_tpu_torch.io import tables as _m

        return getattr(_m, name)
    if name in ("ransac_homography", "ransac_pnp", "ransac_homography_sweep",
                "ransac_pnp_sweep", "ransac_essential", "ransac_essential_sweep"):
        from ransac_tpu_torch.models import ransac as _m

        return getattr(_m, name)
    if name == "two_view_pipeline":
        from ransac_tpu_torch.pipelines import twoview as _m

        return getattr(_m, name)
    if name == "incremental_sfm":
        from ransac_tpu_torch.pipelines.sfm import incremental_sfm

        return incremental_sfm
    if name == "bundle_adjust":
        from ransac_tpu_torch.ba.bundle import bundle_adjust

        return bundle_adjust
    if name == "bundle_adjust_cg":
        from ransac_tpu_torch.ba.schur_cg import bundle_adjust_cg

        return bundle_adjust_cg
    raise AttributeError(name)
