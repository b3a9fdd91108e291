"""Typed configuration for the ported pipelines.

Copies of ``ransac_tpu.utils.config``'s ``RansacConfig``,
``CameraIntrinsicsConfig``, ``LocalizeConfig``, ``RaycastConfig``,
``TwoViewConfig`` and ``BundleAdjustConfig`` with
the same fields and defaults (the originals cannot be imported without JAX).  ``from_dict``
rebuilds a config from ``dataclasses.asdict`` of either package's config,
so one configuration carries across.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class RansacConfig:
    """Fixed-shape RANSAC engine configuration (reference values as
    defaults: homography bound 75.0, main_v1.py:862; PnP bound 30.0 and
    budget 5000, main_v1.py:497-500)."""

    #: Inlier threshold in the residual's native units (pixels).
    threshold: float = 75.0
    #: Number of random minimal samples when enumeration is too large.
    num_hypotheses: int = 4096
    #: Enumerate every C(N,k) minimal sample when it fits the cap below.
    exhaustive: bool = True
    #: Cap on enumerated samples before random sampling would take over.
    max_exhaustive_samples: int = 8192
    #: 'count' = max inlier count (MSAC tie-break); 'msac' = min truncated
    #: residual.
    selection: str = "msac"
    #: Refit the model on the winning inlier set.
    refit: bool = True
    #: LM iterations after the least-squares refit.
    refine_iters: int = 10
    seed: int = 0


@dataclass(frozen=True)
class CameraIntrinsicsConfig:
    """Physical-film intrinsics (main_v1.py:869-883): fx = f_mm /
    sensor_w_mm * W, fy = f_mm / sensor_h_mm * H."""

    focal_length_mm: float = 240.0
    sensor_width_mm: float = 127.0
    sensor_height_mm: float = 178.0
    cx: float = 9.82666819e02
    cy: float = 6.97950868e02


@dataclass(frozen=True)
class LocalizeConfig:
    """Single-image candidate-camera localization (= reference main_v1
    flow)."""

    ransac: RansacConfig = field(default_factory=RansacConfig)
    pnp_ransac: RansacConfig = field(
        default_factory=lambda: RansacConfig(threshold=30.0, num_hypotheses=5000)
    )
    intrinsics: CameraIntrinsicsConfig = field(default_factory=CameraIntrinsicsConfig)
    #: Candidates with grid_code below this score 0 (then 1e6 at argmin).
    grid_code_min: int = 0
    #: Observer height added to each candidate elevation (main_v1.py:748).
    observer_height_m: float = 2.0
    #: Minimum PnP inliers required (main_v1.py:504).
    min_pnp_inliers: int = 6
    #: Feature-table z: 'elevation' or 'height_plus_elevation'.
    z_mode: str = "elevation"
    #: Divisor applied to annotated pixel coordinates (main_v1.py:705).
    pixel_scale: float = 1.0


@dataclass(frozen=True)
class RaycastConfig:
    """DEM ray-march geo-inversion (main_v1.py:635-684)."""

    max_search_dist_m: float = 10_000.0
    step_m: float = 1.0
    #: Reference quirk: a hit only counts after this many steps
    #: (150 at main_v1.py:650; 120 at testpro.py:689). 0 disables.
    min_hit_step: int = 150
    #: Ray-correction mode: 'weighted_factors' (main_v1.py:577-632),
    #: 'lsq_scales' (test_pro.py:645-680), or 'none'.
    correction: str = "weighted_factors"
    #: Inverse-distance weight cap and nearest-neighbor boost
    #: (main_v1.py:577: max_weight=1, knn_weight=10).
    max_weight: float = 1.0
    knn_weight: float = 10.0
    #: Per-component optimization factors with |f|>2 are dropped
    #: (main_v1.py:616).
    factor_abs_max: float = 2.0
    #: Camera altitude snap above terrain (main_v1.py:915).
    camera_height_above_dem_m: float = 1.5
    #: March strategy: 'mip' (coarse-to-fine over a pooled-max DEM, the
    #: same results) or 'chunk' (plain chunked lockstep march).
    march: str = "mip"


@dataclass(frozen=True)
class TwoViewConfig:
    """Two-view pipeline: detect -> match -> essential RANSAC ->
    triangulate."""

    max_keypoints: int = 1024
    harris_k: float = 0.04
    nms_radius: int = 4
    patch_size: int = 8
    match_ratio: float = 0.9
    #: Essential-RANSAC engine: "auto" takes the fused large-pool sweep for
    #: CUDA tensors and the stage-wise engine for CPU tensors (the JAX
    #: package's TPU / elsewhere rule); "sweep" / "stagewise" force a path.
    engine: str = "auto"
    #: The RANSAC threshold is in pixels (the pipeline turns it into a
    #: squared normalized Sampson bound with the focal length).
    ransac: RansacConfig = field(
        default_factory=lambda: RansacConfig(
            threshold=2.0, num_hypotheses=8192, exhaustive=False))


@dataclass(frozen=True)
class BundleAdjustConfig:
    max_iters: int = 30
    damping_init: float = 1e-3
    damping_up: float = 4.0
    damping_down: float = 0.5
    rtol: float = 1e-8
    #: Huber robust-loss scale in pixels (0 disables).
    huber_scale: float = 0.0


def from_dict(cls, m: Mapping[str, Any]):
    """Build a (possibly nested) config dataclass from a plain mapping,
    e.g. ``dataclasses.asdict`` of the JAX package's config."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in m:
            continue
        v = m[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, Mapping):
            v = from_dict(ftype, v)
        kwargs[f.name] = v
    return cls(**kwargs)
