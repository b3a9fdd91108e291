"""Visualization suite.

Replaces the reference's 10 ``plot_*`` functions (``main_v1.py:62-156``),
its pandas/seaborn/plotly dashboards (``test02.py:160-203``), the pose
triad (``testpro-K.py:165-196``) and the DEM terrain mesh (``3D-1.py:
122-147``).  Differences by design: figures are returned (and optionally
saved) instead of ``plt.show()``-blocking, everything works headless (Agg),
and the plotly dependency is dropped — 3D views use matplotlib.

Copy of ``ransac_tpu.viz``.  matplotlib (and pandas, for the correlation
heatmap) are imported inside the plotting functions, so importing this
module needs neither; a plot drawn where matplotlib is missing raises an
``ImportError`` that names it.
"""

from __future__ import annotations

import numpy as np

from ransac_tpu_torch.ops.geodesy import utm_to_wgs84


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("ransac_tpu_torch.viz draws with matplotlib, which "
                          "is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, save_to=None):
    plt = _pyplot()
    if save_to:
        fig.savefig(save_to, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_error_histogram(errors, title="error histogram", save_to=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(np.asarray(errors), bins=30, alpha=0.75, edgecolor="black")
    ax.set_title(title)
    ax.set_xlabel("error")
    ax.set_ylabel("frequency")
    ax.grid(True)
    return _finish(fig, save_to)


def plot_error_boxplot(errors, save_to=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.boxplot(np.asarray(errors), vert=True, patch_artist=True)
    ax.set_title("error distribution")
    ax.grid(True)
    return _finish(fig, save_to)


def plot_camera_location_scores(scores_rows, zone=50, save_to=None):
    """Score scatter map in WGS84 (main_v1.py:71-84): rows are the
    location-CSV layout [id, err1, err2, grid, E, N, z]."""
    plt = _pyplot()
    rows = np.asarray(scores_rows, dtype=np.float64)
    lon, lat = utm_to_wgs84(rows[:, 4], rows[:, 5], zone)
    fig, ax = plt.subplots(figsize=(9, 7))
    sc = ax.scatter(lon, lat, c=rows[:, 1], cmap="viridis_r", marker="o")
    fig.colorbar(sc, ax=ax, label="err1 (min_score)")
    ax.set_title("candidate camera location scores")
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    ax.grid(True)
    return _finish(fig, save_to)


def plot_camera_pose(cam_utm, best_index, zone=50, save_to=None):
    """3D candidate scatter + best pick (main_v1.py:87-101)."""
    plt = _pyplot()
    cam_utm = np.asarray(cam_utm, np.float64)
    lon, lat = utm_to_wgs84(cam_utm[:, 0], cam_utm[:, 1], zone)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(lon, lat, cam_utm[:, 2], c="blue", marker="o", s=8)
    ax.scatter(lon[best_index], lat[best_index], cam_utm[best_index, 2],
               c="red", marker="^", s=60)
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    ax.set_zlabel("elevation")
    ax.set_title("camera candidates (best in red)")
    return _finish(fig, save_to)


def plot_distance_histogram(distances, save_to=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(np.asarray(distances), bins=30, alpha=0.75, color="green",
            edgecolor="black")
    ax.set_title("distance histogram")
    ax.grid(True)
    return _finish(fig, save_to)


def plot_angle_rose(angles_deg, save_to=None):
    plt = _pyplot()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="polar")
    ax.hist(np.radians(np.asarray(angles_deg)), bins=30, alpha=0.75,
            color="purple", edgecolor="black")
    ax.set_title("bearing rose")
    return _finish(fig, save_to)


def plot_nearest_neighbor_distances(nn_distances, save_to=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(np.asarray(nn_distances), bins=30, alpha=0.75, color="orange",
            edgecolor="black")
    ax.set_title("nearest-neighbor distances")
    ax.grid(True)
    return _finish(fig, save_to)


def plot_homography_heatmap(H, save_to=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.asarray(H), cmap="coolwarm", vmin=-1, vmax=1)
    for (i, j), v in np.ndenumerate(np.asarray(H)):
        ax.text(j, i, f"{v:.2g}", ha="center", va="center", fontsize=8)
    fig.colorbar(im, ax=ax)
    ax.set_title("homography matrix")
    return _finish(fig, save_to)


def plot_ransac_scatter(inliers, outliers, save_to=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    inliers = np.asarray(inliers).reshape(-1, 2) if len(inliers) else inliers
    outliers = np.asarray(outliers).reshape(-1, 2) if len(outliers) else outliers
    if len(inliers):
        ax.scatter(inliers[:, 0], inliers[:, 1], c="green", marker="o",
                   label="inliers")
    if len(outliers):
        ax.scatter(outliers[:, 0], outliers[:, 1], c="red", marker="x",
                   label="outliers")
    ax.legend()
    ax.set_title("RANSAC consensus")
    ax.grid(True)
    return _finish(fig, save_to)


def plot_annotated_image(img, pixels, symbols, calc_pixels=None,
                         inlier_mask=None, unannotated_mask=None,
                         save_to=None):
    """Annotated-overlay figure (main_v1.py:320-353): actual pixels,
    model-projected pixels, inlier/outlier coloring.  Rows flagged in
    ``unannotated_mask`` are drawn as the reference's unnoted features
    (main_v1.py:375-379): projected position only, black square + italic
    symbol label."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(14, 10))
    if img is not None:
        ax.imshow(img, cmap="gray" if np.asarray(img).ndim == 2 else None)
    pixels = np.asarray(pixels)
    for i, (p, s) in enumerate(zip(pixels, symbols)):
        if unannotated_mask is not None and unannotated_mask[i]:
            if calc_pixels is None:
                continue
            q = np.asarray(calc_pixels)[i]
            ax.text(q[0], q[1], str(s), color="black", fontsize=6,
                    style="italic", weight="bold")
            ax.plot(*q, marker="s", markersize=3, color="black")
            continue
        color = "green"
        if inlier_mask is not None and not inlier_mask[i]:
            color = "red"
        ax.annotate(str(s), p, color="purple", fontsize=7, weight="bold")
        ax.plot(*p, marker="X", color=color, markersize=4)
        if calc_pixels is not None:
            q = np.asarray(calc_pixels)[i]
            ax.plot([p[0], q[0]], [p[1], q[1]], color=color, linewidth=1.5)
            ax.plot(*q, marker="o", color=color, markersize=3)
    ax.set_title("annotated features: actual (X) vs projected (o)")
    return _finish(fig, save_to)


def plot_pose_triad(R, origin, points=None, labels=None, axis_len=50.0,
                    save_to=None):
    """Camera-axes quiver triad + landmark ids (testpro-K.py:165-196)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    R = np.asarray(R)
    origin = np.asarray(origin)
    colors = ["r", "g", "b"]
    for a in range(3):
        d = R.T[:, a] * axis_len
        ax.quiver(*origin, *d, color=colors[a], linewidth=2)
    if points is not None:
        points = np.asarray(points)
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], c="k", s=10)
        if labels is not None:
            for p, l in zip(points, labels):
                ax.text(p[0], p[1], p[2], str(l), fontsize=7)
    ax.set_title("camera pose triad")
    return _finish(fig, save_to)


def plot_terrain_mesh(dem, stride=4, polygons=None, save_to=None):
    """DEM surface render (3D-1.py:122-147 equivalent, matplotlib)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    z = np.asarray(dem.data)[::stride, ::stride]
    H, W = z.shape
    xs = dem.x0 + np.arange(W) * dem.dx * stride
    ys = dem.y0 + np.arange(H) * dem.dy * stride
    XX, YY = np.meshgrid(xs, ys)
    ax.plot_surface(XX, YY, z, cmap="terrain", linewidth=0,
                    antialiased=False, alpha=0.9)
    if polygons:
        for coords in polygons:
            c = np.asarray(coords)
            ax.plot(c[:, 0], c[:, 1], c[:, 2] + 2.0, "r-", linewidth=2)
    ax.set_title("terrain")
    return _finish(fig, save_to)


def plot_accuracies(accuracy_rows, save_to=None):
    """Accuracies dashboard (test02.py:160-176): actual-vs-calculated pixel
    scatter + per-feature error bars."""
    plt = _pyplot()
    rows = accuracy_rows[1:]
    act = np.array([[float(r[5]), float(r[6])] for r in rows])
    calc = np.array([[float(r[7]), float(r[8])] for r in rows])
    err = np.linalg.norm(act - calc, axis=1)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 5))
    ax1.scatter(act[:, 0], act[:, 1], c="blue", label="actual", s=14)
    ax1.scatter(calc[:, 0], calc[:, 1], c="red", label="calculated",
                marker="x", s=14)
    for a, c in zip(act, calc):
        ax1.plot([a[0], c[0]], [a[1], c[1]], "k-", linewidth=0.5)
    ax1.invert_yaxis()
    ax1.legend()
    ax1.set_title("actual vs calculated pixels")
    ax2.bar(np.arange(len(err)), err)
    ax2.set_title("per-feature pixel error")
    ax2.set_xlabel("feature")
    return _finish(fig, save_to)


def plot_correlation_heatmap(correlation_rows, columns=None, save_to=None):
    """Numeric-column correlation heatmap (test02.py:178-192)."""
    plt = _pyplot()
    import pandas as pd

    header, data = correlation_rows[0], correlation_rows[1:]
    df = pd.DataFrame(data, columns=header)
    num = df.apply(pd.to_numeric, errors="coerce").dropna(axis=1, how="all")
    if columns:
        num = num[[c for c in columns if c in num]]
    corr = num.corr()
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(corr.values, cmap="coolwarm", vmin=-1, vmax=1)
    ax.set_xticks(range(len(corr.columns)))
    ax.set_xticklabels(corr.columns, rotation=90, fontsize=7)
    ax.set_yticks(range(len(corr.columns)))
    ax.set_yticklabels(corr.columns, fontsize=7)
    fig.colorbar(im, ax=ax)
    ax.set_title("feature-metric correlations")
    return _finish(fig, save_to)
