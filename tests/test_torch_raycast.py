"""The DEM slice of the port (``ransac_tpu_torch.io.dem``, ``io.tiff``,
``pipelines.raycast``, ``ops.lm.fit_ray_scales``, ``ops.projection.
pixel_to_ray``, ``cli localize --dem``) against the JAX package on the CPU.

The samplers, the quad pack, the GeoTIFF ingest and the UTM resample equal
the JAX functions run eagerly bit for bit.  The JAX marches are jitted, and
XLA's CPU backend contracts ``a * b + c`` into FMAs where the port rounds
the product and the sum apart, so a ray that grazes the surface within
float32 rounding may stop one step apart (and JAX's chunked march sums
its positions trip by trip, where the port forms each step's position as
the mip marches do): hit masks and stop steps are held equal on all but
MAX_DIFFERING rays of a scene, each of which must differ by one step at
most and cross within MARGIN_M of the surface (its |z - DEM| at the
earlier of the two stops; ~30 float32 ulps of a 300 m height).  The
port's three marches equal each other exactly.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.io import dem as jdem
from ransac_tpu.io.export import write_boundary_csv as jwrite_boundary_csv
from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops.geodesy import SceneFrame as JSceneFrame
from ransac_tpu.ops.lm import fit_ray_scales as jfit_ray_scales
from ransac_tpu.pipelines import raycast as jr
from ransac_tpu.utils.config import RaycastConfig as JRaycastConfig
from ransac_tpu_torch import cli
from ransac_tpu_torch.io import dem, tables
from ransac_tpu_torch.io.synthetic import (boundary_polygon, write_geotiff,
                                           write_planted_dem, write_planted_scene)
from ransac_tpu_torch.ops import projection
from ransac_tpu_torch.ops.geodesy import SceneFrame
from ransac_tpu_torch.ops.lm import fit_ray_scales
from ransac_tpu_torch.pipelines import raycast
from ransac_tpu_torch.utils.config import RaycastConfig, from_dict
from torch_threads import one_torch_thread  # noqa: F401

MAX_DIFFERING = 2   # rays of a 256-ray scene
MARGIN_M = 1e-3
N_RAYS, MAX_STEPS = 256, 3000
ANCHOR = np.array([739000.0, 2888000.0, 0.0])
MIP = dict(pool=8, seg_steps=30, lookahead=32)  # 30 m cells: 8 x 30 / 1 m >= 30


def _terrain(X, Y):
    """``tools/bench_raycast.py``'s rugged terrain."""
    return 40.0 * np.sin(X / 700.0) * np.cos(Y / 900.0) + 30.0 * np.sin((X + Y) / 400.0)


@pytest.fixture(scope="module")
def dems():
    """(JAX DemUtm, the port's) of a 4 km DEM at 30 m."""
    j = jdem.synthetic_dem(JSceneFrame(anchor=ANCHOR), extent_m=2000.0,
                           spacing_m=30.0, terrain_fn=_terrain)
    return j, dem.dem_from_numpy(j)


def _rays(kind, n=N_RAYS, seed=0):
    """``tools/bench_raycast.py``'s scenes: rays from 300 m above the
    terrain, descending (hit), ascending (sky) or 60/30/10 hit, sky and
    grazing (mixed)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    spans = {"hit": [(n, 0.1, 0.5, -1.0)], "sky": [(n, 0.05, 0.3, 1.0)],
             "mixed": [(int(0.6 * n), 0.1, 0.5, -1.0),
                       (int(0.9 * n) - int(0.6 * n), 0.05, 0.3, 1.0),
                       (n - int(0.9 * n), 0.002, 0.01, -1.0)]}[kind]
    k = 0
    for m, lo, hi, sign in spans:
        d[k:k + m, 2] = sign * rng.uniform(lo, hi, m)
        k += m
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.repeat([[0.0, 0.0, 300.0]], n, 0).astype(np.float32), d.astype(np.float32)


def _stop_steps(pos, o, d):
    return np.rint(np.einsum("ij,ij->i", np.asarray(pos, np.float64) - o, d)).astype(int)


def _margin(t_dem, pos):
    """|z - DEM(x, y)| at positions [k, 3] (the port's sampler)."""
    z = dem.bilinear_sample(*t_dem.device_arrays("cpu"), torch.as_tensor(pos[:, 0]),
                            torch.as_tensor(pos[:, 1])).numpy()
    return np.abs(pos[:, 2] - z)


def _hold_to_jax(t_dem, o, d, out_t, out_j):
    """Hit masks and stop steps of the port's march against JAX's, under
    the module's tolerance.  Returns the differing rays' margins."""
    (pos_t, hit_t), (pos_j, hit_j) = out_t, out_j
    pos_t, hit_t = pos_t.numpy(), hit_t.numpy()
    pos_j, hit_j = np.asarray(pos_j), np.asarray(hit_j)
    s_t, s_j = _stop_steps(pos_t, o, d), _stop_steps(pos_j, o, d)
    differ = np.flatnonzero((s_t != s_j) | (hit_t != hit_j))
    assert len(differ) <= MAX_DIFFERING, differ
    assert (np.abs(s_t - s_j)[differ] <= 1).all()
    earlier = np.where((s_t <= s_j)[differ, None], pos_t[differ], pos_j[differ])
    margins = _margin(t_dem, earlier)
    assert (margins <= MARGIN_M).all(), dict(zip(differ.tolist(), margins.tolist()))
    return margins


# ------------------------------------------------------------ samplers
def test_bilinear_samplers_and_pack_equal_jax(dems):
    j, t = dems
    rng = np.random.default_rng(0)
    edges = (j.x0 + j.dx * np.arange(-2, j.data.shape[1] + 2)).astype(np.float32)
    x = np.concatenate([rng.uniform(-2400, 2400, 4000), edges, edges]).astype(np.float32)
    y = np.concatenate([rng.uniform(-2400, 2400, 4000), edges, edges[::-1]]).astype(np.float32)
    ja, ta = j.device_arrays(), t.device_arrays("cpu")
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in ta[1:])
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    z_j = np.asarray(jdem.bilinear_sample(*ja, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(dem.bilinear_sample(*ta, xt, yt).numpy(), z_j)
    pack_j, pack_t = jdem.pack_bilinear(ja[0]), dem.pack_bilinear(t.data)
    np.testing.assert_array_equal(pack_t.numpy(), np.asarray(pack_j))
    h, w = t.data.shape
    np.testing.assert_array_equal(
        dem.bilinear_sample_packed(pack_t, h, w, *ta[1:], xt, yt).numpy(),
        np.asarray(jdem.bilinear_sample_packed(pack_j, h, w, *ja[1:],
                                               jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("nodata", [None, -9999.0])
def test_geotiff_and_utm_resample_equal_jax(tmp_path, nodata):
    """The port's GeoTIFF writer read back by both packages' readers, and
    resampled onto one scene frame: equal bit for bit, nodata -> NaN."""
    rng = np.random.default_rng(1)
    lon = 119.30 + 0.0009 * np.arange(40)
    lat = 26.12 - 0.0009 * np.arange(30)
    data = (600.0 + 80.0 * rng.random((30, 40))).astype(np.float32)
    if nodata is not None:
        data[4:9, 11:17] = nodata
    path = str(tmp_path / "d.tif")
    write_geotiff(path, data, lon, lat, nodata=nodata)
    ll_t, ll_j = dem.load_geotiff(path), jdem.load_geotiff(path)
    for a, b in ((ll_t.data, ll_j.data), (ll_t.lon, ll_j.lon), (ll_t.lat, ll_j.lat)):
        np.testing.assert_array_equal(a, b)
    assert ll_t.utm_x_range == ll_j.utm_x_range and ll_t.utm_y_range == ll_j.utm_y_range
    assert np.isnan(ll_t.data).sum() == (0 if nodata is None else 30)
    np.testing.assert_array_equal(ll_t.data[::-1], np.where(data == nodata, np.nan, data))
    anchor = np.array([ll_t.utm_x_range[0] + 900.0, ll_t.utm_y_range[0] + 1200.0, 0.0])
    u_t = dem.resample_to_utm(ll_t, SceneFrame(anchor=anchor), 30.0)
    u_j = jdem.resample_to_utm(ll_j, JSceneFrame(anchor=anchor), 30.0)
    np.testing.assert_array_equal(u_t.data, u_j.data)
    assert (u_t.x0, u_t.y0, u_t.dx, u_t.dy) == (u_j.x0, u_j.y0, u_j.dx, u_j.dy)


def test_polygon_interior_and_bounds_equal_jax(dems):
    j, t = dems
    poly = np.array([[-300.0, -200.0], [500.0, -350.0], [650.0, 400.0], [-100.0, 600.0]])
    np.testing.assert_array_equal(dem.polygon_interior_elevations(t, poly, 40.0),
                                  jdem.polygon_interior_elevations(j, poly, 40.0))
    x = np.array([-2100.0, -2000.0, 0.0, 1999.0, 2000.5])
    for margin in (0.0, 50.0):
        np.testing.assert_array_equal(dem.in_bounds(t, x, x[::-1], margin),
                                      jdem.in_bounds(j, x, x[::-1], margin))


# ------------------------------------------------------------ marches
@pytest.mark.parametrize("kind", ["hit", "sky", "mixed"])
def test_marches_match_jax_and_each_other(dems, kind):
    """march_rays, march_rays_mip with pool2 = 0 and > 0 against JAX's (the
    quad-packed sampler, as GeoInverter uses), and march_rays_mip_compact
    against the port's march_rays_mip exactly; the loops read the device
    once a trip."""
    j, t = dems
    o, d = _rays(kind)
    ja, ta = j.device_arrays(), t.device_arrays("cpu")
    pack_j, pack_t = jdem.pack_bilinear(ja[0]), dem.pack_bilinear(t.data)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    common = dict(max_steps=MAX_STEPS, step=1.0, min_hit_step=150)
    raycast.reset_counts()
    out_t = raycast.march_rays(ot, dt, *ta, dem_pack=pack_t, **common)
    assert 0 < raycast.COUNTS["reads"] <= raycast.COUNTS["trips"]
    _hold_to_jax(t, o, d, out_t, jr.march_rays(jnp.asarray(o), jnp.asarray(d), *ja,
                                               dem_pack=pack_j, **common))
    for pool2 in (0, 64):
        kw = dict(common, **MIP, pool2=pool2)
        raycast.reset_counts()
        mip_t = raycast.march_rays_mip(ot, dt, *ta, dem_pack=pack_t, **kw)
        assert raycast.COUNTS["reads"] == raycast.COUNTS["trips"] > 0
        _hold_to_jax(t, o, d, mip_t, jr.march_rays_mip(
            jnp.asarray(o), jnp.asarray(d), *ja, dem_pack=pack_j, **kw))
        raycast.reset_counts()
        cmp_t = raycast.march_rays_mip_compact(ot, dt, *ta, dem_pack=pack_t, **kw)
        assert raycast.COUNTS["reads"] == raycast.COUNTS["trips"] > 0
        assert torch.equal(cmp_t[0], mip_t[0]) and torch.equal(cmp_t[1], mip_t[1])
        # The unpacked sampler gives the same march.
        plain_t = raycast.march_rays_mip(ot, dt, *ta, **kw)
        assert torch.equal(plain_t[0], mip_t[0]) and torch.equal(plain_t[1], mip_t[1])
        # The chunked and the mip march stop at the same step and position.
        assert torch.equal(mip_t[0], out_t[0]) and torch.equal(mip_t[1], out_t[1])
    if kind == "sky":
        assert not out_t[1].any()
    else:
        assert out_t[1].float().mean() > 0.4



@pytest.mark.parametrize("kind", ["hit", "sky", "mixed"])
def test_level2_scan_runs_only_after_an_allclear_trip(dems, monkeypatch, kind):
    """The mip marches run the level-2 scan only on a trip that follows one
    whose level-1 window was clear for every active ray (JAX's
    ``lax.cond(allclear, l2_scan, ...)``): the scans, counted by their mip
    block lookups (two a coarse scan, two a level-2 scan), equal the trips
    that follow an ``allclear`` read of the same loop, and the hit and
    mixed scenes skip the scan on most trips (the sky scene runs it).  Trips and reads are one
    each, and the marches' results are those of the march without level 2
    (held to JAX's in ``test_marches_match_jax_and_each_other``)."""
    _, t = dems
    o, d = _rays(kind)
    ta, pack_t = t.device_arrays("cpu"), dem.pack_bilinear(t.data)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    kw = dict(max_steps=MAX_STEPS, step=1.0, min_hit_step=150, **MIP, dem_pack=pack_t)
    lookups, reads = [0], []
    block, read = raycast._block, raycast._read

    def counting_block(*a):
        lookups[0] += 1
        return block(*a)

    def recording_read(x):
        reads.append(read(x))
        return reads[-1]

    monkeypatch.setattr(raycast, "_block", counting_block)
    monkeypatch.setattr(raycast, "_read", recording_read)
    base = raycast.march_rays_mip(ot, dt, *ta, **kw)
    for march in (raycast.march_rays_mip, raycast.march_rays_mip_compact):
        raycast.reset_counts()
        lookups[0], reads[:] = 0, []
        out = march(ot, dt, *ta, pool2=64, **kw)
        trips, scans = raycast.COUNTS["trips"], raycast.COUNTS["l2_scans"]
        assert raycast.COUNTS["reads"] == trips == len(reads) > 0
        assert lookups[0] == 2 * trips + 2 * scans
        assert all(len(r) == 2 for r in reads)  # one read carries both flags
        assert torch.equal(out[0], base[0]) and torch.equal(out[1], base[1])
        if march is raycast.march_rays_mip:
            assert scans == sum(bool(clear) for _, clear in reads[:-1])
            if kind == "sky":
                assert scans >= 1
        else:  # each stage starts with allclear False
            assert scans <= sum(bool(clear) for _, clear in reads[:-1])
        if kind != "sky":
            assert scans < trips / 2, (scans, trips)

def test_nodata_cells_never_hit():
    """NaN cells (nodata) compare false, so no march stops in them: rays
    aimed into a NaN pit under flat ground pass it and hit beyond, as the
    JAX marches do.  The mip marches stop later than the chunked one: a
    pooled max over a NaN cell is NaN, so its dilated blocks read as clear
    and are skipped (the JAX package's semantics too)."""
    frame = JSceneFrame(anchor=ANCHOR)
    j = jdem.synthetic_dem(frame, extent_m=1500.0, spacing_m=10.0,
                           terrain_fn=lambda X, Y: np.where(
                               (X > 100) & (X < 400) & (np.abs(Y) < 200), np.nan, 0.0))
    t = dem.dem_from_numpy(j)
    n = 64
    d = np.stack([np.ones(n), np.linspace(-0.3, 0.3, n), -np.full(n, 0.6)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.repeat([[0.0, 0.0, 120.0]], n, 0).astype(np.float32)
    ot, dt, ta, ja = torch.from_numpy(o), torch.from_numpy(d), t.device_arrays("cpu"), \
        j.device_arrays()
    kw = dict(max_steps=1500, step=1.0, min_hit_step=0)
    mip = dict(kw, pool=8, seg_steps=32, lookahead=32)
    chunk_t = raycast.march_rays(ot, dt, *ta, **kw)
    chunk_j = jr.march_rays(jnp.asarray(o), jnp.asarray(d), *ja, **kw)
    mip_t = raycast.march_rays_mip(ot, dt, *ta, **mip)
    mip_j = jr.march_rays_mip(jnp.asarray(o), jnp.asarray(d), *ja, **mip)
    compact_t = raycast.march_rays_mip_compact(ot, dt, *ta, **mip)
    assert torch.equal(compact_t[0], mip_t[0]) and torch.equal(compact_t[1], mip_t[1])
    for (pos, hit), (pos_j, hit_j) in ((chunk_t, chunk_j), (mip_t, mip_j)):
        pos = pos.numpy()
        # Every ray reaches the ground (z = 0) inside the pit, 100 < x < 400;
        # a sample touches a NaN cell below x = 400 (the last is at 390).
        assert hit.all() and (pos[:, 0] >= 400.0).all()
        np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_j))
        np.testing.assert_array_equal(_stop_steps(pos, o, d),
                                      _stop_steps(np.asarray(pos_j), o, d))
    assert (chunk_t[0][:, 0] < 402.0).all() and (mip_t[0][:, 0] > 450.0).all()


# ------------------------------------------------------------ corrections
def _camera():
    """A camera 300 m up looking 45 degrees down toward +x (the JAX
    package's raycast tests)."""
    K = np.array([[1000.0, 0, 500.0], [0, 1000.0, 500.0], [0, 0, 1.0]])
    fwd = np.array([1.0, 0.0, -1.0]) / np.sqrt(2)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = -np.cross(fwd, right)
    return K, np.stack([right, -down, fwd]), np.array([0.0, 0.0, 300.0])


def _controls(seed=0):
    """Control points on the ground of the synthetic paraboloid in front of
    the camera, and their pixels with 2 px of noise (one an outlier)."""
    K, R, origin = _camera()
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(150, 600, 8), rng.uniform(-150, 150, 8), np.zeros(8)], 1)
    X[:, 2] = 100.0 * np.exp(-((X[:, 0] / 1500.0) ** 2 + (X[:, 1] / 1500.0) ** 2))
    Xc = (X - origin) @ R.T
    pix = Xc[:, :2] / Xc[:, 2:] * 1000.0 + 500.0 + rng.normal(scale=2.0, size=(8, 2))
    pix[3] += [40.0, -25.0]
    return pix, X


def test_correction_helpers_match_jax():
    K, R, origin = _camera()
    pix, X = _controls()
    q = np.random.default_rng(2).uniform(0, 1000, (20, 2)).astype(np.float32)
    q[5] = pix[2]  # a query on a control pixel: weight 1, boosted
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    tK, tR = torch.from_numpy(f32(K)), torch.from_numpy(f32(R))
    for force in (False, True):
        np.testing.assert_allclose(
            projection.pixel_to_ray(torch.from_numpy(q), tK, tR, force).numpy(),
            np.asarray(jproj.pixel_to_ray(jnp.asarray(q), jnp.asarray(f32(K)),
                                          jnp.asarray(f32(R)), force)), atol=1e-6)
    w_t = raycast.calculate_weights(torch.from_numpy(q), torch.from_numpy(f32(pix)), 1.0, 10.0)
    w_j = np.asarray(jr.calculate_weights(jnp.asarray(q), jnp.asarray(f32(pix)), 1.0, 10.0))
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=1e-6)
    f_t, v_t = raycast.compute_optimization_factors(
        torch.from_numpy(f32(pix)), torch.from_numpy(f32(X)), tK, tR,
        torch.from_numpy(f32(origin)), 2.0)
    f_j, v_j = jr.compute_optimization_factors(
        jnp.asarray(f32(pix)), jnp.asarray(f32(X)), jnp.asarray(f32(K)),
        jnp.asarray(f32(R)), jnp.asarray(f32(origin)), 2.0)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-5)
    np.testing.assert_allclose(
        raycast.weighted_factors(f_t, v_t, w_t).numpy(),
        np.asarray(jr.weighted_factors(f_j, v_j, jnp.asarray(w_j))), rtol=1e-5)
    ideal = f32((X - origin) / np.linalg.norm(X - origin, axis=1, keepdims=True))
    rays = projection.pixel_to_ray(torch.from_numpy(f32(pix)), tK, tR)
    s_t, res_t = fit_ray_scales(torch.from_numpy(ideal), rays)
    s_j, _ = jfit_ray_scales(jnp.asarray(ideal), jnp.asarray(rays.numpy()))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4)
    assert float(res_t.cost[0]) < float(0.5 * ((rays.numpy() - ideal) ** 2).sum())


@pytest.fixture(scope="module")
def paraboloid():
    j = jdem.synthetic_dem(JSceneFrame(anchor=ANCHOR), extent_m=1500.0, spacing_m=10.0)
    return j, dem.dem_from_numpy(j)


@pytest.mark.parametrize("correction", ["weighted_factors", "lsq_scales", "none"])
def test_pixel_to_geo_matches_jax(paraboloid, correction):
    """GeoInverter.pixel_to_geo of the port against JAX's: the same hits,
    positions within 1e-4 m (at a few hundred metres, float32's ulp is
    3e-5 m).  ``lsq_scales`` runs on the port's fitted scales on both sides
    (the fits themselves are held in ``test_correction_helpers_match_jax``:
    two LM runs agree to ~1e-6, which moves a 500 m hit by more than an
    ulp)."""
    j, t = paraboloid
    K, R, origin = _camera()
    pix, X = _controls()
    q = np.concatenate([pix, np.random.default_rng(4).uniform(0, 1000, (40, 2)),
                        [[500.0, -400.0]]])  # the last above the horizon
    kw = dict(K=K, R=R, ray_origin=origin, control_pixels=pix, control_pos3d=X)
    inv_t = raycast.GeoInverter(dem=t, cfg=RaycastConfig(correction=correction),
                                device="cpu", **kw)
    inv_j = jr.GeoInverter(dem=j, cfg=JRaycastConfig(correction=correction), **kw)
    if correction == "lsq_scales":
        np.testing.assert_allclose(inv_t._scales.numpy(), inv_j._scales, rtol=1e-4)
        inv_j._scales = inv_t._scales.numpy()
    utm_t, hit_t = inv_t.pixel_to_geo(q)
    utm_j, hit_j = inv_j.pixel_to_geo(q)
    np.testing.assert_array_equal(hit_t, hit_j)
    assert hit_t[:-1].all() and not hit_t[-1]
    np.testing.assert_allclose(utm_t[hit_t], utm_j[hit_j], rtol=0, atol=1e-4)
    if correction != "lsq_scales":  # its fit spreads over every control ray
        err = np.linalg.norm(utm_t[:8] - (X + ANCHOR), axis=1)
        assert np.median(err) < 15.0, err


def test_convert_boundary_matches_jax(paraboloid, tmp_path):
    """The same keys in the same order, the same vertices, and the
    nonzero filter (a vertex above the horizon is dropped)."""
    j, t = paraboloid
    K, R, origin = _camera()
    pix, X = _controls()
    kw = dict(K=K, R=R, ray_origin=origin, control_pixels=pix, control_pos3d=X,
              cfg=None)
    doc = {"info": {"name": "b.jpg"}, "objects": [
        {"category": "__background__", "group": 1,
         "segmentation": boundary_polygon((1000, 1000), 21).tolist()},
        {"category": "ri-dge 2", "group": 3,
         "segmentation": [[300.0, 600.0], [500.0, -300.0], [700.0, 650.0]]}]}
    del kw["cfg"]
    geo_t, pix_t = raycast.GeoInverter(dem=t, device="cpu", **kw).convert_boundary(doc)
    geo_j, pix_j = jr.GeoInverter(dem=j, **kw).convert_boundary(doc)
    assert list(geo_t) == list(geo_j) == [(1, "background"), (3, "ridge2")]
    assert pix_t == pix_j and len(pix_t[(3, "ridge2")]) == 2
    for k in geo_t:
        np.testing.assert_allclose(np.array(geo_t[k]), np.array(geo_j[k]), atol=1e-4)


def test_raycast_config_carries_across():
    cfg = JRaycastConfig(correction="lsq_scales", min_hit_step=120, march="chunk")
    assert from_dict(RaycastConfig, vars(cfg)) == RaycastConfig(
        correction="lsq_scales", min_hit_step=120, march="chunk")
    assert RaycastConfig().march == "mip"


# ------------------------------------------------------------ cli --dem
def test_cli_localize_report_dem_end_to_end(tmp_path, monkeypatch, capsys):
    """``cli localize --report --dem --json-file --query --device cpu`` on the
    planted scene and its planted DEM writes the location, accuracies,
    correlations and boundary CSVs and a shapefile; the boundary rows are
    those of the JAX package's GeoInverter given the same camera, DEM and
    control points (the DEM's elevations centred on the scene frame, as
    the port's command centres them)."""
    ps = write_planted_scene(tmp_path / "scene", seed=0, n_unannotated=3)
    tif, js = write_planted_dem(tmp_path / "scene", ps)
    monkeypatch.chdir(tmp_path)
    lines = iter(["900,1100", "1,2,3", "x,y", "exit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert cli.main(["localize", "--features", ps.features_csv, "--cameras",
                     ps.cameras_csv, "--pixel-x", ps.pixel_x, "--pixel-y", ps.pixel_y,
                     "--width", str(ps.image_size[0]), "--height",
                     str(ps.image_size[1]), "--output", "out.jpg", "--report",
                     "--dem", tif, "--json-file", js, "--query", "1071,1000",
                     "1071,200", "--interactive", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pixel (1071,1000) -> E=" in out and "pixel (1071,200) -> no DEM" in out
    # The REPL: an answer, a wrong format, a bad number, then exit.
    assert "pixel (900,1100) -> " in out and "format: 755,975" in out
    assert "bad input" in out
    for name in ("out_location.csv", "out_accuracies.csv", "out_correlations.csv",
                 "boundary_points_geo.csv"):
        assert os.path.getsize(name) > 0, name
    shp = sorted(os.listdir("output_shapefiles"))
    assert shp == [f"background_1_boundary.{e}" for e in ("dbf", "prj", "shp", "shx")]
    rows = np.genfromtxt("boundary_points_geo.csv", delimiter=",", skip_header=1)
    assert rows.ndim == 2 and 3 <= len(rows) <= 21

    # The JAX package on the same inputs.
    feats = tables.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y)
    scene = tables.build_scene(feats, tables.read_camera_locations(ps.cameras_csv),
                               device="cpu")
    from ransac_tpu_torch.pipelines.localize import localize

    res = localize(scene, ps.image_size, device="cpu")
    frame = JSceneFrame(anchor=scene.frame.anchor)
    dj = jdem.resample_to_utm(jdem.load_geotiff(tif), frame, 10.0)
    dj.data = (dj.data.astype(np.float64) - frame.anchor[2]).astype(np.float32)
    origin = frame.center(res.camera_origin_utm[None])[0]
    z = float(jdem.bilinear_sample(jnp.asarray(dj.data), dj.x0, dj.y0, dj.dx, dj.dy,
                                   jnp.float32(origin[0]), jnp.float32(origin[1])))
    inv = jr.GeoInverter(K=res.K, R=res.R, ray_origin=np.array(
        [origin[0], origin[1], z + 1.5]), dem=dj,
        control_pixels=feats.pixels.astype(np.float32).astype(np.float64),
        control_pos3d=frame.center(feats.pos3d_utm).astype(np.float64))
    with open(js, encoding="utf-8") as f:
        geo, pix = inv.convert_boundary(json.load(f))
    jwrite_boundary_csv(str(tmp_path / "jax_boundary.csv"), geo, pix)
    ref = np.genfromtxt(tmp_path / "jax_boundary.csv", delimiter=",", skip_header=1)
    assert rows.shape == ref.shape
    np.testing.assert_array_equal(rows[:, 1:4], ref[:, 1:4])
    np.testing.assert_allclose(rows[:, 4:], ref[:, 4:], rtol=0, atol=1e-3)
