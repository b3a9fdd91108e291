"""DEM ray-cast geo-inversion: pixel -> ground coordinates (port of
``ransac_tpu.pipelines.raycast``).

Replaces the reference's scalar REPL path (``main_v1.py:547-684``), which
builds one ray per query pixel and marches it 1 m at a time with a PROJ
call and a scipy interpolation at every step.  Here every query ray
marches in lockstep over a [R, 3] position tensor with a done mask,
sampling a scene-centred UTM DEM (``io.dem``) by bilinear gathers, with no
geodesy in the loop.  Both of the reference's ray corrections are here:

- weighted optimization factors (main_v1.py:577-632): per-control-point
  componentwise ideal/computed direction ratios, |f| > 2 filtered,
  inverse-distance weights capped at ``max_weight`` with the nearest
  control point boosted ``knn_weight`` x, the z component corrected;
- per-axis least-squares scales (test_pro.py:645-680) through the LM core
  (``ops.lm.fit_ray_scales``).

The reference's >= 150-step hit warm-up (main_v1.py:650) is
``RaycastConfig.min_hit_step``.

The JAX marches are ``lax.while_loop``s that never leave the device.  A
torch loop is driven from the host, so each trip here ends in one read of
the done mask (the compact march reads the active count, which also
decides its stage exits).  ``COUNTS`` counts the trips and those reads.
JAX's ``lax.cond`` on the level-2 scan is a host branch: the mip marches'
read carries the trip's ``allclear`` flag beside the done mask's, and the
next trip runs the scan only when it was set (``COUNTS["l2_scans"]``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ransac_tpu_torch.io.dem import (DemUtm, bilinear_sample,
                                     bilinear_sample_packed, device_scalar,
                                     pack_bilinear)
from ransac_tpu_torch.ops import projection as proj
from ransac_tpu_torch.ops.lm import fit_ray_scales
from ransac_tpu_torch.utils.config import RaycastConfig
from ransac_tpu_torch.utils.logging import host_sync, register_counters, timed

#: Trips of the marches' loops, host reads of their loop state and level-2
#: scans of the mip marches in this process.
COUNTS = {"trips": 0, "reads": 0, "l2_scans": 0}
register_counters("raycast", COUNTS)


def reset_counts() -> None:
    COUNTS.update(trips=0, reads=0, l2_scans=0)


def _read(t: torch.Tensor):
    """One host read of a march's loop state: a number, or a list of them
    for a 1-d tensor."""
    COUNTS["reads"] += 1
    with host_sync("raycast.read"):
        return t.tolist() if t.dim() else t.item()


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none), as JAX's
    argmax of booleans: argmax returns the first maximum."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


# ------------------------------------------------------------ corrections
def calculate_weights(query_pixels: torch.Tensor, control_pixels: torch.Tensor,
                      max_weight: float = 1.0, knn_weight: float = 10.0):
    """Batched main_v1.py:577-596: weights [R, C], the inverse pixel
    distance capped at max_weight, the nearest control point boosted
    knn_weight x."""
    d = torch.linalg.vector_norm(
        query_pixels[:, None, :] - control_pixels[None, :, :], dim=-1)
    w = torch.clamp(torch.where(d == 0.0, 1.0, 1.0 / torch.where(d == 0, 1.0, d)),
                    max=max_weight)
    boost = F.one_hot(torch.argmin(d, dim=1), control_pixels.shape[0]).to(w.dtype)
    return w * (1.0 + (knn_weight - 1.0) * boost)


def compute_optimization_factors(control_pixels, control_pos3d, K, R,
                                 ray_origin, factor_abs_max: float = 2.0):
    """Batched main_v1.py:599-625: (factors [C, 3], valid [C]), the
    componentwise ideal/computed ray ratios; rows with |f| > factor_abs_max
    are filtered (valid False) as the reference's ``continue``."""
    ideal = control_pos3d - ray_origin[None, :]
    norm = torch.linalg.vector_norm(ideal, dim=-1, keepdim=True)
    valid = norm[:, 0] > 0
    ideal = ideal / torch.where(norm > 0, norm, 1.0)
    rays = proj.pixel_to_ray(control_pixels, K, R)
    factors = ideal / torch.where(rays.abs() < 1e-12, 1e-12, rays)
    valid = valid & (factors.abs() <= factor_abs_max).all(-1)
    return factors, valid


def weighted_factors(factors: torch.Tensor, valid: torch.Tensor,
                     weights: torch.Tensor):
    """Batched main_v1.py:627-632 over query rows: weights [R, C] x factors
    [C, 3] -> [R, 3], the normalized weighted mean over valid control
    points."""
    w = weights * valid[None, :].to(weights.dtype)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    return (w[..., None] * factors[None, :, :]).sum(1) / wsum


# ------------------------------------------------------------ ray march
def _geometry(dem_data, x0, y0, dx, dy):
    """(x0, y0, dx, dy, xmax, ymax) as 0-d float32 tensors on the grid's
    device (numbers are filled in there), as a jitted JAX march sees them."""
    x0, y0, dx, dy = (device_scalar(v, dem_data) for v in (x0, y0, dx, dy))
    h, w = dem_data.shape
    return x0, y0, dx, dy, x0 + dx * (w - 1), y0 + dy * (h - 1)


def _sampler(dem_data, dem_pack, x0, y0, dx, dy):
    h, w = dem_data.shape
    if dem_pack is None:
        return lambda xs, ys: bilinear_sample(dem_data, x0, y0, dx, dy, xs, ys)
    return lambda xs, ys: bilinear_sample_packed(dem_pack, h, w, x0, y0, dx, dy,
                                                 xs, ys)


def march_rays(origins: torch.Tensor, directions: torch.Tensor, dem_data,
               x0, y0, dx, dy, max_steps: int, step: float = 1.0,
               min_hit_step: int = 150, chunk: int = 64, dem_pack=None):
    """Lockstep batched ray march: origins and unit directions [R, 3] in
    centred UTM, the DEM grid and its 0-d float32 origin and spacing
    (``DemUtm.device_arrays``).  Returns (positions [R, 3], hit mask [R]).
    ``dem_pack`` (``io.dem.pack_bilinear``) samples through the quad-packed
    grid.

    A ray stops at z <= DEM(x, y) after >= min_hit_step steps (the
    reference's warm-up, main_v1.py:650), on leaving the DEM footprint, or
    at max_steps.  Each trip evaluates ``chunk`` steps of every ray in one
    [R * chunk] gather and takes the first stop in it: the steps
    0..max_steps-1 of the reference's 1 m march, 1/chunk of the trips.
    The loop ends when every ray is done (one read a trip).

    Step g is at origin + (g * step) * direction, as in the mip marches, so
    the three marches stop every ray at the same step and position.  (The
    JAX march adds each trip's advance to the last position instead; that
    sum drifts by float32 roundings, and a ray that grazes the surface can
    stop a step apart from its mip march.)"""
    n = origins.shape[0]
    dev = origins.device
    x0, y0, dx, dy, xmax, ymax = _geometry(dem_data, x0, y0, dx, dy)
    sample = _sampler(dem_data, dem_pack, x0, y0, dx, dy)
    kg = torch.arange(chunk, dtype=torch.int32, device=dev)
    o, d = origins[:, None, :], directions[:, None, :]
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    hit = torch.zeros_like(done)
    istop = torch.full((n,), max_steps, dtype=torch.int32, device=dev)
    i = 0
    while i < max_steps:
        gstep = i + kg
        P = o + (gstep.to(torch.float32) * step)[None, :, None] * d
        z_dem = sample(P[..., 0].reshape(-1), P[..., 1].reshape(-1)).reshape(n, chunk)
        inside = ((P[..., 0] >= x0) & (P[..., 0] <= xmax)
                  & (P[..., 1] >= y0) & (P[..., 1] <= ymax))
        in_budget = gstep < max_steps
        hit_k = ((gstep >= min_hit_step)[None, :] & (P[..., 2] <= z_dem)
                 & inside & in_budget[None, :])
        stop_k = (hit_k | ~inside) & in_budget[None, :]
        any_stop = stop_k.any(dim=1) & ~done
        first = _first_true(stop_k)
        first_is_hit = hit_k.gather(1, first[:, None])[:, 0]
        istop = torch.where(any_stop, i + first.to(torch.int32), istop)
        hit = hit | (any_stop & first_is_hit)
        done = done | any_stop
        i += chunk
        COUNTS["trips"] += 1
        if i < max_steps and _read(done.all()):
            break
    t_stop = istop.to(torch.float32) * step
    return origins + t_stop[:, None] * directions, hit


def _build_mip(dem_data, p):
    """Pooled max over p x p cells, padded with -inf, 3x3-block dilated:
    an upper bound of every bilinear sample whose query falls in a block.
    Returns (flat [hb * wb], hb, wb)."""
    h, w = dem_data.shape
    hb, wb = -(-h // p), -(-w // p)
    padded = torch.full((hb * p, wb * p), -torch.inf, dtype=dem_data.dtype,
                        device=dem_data.device)
    padded[:h, :w] = dem_data
    pooled = padded.reshape(hb, p, wb, p).amax(dim=(1, 3))
    pp = F.pad(pooled, (1, 1, 1, 1), value=-torch.inf)
    dil = pp[1:-1, 1:-1]
    for ro in (-1, 0, 1):
        for co in (-1, 0, 1):
            dil = torch.maximum(dil, pp[1 + ro:1 + ro + hb, 1 + co:1 + co + wb])
    return dil.reshape(-1), hb, wb


def _mip_setup(dem_data, dem_pack, x0, y0, dx, dy, pool, pool2, lookahead,
               lookahead2, seg_steps, step):
    """The coarse-to-fine march's sampler and dilated pooled-max mips (the
    ``geo.march_setup`` span)."""
    with timed("geo.march_setup"):
        x0, y0, dx, dy, xmax, ymax = _geometry(dem_data, x0, y0, dx, dy)
        sample = _sampler(dem_data, dem_pack, x0, y0, dx, dy)
        flat, hb, wb = _build_mip(dem_data, pool)
        l1 = (flat, hb, wb, pool * dx, pool * dy)
        l2 = None
        if pool2 > 0:
            flat2, hb2, wb2 = _build_mip(dem_data, pool2)
            l2 = (flat2, hb2, wb2, pool2 * dx, pool2 * dy,
                  torch.arange(lookahead2, dtype=torch.float32, device=dem_data.device),
                  lookahead * seg_steps * step)
    return sample, l1, l2, (x0, y0, xmax, ymax)


def _block(m, m0, size, nb):
    """The mip block of centred coordinates m: truncation toward zero of a
    true division (JAX's ``astype(int32)``), clamped to [0, nb - 1]."""
    return ((m - m0) / size).to(torch.int32).clamp(0, nb - 1)


def _mip_body(origins, directions, sample, l1, l2, geom, max_steps, step,
              min_hit_step, seg_steps, lookahead, lookahead2):
    """The trip of the coarse-to-fine march for THESE rays, shared by
    ``march_rays_mip`` (one loop over all rays) and
    ``march_rays_mip_compact`` (staged loops over shrinking active sets).
    State: (allclear, i, done, hit, istop); the body takes ``allclear`` as
    the host's bool (the previous trip's, as read) and returns it as a 0-d
    tensor for the loop's read."""
    n = origins.shape[0]
    dev = origins.device
    pooled, hb, wb, bx_size, by_size = l1
    x0, y0, xmax, ymax = geom
    seg_len = seg_steps * step
    ks = torch.arange(lookahead, dtype=torch.float32, device=dev)
    kf = torch.arange(seg_steps, dtype=torch.int32, device=dev)
    ox, oy, oz = (origins[:, k, None] for k in range(3))
    dxr, dyr, dzr = (directions[:, k, None] for k in range(3))

    def outside(t):
        px = ox + t * dxr
        py = oy + t * dyr
        return (px < x0) | (px > xmax) | (py < y0) | (py > ymax)

    def l2_scan(i):
        """Level 2: lookahead2 super-segments of seg2_len; jump to the first
        suspicious one."""
        pooled2, hb2, wb2, b2x_size, b2y_size, ks2, seg2_len = l2
        t2 = (i.to(torch.float32) * step)[:, None] + ks2[None, :] * seg2_len
        t2e = t2 + seg2_len
        t2m = t2 + 0.5 * seg2_len
        b2xi = _block(ox + t2m * dxr, x0, b2x_size, wb2)
        b2yi = _block(oy + t2m * dyr, y0, b2y_size, hb2)
        zmax2 = pooled2[(b2yi * wb2 + b2xi).long()]
        z2s = oz + t2 * dzr
        z2e = oz + t2e * dzr
        susp2 = (torch.minimum(z2s, z2e) <= zmax2) | outside(t2) | outside(t2e)
        fs2 = torch.where(susp2.any(dim=1), _first_true(susp2),
                          lookahead2).to(torch.int32)
        return i + fs2 * (lookahead * seg_steps)

    def body(state):
        allclear, i, done, hit, istop = state
        if l2 is not None and allclear:
            # JAX's lax.cond(allclear, l2_scan, identity).
            i = l2_scan(i)
            COUNTS["l2_scans"] += 1
        t0 = i.to(torch.float32) * step

        # Coarse scan: lookahead segments [t0 + k * seg, ...].
        t_start = t0[:, None] + ks[None, :] * seg_len
        t_end = t_start + seg_len
        t_mid = t_start + 0.5 * seg_len
        bxi = _block(ox + t_mid * dxr, x0, bx_size, wb)
        byi = _block(oy + t_mid * dyr, y0, by_size, hb)
        zmax_seg = pooled[(byi * wb + bxi).long()]
        zmin_seg = torch.minimum(oz + t_start * dzr, oz + t_end * dzr)
        suspicious = (zmin_seg <= zmax_seg) | outside(t_start) | outside(t_end)
        any_susp = suspicious.any(dim=1)
        allclear = ~(any_susp & ~done).any()
        fs = torch.where(any_susp, _first_true(suspicious), lookahead).to(torch.int32)
        i_skip = i + fs * seg_steps

        # Fine scan: seg_steps exact steps from i_skip.
        g = i_skip[:, None] + kf[None, :]
        t = g.to(torch.float32) * step
        px = ox + t * dxr
        py = oy + t * dyr
        pz = oz + t * dzr
        z_dem = sample(px.reshape(-1), py.reshape(-1)).reshape(n, seg_steps)
        inside = (px >= x0) & (px <= xmax) & (py >= y0) & (py <= ymax)
        in_budget = g < max_steps
        hit_k = (g >= min_hit_step) & (pz <= z_dem) & inside & in_budget
        stop_k = (hit_k | ~inside) & in_budget
        any_stop = stop_k.any(dim=1) & ~done
        first = _first_true(stop_k).to(torch.int32)
        first_is_hit = hit_k.gather(1, first.long()[:, None])[:, 0]

        i_next = torch.clamp(i_skip + seg_steps, max=max_steps)
        i_stop = torch.where(any_stop, i_skip + first, i_next)
        new_i = torch.where(done, i, i_stop)
        hit = hit | (any_stop & first_is_hit)
        istop = torch.where(done, istop, i_stop)
        done = done | any_stop | (new_i >= max_steps)
        COUNTS["trips"] += 1
        return allclear, new_i, done, hit, istop

    return body


def _start_state(n, max_steps, device):
    return (False,
            torch.zeros(n, dtype=torch.int32, device=device),
            torch.zeros(n, dtype=torch.bool, device=device),
            torch.zeros(n, dtype=torch.bool, device=device),
            torch.full((n,), max_steps, dtype=torch.int32, device=device))


def march_rays_mip(origins: torch.Tensor, directions: torch.Tensor, dem_data,
                   x0, y0, dx, dy, max_steps: int, step: float = 1.0,
                   min_hit_step: int = 150, pool: int = 8, seg_steps: int = 32,
                   lookahead: int = 32, dem_pack=None, pool2: int = 0,
                   lookahead2: int = 16):
    """Coarse-to-fine (max-mipmap) batched ray march: the semantics of
    :func:`march_rays` with far fewer DEM samples.

    A pooled-max mip of the DEM (``pool`` x ``pool`` cells, 3x3-block
    dilated, so it bounds every bilinear sample whose query falls in the
    block) skips a segment [s, s + seg_steps * step] with one lookup when
    min(z_start, z_end) > pooled_max(mid).  Each trip scans ``lookahead``
    segments coarsely, jumps to the first suspicious one, and scans its
    ``seg_steps`` steps exactly as march_rays.  The caller keeps
    ``seg_steps * step <= pool * min(dx, dy)`` (``GeoInverter`` does).
    Positions are exact ``origin + i * step * dir``.

    ``pool2 > 0`` adds a second level: a trip first scans ``lookahead2``
    super-segments of ``lookahead * seg_steps`` steps against a ``pool2``
    mip, but only while the previous trip found every active ray's level-1
    window clear (``lookahead * seg_steps * step <= pool2 * min(dx, dy)``).
    """
    n = origins.shape[0]
    sample, l1, l2, geom = _mip_setup(dem_data, dem_pack, x0, y0, dx, dy, pool,
                                      pool2, lookahead, lookahead2, seg_steps, step)
    body = _mip_body(origins, directions, sample, l1, l2, geom, max_steps, step,
                     min_hit_step, seg_steps, lookahead, lookahead2)
    state = _start_state(n, max_steps, origins.device)
    while True:
        allclear, *rest = body(state)
        done_all, clear = _read(torch.stack([rest[1].all(), allclear]))
        state = (bool(clear), *rest)
        if done_all:
            break
    t_stop = state[4].to(torch.float32) * step
    return origins + t_stop[:, None] * directions, state[3]


def march_rays_mip_compact(origins: torch.Tensor, directions: torch.Tensor,
                           dem_data, x0, y0, dx, dy, max_steps: int,
                           step: float = 1.0, min_hit_step: int = 150,
                           pool: int = 8, seg_steps: int = 32,
                           lookahead: int = 32, dem_pack=None, pool2: int = 0,
                           lookahead2: int = 16, stages: tuple = (4, 16)):
    """Active-ray-compacting coarse-to-fine march: the semantics of
    :func:`march_rays_mip`.

    In the lockstep march every ray pays every trip until the slowest is
    done.  Here stage k stops once the active count fits the next bucket
    ``R / stages[k]``; a stable sort on ``done`` puts the active rays first,
    a slice to the bucket drops the finished ones, and the next stage
    marches only those, at 1/4, 1/16, ... of the width.  Results scatter
    back through the original index.  The active count read at the end of
    each trip (with the trip's ``allclear``) decides both the loop and the
    stage exit; each stage starts with ``allclear`` False, as JAX's."""
    n = origins.shape[0]
    dev = origins.device
    sample, l1, l2, geom = _mip_setup(dem_data, dem_pack, x0, y0, dx, dy, pool,
                                      pool2, lookahead, lookahead2, seg_steps, step)
    sizes = [n] + [max(-(-n // s), 1) for s in stages]
    hit_full = torch.zeros(n, dtype=torch.bool, device=dev)
    istop_full = torch.full((n,), max_steps, dtype=torch.int32, device=dev)
    orig = torch.arange(n, device=dev)
    cur_o, cur_d = origins, directions
    _, cur_i, cur_done, cur_hit, cur_istop = _start_state(n, max_steps, dev)
    active = n  # every ray is active at the start; then as read
    for k in range(len(sizes)):
        nxt = sizes[k + 1] if k + 1 < len(sizes) else 0
        body = _mip_body(cur_o, cur_d, sample, l1, l2, geom, max_steps, step,
                         min_hit_step, seg_steps, lookahead, lookahead2)
        state = (False, cur_i, cur_done, cur_hit, cur_istop)
        while active > 0 and active > nxt:
            allclear, *rest = body(state)
            active, clear = _read(torch.stack([(~rest[1]).sum(),
                                               allclear.to(torch.int64)]))
            state = (bool(clear), *rest)
        _, cur_i, cur_done, cur_hit, cur_istop = state
        hit_full[orig] = cur_hit
        istop_full[orig] = cur_istop
        if nxt > 0:
            # Stable sort: the active rays (done False) first.
            order = torch.sort(cur_done.to(torch.int32), stable=True).indices[:nxt]
            cur_o, cur_d = cur_o[order], cur_d[order]
            cur_i, cur_done = cur_i[order], cur_done[order]
            cur_hit, cur_istop = cur_hit[order], cur_istop[order]
            orig = orig[order]
    t_stop = istop_full.to(torch.float32) * step
    return origins + t_stop[:, None] * directions, hit_full


# ------------------------------------------------------------ inverter
@dataclass
class GeoInverter:
    """The solved camera and the DEM, answering pixel -> geo queries in a
    batch: the engine behind the reference's REPL (main_v1.py:934-958) and
    boundary conversion (main_v1.py:765-785), on ``device``."""

    K: np.ndarray
    R: np.ndarray
    ray_origin: np.ndarray      # [3] centred UTM
    dem: DemUtm
    control_pixels: np.ndarray  # [C, 2]
    control_pos3d: np.ndarray   # [C, 3] centred
    cfg: RaycastConfig = field(default_factory=RaycastConfig)
    device: str = "cuda"

    def _f32(self, a) -> torch.Tensor:
        with host_sync("geo.upload"):  # a blocking copy to the device
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def __post_init__(self):
        # The grid, its quad pack (one row gather a bilinear sample) and
        # the control geometry go to the device once.
        self._dem_arrs = self.dem.device_arrays(self.device)
        self._dem_pack = pack_bilinear(self.dem.data, self.device)
        self._K, self._R = self._f32(self.K), self._f32(self.R)
        self._control_pixels = self._f32(self.control_pixels)
        self._factors, self._valid = compute_optimization_factors(
            self._control_pixels, self._f32(self.control_pos3d), self._K,
            self._R, self._f32(self.ray_origin), self.cfg.factor_abs_max)
        self._scales = None
        if self.cfg.correction == "lsq_scales":
            ideal = self.control_pos3d - self.ray_origin
            ideal = ideal / np.linalg.norm(ideal, axis=1, keepdims=True)
            rays = proj.pixel_to_ray(self._control_pixels, self._K, self._R)
            self._scales, _ = fit_ray_scales(self._f32(ideal), rays)

    def rays_for(self, pixels: np.ndarray) -> torch.Tensor:
        with timed("geo.rays"):
            pixels = self._f32(np.atleast_2d(pixels))
            rays = proj.pixel_to_ray(pixels, self._K, self._R)
            if self.cfg.correction == "weighted_factors":
                w = calculate_weights(pixels, self._control_pixels,
                                      self.cfg.max_weight, self.cfg.knn_weight)
                f = weighted_factors(self._factors, self._valid, w)
                # The reference scales only z, then renormalizes
                # (main_v1.py:671-678).
                rays = torch.cat([rays[:, :2], rays[:, 2:] * f[:, 2:]], 1)
            elif self.cfg.correction == "lsq_scales":
                rays = rays * self._scales[None, :]
            return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)

    def march_params(self) -> dict:
        """The march's keywords for this DEM and config (JAX's
        ``pixel_to_geo``): max_steps; for the mip march, the segment that the
        level-1 mip covers and the smallest power-of-two pool2 covering a
        whole level-1 window."""
        cfg = self.cfg
        kw = dict(max_steps=int(cfg.max_search_dist_m / cfg.step_m),
                  step=cfg.step_m, min_hit_step=cfg.min_hit_step)
        if cfg.march != "mip":
            return kw
        pool, lookahead = 8, 32
        spacing = min(abs(self.dem.dx), abs(self.dem.dy))
        seg_steps = int(min(max(int(pool * spacing / cfg.step_m), 1), 32))
        pool2 = 1
        while pool2 * spacing < lookahead * seg_steps * cfg.step_m:
            pool2 *= 2
        return dict(kw, pool=pool, seg_steps=seg_steps, lookahead=lookahead,
                    pool2=pool2)

    def march(self, rays: torch.Tensor):
        """(positions [R, 3] centred, hit [R]) of ``rays`` from the origin,
        by the config's march."""
        with timed("geo.march"):
            origins = self._f32(self.ray_origin).expand(rays.shape[0], 3)
            fn = march_rays_mip if self.cfg.march == "mip" else march_rays
            return fn(origins, rays, *self._dem_arrs, dem_pack=self._dem_pack,
                      **self.march_params())

    def pixel_to_geo(self, pixels: np.ndarray):
        """[R, 2] pixels -> (utm [R, 3] float64 absolute, hit mask [R]); a
        call is a request, the root of its spans."""
        with timed("pixel_to_geo"):
            pos, hit = self.march(self.rays_for(np.asarray(pixels, np.float64)))
            with host_sync("geo.answer", n=2):
                pos, hit = pos.cpu(), hit.cpu()
            utm = self.dem.frame.uncenter(pos.numpy().astype(np.float64))
            return utm, hit.numpy()

    def convert_boundary(self, json_data: dict):
        """ISAT segmentation JSON -> ({(group, category): [utm rows]},
        {(group, category): [pixels]}), batched (main_v1.py:765-785, with
        its ``geo_coord.all()`` nonzero filter)."""
        keys, pix = [], []
        for obj in json_data.get("objects", []):
            group = obj.get("group")
            category = re.sub(r"[^a-zA-Z0-9]", "", str(obj.get("category")))
            for px, py in obj.get("segmentation", []):
                keys.append((group, category))
                pix.append((px, py))
        if not pix:
            return {}, {}
        utm, hit = self.pixel_to_geo(np.asarray(pix, np.float64))
        geo, pixels = {}, {}
        for k, p, u, h in zip(keys, pix, utm, hit):
            if not h or not u.all():
                continue
            geo.setdefault(k, []).append(u)
            pixels.setdefault(k, []).append(p)
        return geo, pixels


def localized_inverter(scene, result, dem: DemUtm,
                       cfg: RaycastConfig = RaycastConfig(), device="cuda"):
    """The ``localize --dem`` inverter of a localization ``result``
    (``pipelines.localize``): the PnP camera put ``cfg.camera_height_above_dem_m``
    above the DEM under it (main_v1.py:914-915), the scene's annotated
    landmarks as control points.  ``dem`` holds elevations centred as the
    scene is (``io.dem.center_elevations``).  None where the camera is
    outside the DEM (main_v1.py:921-929)."""
    from ransac_tpu_torch.io.dem import in_bounds

    origin = scene.frame.center(result.camera_origin_utm[None])[0]
    arrs = dem.device_arrays(device)
    xy = torch.as_tensor(origin[:2], dtype=torch.float32, device=device)
    z_dem = float(bilinear_sample(*arrs, xy[0], xy[1]))
    origin = np.array([origin[0], origin[1], z_dem + cfg.camera_height_above_dem_m])
    if not bool(in_bounds(dem, origin[0], origin[1])):
        return None
    feats = scene.features
    return GeoInverter(
        K=result.K, R=result.R, ray_origin=origin, dem=dem,
        control_pixels=feats.pixels.astype(np.float32).astype(np.float64),
        control_pos3d=scene.frame.center(feats.pos3d_utm).astype(np.float64),
        cfg=cfg, device=device)
