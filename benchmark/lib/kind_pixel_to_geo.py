"""Traffic of kind ``pixel_to_geo``: each request is one batch of pixels
through the port's ``GeoInverter.pixel_to_geo``, the engine of the
reference's REPL (main_v1.py:934-958).

Set-up draws one photograph and its terrain from the seed, writes the
photograph's CSVs and the terrain as a GeoTIFF under the run's work
directory, localizes the photograph through the port (the CLI's default
route), loads the DEM through the port's ``io.dem`` as ``localize --dem``
does, and builds the port's ``localized_inverter``.  Request i's pixels
are drawn from (seed, i), uniformly over the image.

The comparison holds every ray of every request against the plain
reference's ray and surface.  The reference starts from the camera the
program's localization found (the program's state: the stage the
requests time starts there), so the start is checked by itself: the
set-up's localization against the reference's, by ``kind_localize``'s
numbers under ``start_``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import kind_localize as kl
import reference as ref
import scenes

NUMBERS = ("dir_excess_urad", "stop_violation_m")
#: Every number ``judge_run`` returns (the start's under ``start_``): the
#: keys of a mix's ``limits``.
LIMITS = NUMBERS + tuple("start_" + n for n in kl.NUMBERS)


def program_raycast_config(cfg: dict):
    from ransac_tpu_torch.utils.config import RaycastConfig

    return RaycastConfig(**cfg["raycast"])


class Session:
    def __init__(self, cfg, traffic, seed, device, workdir, n_candidates=None):
        from ransac_tpu_torch.io.dem import (center_elevations, load_geotiff,
                                             resample_to_utm)
        from ransac_tpu_torch.pipelines.localize import localize
        from ransac_tpu_torch.pipelines.raycast import localized_inverter

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.grid, (self.photo,) = kl.make_photos(cfg, 1, seed, n_candidates)
        self.terrain = scenes.planted_terrain(self.photo, cfg["dem"], cfg["observer_height_m"])
        tif = os.path.join(workdir, "dem.tif")
        scenes.write_geotiff(tif, self.terrain)
        scene = kl.ingest(cfg, self.grid, self.photo, os.path.join(workdir, "photo"), device)
        res = localize(scene, tuple(cfg["image_size"]), kl.program_config(cfg),
                       use_sweep=False, device=device)
        self.localized = kl.answer_of(0, res)
        dem = center_elevations(resample_to_utm(load_geotiff(tif), scene.frame,
                                                spacing_m=cfg["dem"]["resample_spacing_m"]))
        self.inverter = localized_inverter(scene, res, dem, program_raycast_config(cfg),
                                           device=device)
        if self.inverter is None:
            raise RuntimeError("the localized camera lies outside the DEM")

    def next_input(self, i: int) -> np.ndarray:
        return request_pixels(self.cfg, self.traffic, self.seed, i)

    def request(self, pixels: np.ndarray):
        utm, hit = self.inverter.pixel_to_geo(pixels)
        return pixels, np.asarray(utm, np.float64), np.asarray(hit, bool)

    def release(self) -> None:
        self.inverter = None


def request_pixels(cfg: dict, traffic: dict, seed: int, i: int) -> np.ndarray:
    w, h = cfg["image_size"]
    rng = np.random.default_rng([seed, 3, i])
    return rng.uniform([0.0, 0.0], [w, h], size=(traffic["pixels"], 2))


class Ground:
    """The reference's side of the DEM stage, from the benchmark's inputs
    and the program's camera (R and centre)."""

    def __init__(self, cfg, grid, photo, terrain, localized, device,
                 P: ref.Prec = ref.REFERENCE):
        self.cfg, self.P = cfg, P
        rc = cfg["raycast"]
        self.anchor = np.concatenate([photo.landmarks, grid.utm]).mean(0)
        lon, lat = scenes.tiff_lonlat(terrain)
        self.surface = ref.utm_surface(terrain.data, lon, lat, self.anchor,
                                       cfg["dem"]["resample_spacing_m"], P, device)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=P.dtype, device=device)  # noqa: E731
        c = t(localized.origin - self.anchor)
        z = ref.sample(self.surface, c[None, 0], c[None, 1])[0]
        self.origin = torch.stack([c[0], c[1], z + rc["camera_height_above_dem_m"]])
        self.K, self.R = t(scenes.film_K(cfg)), t(localized.R)
        self.ctrl_pixels = t(photo.pixels)
        self.ctrl_pos = t(photo.landmarks - self.anchor)

    def rays(self, pixels: np.ndarray) -> torch.Tensor:
        return ref.corrected_rays(self._px(pixels), self.K, self.R, self.origin,
                                  self.ctrl_pixels, self.ctrl_pos, self.cfg["raycast"], self.P)

    def tolerance(self, pixels: np.ndarray) -> torch.Tensor:
        return ref.correction_tolerance(self._px(pixels), self.K, self.R, self.origin,
                                        self.ctrl_pixels, self.ctrl_pos, self.cfg["raycast"])

    def _px(self, pixels: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(pixels, dtype=self.P.dtype, device=self.origin.device)

    def answer(self, pixels: np.ndarray):
        """The reference's own march from its rays (the control's answer)."""
        d = self.rays(pixels)
        stop, hit = ref.march(self.surface, self.origin, d, self.cfg["raycast"])
        t = stop.to(d.dtype) * self.cfg["raycast"]["step_m"]
        pos = self.origin + t[:, None] * d
        return pixels, pos.double().cpu().numpy() + self.anchor, hit.cpu().numpy()


def control_answers(session: Session, n: int, device) -> list:
    """The control's answers to the session's first ``n`` requests, from the
    program's set-up camera."""
    ground = Ground(session.cfg, session.grid, session.photo, session.terrain,
                    session.localized, device, ref.CONTROL)
    return [ground.answer(session.next_input(i)) for i in range(n)]


def judge(cfg, grid, photo, terrain, localized, answers, device):
    """[numbers of each answer]: its rays' directions against the
    reference's, beyond what float32 rounding of the control factors allows
    (``reference.correction_tolerance``), and its stops against the
    march's rule on the reference's surface along the reference's rays."""
    g = Ground(cfg, grid, photo, terrain, localized, device)
    rc = cfg["raycast"]
    o_abs = g.origin.cpu().numpy() + g.anchor
    out = []
    for pixels, utm, hit in answers:
        d = g.rays(pixels)
        v = torch.as_tensor(utm - o_abs, dtype=torch.float64, device=d.device)
        t = torch.linalg.vector_norm(v, dim=-1)
        chord = torch.linalg.vector_norm(v / t[:, None].clamp(min=1e-30) - d, dim=-1)
        stop = torch.round(t / rc["step_m"]).long()
        viol = ref.stop_violations(g.surface, g.origin, d, stop,
                                   torch.as_tensor(hit, device=d.device), rc)
        angle = 2.0 * torch.arcsin((0.5 * chord).clamp(max=1.0))
        excess = (angle - g.tolerance(pixels)).clamp(min=0.0)
        out.append({"dir_excess_urad": float(excess.max()) * 1e6,
                    "stop_violation_m": float(viol.max())})
    return out


def judge_start(cfg, grid, photo, localized, device) -> dict:
    """The set-up's localization against the reference's, as
    ``kind_localize`` holds a request."""
    r = kl.Reference(cfg, grid, photo, device)
    return {"start_" + k: v for k, v in kl.judge_one(r, localized).items()}


def judge_run(session: Session, answers, device) -> list[dict]:
    """Every request's numbers, and the start's (not a request)."""
    start = judge_start(session.cfg, session.grid, session.photo, session.localized, device)
    return judge(session.cfg, session.grid, session.photo, session.terrain,
                 session.localized, answers, device) + [dict(start, request=False)]
