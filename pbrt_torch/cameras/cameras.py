"""Projective cameras: perspective, orthographic, pinhole, environment
(port of ``pbrt_tpu/cameras/cameras.py``; reference:
src/cameras/{perspective,orthographic,environment}.cpp and the fork's
pinhole.cpp). ``make_camera`` also dispatches the fork's lens cameras
(``cameras/realistic.py``, ``cameras/eye.py``).

Every camera's ``generate_rays(px, py, u_lens1, u_lens2, u_time,
wavelength=None, noise=None)`` turns (R,) continuous raster coordinates
and uniforms into world rays. ``wavelength`` (nm, a number or (R,)) and
``noise`` (the keyed normals of ``core/rng.py:camera_normals``, (R, T, 2)
for the camera's ``noise_tags``) matter only to the lens cameras; the
cameras here have no noise tags and pass the wavelength through. An
animated camera-to-world transform is interpolated at each ray's time
(``AnimatedTransform.interpolate``, cameras.py:91-95); a static one is
applied as its single matrix.

Only the projective camera has ray differentials (perspective.cpp:99-130,
orthographic.cpp:63-76); for the others a textured scene takes the
renderer's pixel-cone footprint, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.core import sampling as smp
from pbrt_torch.core import transform as xf


def screen_window(xres: int, yres: int, params=None):
    """Default screen window from the aspect (camera.cpp:78-87)."""
    if params is not None:
        sw = params.find_floats("screenwindow")
        if sw is not None and len(sw) == 4:
            return tuple(float(v) for v in sw)
    aspect = xres / yres
    if aspect > 1.0:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def _screen_to_raster(xres, yres, window):
    x0, x1, y0, y1 = window
    return (xf.scale(xres, yres, 1.0)
            @ xf.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
            @ xf.translate((-x0, -y1, 0.0)))


class CameraPlacement:
    """What every camera shares: the shutter, the camera-to-world transform
    (``cam_to_world`` the (4, 4) shutter-open keyframe on the device,
    ``motion`` the animated transform or None) and the lens metadata the
    film header carries. Subclasses are dataclasses with these fields."""

    noise_tags = range(0)  # the fold-in tags of the camera's keyed normals

    def _c2w(self, time):
        return self.cam_to_world if self.motion is None else self.motion.interpolate(time)

    def shutter_time(self, u_time):
        return self.shutter_open + u_time * (self.shutter_close - self.shutter_open)

    def to_world(self, o, d, u_time, wavelength=None, renormalize=False,
                 keep=None) -> geom.Ray:
        """Camera-space (o, d) → world rays at the sampled shutter times;
        the lens cameras renormalize the world direction and zero it off
        ``keep`` (R,) bool, their live lanes."""
        time = self.shutter_time(u_time)
        c2w = self._c2w(time)
        d_w = xf.apply_vector(c2w, d)
        if renormalize:
            d_w = geom.normalize(d_w)
        if keep is not None:
            d_w = d_w * keep[:, None]
        return geom.Ray.make(xf.apply_point(c2w, o), d_w, time=time, wavelength=wavelength)


@dataclasses.dataclass
class ProjectiveCamera(CameraPlacement):
    """Perspective or orthographic (``kind``), with the thin lens."""

    raster_to_camera: torch.Tensor  # (4, 4) f32
    cam_to_world: torch.Tensor  # (4, 4) f32, the shutter-open keyframe
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    fov_deg: float = 0.0
    #: the animated camera-to-world transform; None when it is static
    motion: xf.AnimatedTransform | None = None
    kind: str = "perspective"
    focal_length_mm: float = 0.0
    f_stop: float = 0.0

    def generate_rays(self, px, py, u_lens1, u_lens2, u_time, wavelength=None,
                      noise=None) -> geom.Ray:
        """px, py: (R,) continuous raster coordinates; uniforms (R,)."""
        p_ras = torch.stack([px, py, torch.zeros_like(px)], -1)
        p_cam = xf.apply_point(self.raster_to_camera, p_ras)
        if self.kind == "orthographic":
            o = p_cam
            d = torch.zeros_like(p_cam)
            d[:, 2] = 1.0
        else:
            o = torch.zeros_like(p_cam)
            d = geom.normalize(p_cam)
        if self.lens_radius > 0.0:
            lx, ly = smp.concentric_sample_disk(u_lens1, u_lens2)
            ft = self.focal_distance / torch.clamp(d[..., 2], min=1e-9)
            p_focus = o + ft[..., None] * d
            lens = torch.stack([lx * self.lens_radius, ly * self.lens_radius,
                                torch.zeros_like(lx)], -1)
            o = o + lens if self.kind == "orthographic" else lens
            d = geom.normalize(p_focus - o)
        return self.to_world(o, d, u_time, wavelength)

    def ray_differentials(self, px, py, ray: geom.Ray):
        """The rays one raster pixel over in x and in y: the same origin,
        directions through the shifted film points; an orthographic camera
        shifts the origin instead (cameras.py:97-119). → world (rx_o, rx_d,
        ry_o, ry_d)."""
        p_ras = torch.stack([px, py, torch.zeros_like(px)], -1)
        p_cam = xf.apply_point(self.raster_to_camera, p_ras)
        one = torch.eye(3, dtype=p_ras.dtype, device=p_ras.device)
        dx = xf.apply_point(self.raster_to_camera, p_ras + one[0]) - p_cam
        dy = xf.apply_point(self.raster_to_camera, p_ras + one[1]) - p_cam
        c2w = self._c2w(ray.time)
        if self.kind == "orthographic":
            return (ray.origin + xf.apply_vector(c2w, dx), ray.direction,
                    ray.origin + xf.apply_vector(c2w, dy), ray.direction)
        rx_d = xf.apply_vector(c2w, geom.normalize(p_cam + dx))
        ry_d = xf.apply_vector(c2w, geom.normalize(p_cam + dy))
        return ray.origin, rx_d, ray.origin, ry_d


@dataclasses.dataclass
class PinholeCamera(CameraPlacement):
    """The fork's pinhole: the film plane at ``film_distance`` behind an
    ideal pinhole at the origin (pinhole.h:27-34; cameras.py:122-149)."""

    raster_to_camera: torch.Tensor  # (4, 4) raster → screen window
    cam_to_world: torch.Tensor
    film_distance: float
    shutter_open: float
    shutter_close: float
    motion: xf.AnimatedTransform | None = None
    fov_deg: float = 0.0
    focal_length_mm: float = 0.0
    f_stop: float = 0.0

    def generate_rays(self, px, py, u_lens1, u_lens2, u_time, wavelength=None,
                      noise=None) -> geom.Ray:
        p_ras = torch.stack([px, py, torch.zeros_like(px)], -1)
        p_film = xf.apply_point(self.raster_to_camera, p_ras)
        p_film[:, 2] = -self.film_distance
        return self.to_world(torch.zeros_like(p_film), geom.normalize(-p_film), u_time,
                             wavelength)


@dataclasses.dataclass
class EnvironmentCamera(CameraPlacement):
    """360° latitude-longitude camera (environment.cpp:48-75;
    cameras.py:152-184)."""

    cam_to_world: torch.Tensor
    shutter_open: float
    shutter_close: float
    xres: int
    yres: int
    motion: xf.AnimatedTransform | None = None
    fov_deg: float = 360.0
    focal_length_mm: float = 0.0
    f_stop: float = 0.0

    def generate_rays(self, px, py, u_lens1, u_lens2, u_time, wavelength=None,
                      noise=None) -> geom.Ray:
        theta = math.pi * py / self.yres
        phi = 2.0 * math.pi * px / self.xres
        st = torch.sin(theta)
        d = torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)], -1)
        return self.to_world(torch.zeros_like(d), d, u_time, wavelength)


def placement(cam_to_world: xf.AnimatedTransform, params, device) -> dict:
    """The ``CameraPlacement`` fields from the scene's transform and the
    camera's shutter parameters."""
    return dict(
        cam_to_world=torch.as_tensor(np.asarray(cam_to_world.m_start, np.float32),
                                     device=device),
        motion=None if cam_to_world.is_static else cam_to_world,
        shutter_open=params.find_one_float("shutteropen", 0.0),
        shutter_close=params.find_one_float("shutterclose", 1.0),
    )


def make_camera(name, params, cam_to_world: xf.AnimatedTransform, xres: int,
                yres: int, device):
    """The camera ``name`` from its parameters (the reference's
    Create*Camera defaults; cameras.py:190-249)."""
    place = placement(cam_to_world, params, device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if name in ("perspective", "orthographic"):
        s2r = _screen_to_raster(xres, yres, screen_window(xres, yres, params))
        if name == "perspective":
            fov = params.find_one_float("fov", 90.0)
            c2s = xf.perspective(fov, 1e-2, 1000.0)
        else:
            fov = 0.0
            c2s = xf.orthographic(0.0, 1.0)
        return ProjectiveCamera(
            raster_to_camera=f32(xf.inverse(c2s) @ xf.inverse(s2r)),
            lens_radius=float(np.float32(params.find_one_float("lensradius", 0.0))),
            focal_distance=float(np.float32(params.find_one_float("focaldistance", 1e30))),
            fov_deg=float(fov), kind=name, **place)
    if name == "pinhole":
        s2r = _screen_to_raster(xres, yres, screen_window(xres, yres, params))
        return PinholeCamera(
            raster_to_camera=f32(xf.inverse(s2r)),
            film_distance=float(np.float32(params.find_one_float("filmdistance", 1.0))),
            **place)
    if name == "environment":
        return EnvironmentCamera(xres=xres, yres=yres, **place)
    if name == "idealDiffraction":
        from pbrt_torch.cameras.realistic import make_ideal_diffraction

        return make_ideal_diffraction(params, place, xres, yres)
    if name in ("realistic", "realisticDiffraction", "perspectiveDiffraction"):
        from pbrt_torch.cameras.realistic import make_realistic_diffraction

        return make_realistic_diffraction(params, place, xres, yres)
    if name == "realisticEye":
        from pbrt_torch.cameras.eye import make_realistic_eye

        return make_realistic_eye(params, place, xres, yres)
    raise ValueError(f"unknown camera {name!r}")
