"""Perspective camera (port of ``pbrt_tpu/cameras/cameras.py``'s
``ProjectiveCamera`` for kind "perspective"; reference:
src/cameras/perspective.cpp:55-130, thin lens and ray differentials
included).

Orthographic, pinhole, environment and the lens-simulation cameras wait
for later slices. An animated camera-to-world transform is interpolated
at each ray's time (``AnimatedTransform.interpolate``, cameras.py:91-95,
:111); a static one is applied as its single matrix.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class PerspectiveCamera:
    raster_to_camera: torch.Tensor  # (4, 4) f32
    cam_to_world: torch.Tensor  # (4, 4) f32, the shutter-open keyframe
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    fov_deg: float = 0.0
    #: the animated camera-to-world transform; None when it is static
    motion: xf.AnimatedTransform | None = None

    def _c2w(self, time):
        return self.cam_to_world if self.motion is None else self.motion.interpolate(time)

    def generate_rays(self, px, py, u_lens1, u_lens2, u_time) -> geom.Ray:
        """px, py: (R,) continuous raster coordinates; uniforms (R,)."""
        p_ras = torch.stack([px, py, torch.zeros_like(px)], -1)
        p_cam = xf.apply_point(self.raster_to_camera, p_ras)
        o = torch.zeros_like(p_cam)
        d = geom.normalize(p_cam)
        if self.lens_radius > 0.0:
            lx, ly = smp.concentric_sample_disk(u_lens1, u_lens2)
            lx = lx * self.lens_radius
            ly = ly * self.lens_radius
            ft = self.focal_distance / torch.clamp(d[..., 2], min=1e-9)
            p_focus = o + ft[..., None] * d
            o = torch.stack([lx, ly, torch.zeros_like(lx)], -1)
            d = geom.normalize(p_focus - o)
        time = self.shutter_open + u_time * (self.shutter_close - self.shutter_open)
        c2w = self._c2w(time)
        o_w = xf.apply_point(c2w, o)
        d_w = xf.apply_vector(c2w, d)
        return geom.Ray.make(o_w, d_w, time=time)

    def ray_differentials(self, px, py, ray: geom.Ray):
        """The rays one raster pixel over in x and in y: the same origin,
        directions through the shifted film points
        (GenerateRayDifferential, perspective.cpp:99-130; the JAX
        package's cameras.py:97-119). → world (rx_o, rx_d, ry_o, ry_d)."""
        p_ras = torch.stack([px, py, torch.zeros_like(px)], -1)
        p_cam = xf.apply_point(self.raster_to_camera, p_ras)
        one = torch.eye(3, dtype=p_ras.dtype, device=p_ras.device)
        dx = xf.apply_point(self.raster_to_camera, p_ras + one[0]) - p_cam
        dy = xf.apply_point(self.raster_to_camera, p_ras + one[1]) - p_cam
        c2w = self._c2w(ray.time)
        rx_d = xf.apply_vector(c2w, geom.normalize(p_cam + dx))
        ry_d = xf.apply_vector(c2w, geom.normalize(p_cam + dy))
        return ray.origin, rx_d, ray.origin, ry_d


def make_camera(name, params, cam_to_world: xf.AnimatedTransform, xres: int,
                yres: int, device) -> PerspectiveCamera:
    if name != "perspective":
        raise NotImplementedError(f"camera {name!r} is not ported yet")
    window = screen_window(xres, yres, params)
    s2r = _screen_to_raster(xres, yres, window)
    fov = params.find_one_float("fov", 90.0)
    c2s = xf.perspective(fov, 1e-2, 1000.0)
    r2c = xf.inverse(c2s) @ xf.inverse(s2r)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return PerspectiveCamera(
        raster_to_camera=f32(r2c), cam_to_world=f32(cam_to_world.m_start),
        motion=None if cam_to_world.is_static else cam_to_world,
        lens_radius=float(np.float32(params.find_one_float("lensradius", 0.0))),
        focal_distance=float(np.float32(params.find_one_float("focaldistance", 1e30))),
        shutter_open=params.find_one_float("shutteropen", 0.0),
        shutter_close=params.find_one_float("shutterclose", 1.0),
        fov_deg=float(fov),
    )
