"""The fork's ``realisticEye`` camera: schematic human-eye optics with
biconic surfaces, spectral ocular media and a curved retina. Port of
``pbrt_tpu/cameras/eye.py``; reference: src/cameras/realisticEye.cpp.

As the JAX package traces it:

- the lens file holds the effective focal length, then rows of (radiusX,
  radiusY, thickness, medium index, semi-diameter, conicX, conicY), front
  to back; ``flipLensRadius`` negates radii and conics, a stop row (both
  radii 0) takes ``pupilDiameter``, and a semi-diameter the conic cannot
  reach is clamped to 0.95 of its limit (eye.py:267-332);
- media 1 … 6 take the ``ior1`` … ``ior6`` spectra, read at the ray's
  wavelength (550 nm where it is 0) by ``value_at_wavelength``
  (eye.py:78-89);
- the film point lies on the curved retina (``retinaRadius``,
  ``retinaSemiDiam`` at ``retinaDistance``), lanes off its cap dead; rays
  aim at the rear surface's disk and trace rear → front: the stop plane or
  a biconic surface, hit by 48 bisection steps of its sag equation
  (``BISECT_ITERS``), then Snell's law between the element's medium and
  the next non-stop row's (eye.py:90-265);
- ``lensDecenterX/Y`` and ``lensTiltX/Y`` are read into the camera and
  applied by neither the JAX package's trace nor this one.

Plain PyTorch over the whole wave, one Python loop over the static
surfaces; a biconic surface is about 48 × 28 launches of bisection.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_torch.cameras.cameras import CameraPlacement
from pbrt_torch.cameras.realistic import lane_wavelengths, refract, safe_dz
from pbrt_torch.config import DEFAULT_SPECTRAL
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import sampling as smp
from pbrt_torch.core import spectrum as spec
from pbrt_torch.scene.paramset import read_float_file

F32 = np.float32
BISECT_ITERS = 48


def biconic_z(x, y, rx, ry, cx, cy):
    """Sag z(x, y) of a biconic surface (BiconicZ, realisticEye.cpp:877-895;
    eye.py:44-50), in float32."""
    f = (x * x) / rx + (y * y) / ry
    g = 1.0 - (1.0 + cx) * (x * x) / (rx * rx) - (1.0 + cy) * (y * y) / (ry * ry)
    return f / (1.0 + torch.sqrt(torch.clamp(g, min=0.001)))


@dataclasses.dataclass
class RealisticEyeCamera(CameraPlacement):
    """The surfaces in trace order (rear → front), host (E,) arrays."""

    el_rx: np.ndarray  # float32
    el_ry: np.ndarray
    el_thickness: np.ndarray
    el_medium: np.ndarray  # int, 0 for a stop
    el_semidiam: np.ndarray
    el_cx: np.ndarray
    el_cy: np.ndarray
    ior_spectra: torch.Tensor  # (6, n_bins) on the device
    cam_to_world: torch.Tensor
    shutter_open: float
    shutter_close: float
    retina_distance: float  # float32 values, mm
    retina_radius: float = 0.0
    retina_semidiam: float = 0.0
    pupil_diameter: float = 4.0
    lens_decenter: tuple = (0.0, 0.0)
    lens_tilt: tuple = (0.0, 0.0)
    motion: object = None
    xres: int = 256
    yres: int = 256
    film_diag: float = 10.0
    focal_length_mm: float = 16.7
    f_stop: float = 4.0
    fov_deg: float = 0.0

    def _medium_ior(self, medium: int, lam_eff):
        """The index of 1-based medium ``medium`` at λ (lookUpIOR,
        realisticEye.cpp:899-918); 1 outside the media."""
        if medium <= 0:
            return torch.ones_like(lam_eff)
        curve = self.ior_spectra[min(medium - 1, self.ior_spectra.shape[0] - 1)]
        return spec.value_at_wavelength(curve.expand(lam_eff.shape + curve.shape), lam_eff)

    def _next_medium(self, i: int) -> int:
        """The medium on surface i's scene side: the next row's, or the one
        after it where the next is a stop (eye.py:209-217); 0 past the front."""
        n = len(self.el_rx)
        if i + 1 >= n:
            return 0
        nm = int(self.el_medium[i + 1])
        return int(self.el_medium[min(i + 2, n - 1)]) if nm == 0 and i + 2 < n else nm

    def generate_rays(self, px, py, u_lens1, u_lens2, u_time, wavelength=None,
                      noise=None) -> geom.Ray:
        lam = lane_wavelengths(wavelength, px, 0.0)
        lam_eff = torch.where(lam == 0.0, 550.0, lam)
        ar = self.xres / self.yres
        width = self.film_diag / np.sqrt(1.0 + 1.0 / (ar * ar))
        height = width / ar
        hx, hy = self.xres / 2.0, self.yres / 2.0
        x0 = -(px - hx - 0.25) / hx * width / 2.0
        y0 = (py - hy - 0.25) / hy * height / 2.0
        rd = F32(self.retina_distance)
        alive = torch.ones_like(px, dtype=torch.bool)
        if self.retina_radius != 0.0:  # the curved retina (eye.py:119-141)
            rr, rs = F32(self.retina_radius), F32(self.retina_semidiam)
            alive = (x0 * x0 + y0 * y0) <= float(rs ** 2)
            z_disc = float(-np.sqrt(np.maximum(rr ** 2 - rs ** 2, F32(1e-12))))
            el = torch.atan(x0 / z_disc)
            az = torch.atan(y0 / z_disc)
            rcos = float(rr) * torch.cos(el)
            x0, y0, z0 = (float(-rr) * torch.sin(el), -rcos * torch.sin(az),
                          -(rcos * torch.cos(az)) - float(rd) + float(rr))
        else:
            z0 = torch.full_like(x0, -float(rd))
        o = torch.stack([x0, y0, z0], -1)

        lu, lv = smp.concentric_sample_disk(u_lens1, u_lens2)
        semi0, r0 = float(self.el_semidiam[0]), float(self.el_rx[0])
        disc_z = 0.0
        if r0 != 0.0:  # sgn(radius) · BiconicZ(semiDiam, 0) (eye.py:147-157)
            ry0 = float(self.el_ry[0]) or 1e9
            t = lambda v: torch.tensor(v, dtype=torch.float32)  # host float32 scalars
            disc_z = (1.0 if r0 > 0.0 else -1.0) * float(biconic_z(
                t(semi0), t(0.0), t(r0), t(ry0), t(float(self.el_cx[0])),
                t(float(self.el_cy[0]))))
        target = torch.stack([lu * semi0, lv * semi0, torch.full_like(lu, disc_z)], -1)
        d = geom.normalize(target - o)

        lens_dist = F32(0.0)
        for i in range(len(self.el_rx)):
            rx, ry = F32(self.el_rx[i]), F32(self.el_ry[i])
            thick = F32(self.el_thickness[i])
            lens_dist = lens_dist + thick
            semi2 = float(F32(self.el_semidiam[i]) * F32(self.el_semidiam[i]))
            dz_safe = safe_dz(d[:, 2])
            if rx == 0.0 and ry == 0.0:  # the stop's plane
                t_ap = (float(rd) if i == 0 else float(lens_dist) - o[:, 2]) / dz_safe
                new_o = o + t_ap[:, None] * d
                ok = new_o[:, 0] ** 2 + new_o[:, 1] ** 2 <= semi2
                new_d = d
            else:
                t_hi = rd * F32(2.0) if thick == 0.0 else thick * F32(1.5)
                new_o, normal, ok = self._biconic_hit(
                    o, d, lens_dist, rx if rx != 0 else F32(1e9), ry if ry != 0 else F32(1e9),
                    F32(self.el_cx[i]), F32(self.el_cy[i]), float(t_hi), semi2)
                n1 = self._medium_ior(int(self.el_medium[i]), lam_eff)
                n2 = self._medium_ior(self._next_medium(i), lam_eff)
                new_d, tir = refract(d, geom.face_forward(normal, -d), n1 / n2)
                ok = ok & ~tir
            alive = alive & ok
            o = torch.where(alive[:, None], new_o, o)
            d = torch.where(alive[:, None], new_d, d)
        d = torch.where(alive[:, None], d, 0.0)
        return self.to_world(o, d, u_time, lam, renormalize=True, keep=alive)

    @staticmethod
    def _biconic_hit(o, d, lens_dist, rx, ry, cx, cy, t_hi: float, semi2: float):
        """A biconic surface with its vertex at z = lens_dist: the hit by
        bisection on [0, t_hi] (IntersectLensElAspheric, realisticEye.cpp:
        364-470), the sag's normal (:470-500). → (point, normal, hit
        bracketed and within the semi-diameter)."""
        oz = o[:, 2] + float(-lens_dist)

        def sag(t):
            return (oz + t * d[:, 2]) - biconic_z(o[:, 0] + t * d[:, 0], o[:, 1] + t * d[:, 1],
                                                  float(rx), float(ry), float(cx), float(cy))

        lo = torch.zeros_like(oz)
        hi = torch.full_like(oz, t_hi)
        f_lo = sag(lo)
        bracket = f_lo * sag(hi) < 0.0
        for _ in range(BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            f_mid = sag(mid)
            go_lo = f_lo * f_mid < 0.0
            hi = torch.where(go_lo, mid, hi)
            lo = torch.where(go_lo, lo, mid)
            f_lo = torch.where(go_lo, f_lo, f_mid)
        p = o + (0.5 * (lo + hi))[:, None] * d
        within = p[:, 0] ** 2 + p[:, 1] ** 2 <= semi2
        hx, hy = p[:, 0], p[:, 1]
        rx2, ry2 = float(rx * rx), float(ry * ry)
        c1x, c1y = float(F32(1.0) + cx), float(F32(1.0) + cy)
        root = torch.sqrt(torch.clamp(1.0 - c1x * hx * hx / rx2 - c1y * hy * hy / ry2,
                                      min=1e-6))
        fq = (hx * hx) / float(rx) + (hy * hy) / float(ry)
        gq = 1.0 + root
        zx = (2.0 * hx / float(rx) * gq - (-c1x * hx) / (rx2 * root) * fq) / (gq * gq)
        zy = (2.0 * hy / float(ry) * gq - (-c1y * hy) / (ry2 * root) * fq) / (gq * gq)
        one, zero = torch.ones_like(hx), torch.zeros_like(hx)
        normal = geom.normalize(geom.cross(torch.stack([one, zero, zx], -1),
                                           torch.stack([zero, one, zy], -1)))
        return p, normal, bracket & within


def make_realistic_eye(params, place: dict, xres: int, yres: int):
    """CreateRealisticEyeCamera (realisticEye.cpp:60-135; eye.py:267-332)."""
    specfile = params.find_one_filename("specfile", "")
    if not specfile:
        raise ValueError("realisticEye needs a specfile")
    vals = read_float_file(specfile)
    if (len(vals) - 1) % 7 != 0:
        raise ValueError(f"{specfile}: rows must be [rx ry thick medium semidiam cx cy]")
    efl = float(vals[0])
    rows = vals[1:].reshape(-1, 7)
    pupil = params.find_one_float("pupilDiameter", 4.0)
    rx, ry, cx, cy = (rows[:, k].copy() for k in (0, 1, 5, 6))
    if params.find_one_bool("flipLensRadius", False):
        rx, ry, cx, cy = -rx, -ry, -cx, -cy
    semidiam = rows[:, 4].copy()
    stop = (rx == 0) & (ry == 0)
    semidiam[stop] = pupil / 2.0
    for i in range(len(rows)):  # the semi-diameter clamp (realisticEye.cpp:228-236)
        if stop[i]:
            continue
        smaller_r, bigger_k = min(rx[i], ry[i]), max(cx[i], cy[i])
        if smaller_r != 0 and semidiam[i] ** 2 * (1 + bigger_k) / smaller_r ** 2 > 1.0:
            semidiam[i] = 0.95 * np.sqrt(smaller_r ** 2 / (1 + bigger_k))
    order = slice(None, None, -1)  # trace order, rear first
    iors = np.ones((6, DEFAULT_SPECTRAL.n_bins), np.float32)
    for k in range(6):
        iors[k] = params.find_one_spectrum(f"ior{k + 1}", 1.0)
    f32 = lambda a: np.asarray(a, np.float32)
    fv = lambda name, default: float(F32(params.find_one_float(name, default)))
    return RealisticEyeCamera(
        el_rx=f32(rx[order]), el_ry=f32(ry[order]), el_thickness=f32(rows[:, 2][order]),
        el_medium=np.asarray(rows[:, 3][order], np.int32),
        el_semidiam=f32(semidiam[order]), el_cx=f32(cx[order]), el_cy=f32(cy[order]),
        ior_spectra=torch.as_tensor(iors, device=place["cam_to_world"].device),
        retina_distance=fv("retinaDistance", 16.32), retina_radius=fv("retinaRadius", 0.0),
        retina_semidiam=fv("retinaSemiDiam", 0.0), pupil_diameter=float(F32(pupil)),
        lens_decenter=(fv("lensDecenterX", 0.0), fv("lensDecenterY", 0.0)),
        lens_tilt=(fv("lensTiltX", 0.0), fv("lensTiltY", 0.0)),
        xres=xres, yres=yres, film_diag=params.find_one_float("filmdiag", 10.0),
        focal_length_mm=efl, f_stop=efl / max(pupil, 1e-9), **place)
