"""The fork's lens cameras: ``realisticDiffraction`` (a stack of spherical
elements with wavelength-dependent refraction and HURB diffraction) and
``idealDiffraction`` (a thin lens with aperture diffraction). Port of
``pbrt_tpu/cameras/realistic.py``; reference:
src/cameras/realisticDiffraction.cpp and idealDiffraction.cpp.

The realistic camera, as the JAX package traces it:

- the lens file holds the focal length, then rows of (radius, separation,
  n, aperture) front to back; the rows are reversed into trace order, a
  row of radius 0 is the stop, sized by ``aperture_diameter``, and each
  element's medium on the scene side is the next row's n, skipping stop
  rows (realistic.py:481-563);
- the film point, in millimetres, carries the reference's -0.25 alignment
  offset and may lie on a curved sensor (``curveRadius``); rays aim at a
  concentric-disk point of the rear element, or at a fixed exit point
  (``pinhole_exit_*``), or through a pinhole array or its microlenses
  (``num_pinholes_*``, ``microlens_enabled``) (:120-170, :265-285);
- each element in trace order is the stop plane or a sphere: the hit, its
  aperture test, then Snell's law, with the chromatic shift n - 0.04 (λ -
  550) / 300 on every medium but n = 1 (``chromaticAberrationEnabled``) or
  the eye-media Cauchy fits (``IORforEyeEnabled``), and total internal
  reflection kills the lane (:171-246);
- after every element HURB bends the ray by two keyed normals scaled by
  the edge distances' uncertainty angles (:288-335), the normals drawn
  under fold-in tag 1000 + i (``noise_tags``; ``core/rng.py:
  camera_normals``);
- a dead lane gets direction 0; the trace is in camera-space millimetres
  and ``cam_to_world`` applies with no rescale (:253-263).

The trace is plain PyTorch over the whole wave: one Python loop over the
static element list, as the JAX code unrolls it, about 40 launches per
element and 40 more for HURB. The elements' numbers are host float32
scalars, combined as the JAX package combines its float32 scalars.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbrt_torch.cameras.cameras import CameraPlacement
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.core import sampling as smp
from pbrt_torch.scene.paramset import read_float_file

F32 = np.float32
#: media recognized by their design n under ``IORforEyeEnabled``
#: (realisticDiffraction.cpp:360-380; realistic.py:59-64)
EYE_MEDIA = (1.336, 1.42, 1.3374, 1.3771)
#: float32 √2, as ``jnp.sqrt(2.0)``
SQRT2 = float(F32(math.sqrt(2.0)))


def cauchy_ior(lam, n_ref: float, a: float = 6.0e3):
    """n(λ) = n_ref + A (1/λ² - 1/589²) (realistic.py:51-56)."""
    return n_ref + a * (1.0 / (lam * lam) - 1.0 / (589.0 * 589.0))


def lane_wavelengths(wavelength, like: torch.Tensor, default: float):
    """(R,) float32 wavelengths: the given (R,) ones, or one number (by
    default ``default``) on every lane."""
    if wavelength is None:
        wavelength = default
    if isinstance(wavelength, (int, float)):
        return torch.full_like(like, float(wavelength))
    return wavelength.to(torch.float32).expand(like.shape).contiguous()


def safe_dz(dz):
    return torch.where(dz.abs() < 1e-12, 1e-12, dz)


def _edge_frame(ix, iy):
    """The aperture plane's radial and tangential unit vectors at (ix, iy),
    any orthogonal pair on the axis (realistic.py:311-317)."""
    radius = torch.sqrt(ix * ix + iy * iy)
    central = radius < 1e-8
    ux = torch.where(central, 1.0, ix)
    uy = torch.where(central, 0.0, iy)
    safe_r = torch.clamp(torch.sqrt(ux * ux + uy * uy), min=1e-9)
    zero = torch.zeros_like(ix)
    radial = torch.stack([ux / safe_r, uy / safe_r, zero], -1)
    tangent = torch.stack([-uy / safe_r, ux / safe_r, zero], -1)
    return radius, radial, tangent


def hurb(o, d, aperture: float, lam, noise):
    """Heisenberg uncertainty ray bending at an element of full aperture
    ``aperture`` (realistic.py:288-335; realisticDiffraction.cpp:997-1085):
    σ = atan(1 / (√2 · edge distance · 2π / λ)), the edge distances a
    (radial) and b (tangential) in metres. → the new direction."""
    radius, dir_r, dir_o = _edge_frame(o[:, 0], o[:, 1])
    half_ap = float(F32(aperture) / F32(2.0))
    a = torch.clamp(half_ap - radius, min=1e-6)
    b = torch.sqrt(torch.clamp(float(F32(half_ap) * F32(half_ap)) - radius * radius,
                               min=1e-12))
    lam_m = lam * 1e-9
    sigma_x = torch.atan(1.0 / (SQRT2 * a * 1e-3 * 2.0 * math.pi / lam_m))
    sigma_y = torch.atan(1.0 / (SQRT2 * b * 1e-3 * 2.0 * math.pi / lam_m))
    proj_a = (d * dir_r).sum(-1)
    proj_b = (d * dir_o).sum(-1)
    proj_c = d[:, 2]
    r_a = torch.sqrt(proj_a * proj_a + proj_c * proj_c)
    theta_a = torch.arccos(torch.clamp(proj_a / torch.clamp(r_a, min=1e-12), -1.0, 1.0))
    theta_a = theta_a + noise[:, 0] * sigma_x
    new_a = torch.cos(theta_a) * r_a
    dz = torch.sin(theta_a) * r_a
    r_b = torch.sqrt(proj_b * proj_b + dz * dz)
    theta_b = torch.arccos(torch.clamp(proj_b / torch.clamp(r_b, min=1e-12), -1.0, 1.0))
    theta_b = theta_b + noise[:, 1] * sigma_y
    new_b = torch.cos(theta_b) * r_b
    new_d = torch.stack([dir_r[:, 0] * new_a + dir_o[:, 0] * new_b,
                         dir_r[:, 1] * new_a + dir_o[:, 1] * new_b,
                         torch.sin(theta_b) * r_b], -1)
    bad = torch.isnan(new_d).any(-1)
    return torch.where(bad[:, None], d, geom.normalize(new_d))


def refract(d, nvec, eta):
    """Vector Snell's law (realistic.py:224-233) → (new direction, TIR)."""
    cos_i = -(nvec * d).sum(-1)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    d_refr = geom.normalize(eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * nvec)
    return d_refr, sin2_t > 1.0


def sensor_width(film_diag: float, xres: int, yres: int) -> float:
    ar = xres / yres
    return film_diag / np.sqrt(1.0 + 1.0 / (ar * ar))


@dataclasses.dataclass
class RealisticDiffractionCamera(CameraPlacement):
    """The lens stack in trace order (rear → front), host float32 (E,)."""

    el_radius: np.ndarray
    el_sep: np.ndarray
    el_n: np.ndarray  # design n (stop rows 1)
    el_aperture: np.ndarray  # full aperture diameter
    el_next_n: np.ndarray  # medium on the scene side
    cam_to_world: torch.Tensor
    shutter_open: float
    shutter_close: float
    film_distance: float  # float32 values
    aperture_offset: tuple = (0.0, 0.0)
    film_center: tuple = (0.0, 0.0)
    curve_radius: float = 0.0
    motion: object = None
    xres: int = 256
    yres: int = 256
    film_diag: float = 35.0
    diffraction: bool = True
    chromatic: bool = False
    ior_for_eye: bool = False
    focal_length_mm: float = 50.0
    f_stop: float = 4.0
    fov_deg: float = 0.0
    num_pinholes: tuple = (-1, -1)
    microlens: bool = False
    pinhole_exit: tuple = (-1.0, -1.0, -1.0)

    @property
    def sensor_width(self) -> float:
        return sensor_width(self.film_diag, self.xres, self.yres)

    @property
    def noise_tags(self) -> range:
        n = len(self.el_radius) if self.diffraction else 0
        return range(rng.REALISTIC_NOISE_TAG, rng.REALISTIC_NOISE_TAG + n)

    def _ior(self, n_design, lam):
        """The medium's index at λ for design index ``n_design`` (host)."""
        if self.ior_for_eye:
            out = None
            for n_ref in EYE_MEDIA:
                if abs(F32(n_design) - F32(n_ref)) < F32(1e-3):
                    out = cauchy_ior(lam, n_ref)
            return out if out is not None else torch.full_like(lam, float(n_design))
        if self.chromatic and n_design != 1.0:
            return float(n_design) + (lam - 550.0) * (-0.04 / 300.0)
        return torch.full_like(lam, float(n_design))

    def generate_rays(self, px, py, u_lens1, u_lens2, u_time, wavelength=None,
                      noise=None) -> geom.Ray:
        lam = lane_wavelengths(wavelength, px, 550.0)
        width = self.sensor_width
        height = width / (self.xres / self.yres)
        hx, hy = self.xres / 2.0, self.yres / 2.0
        x0 = -(px - hx - 0.25) / hx * width / 2.0 + self.film_center[0]
        y0 = (py - hy - 0.25) / hy * height / 2.0 + self.film_center[1]
        fd = self.film_distance
        if self.curve_radius != 0.0:
            cr = self.curve_radius
            th, ph = x0 / cr, y0 / cr
            x0, y0, z0 = (cr * torch.cos(ph) * torch.sin(th), cr * torch.sin(ph),
                          float(F32(-fd) - F32(cr)) + cr * torch.cos(ph) * torch.cos(th))
        else:
            z0 = torch.full_like(x0, -fd)
        o = torch.stack([x0, y0, z0], -1)

        lu, lv = smp.concentric_sample_disk(u_lens1, u_lens2)
        if self.pinhole_exit[0] != -1.0:
            target = torch.tensor(self.pinhole_exit, dtype=torch.float32,
                                  device=px.device).expand(o.shape)
        elif self.num_pinholes[0] > 0:
            target = self._pinhole_target(px, py, lu, lv, width)
        else:
            first_ap = F32(self.el_aperture[0]) / F32(2.0)
            r0 = F32(self.el_radius[0])
            z_int = (F32(0.0) if r0 == 0.0 else
                     -r0 - np.sqrt(np.maximum(r0 * r0 - first_ap * first_ap, F32(0.0))))
            fa = float(first_ap)
            target = torch.stack([lu * fa, lv * fa, torch.full_like(lu, float(z_int))], -1)
        d = geom.normalize(target - o)
        alive = torch.ones_like(px, dtype=torch.bool)

        lens_dist = F32(0.0)
        for i in range(len(self.el_radius)):
            radius = F32(self.el_radius[i])
            lens_dist = lens_dist + F32(self.el_sep[i])
            aperture = F32(self.el_aperture[i])
            if radius == 0.0:  # the stop's plane
                if i == 0:
                    t_ap = fd / safe_dz(d[:, 2])
                else:
                    t_ap = (float(lens_dist) - o[:, 2]) / safe_dz(d[:, 2])
                new_o = o + t_ap[:, None] * d
                ox, oy = self.aperture_offset
                ok = ((new_o[:, 0] - ox) ** 2 + (new_o[:, 1] - oy) ** 2
                      <= float(aperture * aperture * F32(0.25)))
                new_d = d
            else:  # a sphere centred on the axis at lens_dist - radius
                new_o, new_d, ok = self._sphere(o, d, i, radius, lens_dist, aperture, lam)
            alive = alive & ok
            o = torch.where(alive[:, None], new_o, o)
            d = torch.where(alive[:, None], new_d, d)
            if self.diffraction and noise is not None:
                d = hurb(o, d, float(aperture), lam, noise[:, i])
        d = torch.where(alive[:, None], d, 0.0)
        return self.to_world(o, d, u_time, lam, renormalize=True, keep=alive)

    def _sphere(self, o, d, i, radius, lens_dist, aperture, lam):
        """Element i's spherical surface: the hit, its aperture test and the
        refraction (realistic.py:188-240). → (point, direction, ok)."""
        center_z = float(lens_dist - radius)
        rabs = np.abs(radius)
        oc = torch.stack([o[:, 0], o[:, 1], o[:, 2] - center_z], -1)
        A = (d * d).sum(-1)
        B = 2.0 * (d * oc).sum(-1)
        C = (oc * oc).sum(-1) - float(rabs * rabs)
        disc = B * B - 4 * A * C
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(B < 0, -0.5 * (B - sq), -0.5 * (B + sq))
        t0 = q / torch.where(A.abs() < 1e-20, 1e-20, A)
        t1 = C / torch.where(q.abs() < 1e-20, 1e-20, q)
        tlo, thi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        thit = torch.where(tlo > 1e-7, tlo, thi)
        p = o + thit[:, None] * d
        in_ap = p[:, 0] ** 2 + p[:, 1] ** 2 < float(aperture * aperture / F32(4.0))
        normal = geom.normalize(torch.stack([p[:, 0], p[:, 1], p[:, 2] - center_z], -1))
        eta = self._ior(self.el_n[i], lam) / self._ior(self.el_next_n[i], lam)
        d_refr, tir = refract(d, -normal if radius > 0 else normal, eta)
        return p, d_refr, (disc >= 0.0) & (thit > 1e-7) & in_ap & ~tir

    def _pinhole_target(self, px, py, lu, lv, width):
        """The light-field target: the centre of the pixel's pinhole, or a
        point of its microlens (realistic.py:265-285)."""
        nw, nh = self.num_pinholes
        s_pitch = width / nw
        pin_dist = s_pitch * float(self.film_distance) / (float(self.el_aperture[-1]) + s_pitch)
        xp = ((px - 0.25) / (self.xres // nw)).to(torch.int32).clamp(0, nw - 1)
        yp = ((py - 0.25) / (self.yres // nh)).to(torch.int32).clamp(0, nh - 1)
        cx = (xp.to(torch.float32) + 0.5 - nw / 2.0) * s_pitch
        cy = (yp.to(torch.float32) + 0.5 - nh / 2.0) * s_pitch
        if self.microlens:
            cx = cx + lu * s_pitch / 2.0
            cy = cy + lv * s_pitch / 2.0
        return torch.stack([cx, cy, torch.full_like(cx, -pin_dist)], -1)


@dataclasses.dataclass
class IdealDiffractionCamera(CameraPlacement):
    """The fork's thin lens with aperture diffraction (idealDiffraction.cpp;
    realistic.py:338-414): the film at -``film_distance`` mm, the aperture
    disk at z = 0, the thin-lens focus, then two keyed normals (tag 2000)
    scaled by σ = atan(λ / (4π · edge distance)) in the aperture's radial
    and tangential frame. ``chromaticAberrationEnabled`` is parsed by the
    reference and the JAX package and applied by neither."""

    cam_to_world: torch.Tensor
    shutter_open: float
    shutter_close: float
    film_distance: float  # float32 values, mm
    focal_length: float
    aperture_diameter: float
    motion: object = None
    xres: int = 256
    yres: int = 256
    film_diag: float = 35.0
    diffraction: bool = True
    focal_length_mm: float = 50.0
    f_stop: float = 4.0
    fov_deg: float = 0.0

    @property
    def sensor_width(self) -> float:
        return sensor_width(self.film_diag, self.xres, self.yres)

    @property
    def noise_tags(self) -> range:
        n = 1 if self.diffraction else 0
        return range(rng.IDEAL_NOISE_TAG, rng.IDEAL_NOISE_TAG + n)

    def generate_rays(self, px, py, u_lens1, u_lens2, u_time, wavelength=None,
                      noise=None) -> geom.Ray:
        lam = lane_wavelengths(wavelength, px, 550.0)
        width = self.sensor_width
        height = width / (self.xres / self.yres)
        hx, hy = self.xres / 2.0, self.yres / 2.0
        o = torch.stack([-(px - hx) / hx * width / 2.0, (py - hy) / hy * height / 2.0,
                         torch.full_like(px, -self.film_distance)], -1)
        lu, lv = smp.concentric_sample_disk(u_lens1, u_lens2)
        half_ap = float(F32(self.aperture_diameter) / F32(2.0))
        p_lens = torch.stack([lu * half_ap, lv * half_ap, torch.zeros_like(lu)], -1)
        f, fd = F32(self.focal_length), F32(self.film_distance)
        denom = F32(1.0) / f - F32(1.0) / fd
        if np.abs(f - fd) < F32(1e-10):
            focus = F32(1e6) * f
        else:
            focus = F32(1.0) / (F32(1e-12) if np.abs(denom) < F32(1e-12) else denom)
        d_center = geom.normalize(-o)
        p_focus = (float(focus) / safe_dz(d_center[:, 2]))[:, None] * d_center
        d = geom.normalize(p_focus - p_lens)
        if self.diffraction and noise is not None:
            d = ideal_diffract(p_lens, d, self.aperture_diameter, lam, noise[:, 0])
        return self.to_world(p_lens, d, u_time, lam, renormalize=True)


def ideal_diffract(p, d, aperture: float, lam, noise):
    """Azimuth and elevation Gaussian bends in the aperture's radial (S) and
    tangential (L) frame, σ without the realistic camera's √2
    (realistic.py:416-455; idealDiffraction.cpp:418-500)."""
    ip_len, dir_s, dir_l = _edge_frame(p[:, 0], p[:, 1])
    half_ap = float(F32(aperture) / F32(2.0))
    edge_s = torch.clamp(half_ap - ip_len, min=1e-6)
    edge_l = torch.sqrt(torch.clamp(float(F32(half_ap) * F32(half_ap)) - ip_len * ip_len,
                                    min=1e-12))
    lam_m = lam * 1e-9
    sigma_s = torch.atan(1.0 / (2.0 * edge_s * 1e-3 * 2.0 * math.pi / lam_m))
    sigma_l = torch.atan(1.0 / (2.0 * edge_l * 1e-3 * 2.0 * math.pi / lam_m))
    proj_s = (d * dir_s).sum(-1)
    proj_l = (d * dir_l).sum(-1)
    dz = d[:, 2]
    theta_a = torch.atan2(proj_s, dz) + noise[:, 0] * sigma_s
    theta_e = torch.atan2(proj_l, torch.sqrt(proj_s * proj_s + dz * dz)) + noise[:, 1] * sigma_l
    new_l = torch.sin(theta_e)
    small_h = torch.cos(theta_e)
    new_s = small_h * torch.sin(theta_a)
    new_d = torch.stack([dir_s[:, 0] * new_s + dir_l[:, 0] * new_l,
                         dir_s[:, 1] * new_s + dir_l[:, 1] * new_l,
                         small_h * torch.cos(theta_a)], -1)
    bad = torch.isnan(new_d).any(-1)
    return torch.where(bad[:, None], d, geom.normalize(new_d))


def make_ideal_diffraction(params, place: dict, xres: int, yres: int):
    """CreateIdealDiffractionCamera (idealDiffraction.cpp:30-53;
    realistic.py:458-478)."""
    focal = params.find_one_float("focal_length", 50.0)
    ap = params.find_one_float("aperture_diameter", 1.0)
    return IdealDiffractionCamera(
        film_distance=float(F32(params.find_one_float("filmdistance", 70.0))),
        focal_length=float(F32(focal)), aperture_diameter=float(F32(ap)),
        xres=xres, yres=yres, film_diag=float(params.find_one_float("filmdiag", 35.0)),
        diffraction=params.find_one_float("diffractionEnabled", 1.0) == 1.0,
        focal_length_mm=float(focal), f_stop=float(focal / max(ap, 1e-6)), **place)


def lens_rows(vals: np.ndarray, ap_diam: float):
    """A lens file's rows → the (E,) element arrays in trace order (rear
    first): radius, separation, design n (stop rows 1), aperture (stop
    rows ``ap_diam``) and the medium on each element's scene side, the
    next non-stop row's n, 1 past the front (realistic.py:492-522)."""
    rows = vals[1:].reshape(-1, 4)
    radius, sep, n, aperture = (rows[::-1, k].copy() for k in range(4))
    aperture[radius == 0.0] = ap_diam
    next_n = np.ones(len(rows), np.float64)
    for i in range(len(rows)):
        j = i + 1
        while j < len(rows) and n[j] == 0.0:
            j += 1
        next_n[i] = n[j] if j < len(rows) else 1.0
    n = np.where(n == 0.0, 1.0, n)
    return tuple(a.astype(np.float32) for a in (radius, sep, n, aperture, next_n))


def make_realistic_diffraction(params, place: dict, xres: int, yres: int):
    """CreateRealisticDiffractionCamera (realisticDiffraction.cpp:44-95;
    realistic.py:481-563)."""
    specfile = params.find_one_filename("specfile", "")
    if not specfile:
        raise ValueError("realisticDiffraction needs a specfile")
    vals = read_float_file(specfile)
    if (len(vals) - 1) % 4 != 0:
        raise ValueError(f"{specfile}: bad float count (forgot focal length?)")
    focal_length = float(vals[0])
    ap_diam = params.find_one_float("aperture_diameter", 1.0)
    radius, sep, n, aperture, next_n = lens_rows(vals, ap_diam)
    f = lambda name, default: float(F32(params.find_one_float(name, default)))
    return RealisticDiffractionCamera(
        el_radius=radius, el_sep=sep, el_n=n, el_aperture=aperture, el_next_n=next_n,
        film_distance=f("filmdistance", 70.0),
        aperture_offset=(f("x_aperture_offset", 0.0), f("y_aperture_offset", 0.0)),
        film_center=(f("film_center_x", 0.0), f("film_center_y", 0.0)),
        curve_radius=f("curveRadius", 0.0), xres=xres, yres=yres,
        film_diag=params.find_one_float("filmdiag", 35.0),
        diffraction=params.find_one_bool("diffractionEnabled", True),
        chromatic=params.find_one_bool("chromaticAberrationEnabled", False),
        ior_for_eye=params.find_one_bool("IORforEyeEnabled", False),
        focal_length_mm=focal_length, f_stop=focal_length / max(ap_diam, 1e-9),
        num_pinholes=(int(params.find_one_float("num_pinholes_w", -1)),
                      int(params.find_one_float("num_pinholes_h", -1))),
        microlens=bool(params.find_one_float("microlens_enabled", 0)),
        pinhole_exit=(params.find_one_float("pinhole_exit_x", -1.0),
                      params.find_one_float("pinhole_exit_y", -1.0),
                      params.find_one_float("pinhole_exit_z", -1.0)),
        **place)
