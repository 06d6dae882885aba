"""Measured BRDFs: scattered spectral samples (.brdf) and MERL half-angle
tables (.merl), evaluated lane-parallel.

Port of ``pbrt_tpu/bsdf/measured.py`` (reference: src/materials/measured.cpp
and core/reflection.{h,cpp}: IrregIsotropicBRDF, RegularHalfangleBRDF,
BRDFRemap).

- ``.brdf``: text — the number of wavelengths, the wavelengths, then rows of
  (θi, φi, θo, φo, spectrum) (measured.cpp:29-42). Each sample becomes a
  point p = (sinθi·sinθo, Δφ/π, cosθi·cosθo); a lookup takes the smallest
  radius of the doubling schedule that holds more than 2 samples and
  averages the samples inside it with weights e^{−100·d²}
  (IrregIsotropicBRDF::f, reflection.cpp:251-264).
- ``.merl``: three int32 dimensions (90, 90, 180), then doubles, indexed by
  the square-root-remapped θh, θd and φd, with channel scales (1/1500,
  1.15/1500, 1.66/1500).

The samples of every file live in one pool (P, 3) / (P, S); a lane reads
the rows [offset, offset + count) of its material. The (R, P) distance
matrix is formed once per call (at 32,768 lanes and P = 1,501 one (R, P)
float32 tensor is 197 MB); the radius comes from each lane's
third-smallest distance, never from a (12, R, P) comparison.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.core import spectrum as spec_mod
from pbrt_torch.scene.paramset import read_float_file

#: cap on retained .brdf samples per file
MAX_IRREG_SAMPLES = 1500

MERL_N_THETA_H = 90
MERL_N_THETA_D = 90
MERL_N_PHI_D = 180
_MERL_SCALE = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0])

#: radius² doubling schedule of IrregIsotropicBRDF::f (reflection.cpp:
#: 254-263): from .001, doubled until more than 2 samples are found or it
#: passes 1.5; float32 as the JAX package compares them
_IRREG_R2 = [float(np.float32(r)) for r in 0.001 * (2.0 ** np.arange(12, dtype=np.float64))]


def brdf_remap(wo, wi):
    """(BRDFRemap) local-frame directions (..., 3) → lookup points (..., 3)."""
    cosi = wi[..., 2]
    coso = wo[..., 2]
    sini = torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=0.0))
    sino = torch.sqrt(torch.clamp(1.0 - coso * coso, min=0.0))
    phii = torch.atan2(wi[..., 1], wi[..., 0])
    phio = torch.atan2(wo[..., 1], wo[..., 0])
    dphi = phii - phio
    dphi = torch.where(dphi < 0.0, dphi + 2 * math.pi, dphi)
    dphi = torch.where(dphi > 2 * math.pi, dphi - 2 * math.pi, dphi)
    dphi = torch.where(dphi > math.pi, 2 * math.pi - dphi, dphi)
    return torch.stack([sini * sino, dphi / math.pi, cosi * coso], -1)


def irreg_f(points, spectra, offset, count, wo, wi):
    """(R, S) IrregIsotropicBRDF::f of each lane against its rows
    [offset, offset + count) of the pool ``points`` (P, 3) / ``spectra``
    (P, S)."""
    m = brdf_remap(wo, wi)
    idx = torch.arange(points.shape[0], device=points.device)
    in_range = (idx >= offset[:, None]) & (idx < (offset + count)[:, None])
    d2 = (points[:, 0] - m[:, 0:1]) ** 2
    d2 = d2 + (points[:, 1] - m[:, 1:2]) ** 2
    d2 = d2 + (points[:, 2] - m[:, 2:3]) ** 2
    d2 = torch.where(in_range, d2, math.inf)
    del in_range
    # the first radius holding > 2 samples (the last one bails out): a
    # radius holds 3 samples iff the third-smallest distance lies inside it
    third = torch.topk(d2, min(3, d2.shape[1]), dim=1, largest=False).values[:, -1]
    radii = torch.tensor(_IRREG_R2, dtype=d2.dtype, device=d2.device)
    k = (third[:, None] >= radii[:-1]).sum(1)
    r2 = radii[k]
    w = torch.where(d2 < r2[:, None], torch.exp(-100.0 * d2), 0.0)
    del d2
    wsum = w.sum(1)
    v = torch.clamp(w @ spectra, min=0.0)  # the reference clamps before dividing
    return torch.where((wsum > 1e-9)[:, None], v / wsum[:, None], 0.0)


def _rotate(v, axis, angle):
    """Rodrigues' rotation of v (R, 3) about a unit ``axis`` (3,)."""
    c = torch.cos(angle)[:, None]
    s = torch.sin(angle)[:, None]
    axis = axis.expand_as(v)
    return v * c + geom.cross(axis, v) * s + axis * geom.dot(axis, v)[:, None] * (1.0 - c)


def merl_f(table, offset, wo, wi, config=spec_mod.DEFAULT_SPECTRAL):
    """(R, S) RegularHalfangleBRDF::f: the table row of each lane's
    half-angle coordinates, from RGB as a reflectance."""
    whn = geom.normalize(wo + wi)
    wh_theta = torch.acos(torch.clamp(whn[:, 2], -1.0, 1.0))
    wh_phi = torch.atan2(whn[:, 1], whn[:, 0])
    z = torch.tensor([0.0, 0.0, 1.0], dtype=wo.dtype, device=wo.device)
    y = torch.tensor([0.0, 1.0, 0.0], dtype=wo.dtype, device=wo.device)
    wd = _rotate(_rotate(wi, z, -wh_phi), y, -wh_theta)
    wd_theta = torch.acos(torch.clamp(wd[:, 2], -1.0, 1.0))
    wd_phi = torch.atan2(wd[:, 1], wd[:, 0])
    wd_phi = torch.where(wd_phi < 0.0, wd_phi + math.pi, wd_phi)
    th = (torch.sqrt(torch.clamp(wh_theta / (math.pi / 2), min=0.0)) * MERL_N_THETA_H)
    th = th.to(torch.int64).clamp(0, MERL_N_THETA_H - 1)
    td = (wd_theta / (math.pi / 2) * MERL_N_THETA_D).to(torch.int64).clamp(0, MERL_N_THETA_D - 1)
    pd = (wd_phi / math.pi * MERL_N_PHI_D).to(torch.int64).clamp(0, MERL_N_PHI_D - 1)
    flat = (th * MERL_N_THETA_D + td) * MERL_N_PHI_D + pd
    return spec_mod.rgb_to_spectrum(table[offset + flat], "reflectance", config)


# ---------------------------------------------------------------------------
# Host-side loaders
# ---------------------------------------------------------------------------


def load_irreg_brdf(path: str, config):
    """.brdf → (points (P, 3), spectra (P, S)) float32, evenly subsampled to
    ``MAX_IRREG_SAMPLES`` when the file holds more."""
    vals = read_float_file(path)
    num_wls = int(vals[0])
    wls = vals[1:1 + num_wls]
    stride = 4 + num_wls
    rest = vals[1 + num_wls:]
    n = len(rest) // stride
    rows = rest[: n * stride].reshape(n, stride)

    def sph(theta, phi):
        st, ct = np.sin(theta), np.cos(theta)
        return np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)

    # the remap in float32, as the JAX package runs it on its device arrays
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    pts = brdf_remap(f32(sph(rows[:, 2], rows[:, 3])), f32(sph(rows[:, 0], rows[:, 1]))).numpy()
    spectra = np.stack([spec_mod.from_sampled(wls, rows[k, 4:], config) for k in range(n)])
    if n > MAX_IRREG_SAMPLES:
        sel = np.linspace(0, n - 1, MAX_IRREG_SAMPLES).astype(int)
        pts, spectra = pts[sel], spectra[sel]
    return pts.astype(np.float32), spectra.astype(np.float32)


def load_merl(path: str):
    """.merl binary → (90·90·180, 3) float32 RGB, scaled and clamped at 0."""
    with open(path, "rb") as f:
        dims = np.frombuffer(f.read(12), "<i4")
        n = int(dims[0] * dims[1] * dims[2])
        if n != MERL_N_THETA_H * MERL_N_THETA_D * MERL_N_PHI_D:
            raise ValueError(f"{path}: unexpected MERL dims {dims}")
        data = np.frombuffer(f.read(n * 3 * 8), "<f8")
    if data.size != 3 * n:
        raise ValueError(f"{path}: truncated MERL table")
    rgb = data.reshape(3, n).T * _MERL_SCALE
    return np.maximum(rgb, 0.0).astype(np.float32)
