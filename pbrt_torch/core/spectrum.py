"""Spectra as a trailing wavelength axis (..., n_bins).

Port of ``pbrt_tpu/core/spectrum.py``: the per-config tables (bin-averaged
CIE curves and the reference's 14 Smits basis SPDs), RGB/XYZ → spectrum
for reflectances and illuminants, SPD resampling, blackbody, and
``luminance``, ``to_xyz`` and ``to_rgb`` on device tensors.

The tables are built on the host in numpy; RGB → spectrum
(``rgb_to_spectrum``) keeps the JAX package's float32 operation order,
and the parser resolves every spectral parameter with it on the host at
parse time (``from_rgb``; reference: SampledSpectrum::Init,
spectrum.h:297-351; FromRGB, spectrum.cpp:92-180).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pbrt_torch.config import DEFAULT_SPECTRAL, SpectralConfig
from pbrt_torch.core import cie_data

XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float64,
)


def average_spectrum_samples(lambdas, values, lambda0: float,
                             lambda1: float) -> float:
    """Average of the piecewise-linear SPD over [λ0, λ1] with constant
    extrapolation (reference: spectrum.cpp:50-103)."""
    lambdas = np.asarray(lambdas, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    n = len(lambdas)
    if n == 1:
        return float(values[0])
    if lambda1 <= lambdas[0]:
        return float(values[0])
    if lambda0 >= lambdas[-1]:
        return float(values[-1])
    s = 0.0
    if lambda0 < lambdas[0]:
        s += values[0] * (lambdas[0] - lambda0)
    if lambda1 > lambdas[-1]:
        s += values[-1] * (lambda1 - lambdas[-1])
    i = max(int(np.searchsorted(lambdas, lambda0, side="right")) - 1, 0)
    while i + 1 < n and lambdas[i + 1] >= lambda0:
        if lambdas[i] > lambda1:
            break
        seg_l0 = max(lambda0, lambdas[i])
        seg_l1 = min(lambda1, lambdas[i + 1])
        if seg_l1 > seg_l0:

            def interp(w):
                t = (w - lambdas[i]) / (lambdas[i + 1] - lambdas[i])
                return values[i] * (1 - t) + values[i + 1] * t

            s += 0.5 * (interp(seg_l0) + interp(seg_l1)) * (seg_l1 - seg_l0)
        i += 1
    return float(s / (lambda1 - lambda0))


def _binned(lam, spd, config: SpectralConfig) -> np.ndarray:
    e = config.bin_edges
    return np.array([average_spectrum_samples(lam, spd, e[i], e[i + 1])
                     for i in range(config.n_bins)])


_REFL = ("White", "Cyan", "Magenta", "Yellow", "Red", "Green", "Blue")


@functools.lru_cache(maxsize=8)
def tables(config: SpectralConfig = DEFAULT_SPECTRAL) -> dict:
    """Host float32 tables for one config: ``Y`` (n_bins,), ``yint``,
    ``xyz_matrix`` (n_bins, 3), ``refl_basis``/``illum_basis`` (7, n_bins)
    in (white, cyan, magenta, yellow, red, green, blue) order."""
    lam = cie_data.CIE_lambda
    cmf = np.stack([_binned(lam, c, config)
                    for c in (cie_data.CIE_X, cie_data.CIE_Y, cie_data.CIE_Z)])
    yint = cmf[1].sum()
    grid = cie_data.RGB2SpectLambda
    refl = np.stack([_binned(grid, getattr(cie_data, f"RGBRefl2Spect{n}"),
                             config) for n in _REFL])
    illum = np.stack([_binned(grid, getattr(cie_data, f"RGBIllum2Spect{n}"),
                              config) for n in _REFL])
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(Y=f32(cmf[1]), yint=np.float32(yint),
                xyz_matrix=f32(cmf.T / yint), refl_basis=f32(refl),
                illum_basis=f32(illum))


def rgb_to_spectrum(rgb: torch.Tensor, kind: str = "reflectance",
                    config: SpectralConfig = DEFAULT_SPECTRAL) -> torch.Tensor:
    """(..., 3) RGB tensor → (..., n_bins) spectrum on its device,
    Smits-style: white + secondary + primary with the reference's basis
    SPDs, scaled by .94 (reflectance) or .86445 (illuminant) and clamped at
    0, in the JAX package's float32 operation order."""
    t = tables(config)
    basis, scale = ((t["refl_basis"], 0.94) if kind == "reflectance"
                    else (t["illum_basis"], 0.86445))
    white, cyan, magenta, yellow, red, green, blue = torch.as_tensor(
        basis, dtype=rgb.dtype, device=rgb.device)
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]

    def branch(lo, mid, hi, sec, prim):
        return lo * white + (mid - lo) * sec + (hi - mid) * prim

    w = torch.where
    out = w((r <= g) & (r <= b),
            w(g <= b, branch(r, g, b, cyan, blue), branch(r, b, g, cyan, green)),
            w((g <= r) & (g <= b),
              w(r <= b, branch(g, r, b, magenta, blue), branch(g, b, r, magenta, red)),
              w(r <= g, branch(b, r, g, yellow, green), branch(b, g, r, yellow, red))))
    return torch.clamp(out * scale, min=0.0)


def from_rgb(rgb, kind: str = "reflectance",
             config: SpectralConfig = DEFAULT_SPECTRAL) -> np.ndarray:
    """(..., 3) RGB → (..., n_bins) float32 spectrum on the host
    (``rgb_to_spectrum`` on the CPU; the parser resolves every spectral
    parameter with it at parse time)."""
    rgb = torch.as_tensor(np.asarray(rgb, np.float32))
    return rgb_to_spectrum(rgb, kind, config).numpy()


def from_xyz(xyz, kind: str = "reflectance",
             config: SpectralConfig = DEFAULT_SPECTRAL) -> np.ndarray:
    """(..., 3) XYZ → spectrum via linear RGB (reference: spectrum.h:434)."""
    xyz = np.asarray(xyz, np.float32)
    rgb = xyz @ XYZ_TO_RGB.astype(np.float32).T
    return from_rgb(rgb, kind, config)


def from_sampled(lambdas, values,
                 config: SpectralConfig = DEFAULT_SPECTRAL) -> np.ndarray:
    """Bin-average an arbitrary SPD (reference: spectrum.h:277-296)."""
    lambdas = np.asarray(lambdas, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(lambdas, kind="stable")
    return _binned(lambdas[order], values[order], config).astype(np.float32)


def blackbody(temperature: float, config: SpectralConfig = DEFAULT_SPECTRAL,
              normalize=True) -> np.ndarray:
    """Binned Planck spectrum at T kelvin, max bin 1 when ``normalize``
    (reference: Blackbody, spectrum.cpp:187)."""
    lam = np.asarray(config.bin_centers, dtype=np.float64) * 1e-9
    h, c, kb = 6.62606957e-34, 299792458.0, 1.3806488e-23
    vals = (2.0 * h * c * c) / (lam**5 * (np.exp(h * c / (lam * kb * temperature)) - 1.0))
    if normalize:
        vals = vals / vals.max()
    return np.asarray(vals, dtype=np.float32)


def value_at_wavelength(s: torch.Tensor, wavelength, config: SpectralConfig = DEFAULT_SPECTRAL):
    """The spectrum ``s`` (..., n_bins) at ``wavelength`` nm (a number or
    (...,)), linear between bin i's value and bin i + 1's with t = (λ -
    edge_i) / step (GetValueAtWavelength, spectrum.h:384-405). The last
    bin reads itself where the reference reads one past the end (the JAX
    package's spectrum.py:267-285 and its note at :30-32)."""
    lam = torch.as_tensor(wavelength, dtype=s.dtype, device=s.device)
    idx_f = (lam - config.lambda_start) / config.step
    i = torch.floor(idx_f).to(torch.int64).clamp(0, config.n_bins - 1)
    t = (idx_f - i).clamp(0.0, 1.0)
    c0 = s.gather(-1, i[..., None])[..., 0]
    c1 = s.gather(-1, (i + 1).clamp(max=config.n_bins - 1)[..., None])[..., 0]
    return c0 + t * (c1 - c0)


def luminance(s: torch.Tensor, config: SpectralConfig = DEFAULT_SPECTRAL):
    """y(): (..., n_bins) → (...) (reference: spectrum.h:417-422)."""
    t = tables(config)
    w = torch.as_tensor(t["Y"] / t["yint"], dtype=s.dtype, device=s.device)
    return s @ w


def to_xyz(s: torch.Tensor, config: SpectralConfig = DEFAULT_SPECTRAL):
    """(..., n_bins) → (..., 3) XYZ (reference: spectrum.h:352-362)."""
    m = torch.as_tensor(tables(config)["xyz_matrix"], dtype=s.dtype, device=s.device)
    return s @ m


def to_rgb(s: torch.Tensor, config: SpectralConfig = DEFAULT_SPECTRAL):
    """(..., n_bins) → (..., 3) linear RGB (reference: spectrum.h:424-428)."""
    xyz = to_xyz(s, config)
    return xyz @ torch.as_tensor(XYZ_TO_RGB, dtype=s.dtype, device=s.device).T
